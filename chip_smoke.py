"""Smoke test of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
result):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of ``src/repro_torch/csrc`` from source, all
   ``nvcc`` processes at once, and print the build time and each
   kernel's register / spill report;
3. hold each kernel against its plain PyTorch version on the card, in
   bf16 (atol 2e-2, rtol 2e-2: one bf16 rounding of the output) and fp32
   (atol 1e-4, rtol 1e-4: summation order), at the serving path's shapes
   and at the contract's edge cases, and time the kernel, its plain
   version and ``F.scaled_dot_product_attention`` (a yardstick only; the
   port never calls it) at the serving path's shapes, beside the bound.
   Prefill attention runs bf16 on the tensor cores (``wgmma``, K/V by
   TMA) and fp32 on the CUDA cores: its bf16 cases reach the tensor-core
   route's edges (ragged tiles, more K/V tiles than ring stages, q blocks
   at an offset down to Sq = 1, window + softcap, the true-length mask,
   D = 32 with a group of 3, D = 128, and MLA's q/k heads of 192 against
   v heads of 128 in both types), every launch must land on the route of
   its type, two bf16 launches must give equal bits, and it is timed at
   five bf16 causal shapes (Llama-3.2-1B 4x512, 8x256 and one 2048-token
   prompt, Qwen3-30B-A3B 8x256 at D = 128, DeepSeek-R1's MLA prefill 2x1024
   with 128 heads at q/k 192, v 128), at the windowed decoders' prefill
   (H2O-Danube-1.8B at (80, 80), 32/8 heads, window 4096: B8 S512 and B1
   S6144; RecurrentGemma-2B at (256, 256), 10/1 heads, window 2048,
   softcap 30: B8 S512 and B1 S3072; each also held in fp32), at the
   served encoder-decoder's and vision decoder's prefill (Whisper-base's
   encoder self-attention B8 S1536 and its cross-attention B8 Sq32
   Skv1536, both non-causal, and its decoder's causal B8 S32, 8 heads of
   64; Pixtral-12B's causal B8 S1536, 1024 patches + 512 tokens, 32/8
   heads of 128; each also held in fp32; the plain version with the
   encoder's mask made causal must fail the encoder row's tolerance), and
   in fp32 at 4x512.  Each timed bf16 row also gives the kernel alone in
   ``torch.profiler``'s trace and its window-aware bound; SDPA runs with
   a windowed mask where the window binds, and not at all under a
   softcap (it has none).  Every checked forward row also launches the
   training route (``flash_attention_lse``): its out must equal the
   serving launch's bits and its per-row log-sum-exp the plain forward's
   (fp32 atol 1e-4, bf16 atol 1e-3, rtol 1e-4); the fp32 B4 S512 row is
   timed like the bf16 ones (alone, bound, SDPA).
   The flash backward (``flash_attention_bwd``: preprocess, dK/dV and dQ
   launches, bf16 products on ``wgmma`` with tiles by TMA, fp32 on the
   CUDA cores, fp32 sums) is held to its plain version on
   the same out and lse in bf16 at the training shapes (SmolLM-360M B8
   S4096 H15/5 and Llama-3.2-1B B4 S4096 H32/8 at (64, 64), B4 S2048
   H32/4 at (128, 128), causal; H2O-Danube-1.8B's B4 S8192 H32/8 at (80,
   80) with its window of 4096; B4 S2048 at D 64 and 128 with a softcap of
   30; the windowed and softcapped rows with scores spread by SPREAD), in
   fp32 at SmolLM's, and in both types at the edges (S = 100, S = 1, G = 1
   and 3, non-causal at Sq != Skv, an offset q block; D 80 windowed and
   softcapped over ragged tiles and at an offset, tiles wholly past a
   window, a softcap at D 128, a window without the causal mask);
   tolerances tied to the scale of the three gradients (fp32 atol 1e-4 x
   the largest |gradient|, rtol 1e-4; bf16 atol min(2e-2, 0.05 rms), rtol
   2e-2), and the plain version with a window one tile wider must fail a
   windowed bf16 row's; two launches must give equal bits (D 64, 128 and
   the windowed D 80) and every call land on its type's route; the
   training shapes are timed through the wrapper, alone (its three
   kernels' medians summed), plain, and against SDPA's backward
   (``autograd.grad``; the window as a boolean mask on the
   memory-efficient backend; none under a softcap) beside the bound (2.5
   times the forward's operations on the pairs the mask lets through).
   Decode attention (``paged_attention``, each sequence and kv head split
   across a cluster of 8 CTAs and merged in distributed shared memory;
   bf16 products on ``mma.sync``, fp32 on the CUDA cores) is held to its
   plain version at the seven decode shapes it is timed at (Llama-3.2-1B
   B8 over a 2048-token cache, Qwen3-30B-A3B B8 and its b_attn 4
   sub-batch at D = 128, the B1 prefix-hit tail; Whisper-base's decoder
   self-attention over 96 positions and its cross-attention over 1536,
   both at G = 1, D 64, and Pixtral-12B's at G = 4, D 128 over 1600; each
   of these three also in fp32, and the plain version with the cross row's
   length one page short must fail its tolerance) and at the contract's
   edges in both types (length 0 must give exact zeros, length 1, ranks
   left empty, a full table and one past it, groups of 16, 4, 7 and 3);
   every launch must land on the route of its type, two launches must
   give equal bits in both types, each timed row is also read alone in
   the profiler's trace, and the fp32 route is timed at the first shape.
   The fused sampling kernel (each row split across a cluster of 8 CTAs,
   its slices parked in shared memory; fp32, B=8, V=128256, and edge
   rows: the batch-1 prefix tail, Qwen3's V151936 with lanes, V256000,
   the largest slice, Whisper-base's V51872 (no multiple of 128) and
   Pixtral-12B's V131072 with lanes, V7 with ranks left empty, 40 lanes
   in two rounds, a
   maximum tied across a rank boundary, crossings on a refinement level's
   catch-all bucket) must give exactly its plain
   version's tokens and top-K ids, its stats to rtol 1e-5 (float
   summation order), and equal bits over two launches, and must refuse a
   row past its V limit; it is timed at B8 V128256 without and with 5
   lanes, B1 V128256, and B8 with 5 lanes at V151936, V256000, V51872
   and V131072, by CUDA events and
   alone in ``torch.profiler``'s trace (with the wrapper's host µs a
   call), its residency is queried
   (``cudaOccupancyMaxActiveClusters``), and its yardstick is the port's
   own shared-sort route (no single PyTorch call computes the function).  The grouped expert GEMM (``moe_gemm``)
   is held to its plain version in bf16 and fp32 at Qwen3-30B-A3B's
   decode and 8x256-prefill shapes (w1 and w2), as the dispatch lays them
   out, at DeepSeek-R1's (E 256, top-8, D 7168, expert F 2048: decode B8
   and an 8x512 prefill, w1 and w2, the plain version taken 32 blocks at
   a time), and at edge cases (an expert with no rows, unused trailing
   blocks, ragged D and F, E=4 F=64); its bf16 prefill shapes run on the
   ``wgmma`` route (block_t 128), decode on ``mma``, fp32 on ``simt``,
   and the wgmma route is also held at its edges (D = 72, not a multiple
   of its 64-deep k-tile; 16 k-tiles, more than its ring's stages; an
   expert with three consecutive blocks and one with none; block_t 64
   and 256; F = 64 at block_t 128; a ragged column tile), unused blocks
   must give exact zeros, every launch must land on the route
   ``ops.route`` names, and two prefill launches must give equal bits.
   It is timed at decode and at both prefill shapes (with the wrapper's
   host µs a call); its yardsticks are one ``torch.bmm`` over the
   reference's (E, C, D) capacity buffer and, where the card's torch has
   it, ``torch._grouped_mm``.  The grouped GEMM's backward at
   Qwen3-30B-A3B's training shape (4 x 4096 tokens, top-8 of 128 experts,
   D 2048, F 768, block_t 128): the weight gradient (``moe_gemm_wgrad``:
   bf16 on its ``wgmma`` route, 128 x 256 output tiles fed by TMA through
   an mbarrier ring) of w1/w3 (D x F) and w2 (F x D) against its plain
   version with equal bits over two launches, on the route ``ops.route``
   names; at the edges (``WGRAD_EDGES``: ragged widths, M and N multiples
   of 8 but not of 64, empty experts, unused blocks, block_t 16, 64 and
   128, blocks of one expert apart) on wgmma, on the ``mma.sync`` route
   (every bf16 edge) and on simt (fp32); and dX through the forward
   kernel on the transposed weights (on ``wgmma``); timed beside their
   bounds, the weight gradient alone on the wgmma and mma routes (same
   inputs), plain and against one ``torch._grouped_mm`` grouped along the
   rows.
   The SSD state
   scan (``ssd_scan``) must give its plain version's bits (``torch.equal``)
   at Mamba2-370M's 8x256 and 32768-token prefill shapes, the JAX test's
   shapes, one chunk, a ragged N*P and an unaligned view, and is timed
   at the first two by CUDA events and alone in the profiler's trace; no
   PyTorch call computes a linear recurrence, so it has no library
   yardstick.  Its backward (``ssd_scan_bwd``, the adjoint recurrence:
   dstates and ddecay, the cell's sum over CTAs as per-tile partials
   summed in tile order by a second launch) must give the plain
   backward's dstates bits and ddecay to atol 1e-5 + 1e-7 x the sum of
   its products' magnitudes, rtol 1e-5, with equal bits over two
   launches, at Mamba2-370M's training microbatch (8 x 4096 tokens:
   (8, 32, 64, 128, 64), dfinal None), the forward's serving shapes, the
   JAX test's shapes, one chunk, a ragged N*P, a ragged tile and an
   unaligned view, and is timed at the training shape by CUDA events and
   alone (its two launches summed) beside its bound, with no library
   yardstick;
4. the serving paths: full-width Llama-3.2-1B in bf16 (random weights from
   a seed) through the port's ``BatchMaster`` and one ``NodeEngine``:
   the greedy path (~8 requests and a resubmitted prefix), then the
   sampled path (8 requests of mixed SamplingParams with a stop token and
   top-5 logprobs, submitted twice: the streams must be identical), with
   every kernel's launch count read around each path alone: each path
   must launch its kernels, and the dense paths never ``moe_gemm``; every
   flash and paged launch of a path must be on its tensor-core route;
5. reduced fp32 copies of Llama-3.2-1B and of Qwen3-30B-A3B (the MoE one
   with module granularity, b_attn 2 of 4 slots) served once on "cuda"
   (the kernels) and once on "cpu" (the plain versions), greedy and
   sampled requests: the tokens of one page must be identical, and every
   fp32 ``moe_gemm`` launch must be on the ``simt`` route; reduced fp32
   DeepSeek-R1 (MLA, head_dim 128 + rope 64, so its prefill runs the
   fp32 flash kernel at q/k 192, v 128: every flash launch there must be
   at those head dims) the same way, monolithic; reduced
   fp32 Mamba2-370M at model level the same way (identical greedy and
   sampled tokens, the prefill state to atol/rtol 1e-4); reduced fp32
   H2O-Danube-1.8B and RecurrentGemma-2B (window 64) at their published
   head dims, 80 and 256, at model level the same way: 4 prompts of 96
   decoded past the window's wrap, identical greedy and sampled tokens,
   every flash launch at (80, 80) / (256, 256) on the fp32 route;
   reduced fp32 Whisper-base (MHA of 64: G = 1) and Pixtral-12B (heads of
   128, G = 4) at model level the same way, with 32 stub frames / 8 stub
   patches: identical greedy and sampled tokens, every flash launch at the
   head dim on the fp32 route (Whisper's encoder and cross-attention
   non-causal), every decode attention through ``paged_attention`` at the
   model's group; reduced fp32 SmolLM-360M, Qwen3-30B-A3B and
   H2O-Danube-1.8B (at head dim 80, S 160 past its window of 64) trained
   on "cuda" and on "cpu": ``forward_loss`` and every leaf's gradient,
   then one ``train_step``'s loss, grad norm and AdamW moments, with the
   flash forward launched twice a layer (remat) and the backward once, and
   an MoE layer's grouped GEMM 9 times and its weight gradient 3 times
   (all fp32, on the simt routes); reduced fp32 Mamba2-370M the same way,
   the scan launched twice a layer and its backward once;
6. the MoE path: full-width Qwen3-30B-A3B in bf16 (random weights from a
   seed, 61 GB) through ``BatchMaster`` and one ``NodeEngine`` with
   module granularity (Algorithm 1: attention in sub-batches of 4 of the
   8 slots, COMBINE before each MoE layer): 8 greedy requests, then the
   model's default SamplingParams with seeds, submitted twice (identical
   streams required), then the greedy batch once more on a monolithic
   engine sharing the weights (how many streams agree is printed, not
   gated: bf16 sub-batched products may round differently); every flash
   and paged launch on its tensor-core route, and every ``moe_gemm``
   launch at block_t >= 64 (the greedy 8x256 prefill batch) on ``wgmma``,
   every other one (decode's block_t 16) on ``mma``, none on ``simt``;
7. the SSM path: full-width Mamba2-370M in bf16 (random weights from a
   seed) at model level (``prefill``, then ``decode_page``s of 16 steps;
   ``NodeEngine`` serves no SSM, as the JAX engine does not): 8 prompts
   of 256 greedy, the same prompts sampled (T 0.8, top-k 40, top-p 0.95,
   a seed a row, top-5 logprobs) twice with identical streams required,
   then one 32768-token prompt and 16 greedy steps; each part must
   launch ``ssd_scan`` (once a layer per prefill), the sampled parts
   ``fused_sampling``, and none the attention or MoE kernels;
8. the batch job: full-width Llama-3.2-1B in bf16 (random weights from
   seed 0) behind the port's ``StreamingJobDriver``, two ``NodeEngine``
   replicas (8 slots, 2048 positions, pages of 16) sharing the weights,
   a window of 24 and ledger segments of 16 rows.  First a probe: 8
   requests served one at a time, as one batch and mixed with 8 others
   must give identical tokens (a request's output is a function of the
   request, not of its batch; the row counts at which a bf16 row of the
   MLP's down projection changes its bits are logged beside it).  Then
   (a) the 48-request long-tail job
   (every fourth row sampled) in this process, launching the attention
   kernels on their tensor-core routes and ``fused_sampling``, never
   ``moe_gemm``; (b) the same job in a child (``python -m
   repro_torch.launch.job``, fork + exec) SIGKILLed after 16 journaled
   rows, leaving no output; (c) a child resuming it: completed, 48 rows
   merged, at least 16 skipped, at most one segment replayed, and an
   output equal to (a)'s byte for byte; (d) the weights saved, restored
   memory-mapped onto the card (every leaf ``torch.equal``, 4 greedy
   requests give the original's tokens), and a sequence pool snapshotted
   after two ticks restored into a fresh engine that completes it;
9. the MLA path: DeepSeek-R1 in bf16 at every published width (d_model
   7168, 128 heads of 128 + 64, q_lora 1536, kv_lora 512, 256 experts
   top-8 of d_ff 2048 and one shared expert of 2048, vocab 129280) with
   its depth cut from 61 layers to 2 (49.7 GB of weights; 3 layers would
   leave too little of the card's 80 GB), random weights from seed 0,
   through ``BatchMaster`` and one monolithic ``NodeEngine`` (8 slots,
   2048 positions, pages of 16): 8 greedy requests (prompts 64-512,
   32-64 output tokens) and a resubmitted 15-page prefix whose tail runs
   through ``mla_decode``, then 8 requests under the model's default
   SamplingParams; it logs the memory, the weights' draw, prefill and
   decode times and the launches per kernel; every flash launch must be
   on the wgmma route at q/k 192, v 128, every grouped-GEMM launch on
   ``ops.route``'s rule (wgmma at prefill, mma at decode), the sampled
   path must launch ``fused_sampling`` at V 129280, and no path
   ``paged_attention`` (MLA decode is plain PyTorch: no TPU kernel
   computes it); then one B8 decode step's device time (the profiler's
   trace) split into a layer's MLA attention, a layer's MoE FFN and the
   whole step, beside its wall;
10. the windowed decoders: H2O-Danube-1.8B (24 layers, d_model 2560,
    32/8 heads of 80, sliding window 4096, vocab 32000) and
    RecurrentGemma-2B (26 layers: 8 units of two RG-LRU and one local
    attention layer and 2 tail RG-LRU layers, 10 heads of 256 on one kv
    head, window 2048, logit softcap 30, vocab 256000) in bf16 at every
    published width and full depth, random weights from seed 0, at model
    level (``generate``; ``NodeEngine`` serves neither, as the JAX engine
    does not): 8 prompts of 512 greedy (64 tokens), the model card's
    sampling twice with top-5 logprobs (identical streams required), then
    one prompt longer than the window (6144 and 3072 tokens) decoded 32
    steps past it; every flash launch at the model's head dim on wgmma,
    ``fused_sampling`` on the sampled runs, no other kernel (ring decode
    is PyTorch); it logs the weights, prefill and decode times, peak
    memory, launches by route and the phase's seconds, and a B8 decode
    step's device time split by the profiler, beside its wall;
11. the encoder-decoder and the vision decoder: Whisper-base (6 encoder
    and 6 decoder layers, d_model 512, 8 heads of 64 on 8, LayerNorm,
    sinusoid positions, 1536 stub frames, vocab 51865) and Pixtral-12B
    (40 layers, d_model 5120, 32/8 heads of 128, 1024 stub patches before
    the prompt, vocab 131072; 24.5 GB) in bf16 at every published width
    and full depth, random weights from seed 0, stub frames and patches
    from a seed at the reference frontend stub's scale, at model level
    (``generate``; ``NodeEngine`` serves neither, as the JAX engine does
    not): 8 rows with prompts of 32 / 512 greedy (64 tokens), then
    explicit sampling with a seed a row and top-5 logprobs twice
    (identical streams required); every flash launch at the model's head
    dim on wgmma (Whisper: 12 of its 18 a prefill non-causal),
    ``paged_attention`` on every decode step (Whisper twice a layer at
    G = 1, one over the 1536-key cross cache; Pixtral once a layer at
    G = 4), ``fused_sampling`` on the sampled runs only, no MoE or scan
    kernel; it logs the weights, prefill and decode times, peak memory,
    launches by route and the phase's seconds, and a B8 decode step's
    device time split by the profiler, beside its wall;
12. training: SmolLM-360M (32 layers, d_model 960, 15/5 heads of 64,
    vocab 49152; 409M parameters) in bf16 at every published width and
    full depth, random weights from seed 0, 8 steps of
    ``launch/steps.py::train_step`` on 16 x 4096 tokens of
    ``SyntheticLMStream`` (seed 0) in 2 microbatches, remat on, AdamW lr
    1e-3: the loss must be finite and fall; every step must launch the
    flash forward 128 times (2 x 32 layers x 2 microbatches: remat runs
    each layer twice), all on wgmma, the backward wrapper 64 times, all on
    its bf16 route, and no other kernel; it logs s/step, tokens/s, peak
    memory, a step's device time by kernel class beside its wall, the
    model FLOPs' share of the bf16 dense peak (``smollm_360m_train_mfu``),
    and whether a second run from seed 0 repeats the first two losses'
    bits.  Then H2O-Danube-1.8B (24 layers, d_model 2560, 32/8 heads of
    80, window 4096, vocab 32000) at every published width and full depth
    the same way: 5 steps of 4 x 8192 tokens in 2 microbatches, so that
    the window binds (the third step's loss rises past the first's at lr
    1e-3, in bf16 and fp32 alike, and the fifth falls below it); no plain
    version may run on either leg;
13. training the MoE family: Qwen3-30B-A3B (d_model 2048, 32/4 heads of
    128, 128 experts top-8 of expert d_ff 768, vocab 151936) in bf16 at
    every published width, its depth cut 48 -> 4 (3.11 B parameters,
    ~49.8 GB of weights, fp32 masters and moments and bf16 gradients),
    random weights from seed 0, 4 steps of 4 x 4096 tokens in one
    microbatch, remat on, AdamW lr 1e-3: the loss must be finite, fall
    and hold the aux (the first step's loss is its cross-entropy plus
    0.01 x the layers' aux over their count), the recompute must route as
    the forward did, bit for bit; each step must launch the flash forward
    twice a layer and the backward once, the grouped GEMM 9 times a layer
    (forward, recompute, dX), all on wgmma, its weight gradient 3 times a
    layer, all on wgmma, and no plain version; it logs s/step, tokens/s,
    peak memory,
    the capacity drops, a step's device time by kernel class beside its
    wall and the active-parameter MFU (``qwen3_moe_train_mfu``);
14. training the SSM: Mamba2-370M (48 layers, d_model 1024, d_inner 2048,
    32 heads of 64, state 128, vocab 50280; 420M parameters) in bf16 at
    every published width and full depth, random weights from seed 0, 5
    steps of 16 x 4096 tokens in 2 microbatches (phase 12's SmolLM
    shape), remat on, AdamW lr 1e-3: the loss must be finite and fall,
    and a rerun from seed 0 must repeat the first step's loss bit for
    bit; every step must launch the scan 192 times (2 x 48 layers x 2
    microbatches) and its backward 96 times, no other kernel and no plain
    version; it logs s/step, tokens/s, peak memory, a step's device time
    by kernel class beside its wall and the MFU (``mamba2_370m_train_mfu``,
    the SSD's own products counted: ``_model_flops``).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: dict(atol=2e-2, rtol=2e-2),
       torch.float32: dict(atol=1e-4, rtol=1e-4)}
# the flash forward's log-sum-exp: fp32 statistics from the same inputs
# (the bf16 route sums exp2 of fp32 scores from bf16 products)
LSE_TOL = {torch.bfloat16: dict(atol=1e-3, rtol=1e-4),
           torch.float32: dict(atol=1e-4, rtol=1e-4)}
REPLACES = {
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:78",
    # the VJP of the reference's flash attention (pure JAX: the TPU kernel
    # has no backward of its own)
    "flash_attention_bwd": "src/repro/models/flash.py:87",
    "paged_attention":
        "src/repro/kernels/paged_attention/paged_attention.py:73",
    "fused_sampling":
        "src/repro/kernels/fused_sampling/fused_sampling.py:273",
    "moe_gemm": "src/repro/kernels/moe_gemm/moe_gemm.py:31",
    # the expert einsum whose derivative XLA takes in the reference (no TPU
    # kernel computes the weight gradient)
    "moe_gemm_wgrad": "src/repro/models/moe.py:70",
    "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:35",
    # the VJP of the reference's lax.scan between chunks (no TPU kernel
    # computes it)
    "ssd_scan_bwd": "src/repro/models/ssm.py:98",
}
# the kernels each serving path must launch; the others it must not
DENSE_GREEDY = ("flash_attention", "paged_attention")
DENSE_SAMPLED = DENSE_GREEDY + ("fused_sampling",)
MOE_GREEDY = DENSE_GREEDY + ("moe_gemm",)
MOE_SAMPLED = MOE_GREEDY + ("fused_sampling",)
SSM_GREEDY = ("ssd_scan",)
SSM_SAMPLED = SSM_GREEDY + ("fused_sampling",)
MLA_GREEDY = ("flash_attention", "moe_gemm")
MLA_SAMPLED = MLA_GREEDY + ("fused_sampling",)
WINDOW_GREEDY = ("flash_attention",)
WINDOW_SAMPLED = WINDOW_GREEDY + ("fused_sampling",)
# MLA's prefill head dims at DeepSeek-R1's widths: q/k 128 + 64, v 128
MLA_HEADS = (192, 128)
# the windowed decoders' prefill attention, timed in phase 3:
# tag -> (B, S, H, Hkv, D, window, softcap)
WINDOWED_FLASH = {
    "danube B8 S512 H32/8 D80 w4096": (8, 512, 32, 8, 80, 4096, 0.0),
    "danube B1 S6144 H32/8 D80 w4096": (1, 6144, 32, 8, 80, 4096, 0.0),
    "rgemma B8 S512 H10/1 D256 w2048 cap30": (8, 512, 10, 1, 256, 2048,
                                              30.0),
    "rgemma B1 S3072 H10/1 D256 w2048 cap30": (1, 3072, 10, 1, 256, 2048,
                                               30.0),
}
# the served encoder-decoder's and vision decoder's prefill attention,
# timed in phase 3: tag -> (B, Sq, Skv, H, Hkv, D, causal)
ENCODER_FLASH = "whisper enc B8 S1536 H8/8 D64"
SERVED_FLASH = {
    ENCODER_FLASH: (8, 1536, 1536, 8, 8, 64, False),
    "whisper dec B8 S32 H8/8 D64": (8, 32, 32, 8, 8, 64, True),
    "whisper cross B8 Sq32 Skv1536 H8/8 D64": (8, 32, 1536, 8, 8, 64,
                                               False),
    "pixtral B8 S1536 H32/8 D128": (8, 1536, 1536, 32, 8, 128, True),
}
# ... and their decode attention: tag -> (B, max_len, H, Hkv, D, lengths);
# Whisper's self-attention cache (a 32-token prompt and 64 tokens) and its
# cross-attention cache (1536 frames), both MHA (G = 1); Pixtral's cache
# after 1024 patches, 512 tokens and 64 more (G = 4)
CROSS_PAGED = "whisper cross"
SERVED_PAGED = {
    "whisper self": (8, 96, 8, 8, 64, [96] * 8),
    CROSS_PAGED: (8, 1536, 8, 8, 64, [1536] * 8),
    "pixtral": (8, 1600, 32, 8, 128, [1600] * 8),
}
# Their queries (and those of the other windowed, softcapped rows of phase
# 3) are scaled so that q.k / sqrt(D) has a std of SPREAD: the
# softmax then rests on a few keys, so a key moved across the window's
# edge moves an output by a whole v row, and the softcap of 30 bites (at
# scores of std 1, tanh(s / 30) * 30 ~ s); their bf16 outputs are held to
# atol min(2e-2, 0.05 * rms(plain)), rtol 2e-2
SPREAD = 15.0


def log(msg: str) -> None:
    print(msg, flush=True)


def check_launches(path: str, used, expected) -> None:
    """The path launched each of its kernels and none of the others."""
    for name, n in used.items():
        if (n > 0) != (name in expected):
            want = "> 0" if name in expected else "0"
            raise AssertionError(f"{path}: {name} launched {n} times "
                                 f"(expected {want})")


def reset_counts() -> None:
    """Every kernel's launch count, and the counts by route of the kernels
    that have routes, to 0."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention_bwd import ops as bwd_ops
    from repro_torch.kernels.moe_gemm import ops as moe_ops
    from repro_torch.kernels.moe_gemm_wgrad import ops as wgrad_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    kernels.reset_launches()
    ops.reset_routes()
    bwd_ops.reset_routes()
    paged_ops.reset_routes()
    moe_ops.reset_routes()
    wgrad_ops.reset_routes()


def check_routes(path: str, used) -> None:
    """Every attention launch of a bf16 path took the tensor-core route
    (wgmma for flash, mma for paged), and every grouped-GEMM launch a
    tensor-core one (wgmma or mma), none the fp32 simt route."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.moe_gemm import ops as moe_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    for name, mod, tc in (("flash_attention", ops, ("wgmma",)),
                          ("paged_attention", paged_ops, ("mma",)),
                          ("moe_gemm", moe_ops, ("wgmma", "mma"))):
        routes = dict(mod.ROUTE_LAUNCHES)
        if routes["simt"] or sum(routes[r] for r in tc) != used[name]:
            raise AssertionError(f"{path}: {name} launches by route {routes} "
                                 f"of {used[name]} (expected all on {tc})")
    log(f"  {path}: {used['flash_attention']} flash launches, all on the "
        f"wgmma route; {used['paged_attention']} paged launches, all on "
        f"the mma route; moe_gemm by route {dict(moe_ops.ROUTE_LAUNCHES)}")


class _GemmRoutes:
    """Records the block_t and the route of every grouped-GEMM launch while
    a path runs (``grouped_ffn`` calls ``ops.grouped_gemm``, wrapped here
    until ``restore``)."""

    def __init__(self):
        from repro_torch.kernels.moe_gemm import ops
        self.ops, self.orig, self.seen = ops, ops.grouped_gemm, []

        def record(x, w, block_expert, *, block_t=128):
            before = dict(ops.ROUTE_LAUNCHES)
            out = self.orig(x, w, block_expert, block_t=block_t)
            taken = [r for r, n in ops.ROUTE_LAUNCHES.items()
                     if n != before[r]]
            self.seen.append((block_t, taken))
            return out
        ops.grouped_gemm = record

    def restore(self):
        self.ops.grouped_gemm = self.orig

    def check(self, path: str, prefill: bool) -> None:
        """Every launch at block_t >= 64 (a prefill batch's) took wgmma and
        every other one (decode's block_t 16) mma; ``prefill``: the path
        had at least one launch at block_t >= 64."""
        bad = [(bt, r) for bt, r in self.seen
               if r != ["wgmma" if bt >= 64 else "mma"]]
        wide = sum(bt >= 64 for bt, _ in self.seen)
        if bad or (prefill and not wide):
            raise AssertionError(f"{path}: grouped-GEMM launches (block_t, "
                                 f"route) off the rule: {bad[:5]}; "
                                 f"{wide} of {len(self.seen)} at "
                                 f"block_t >= 64")
        log(f"  {path}: {wide} grouped-GEMM launches at block_t >= 64, all "
            f"on wgmma; {len(self.seen) - wide} at block_t < 64, all on mma")


class _FlashShapes:
    """Records the (q/k, v) head dims and the route of every flash launch
    while a path runs (the wrapper's ``ops.launch``, wrapped here until
    ``restore``)."""

    def __init__(self):
        from repro_torch.kernels.flash_attention import ops
        self.ops, self.orig, self.seen = ops, ops.launch, []
        self.non_causal = 0

        def record(lib, q, k, v, *a, **kw):
            self.seen.append((q.shape[3], v.shape[3], ops.route(q.dtype)))
            self.non_causal += not kw["causal"]
            return self.orig(lib, q, k, v, *a, **kw)
        ops.launch = record

    def restore(self):
        self.ops.launch = self.orig

    def check(self, path: str, dims, route: str) -> int:
        """Every launch was at head dims ``dims`` on ``route``, and there
        was at least one; returns their count."""
        bad = [s for s in self.seen if s != (*dims, route)]
        if bad or not self.seen:
            raise AssertionError(f"{path}: flash launches (q/k, v, route) "
                                 f"off {(*dims, route)}: {bad[:5]} of "
                                 f"{len(self.seen)}")
        log(f"  {path}: {len(self.seen)} flash launches, all at q/k "
            f"{dims[0]}, v {dims[1]} on the {route} route")
        return len(self.seen)


class _PagedShapes:
    """Records the (group, head dim, keys of the table, route) of every
    paged-attention launch while a path runs (the wrapper's
    ``ops.launch``, wrapped here until ``restore``)."""

    def __init__(self):
        from repro_torch.kernels.paged_attention import ops
        self.ops, self.orig, self.seen = ops, ops.launch, []

        def record(lib, q, k_pool, v_pool, table, lengths):
            self.seen.append((q.shape[1] // k_pool.shape[2], q.shape[2],
                              table.shape[1] * k_pool.shape[1],
                              ops.route(q.dtype)))
            return self.orig(lib, q, k_pool, v_pool, table, lengths)
        ops.launch = record

    def restore(self):
        self.ops.launch = self.orig


# ---------------------------------------------------------------- timing
def _sdpa(q, k, v, **kw):
    """One ``F.scaled_dot_product_attention`` call on q (B,H,Sq,D), k/v
    (B,Hkv,Skv,D), GQA included: the library yardstick."""
    return lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                  **kw)


# ---------------------------------------------------------------- phase 3
def _rand(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _scaled_tol(want, dtype):
    """The windowed rows' tolerance: bf16's atol tied to the output's
    scale, never looser than ``TOL``."""
    if dtype != torch.bfloat16:
        return TOL[dtype]
    rms = want.float().pow(2).mean().sqrt().item()
    return dict(TOL[dtype], atol=min(TOL[dtype]["atol"], 0.05 * rms))


def _check(name, got, want, dtype, tol=None):
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), **(tol or TOL[dtype]))
    log(f"  {name}: max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
    if not ok or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err})")
    return err


def _flash_bound(q, k, v, qp, kp, window=0, causal=True):
    """(bound ms, bound_by, GFLOP, MB) of one prefill attention call: each
    input read once and the output (q's shape at v's head dim) written
    once, at the card's memory rate, against the operations of the (q,
    key) pairs the mask lets through (causal and windowed, or every pair
    when non-causal; every batch row has the same positions here: 2 * Dqk
    for the score, 2 * Dv for P V) at the card's peak rate for the
    storage type."""
    B, _, H, D = q.shape
    Dv = v.shape[3]
    ok = kp[0][None, :] <= qp[0][:, None] if causal else \
        torch.ones((qp.shape[1], kp.shape[1]), dtype=torch.bool,
                   device=q.device)
    if window > 0:
        ok &= kp[0][None, :] > qp[0][:, None] - window
    pairs = int(ok.sum().item())
    flops = 2.0 * (D + Dv) * pairs * B * H
    nbytes = (q.numel() + q.numel() // D * Dv + k.numel() + v.numel()) \
        * q.element_size() + (qp.numel() + kp.numel()) * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[q.dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes", flops / 1e9,
            nbytes / 1e6)


def _refuses_wrong(name, want, wrong, what, tol):
    """The row's check must see a kernel that computes ``wrong`` (a plain
    version wronged on purpose) in place of ``want``: some output must
    fall outside the row's tolerance ``tol``."""
    off = ~torch.isclose(wrong.float(), want.float(), **tol)
    log(f"  {name}: the check refuses the {what}: {int(off.sum())} of "
        f"{off.numel()} outputs out of tolerance, max abs err "
        f"{(wrong.float() - want.float()).abs().max().item():.3e} (atol "
        f"{tol['atol']:.3e})")
    if not off.any():
        raise AssertionError(f"{name}: the check cannot see the {what}")


def _refuses_wrong_windows(name, q, k, v, qp, kp, kw, want, tol):
    """The windowed rows' check must see a kernel whose window edge is off
    by one 64-key tile (where the window binds) or that drops the softcap:
    the plain version so wronged must fail the row's tolerance."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    wrongs = {}
    if 0 < kw["window"] < k.shape[1]:
        wrongs["window one tile wider"] = dict(kw, window=kw["window"] + 64)
    if kw["softcap"]:
        wrongs["softcap dropped"] = dict(kw, softcap=0.0)
    for what, wkw in wrongs.items():
        _refuses_wrong(name, want, flash_attention_plain(q, k, v, qp, kp,
                                                         **wkw), what, tol)


def check_flash(dev, timer):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_lse, flash_attention_plain)
    from repro_torch.models import flash
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    ops.reset_routes()
    calls = {"wgmma": 0, "simt": 0}

    bad = []      # every row is checked before phase 3 fails

    def case(tag, dtype, B, Sq, Skv, H, Hkv, D, causal=True, window=0,
             softcap=0.0, q0=0, Dv=None, spread=False):
        q = _rand(gen, (B, Sq, H, D), dtype, dev)
        if spread:
            q = (q.float() * SPREAD).to(dtype)
        k = _rand(gen, (B, Skv, Hkv, D), dtype, dev)
        v = _rand(gen, (B, Skv, Hkv, Dv or D), dtype, dev)
        qp = (torch.arange(Sq, dtype=torch.int32, device=dev) + q0)[None] \
            .expand(B, Sq).contiguous()
        kp = torch.arange(Skv, dtype=torch.int32, device=dev)[None] \
            .expand(B, Skv).contiguous()
        kw = dict(causal=causal, window=window, softcap=softcap)
        got = flash_attention(q, k, v, qp, kp, **kw)
        # the training launch: the same out, bit for bit, and each row's
        # log-sum-exp (fp32, natural-log units) against the plain one's
        got2, lse = flash_attention_lse(q, k, v, qp, kp, **kw)
        calls[ops.route(dtype)] += 2
        torch.cuda.synchronize()
        want, want_lse = flash.flash_attention(q, k, v, qp, kp, **kw,
                                               return_lse=True)
        name = f"flash_attention {tag} {str(dtype)[6:]}"
        tol = _scaled_tol(want, dtype) if spread else None
        lse_err = (lse - want_lse).abs().max().item()
        try:
            err = _check(name, got, want, dtype, tol)
            if not torch.equal(got, got2) or not torch.allclose(
                    lse, want_lse, **LSE_TOL[dtype]):
                raise AssertionError(f"{name}: lse max abs err {lse_err}, "
                                     f"out with lse equal: "
                                     f"{torch.equal(got, got2)}")
            log(f"  {name} lse: max_abs_err={lse_err:.3e} ok; out with lse "
                f"equal bits")
        except AssertionError as e:
            log(f"  {e}")
            bad.append(name)
            err = None
        if spread and dtype == torch.bfloat16:
            _refuses_wrong_windows(name, q, k, v, qp, kp, kw, want, tol)
        return err, (q, k, v, qp, kp, kw)

    # Llama-3.2-1B prefill: 4 prompts of 512 (timed below), and a batch of
    # 8 prompts padded to 256 (the engine's bucket for an MoE batch; a
    # dense engine forwards each prompt alone, phase 8)
    main = {}
    for dtype in (torch.bfloat16, torch.float32):
        main[dtype] = case("B4 S512 H32/8 D64 causal", dtype, 4, 512, 512,
                           32, 8, 64)
        case("offset q Sq64 Skv512", dtype, 2, 64, 512, 32, 8, 64, q0=448)
    timed = {"B4 S512 H32/8 D64": main[torch.bfloat16],
             "fp32 B4 S512 H32/8 D64": main[torch.float32]}
    timed["B8 S256 H32/8 D64"] = case("B8 S256 H32/8 D64 causal",
                                      torch.bfloat16, 8, 256, 256, 32, 8, 64)
    case("window100 softcap30 S256", torch.float32, 1, 256, 256, 8, 2, 64,
         window=100, softcap=30.0, spread=True)
    case("non-causal Skv96 (true-length mask)", torch.float32, 1, 96, 96, 4,
         2, 64, causal=False)
    case("G3 D32 S40", torch.float32, 1, 40, 40, 6, 2, 32)
    case("D128 S128", torch.float32, 1, 128, 128, 4, 4, 128)
    # the tensor-core route's edges: ragged tiles, more K/V tiles than
    # ring stages, offset q blocks, window + softcap, the true-length
    # mask, D32 with a group of 3, D128 at Qwen3-30B-A3B's heads
    case("S200 (ragged tiles)", torch.bfloat16, 2, 200, 200, 32, 8, 64)
    timed["B1 S2048 H32/8 D64"] = case("B1 S2048 H32/8 D64 causal",
                                       torch.bfloat16, 1, 2048, 2048, 32, 8,
                                       64)
    case("offset q Sq1 Skv512", torch.bfloat16, 2, 1, 512, 32, 8, 64,
         q0=511)
    case("window100 softcap30 S256", torch.bfloat16, 1, 256, 256, 8, 2, 64,
         window=100, softcap=30.0, spread=True)
    case("non-causal Skv96 (true-length mask)", torch.bfloat16, 1, 96, 96,
         4, 2, 64, causal=False)
    case("G3 D32 S40", torch.bfloat16, 1, 40, 40, 6, 2, 32)
    timed["B8 S256 H32/4 D128"] = case("B8 S256 H32/4 D128 causal",
                                       torch.bfloat16, 8, 256, 256, 32, 4,
                                       128)
    # DeepSeek-R1's MLA prefill: 128 heads, q/k 192 (128 + RoPE 64) against
    # v 128, on both routes; a ragged one and an offset q block
    dqk, dv = MLA_HEADS
    timed["B2 S1024 H128 D192/128"] = case(
        "MLA B2 S1024 H128 D192/128 causal", torch.bfloat16, 2, 1024, 1024,
        128, 128, dqk, Dv=dv)
    for dtype in (torch.bfloat16, torch.float32):
        case("MLA S200 H8 D192/128 (ragged tiles)", dtype, 2, 200, 200, 8,
             8, dqk, Dv=dv)
        case("MLA offset q Sq40 Skv300 D192/128", dtype, 1, 40, 300, 8, 8,
             dqk, q0=260, Dv=dv)
    # the windowed decoders' prefill at their widths (phase 10's shapes),
    # on both routes: H2O-Danube-1.8B at (80, 80), 32 q heads on 8 kv
    # heads, window 4096 (binding only past it); RecurrentGemma-2B at
    # (256, 256), 10 q heads on one kv head, window 2048, softcap 30
    for tag, (B, S, H, Hkv, D, w, cap) in WINDOWED_FLASH.items():
        for dtype in (torch.bfloat16, torch.float32):
            got = case(tag, dtype, B, S, S, H, Hkv, D, window=w, softcap=cap,
                       spread=True)
            if dtype == torch.bfloat16:
                timed[tag] = got
    # the served encoder-decoder and vision decoder at their widths (phase
    # 11's shapes), on both routes: Whisper-base's encoder self-attention
    # over 1536 frames and its cross-attention of 32 decoder positions on
    # them, both non-causal, and its decoder's causal self-attention over
    # a 32-token prompt, 8 heads of 64 (MHA); Pixtral-12B's causal prefill
    # of 1024 patches + 512 tokens, 32/8 heads of 128
    for tag, (B, Sq, Skv, H, Hkv, D, causal) in SERVED_FLASH.items():
        for dtype in (torch.bfloat16, torch.float32):
            got = case(f"{tag} {'causal' if causal else 'non-causal'}",
                       dtype, B, Sq, Skv, H, Hkv, D, causal=causal)
            if dtype == torch.bfloat16:
                timed[tag] = got
    # the check must see a kernel that masks the encoder causally
    _, (q, k, v, qp, kp, kw) = timed[ENCODER_FLASH]
    want = flash_attention_plain(q, k, v, qp, kp, **kw)
    _refuses_wrong(f"flash_attention {ENCODER_FLASH}", want,
                   flash_attention_plain(q, k, v, qp, kp, causal=True),
                   "mask made causal", TOL[torch.bfloat16])
    if bad:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version at {bad}")
    if ops.ROUTE_LAUNCHES != calls:
        raise AssertionError(f"flash_attention launches by route "
                             f"{ops.ROUTE_LAUNCHES}, expected {calls}")
    log(f"  flash_attention launches by route: {calls} (bf16 -> wgmma, "
        f"fp32 -> simt)")

    err, (q, k, v, qp, kp, kw) = main[torch.bfloat16]
    again = [flash_attention(q, k, v, qp, kp, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    if not torch.equal(again[0], again[1]):
        raise AssertionError("flash_attention bf16: two launches gave "
                             "other bits")
    log("  flash_attention bf16 B4 S512: two launches, equal bits")

    from repro_torch.launch.profile import KERNEL_ENTRIES
    rows = {}
    for shape, (e, (q, k, v, qp, kp, kw)) in timed.items():
        bound_ms, bound_by, gflop, mb = _flash_bound(q, k, v, qp, kp,
                                                     kw["window"],
                                                     kw["causal"])
        ms = timer(lambda: flash_attention(q, k, v, qp, kp, **kw))
        alone_ms = timer.kernel_ms(lambda: flash_attention(q, k, v, qp, kp,
                                                           **kw),
                                   KERNEL_ENTRIES["flash_attention"])
        plain_ms = timer(lambda: flash_attention_plain(q, k, v, qp, kp,
                                                       **kw), iters=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        Sq, Skv = q.shape[1], k.shape[1]
        if kw["window"] and kw["window"] < Skv:     # a windowed causal mask
            ok = kp[0][None, :] <= qp[0][:, None]
            ok &= kp[0][None, :] > qp[0][:, None] - kw["window"]
            sdpa_kw = dict(attn_mask=ok)
        else:
            sdpa_kw = dict(is_causal=kw["causal"])
        # SDPA has no softcap ("—"), and may refuse a v narrower than q/k
        # on this card's torch
        library_ms = library_host_us = None
        if kw["softcap"]:
            log(f"  sdpa: no softcap, no library yardstick for {shape}")
        else:
            try:
                library_ms = timer(_sdpa(qt, kt, vt, **sdpa_kw))
                library_host_us = timer.host_us(_sdpa(qt, kt, vt, **sdpa_kw))
            except RuntimeError as e:
                log(f"  sdpa refuses {shape}: {str(e).splitlines()[0]}")
        # the host's side of one call (the wrapper's checks, four tensor
        # maps and a ctypes call; SDPA's dispatch), beside the card's
        host_us = timer.host_us(lambda: flash_attention(q, k, v, qp, kp,
                                                        **kw))
        rows[shape] = dict(max_abs_err=e, ms=ms, kernel_alone_ms=alone_ms,
                           plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=library_ms,
                           host_us=host_us, library_host_us=library_host_us)
        mask = "causal" if kw["causal"] else "non-causal"
        log(f"  flash_attention {str(q.dtype)[6:]} {shape} {mask}: "
            f"kernel {ms:.4f} ms "
            f"({alone_ms:.4f} ms alone in the profiler's trace), plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}; {gflop:.2f} GFLOP, {mb:.1f} "
            f"MB); host {host_us:.1f} us a call, sdpa's "
            f"{library_host_us} us")
    print(json.dumps({"flash_attention_shapes": rows}), flush=True)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces=REPLACES["flash_attention"],
                shape="B4 S512 H32/8 D64 causal bf16",
                **rows["B4 S512 H32/8 D64"])


# the training shapes of the flash backward, timed in phase 3:
# tag -> (B, S, H, Hkv, D, window, softcap)
TRAIN_FLASH = {
    "smollm B8 S4096 H15/5 D64": (8, 4096, 15, 5, 64, 0, 0.0),
    "llama B4 S4096 H32/8 D64": (4, 4096, 32, 8, 64, 0, 0.0),
    "B4 S2048 H32/4 D128": (4, 2048, 32, 4, 128, 0, 0.0),
    # H2O-Danube-1.8B's training shape (phase 12's microbatch of 2 rows,
    # twice): the window binds past 4096 of the 8192 positions
    "danube B4 S8192 H32/8 D80 w4096": (4, 8192, 32, 8, 80, 4096, 0.0),
    # softcapped rows (RecurrentGemma's cap of 30) at D 64 and 128
    "B4 S2048 H32/8 D64 cap30": (4, 2048, 32, 8, 64, 0, 30.0),
    "B4 S2048 H32/4 D128 cap30": (4, 2048, 32, 4, 128, 0, 30.0),
}
DANUBE_BWD = "danube B4 S8192 H32/8 D80 w4096"


def _grad_tol(wants, dtype):
    """The backward's tolerance, tied to the scale of its three gradients
    (one may be ~0 throughout: at S = 1, dq and dk are 0 in exact
    arithmetic): fp32 atol 1e-4 x the largest |gradient|, rtol 1e-4
    (summation order); bf16 ``_scaled_tol``'s atol over all three, rtol
    2e-2 (one bf16 rounding of each gradient)."""
    if dtype == torch.float32:
        scale = max(w.float().abs().max().item() for w in wants)
        return dict(atol=1e-4 * scale, rtol=1e-4)
    rms = math.sqrt(sum(w.float().pow(2).sum().item() for w in wants)
                    / sum(w.numel() for w in wants))
    return dict(TOL[dtype], atol=min(TOL[dtype]["atol"], 0.05 * rms))


def _pairs(Sq, Skv, causal, window, q0=0):
    """(q, key) pairs a row's mask lets through, positions q0.. against
    0..: causal and windowed, or every pair."""
    qp = torch.arange(Sq, dtype=torch.int64) + q0
    hi = torch.clamp(qp + 1, max=Skv) if causal else torch.full_like(qp, Skv)
    lo = torch.clamp(qp - window + 1, min=0) if window > 0 else \
        torch.zeros_like(qp)
    return int(torch.clamp(hi - lo, min=0).sum())


def _flash_bwd_bound(q, k, causal=True, window=0):
    """(bound ms, bound_by, GFLOP, MB) of one backward call: q, k, v, out,
    dout and lse read once, dq, dk, dv written once, at the card's memory
    rate, against 2.5 times the forward's operations on the pairs the mask
    lets through (causal and windowed; every batch row has the same
    positions here) at its peak for the storage type."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    pairs = _pairs(Sq, Skv, causal, window, Skv - Sq if causal else 0)
    flops = 2.5 * 2.0 * (D + D) * pairs * B * H
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
        + B * Sq * H * 4 + (B * Sq + B * Skv) * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[q.dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes", flops / 1e9,
            nbytes / 1e6)


def _sdpa_bwd_ms(timer, q, k, v, dout, kw):
    """SDPA's backward (``autograd.grad`` of one call) on the same inputs,
    timed alone: causal through ``is_causal``; a window through a boolean
    mask on the memory-efficient backend.  None where SDPA cannot compute
    the function (a softcap) or refuses the call."""
    if kw["softcap"]:
        return None
    from torch.nn.attention import SDPBackend, sdpa_kernel
    g = dout.transpose(1, 2)
    if kw["window"] <= 0:
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        try:
            o = F.scaled_dot_product_attention(qt, kt, vt,
                                               is_causal=kw["causal"],
                                               enable_gqa=True)
            return timer(lambda: torch.autograd.grad(
                o, (qt, kt, vt), g, retain_graph=True), iters=10)
        except RuntimeError as exc:
            log(f"  sdpa backward refuses B{q.shape[0]} S{q.shape[1]} "
                f"D{q.shape[3]} {kw}: {str(exc).splitlines()[0]}")
            return None
    S = q.shape[1]
    i = torch.arange(S, device=q.device)
    mask = (i[None, :] <= i[:, None]) & \
        (i[None, :] > i[:, None] - kw["window"])
    G = q.shape[2] // k.shape[2]
    # GQA through enable_gqa, else with K and V repeated to the q heads
    for gqa in (True, False):
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k if gqa else k.repeat_interleave(G, 2),
                                v if gqa else v.repeat_interleave(G, 2)))
        try:
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                o = F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=gqa)
                ms = timer(lambda: torch.autograd.grad(
                    o, (qt, kt, vt), g, retain_graph=True), iters=5)
            how = "enable_gqa" if gqa else "K/V repeated to the q heads"
            log(f"  sdpa backward with the window as a boolean mask "
                f"(memory-efficient backend, {how}): {ms:.4f} ms")
            return ms
        except RuntimeError as exc:
            log(f"  sdpa backward (mask, enable_gqa={gqa}) refuses "
                f"B{q.shape[0]} S{S} D{q.shape[3]}: "
                f"{str(exc).splitlines()[0]}")
    return None


def check_flash_bwd(dev, timer):
    """The flash backward's kernel against its plain version on the same
    out and lse, in bf16 at the training shapes (windowed and softcapped
    ones with spread scores) and in both types at the edges; equal bits
    over two launches at D 64, 80 (windowed) and 128; every call on the
    route of its type (bf16 on wgmma); timed at the training shapes
    through the wrapper, alone (the sum of its three kernels' medians in
    the profiler's trace), its plain version and SDPA's backward
    (``autograd.grad`` of one ``scaled_dot_product_attention``, timed
    alone; with a boolean mask for the window, none under a softcap)
    beside the bound."""
    from repro_torch.kernels.flash_attention_bwd import ops
    from repro_torch.kernels.flash_attention_bwd.ops import (
        flash_attention_bwd, flash_attention_bwd_plain)
    from repro_torch.launch.profile import KERNEL_ENTRIES
    from repro_torch.models import flash
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    ops.reset_routes()
    calls = {"simt": 0, "wgmma": 0}
    bad = []

    def case(tag, dtype, B, Sq, Skv, H, Hkv, D, causal=True, q0=0,
             window=0, softcap=0.0, spread=False):
        q = _rand(gen, (B, Sq, H, D), dtype, dev)
        if spread:
            q = (q.float() * SPREAD).to(dtype)
        k = _rand(gen, (B, Skv, Hkv, D), dtype, dev)
        v = _rand(gen, (B, Skv, Hkv, D), dtype, dev)
        qp = (torch.arange(Sq, dtype=torch.int32, device=dev) + q0)[None] \
            .expand(B, Sq).contiguous()
        kp = torch.arange(Skv, dtype=torch.int32, device=dev)[None] \
            .expand(B, Skv).contiguous()
        kw = dict(causal=causal, window=window, softcap=softcap)
        out, lse = flash.flash_attention(q, k, v, qp, kp, return_lse=True,
                                         **kw)
        dout = _rand(gen, (B, Sq, H, D), dtype, dev)
        args = (q, k, v, qp, kp, out, lse, dout)
        got = flash_attention_bwd(*args, **kw)
        calls[ops.route(dtype)] += 1
        torch.cuda.synchronize()
        want = flash_attention_bwd_plain(*args, **kw)
        tol = _grad_tol(want, dtype)
        errs, ok = [], True
        for g, w, name in zip(got, want, ("dq", "dk", "dv")):
            errs.append((g.float() - w.float()).abs().max().item())
            if not torch.allclose(g.float(), w.float(), **tol) or \
                    not torch.isfinite(g.float()).all():
                bad.append(f"{tag} {str(dtype)[6:]} {name}")
                ok = False
        log(f"  flash_attention_bwd {tag} {str(dtype)[6:]}: max_abs_err "
            f"dq/dk/dv {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (atol "
            f"{tol['atol']:.3e}, rtol {tol['rtol']}) "
            f"{'ok' if ok else 'FAIL'}")
        if window and window < Skv and dtype == torch.bfloat16:
            # the check sees a backward whose window edge is a tile off
            wrong = flash_attention_bwd_plain(*args, **dict(
                kw, window=window + 64))
            if all(torch.allclose(x.float(), w.float(), **tol)
                   for x, w in zip(wrong, want)):
                raise AssertionError(f"flash_attention_bwd {tag}: the check "
                                     f"cannot see a window one tile wider")
            del wrong
        return max(errs), args, kw

    timed = {}
    for tag, (B, S, H, Hkv, D, w, cap) in TRAIN_FLASH.items():
        timed[tag] = case(f"{tag} causal", torch.bfloat16, B, S, S, H, Hkv,
                          D, window=w, softcap=cap, spread=bool(w or cap))
    B, S, H, Hkv, D = TRAIN_FLASH["smollm B8 S4096 H15/5 D64"][:5]
    case("smollm B8 S4096 H15/5 D64 causal", torch.float32, B, S, S, H,
         Hkv, D)
    for dtype in (torch.bfloat16, torch.float32):
        case("S100 (ragged tiles)", dtype, 2, 100, 100, 8, 2, 64)
        case("S1", dtype, 2, 1, 1, 8, 2, 64)
        case("G1 D32 S128", dtype, 1, 128, 128, 4, 4, 32)
        case("G3 D32 S96", dtype, 1, 96, 96, 6, 2, 32)
        case("non-causal Sq40 Skv130 D128", dtype, 2, 40, 130, 4, 2, 128,
             causal=False)
        case("offset q Sq64 Skv200", dtype, 1, 64, 200, 8, 2, 64, q0=136)
        # the window, the softcap and D 80 at the walk's edges
        case("D80 S300 G4 w96 cap30", dtype, 2, 300, 300, 8, 2, 80,
             window=96, softcap=30.0, spread=True)
        case("D80 S100 (ragged tiles) w48", dtype, 2, 100, 100, 8, 2, 80,
             window=48, spread=True)
        case("D80 offset q Sq64 Skv300 w100", dtype, 1, 64, 300, 8, 2, 80,
             q0=236, window=100, spread=True)
        case("D64 S1000 w128 (tiles past the window)", dtype, 1, 1000, 1000,
             4, 2, 64, window=128, spread=True)
        case("D128 S300 cap30", dtype, 2, 300, 300, 8, 2, 128, softcap=30.0,
             spread=True)
        case("D32 non-causal Sq40 Skv130 w24", dtype, 2, 40, 130, 4, 2, 32,
             causal=False, window=24, spread=True)
    if bad:
        raise AssertionError(f"flash_attention_bwd disagrees with its plain "
                             f"version at {bad}")
    if ops.ROUTE_LAUNCHES != calls:
        raise AssertionError(f"flash_attention_bwd calls by route "
                             f"{ops.ROUTE_LAUNCHES}, expected {calls}")
    log(f"  flash_attention_bwd calls by route: {calls} (each call: "
        f"preprocess, dK/dV, dQ; bf16 on wgmma, fp32 on the CUDA "
        f"cores)")
    for shape in ("smollm B8 S4096 H15/5 D64", "B4 S2048 H32/4 D128",
                  DANUBE_BWD):
        _, args, kw = timed[shape]
        again = [flash_attention_bwd(*args, **kw) for _ in range(2)]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*again)):
            raise AssertionError(f"flash_attention_bwd bf16 {shape}: two "
                                 f"launches gave other bits")
        log(f"  flash_attention_bwd bf16 {shape}: two launches, equal bits")
        del again

    rows = {}
    for shape, (e, args, kw) in timed.items():
        q, k, v, qp, kp, out, lse, dout = args
        bound_ms, bound_by, gflop, mb = _flash_bwd_bound(
            q, k, kw["causal"], kw["window"])
        ms = timer(lambda: flash_attention_bwd(*args, **kw), iters=10)
        alone_ms = sum(timer.kernel_ms(
            lambda: flash_attention_bwd(*args, **kw), (entry,), iters=10)
            for entry in KERNEL_ENTRIES["flash_attention_bwd"]
            if not entry.endswith("_simt"))     # bf16: wgmma
        plain_ms = timer(lambda: flash_attention_bwd_plain(*args, **kw),
                         iters=2, warmup=1)
        library_ms = _sdpa_bwd_ms(timer, q, k, v, dout, kw)
        rows[shape] = dict(max_abs_err=e, ms=ms, kernel_alone_ms=alone_ms,
                           plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=library_ms,
                           window=kw["window"], softcap=kw["softcap"])
        log(f"  flash_attention_bwd bf16 {shape} causal: kernel {ms:.4f} ms "
            f"({alone_ms:.4f} ms alone: its three kernels in the "
            f"profiler's trace), plain {plain_ms:.4f} ms, sdpa backward "
            f"{library_ms} ms, bound {bound_ms:.4f} ms ({bound_by}; "
            f"{gflop:.2f} GFLOP, {mb:.1f} MB)")
    print(json.dumps({"flash_attention_bwd_shapes": rows}), flush=True)
    del timed
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/csrc/flash_attention_bwd.cu",
                replaces=REPLACES["flash_attention_bwd"],
                shape="smollm B8 S4096 H15/5 D64 causal bf16",
                **rows["smollm B8 S4096 H15/5 D64"])


def check_paged(dev, timer):
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention, paged_attention_plain)
    from repro_torch.launch.flash_ab import PAGED_SHAPES, paged_label
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    ops.reset_routes()
    calls = {"mma": 0, "simt": 0}

    def dense_view(B, S, Hkv, D, dtype):
        """The engine's slot cache of one layer as a page-16 pool view."""
        page = math.gcd(S, 16)
        kc = _rand(gen, (B, S, Hkv, D), dtype, dev)
        vc = _rand(gen, (B, S, Hkv, D), dtype, dev)
        table = torch.arange(B * S // page, dtype=torch.int32,
                             device=dev).reshape(B, S // page)
        return (kc.view(-1, page, Hkv, D), vc.view(-1, page, Hkv, D), table,
                kc, vc)

    def shuffled(B, H, Hkv, D, page, mp, dtype):
        """A pool with 6 spare pages and a shuffled page table."""
        pool = B * mp + 6
        q = _rand(gen, (B, H, D), dtype, dev)
        kp = _rand(gen, (pool, page, Hkv, D), dtype, dev)
        vp = _rand(gen, (pool, page, Hkv, D), dtype, dev)
        table = torch.randperm(pool, generator=gen, device=dev)[:B * mp] \
            .reshape(B, mp).to(torch.int32)
        return q, kp, vp, table

    def case(tag, dtype, q, kp, vp, table, lengths):
        got = paged_attention(q, kp, vp, table, lengths)
        calls[ops.route(dtype)] += 1
        torch.cuda.synchronize()
        want = paged_attention_plain(q, kp, vp, table, lengths)
        for r in (lengths <= 0).nonzero().flatten().tolist():
            if got[r].any() or not torch.equal(got[r], want[r]):
                raise AssertionError(f"paged_attention {tag}: the length-0 "
                                     f"row {r} is not exact zeros")
        return _check(f"paged_attention {tag} {str(dtype)[6:]}", got, want,
                      dtype)

    # the four timed decode shapes (Llama-3.2-1B, Qwen3-30B-A3B monolithic
    # and at b_attn 4, the prefix-hit tail), in bf16; the first in fp32
    timed = {}
    for B, S, H, Hkv, D, lens in PAGED_SHAPES:
        label = paged_label(B, S, H, Hkv, D, lens)
        q = _rand(gen, (B, H, D), torch.bfloat16, dev)
        kp, vp, table, kc, vc = dense_view(B, S, Hkv, D, torch.bfloat16)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        err = case(label, torch.bfloat16, q, kp, vp, table, lengths)
        timed[label] = (err, (q, kp, vp, table, lengths), kc, vc)
    # the served encoder-decoder's and vision decoder's decode shapes, in
    # both types, bf16 timed: Whisper's self- and cross-attention at G = 1
    # (D 64: 8 outputs a cluster rank), Pixtral's at G = 4, D 128.  The
    # cross cache's last page holds, for row 0, a key along each head's
    # query (queries scaled by SPREAD), so a kernel that stops one page
    # short moves row 0's outputs by a whole v row
    for tag, (B, S, H, Hkv, D, lens) in SERVED_PAGED.items():
        label = f"{tag} {paged_label(B, S, H, Hkv, D, lens)}"
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            q = _rand(gen, (B, H, D), dtype, dev)
            kp, vp, table, kc, vc = dense_view(B, S, Hkv, D, dtype)
            if tag == CROSS_PAGED:
                q = (q.float() * SPREAD).to(dtype)
                kc[0, -1] = q[0].reshape(Hkv, H // Hkv, D)[:, 0]
            err = case(label, dtype, q, kp, vp, table, lengths)
            if dtype == torch.bfloat16:
                timed[label] = (err, (q, kp, vp, table, lengths), kc, vc)
                if tag == CROSS_PAGED:
                    short = (lengths - 16).contiguous()
                    _refuses_wrong(f"paged_attention {label}",
                                   paged_attention_plain(q, kp, vp, table,
                                                         lengths),
                                   paged_attention_plain(q, kp, vp, table,
                                                         short),
                                   "length one page short",
                                   TOL[torch.bfloat16])
    B, S, H, Hkv, D, lens = PAGED_SHAPES[0]
    q = _rand(gen, (B, H, D), torch.float32, dev)
    kp, vp, table, kc32, vc32 = dense_view(B, S, Hkv, D, torch.float32)
    main32 = (q, kp, vp, table, torch.tensor(lens, dtype=torch.int32,
                                             device=dev))
    err32 = case(paged_label(*PAGED_SHAPES[0]), torch.float32, *main32)
    # the contract's edges in both types, on shuffled tables of 40 pages
    # (10 tiles: ranks of one and two tiles): a free slot (length 0, exact
    # zeros), length 1, a length shorter than one rank's share (ranks left
    # empty), the full table and one past it; groups of 16 (D128), 4 (D64)
    # and qwen2's 7; then the shortest tail cache (B1 S8 G3 D32) and
    # finished slots one past a dense cache
    edge = [0, 1, 40, 640, 641, 333]
    for dtype in (torch.bfloat16, torch.float32):
        for H, Hkv, D in ((32, 2, 128), (32, 8, 64), (14, 2, 64)):
            args = shuffled(len(edge), H, Hkv, D, 16, 40, dtype)
            case(f"edges G{H // Hkv} D{D}", dtype, *args,
                 torch.tensor(edge, dtype=torch.int32, device=dev))
        q = _rand(gen, (1, 6, 32), dtype, dev)
        kp, vp, table, _, _ = dense_view(1, 8, 2, 32, dtype)
        case("tail B1 S8 G3 D32", dtype, q, kp, vp, table,
             torch.tensor([5], dtype=torch.int32, device=dev))
        q = _rand(gen, (2, 8, 128), dtype, dev)
        kp, vp, table, _, _ = dense_view(2, 64, 2, 128, dtype)
        case("length past cache D128", dtype, q, kp, vp, table,
             torch.tensor([65, 3], dtype=torch.int32, device=dev))
    if ops.ROUTE_LAUNCHES != calls:
        raise AssertionError(f"paged_attention launches by route "
                             f"{ops.ROUTE_LAUNCHES}, expected {calls}")
    log(f"  paged_attention launches by route: {calls} (bf16 -> mma, "
        f"fp32 -> simt)")
    for tag, args in (("bf16", timed[paged_label(*PAGED_SHAPES[0])][1]),
                      ("fp32", main32)):
        again = [paged_attention(*args) for _ in range(2)]
        torch.cuda.synchronize()
        if not torch.equal(again[0], again[1]):
            raise AssertionError(f"paged_attention {tag}: two launches gave "
                                 f"other bits")
        log(f"  paged_attention {tag} {paged_label(*PAGED_SHAPES[0])}: two "
            f"launches, equal bits")

    def bound(q, kp, table, lengths):
        """(bound ms, bound_by, MB): the cached K/V rows of the valid
        positions, the page-table entries they use, q, the lengths and the
        output, each once, at the card's memory rate, against the QK and
        PV products at its peak for the storage type."""
        page, Hkv, D = kp.shape[1:]
        tokens = int(lengths.clamp(0, table.shape[1] * page).sum().item())
        pages = int(((lengths.clamp(0, table.shape[1] * page) + page - 1)
                     // page).sum().item())
        nbytes = (2 * tokens * Hkv * D + 2 * q.numel()) * q.element_size() \
            + (lengths.numel() + pages) * 4
        flops = 4.0 * D * q.shape[1] * tokens
        t_ops, t_bytes = flops / PEAK_FLOPS[q.dtype], nbytes / PEAK_BYTES
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops > t_bytes else "bytes", nbytes / 1e6)

    from repro_torch.launch.profile import KERNEL_ENTRIES
    rows = {}
    first = paged_label(*PAGED_SHAPES[0])
    timed[f"fp32 {first}"] = (err32, main32, kc32, vc32)
    for label, (e, args, kc, vc) in timed.items():
        q, kp, vp, table, lengths = args
        bound_ms, bound_by, mb = bound(q, kp, table, lengths)
        ms = timer(lambda: paged_attention(*args))
        alone_ms = timer.kernel_ms(lambda: paged_attention(*args),
                                   KERNEL_ENTRIES["paged_attention"])
        plain_ms = timer(lambda: paged_attention_plain(*args), iters=5)
        mask = (torch.arange(kc.shape[1], device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        sdpa = _sdpa(q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                     attn_mask=mask)
        library_ms = timer(sdpa)
        host_us = timer.host_us(lambda: paged_attention(*args))
        library_host_us = timer.host_us(sdpa)
        rows[label] = dict(max_abs_err=e, ms=ms, kernel_alone_ms=alone_ms,
                           plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=library_ms,
                           host_us=host_us, library_host_us=library_host_us)
        log(f"  paged_attention {str(q.dtype)[6:]} {label}: kernel "
            f"{ms:.4f} ms "
            f"({alone_ms:.4f} ms alone in the profiler's trace), plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{bound_ms:.6f} ms ({bound_by}; {mb:.2f} MB); host "
            f"{host_us:.1f} us a call, sdpa's {library_host_us:.1f} us")
    print(json.dumps({"paged_attention_shapes": rows}), flush=True)
    return dict(name="paged_attention", route="cuda",
                source="src/repro_torch/csrc/paged_attention.cu",
                replaces=REPLACES["paged_attention"],
                shape=f"{first} bf16", **rows[first])


def check_fused_sampling(dev, timer):
    from repro_torch import sampling as smp
    from repro_torch.kernels.fused_sampling import ops as fs_ops
    from repro_torch.kernels.fused_sampling.ops import (NEG, fused_sample,
                                                        fused_sample_plain)
    from repro_torch.launch.flash_ab import (SAMPLING_SHAPES, catch_all_rows,
                                             sampling_rows)
    from repro_torch.launch.profile import KERNEL_ENTRIES
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)

    def rows(B, V, k=None, p=None, min_p=None):
        return sampling_rows(gen, B, V, dev, k, p, min_p)

    def case(tag, args, lp_k):
        x, g, k, p, mp, raw = args
        kw = dict(raw=raw if lp_k >= 0 else None, lp_k=max(lp_k, 0),
                  with_lanes=lp_k >= 0)
        got = fused_sample(x, g, k, p, mp, **kw)
        again = fused_sample(x, g, k, p, mp, **kw)
        torch.cuda.synchronize()
        want = fused_sample_plain(x, g, k, p, mp, **kw)
        err = 0.0
        for key, w in want.items():
            if not torch.equal(got[key], again[key]):
                raise AssertionError(f"fused_sampling {tag}: {key} differs "
                                     f"between two launches")
            if key in ("sampled", "greedy", "top_idx"):
                if not torch.equal(got[key], w):
                    raise AssertionError(f"fused_sampling {tag}: {key} "
                                         f"{got[key].tolist()} != plain "
                                         f"{w.tolist()}")
                continue
            fin = torch.isfinite(w)
            if not torch.equal(fin, torch.isfinite(got[key])) or \
                    not torch.allclose(got[key][fin], w[fin], rtol=1e-5,
                                       atol=1e-6):
                raise AssertionError(f"fused_sampling {tag}: {key} "
                                     f"{got[key].tolist()} vs plain "
                                     f"{w.tolist()}")
            if fin.any():
                err = max(err, (got[key][fin] - w[fin]).abs().max().item())
        if not torch.equal(got["greedy"],
                           torch.argmax(x, dim=1).to(torch.int32)):
            raise AssertionError(f"fused_sampling {tag}: greedy != argmax")
        log(f"  fused_sampling {tag}: tokens exact, max_abs_err={err:.3e}, "
            f"two launches equal ok")
        return got, err

    def tied(V):
        """Two rows whose max, draw and top raw entry are tied across the
        boundary between ranks 0 and 1: row 0 keeps only the tied pair
        (k = 2), row 1 keeps every entry."""
        x, g, k, p, mp, raw = rows(2, V, torch.tensor([2, 0]), 1.0, 0.0)
        w = fs_ops.slice_width(V)
        for t, val in ((x, 30.0), (g, 10.0), (raw, 9.0)):
            t[:, w - 1:w + 1] = val
        return w, (x, g, k, p, mp, raw)

    B, V = 8, 128256                          # the serving path's shape
    main = rows(B, V)
    w, tie = tied(V)
    outs = [case("B8 V128256 mixed", main, -1),
            case("B8 V128256 mixed lanes5", main, 5),
            case("filters off", rows(4, V, 0, 1.0, 0.0), 0),
            case("k=1", rows(4, V, 1, 1.0, 0.0), -1),
            case("top-p only", rows(4, V, 0, 0.6, 0.0), -1),
            case("min-p only", rows(4, V, 0, 1.0, 0.05), 3),
            case("odd V 50257 mixed", rows(5, 50257), 2),
            case("B1 V7 k3 (ranks with empty slices)",
                 rows(1, 7, 3, 0.9, 0.0), 7),
            case("B1 V128256 top-p 0.9 (prefix tail)",
                 rows(1, V, 0, 0.9, 0.0), -1),
            case("B8 V151936 mixed lanes5", rows(8, 151936), 5),
            case("B2 V256000 mixed lanes5 (largest slice, raw not parked)",
                 rows(2, 256000), 5),
            case("B8 V256000 mixed lanes5 (RecurrentGemma-2B's vocabulary)",
                 rows(8, 256000), 5),
            case("B8 V51872 mixed lanes5 (Whisper-base's padded vocabulary,"
                 " no multiple of 128)", rows(8, 51872), 5),
            case("B8 V131072 mixed lanes5 (Pixtral-12B's vocabulary)",
                 rows(8, 131072), 5),
            case("B2 V128256 lanes40 (two rounds of lane lists)",
                 rows(2, V), 40),
            case("crossings on a catch-all bucket", catch_all_rows(gen, V, dev),
                 2),
            case(f"tie across the rank boundary at {w}", tie, 3)]
    got = outs[-1][0]
    if got["sampled"].tolist() != [w - 1] * 2 or \
            got["greedy"].tolist() != [w - 1] * 2 or \
            got["top_idx"][:, :2].tolist() != [[w - 1, w]] * 2:
        raise AssertionError(f"fused_sampling tie: {got['sampled'].tolist()}"
                             f" {got['greedy'].tolist()} "
                             f"{got['top_idx'].tolist()}, want the lower "
                             f"index {w - 1}")
    err = max(e for _, e in outs)
    limit = fs_ops.max_vocab()
    too_long = rows(1, limit + 1)
    try:
        fused_sample(*too_long[:5])
    except ValueError as exc:
        log(f"  fused_sampling V {limit + 1} refused: {exc}")
    else:
        raise AssertionError(f"fused_sampling took V {limit + 1} past its "
                             f"limit {limit}")
    del too_long
    for Vq, lanes in ((V, False), (V, True), (151936, True), (256000, True)):
        r = fs_ops.residency(Vq, lanes)
        log(f"  fused_sampling residency V{Vq}{' lanes' if lanes else ''}: "
            f"{r['smem_bytes']} B of shared memory a CTA (raw parked: "
            f"{r['park_raw']}), {r['clusters']} clusters of 8 CTAs resident "
            f"(cudaOccupancyMaxActiveClusters)")

    shapes = {}
    # and RecurrentGemma-2B's, Whisper-base's and Pixtral-12B's
    # vocabularies: B8 with 5 lanes
    for Bs, Vs, lanes in SAMPLING_SHAPES + [(8, 256000, 5), (8, 51872, 5),
                                            (8, 131072, 5)]:
        x, g, k, p, mp, raw = main if (Bs, Vs) == (B, V) else rows(Bs, Vs)
        kw = dict(raw=raw if lanes >= 0 else None, lp_k=max(lanes, 0),
                  with_lanes=lanes >= 0)
        label = f"B{Bs} V{Vs}" + (f" lanes{lanes}" if lanes >= 0 else "")
        nbytes = Bs * Vs * 4 * (3 if lanes >= 0 else 2)
        ms = timer(lambda: fused_sample(x, g, k, p, mp, **kw))
        alone_ms = timer.kernel_ms(lambda: fused_sample(x, g, k, p, mp, **kw),
                                   KERNEL_ENTRIES["fused_sampling"])
        plain_ms = timer(lambda: fused_sample_plain(x, g, k, p, mp, **kw),
                         iters=5)
        host_us = timer.host_us(lambda: fused_sample(x, g, k, p, mp, **kw))
        shapes[label] = dict(ms=ms, kernel_alone_ms=alone_ms,
                             plain_ms=plain_ms,
                             bound_ms=nbytes / PEAK_BYTES * 1e3,
                             host_us=host_us)
        log(f"  fused_sampling f32 {label} mixed k/p/min_p: kernel {ms:.4f} "
            f"ms ({alone_ms:.4f} ms alone in the profiler's trace), plain "
            f"{plain_ms:.4f} ms, bound {shapes[label]['bound_ms']:.6f} ms "
            f"({nbytes / 1e6:.2f} MB); host {host_us:.1f} us a call")

    x, g, k, p, mp, raw = main

    def sort_route():
        tau = smp.joint_threshold(x, k, p, mp, 0)
        s = torch.where(x >= tau[:, None], x + g, NEG)
        return torch.argmax(s, dim=1), torch.argmax(x, dim=1)

    sort_ms = timer(sort_route, iters=5)
    log(f"  yardstick: the port's shared-sort route on the B8 V128256 rows "
        f"{sort_ms:.4f} ms; no single PyTorch call computes this function")
    print(json.dumps({"fused_sampling_shapes": shapes}), flush=True)
    first, lanes5 = shapes["B8 V128256"], shapes["B8 V128256 lanes5"]
    return dict(name="fused_sampling", route="cuda",
                source="src/repro_torch/csrc/fused_sampling.cu",
                replaces=REPLACES["fused_sampling"], max_abs_err=err,
                ms=first["ms"], plain_ms=first["plain_ms"],
                bound_ms=first["bound_ms"], bound_by="bytes",
                library_ms=None, ms_lanes5=lanes5["ms"],
                plain_ms_lanes5=lanes5["plain_ms"],
                bound_ms_lanes5=lanes5["bound_ms"], sort_route_ms=sort_ms,
                shape=f"B{B} V{V} f32 mixed k/p/min_p, no lanes")


def _routed(gen, dev, T, E, k, experts=None):
    """The dispatch of T tokens' top-k of random router logits (over
    ``experts`` only, if given), at the block size the MoE layer picks.
    Returns (plan, rows_of): ``rows_of(x)`` lays x (T, width) out as the
    layer does, sorted by expert and padded per expert."""
    from repro_torch.kernels.moe_gemm import ops
    logits = torch.randn((T, E), generator=gen, device=dev)
    if experts is not None:
        mask = torch.full((E,), -1e30, device=dev)
        mask[list(experts)] = 0.0
        logits = logits + mask
    ids = torch.topk(logits, k, dim=-1).indices
    plan = ops.dispatch_plan(ids, E, ops.pick_block_t(T * k, E))
    tok = torch.arange(T, device=dev).repeat_interleave(k)
    return plan, lambda x: ops.gather_rows(x, plan, tok)


def _gemm_bound(plan, xs, w, n_choices):
    """Least time for one call on these inputs: the touched experts'
    weights, the used rows of x and the whole output, once each, or the
    products of the real choices at the card's peak, whichever is
    larger."""
    E, D, Fo = w.shape
    be = plan.block_expert
    used = be[be >= 0]
    es = w.element_size()
    nbytes = (int(torch.unique(used).numel()) * D * Fo * es
              + int(used.numel()) * plan.block_t * D * es
              + xs.shape[0] * Fo * es + be.numel() * 4)
    flops = 2.0 * n_choices * D * Fo
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[w.dtype]
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations", \
        nbytes, flops


def _plain_blocks(xs, w, be, *, block_t, chunk=32):
    """``grouped_gemm_plain`` taken ``chunk`` blocks at a time: each block's
    rows depend only on its rows and its expert, and the plain version
    gathers one fp32 weight a block (58.7 MB a block at DeepSeek-R1's
    widths, ~30 GB for its 8x512 prefill in one call)."""
    from repro_torch.kernels.moe_gemm.ops import grouped_gemm_plain
    bt, rows = block_t, chunk * block_t
    return torch.cat([grouped_gemm_plain(xs[i:i + rows], w,
                                         be[i // bt:(i + rows) // bt],
                                         block_t=bt)
                      for i in range(0, xs.shape[0], rows)])


def check_moe_gemm(dev, timer):
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.kernels.moe_gemm.ops import (grouped_gemm,
                                                  grouped_gemm_plain)
    from repro_torch.models.moe import expert_capacity
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    ops.reset_routes()
    calls = {"wgmma": 0, "mma": 0, "simt": 0}

    def case(tag, dtype, xs, w, be, bt):
        got = grouped_gemm(xs, w, be, block_t=bt)
        r = ops.route(dtype, bt, xs.shape[1], w.shape[2],
                      xs.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
        calls[r] += 1
        torch.cuda.synchronize()
        want = grouped_gemm_plain(xs, w, be, block_t=bt)
        err = _check(f"moe_gemm {tag} {str(dtype)[6:]} ({r})", got, want,
                     dtype)
        unused = (be < 0).repeat_interleave(bt)
        if got[unused].any():
            raise AssertionError(f"moe_gemm {tag}: unused blocks' rows are "
                                 f"not exact zeros")
        return err

    def planned(tag, dtype, xs, plan, w):
        return case(tag, dtype, xs, w, plan.block_expert, plan.block_t)

    def explicit(tag, experts, n_blocks, bt, E, D, Fo):
        """bf16 blocks of ``experts`` in order, then unused ones; x random
        in every row, unused ones included."""
        be = torch.full((n_blocks,), -1, dtype=torch.int32, device=dev)
        be[:len(experts)] = torch.tensor(experts, dtype=torch.int32,
                                         device=dev)
        xs = _rand(gen, (n_blocks * bt, D), torch.bfloat16, dev)
        w = (0.1 * torch.randn((E, D, Fo), generator=gen, device=dev)) \
            .bfloat16()
        return case(tag, torch.bfloat16, xs, w, be, bt)

    # Qwen3-30B-A3B: E=128, top-8, D=2048, expert F=768; a decode step of
    # 8 slots and the 8 x 256 prefill batch
    E, k, D, Fe = 128, 8, 2048, 768
    main, prefill_w2 = {}, None
    for dtype in (torch.bfloat16, torch.float32):
        w1 = (0.02 * torch.randn((E, D, Fe), generator=gen, device=dev)) \
            .to(dtype)
        w2 = (0.03 * torch.randn((E, Fe, D), generator=gen, device=dev)) \
            .to(dtype)
        for T, name in ((8, "decode B8"), (2048, "prefill 8x256")):
            plan, rows_of = _routed(gen, dev, T, E, k)
            xs = rows_of(_rand(gen, (T, D), dtype, dev))
            err1 = planned(f"{name} w1 bt{plan.block_t} rows{xs.shape[0]}",
                           dtype, xs, plan, w1)
            xs2 = rows_of(_rand(gen, (T, Fe), dtype, dev))
            err2 = planned(f"{name} w2 (F->D)", dtype, xs2, plan, w2)
            main[(dtype, T)] = (err1, xs, plan, w1)
            if dtype == torch.bfloat16 and T == 2048:
                prefill_w2 = (err2, xs2, plan, w2)
    # an expert with no rows (3 and 7 never chosen), ragged D and F
    for dtype in (torch.bfloat16, torch.float32):
        w = _rand(gen, (8, 72, 100), dtype, dev)
        plan, rows_of = _routed(gen, dev, 24, 8, 2,
                                experts=(0, 1, 2, 4, 5, 6))
        planned("E8 two empty experts D72 F100", dtype,
                rows_of(_rand(gen, (24, 72), dtype, dev)), plan, w)
        # the reduced models' experts: E=4, D=128, F=64, top-2
        w = _rand(gen, (4, 128, 64), dtype, dev)
        plan, rows_of = _routed(gen, dev, 64, 4, 2)
        planned("reduced E4 D128 F64", dtype,
                rows_of(_rand(gen, (64, 128), dtype, dev)), plan, w)
    # the wgmma route's edges: D not a multiple of its 64-deep k-tile, an
    # expert with three consecutive blocks and one with none, unused
    # trailing blocks (exact zeros), block_t 64, F = 64 at block_t 128
    # (the second 64-column box wholly past F), more k-tiles than ring
    # stages, block_t 256 with a ragged column tile
    explicit("bt64 D72 F96 (ragged k-tile), expert 0 x3, expert 2 none",
             [1, 0, 0, 0], 6, 64, 3, 72, 96)
    explicit("bt128 D128 F64", [0, 1, 1], 5, 128, 4, 128, 64)
    explicit("bt64 D1024 F256 (16 k-tiles)", [2, 2, 2, 0], 6, 64, 4, 1024,
             256)
    explicit("bt256 D512 F200 (ragged column tile)", [3, 1], 3, 256, 4,
             512, 200)
    # DeepSeek-R1: E=256, top-8, D=7168, expert F=2048, bf16 (a weight is
    # 7.5 GB): a decode step of 8 slots (block_t 16, mma) and an 8 x 512
    # prefill batch (block_t 128, wgmma), w1 and w2
    E2, D2, F2 = 256, 7168, 2048
    ds_w = {"w1": torch.randn((E2, D2, F2), generator=gen, device=dev,
                              dtype=torch.bfloat16).mul_(0.02),
            "w2": torch.randn((E2, F2, D2), generator=gen, device=dev,
                              dtype=torch.bfloat16).mul_(0.03)}
    deepseek = {}
    for T, name in ((8, "decode B8"), (4096, "prefill 8x512")):
        plan, rows_of = _routed(gen, dev, T, E2, k)
        be, bt = plan.block_expert, plan.block_t
        for wname, w in ds_w.items():
            xs = rows_of(_rand(gen, (T, w.shape[1]), torch.bfloat16, dev))
            got = grouped_gemm(xs, w, be, block_t=bt)
            r = ops.route(torch.bfloat16, bt, w.shape[1], w.shape[2], True)
            calls[r] += 1
            torch.cuda.synchronize()
            err = _check(f"moe_gemm DeepSeek {name} {wname} bt{bt} rows"
                         f"{xs.shape[0]} bf16 ({r})", got,
                         _plain_blocks(xs, w, be, block_t=bt), torch.bfloat16)
            if got[(be < 0).repeat_interleave(bt)].any():
                raise AssertionError(f"moe_gemm DeepSeek {name}: unused "
                                     f"blocks' rows are not exact zeros")
            deepseek[f"DeepSeek {name} {wname}"] = (T, (err, xs, plan, w))
            del got
    if ops.ROUTE_LAUNCHES != calls:
        raise AssertionError(f"moe_gemm launches by route "
                             f"{ops.ROUTE_LAUNCHES}, expected {calls}")
    log(f"  moe_gemm launches by route: {calls} (each on ops.route's "
        f"choice)")

    _, xs, plan, w1 = main[(torch.bfloat16, 2048)]
    again = [grouped_gemm(xs, w1, plan.block_expert, block_t=plan.block_t)
             for _ in range(2)]
    torch.cuda.synchronize()
    if not torch.equal(again[0], again[1]):
        raise AssertionError("moe_gemm bf16 prefill w1: two launches gave "
                             "other bits")
    log("  moe_gemm bf16 prefill 8x256 w1 (wgmma): two launches, equal "
        "bits")
    del again

    from repro_torch.launch.profile import KERNEL_ENTRIES
    rows = {}
    timed = {"decode B8 w1": (8, main[(torch.bfloat16, 8)]),
             "prefill 8x256 w1": (2048, main[(torch.bfloat16, 2048)]),
             "prefill 8x256 w2": (2048, prefill_w2), **deepseek}
    for label, (T, (err, xs, plan, w)) in timed.items():
        be, bt = plan.block_expert, plan.block_t
        Ew, Din, Fo = w.shape
        cfg = get_config("deepseek_r1" if label.startswith("DeepSeek")
                         else "qwen3_moe_30b")
        plain = _plain_blocks if label.startswith("DeepSeek") \
            else grouped_gemm_plain
        r = ops.route(torch.bfloat16, bt, Din, Fo, True)
        bound, by, nbytes, flops = _gemm_bound(plan, xs, w, T * k)
        ms = timer(lambda: grouped_gemm(xs, w, be, block_t=bt))
        alone_ms = timer.kernel_ms(lambda: grouped_gemm(xs, w, be,
                                                        block_t=bt),
                                   KERNEL_ENTRIES["moe_gemm"])
        host_us = timer.host_us(lambda: grouped_gemm(xs, w, be, block_t=bt))
        plain_ms = timer(lambda: plain(xs, w, be, block_t=bt), iters=5)
        # the reference's own contraction: one bmm over (E, C, D)
        buf = _rand(gen, (Ew, expert_capacity(cfg, T), Din), torch.bfloat16,
                    dev)
        bmm_ms = timer(lambda: torch.bmm(buf, w))
        gmm_ms = None
        if hasattr(torch, "_grouped_mm"):
            counts = torch.bincount(torch.topk(torch.randn(
                (T, Ew), generator=gen, device=dev), k).indices.reshape(-1),
                minlength=Ew)
            xa = _rand(gen, (T * k, Din), torch.bfloat16, dev)
            offs = torch.cumsum(counts, 0).to(torch.int32)
            gmm_ms = timer(lambda: torch._grouped_mm(xa, w, offs=offs))
        used = int((be >= 0).sum().item())
        log(f"  moe_gemm bf16 {label} (T={T}, top-{k} of {Ew}, D{Din} "
            f"F{Fo}, rows {xs.shape[0]}, block_t {bt}, {used} used blocks, "
            f"{r} route): kernel {ms:.4f} ms ({alone_ms:.4f} ms alone in "
            f"the profiler's trace), host {host_us:.1f} us a "
            f"call, plain {plain_ms:.4f} ms, bmm over (E,C,D) {bmm_ms:.4f} "
            f"ms, torch._grouped_mm {gmm_ms} ms, bound {bound:.4f} ms by "
            f"{by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        rows[label] = dict(max_abs_err=err, ms=ms, kernel_alone_ms=alone_ms,
                           host_us=host_us,
                           plain_ms=plain_ms, bmm_ms=bmm_ms, gmm_ms=gmm_ms,
                           bound_ms=bound, bound_by=by, block_t=bt,
                           rows=xs.shape[0], route=r)
        del buf
    print(json.dumps({"moe_gemm_shapes": rows}), flush=True)
    del deepseek, ds_w, timed
    d = rows["decode B8 w1"]
    err16 = max(main[(torch.bfloat16, T)][0] for T in (8, 2048))
    err32 = max(main[(torch.float32, T)][0] for T in (8, 2048))
    return dict(name="moe_gemm", route="cuda",
                source="src/repro_torch/csrc/moe_gemm.cu",
                replaces=REPLACES["moe_gemm"], max_abs_err=err16,
                max_abs_err_fp32=err32, ms=d["ms"], plain_ms=d["plain_ms"],
                bound_ms=d["bound_ms"], bound_by=d["bound_by"],
                library_ms=d["bmm_ms"], grouped_mm_ms=d["gmm_ms"],
                shape=f"decode B8 top-{k} of {E}, D{D} F{Fe} bf16, rows "
                      f"{d['rows']} block_t {d['block_t']} (mma route); "
                      f"library: torch.bmm over the (E, C, D) capacity "
                      f"buffer; prefill shapes in the moe_gemm_shapes line")


# Qwen3-30B-A3B's training shape of the grouped GEMM's backward (phase 13's
# batch of 4 x 4096 tokens, top-8 of 128 experts), timed in phase 3
TRAIN_MOE = dict(T=4 * 4096, E=128, k=8, D=2048, F=768)


def _wgrad_bound(plan, n_choices, E, M, N, es):
    """Least time for one weight-gradient call on these inputs: the used
    rows of x and dy read once and dw (E, M, N) written once, or 2 M N
    operations a kept choice at the card's peak, whichever is larger."""
    be = plan.block_expert
    used = int((be >= 0).sum().item())
    nbytes = (used * plan.block_t * (M + N) * es + E * M * N * es
              + be.numel() * 4)
    flops = 2.0 * n_choices * M * N
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[torch.bfloat16]
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations", \
        nbytes, flops


def _wgrad_plain_blocks(x, dy, be, E, bt, chunk=128):
    """``grouped_gemm_wgrad_plain`` taken ``chunk`` blocks at a time into
    one fp32 sum (its per-block products at the training shape take ~7
    GB at once), cast to x's dtype at the end."""
    from repro_torch.kernels.moe_gemm_wgrad.ops import \
        grouped_gemm_wgrad_plain
    dw = torch.zeros((E, x.shape[1], dy.shape[1]), dtype=torch.float32,
                     device=x.device)
    for i in range(0, be.numel(), chunk):
        rows = slice(i * bt, (i + chunk) * bt)
        dw += grouped_gemm_wgrad_plain(x[rows].float(), dy[rows].float(),
                                       be[i:i + chunk], E, block_t=bt)
    return dw.to(x.dtype)


def _grouped_mm_wgrad_ms(timer, gen, dev, T, E, k, M, N):
    """The yardstick: one ``torch._grouped_mm`` over the choices packed by
    expert (each group padded to 16 rows), grouped along the reduction
    (x^T (M, rows) times dy (rows, N) -> (E, M, N)).  None where the
    card's torch has no such call or refuses every operand layout tried."""
    if not hasattr(torch, "_grouped_mm"):
        return None
    counts = torch.bincount(torch.topk(torch.randn(
        (T, E), generator=gen, device=dev), k).indices.reshape(-1),
        minlength=E)
    counts = (counts + 15) // 16 * 16
    R = int(counts.sum().item())
    offs = torch.cumsum(counts, 0).to(torch.int32)
    xa = _rand(gen, (R, M), torch.bfloat16, dev)
    ya = _rand(gen, (R, N), torch.bfloat16, dev)
    layouts = {"x^T view, dy": (xa.t(), ya),
               "x^T copy, dy column-major": (xa.t().contiguous(),
                                             ya.t().contiguous().t()),
               "x^T copy, dy": (xa.t().contiguous(), ya)}
    for name, (a, b) in layouts.items():
        try:
            out = torch._grouped_mm(a, b, offs=offs)
            if out.shape != (E, M, N):
                raise RuntimeError(f"output {tuple(out.shape)}")
            ms = timer(lambda: torch._grouped_mm(a, b, offs=offs))
            log(f"  torch._grouped_mm weight gradient ({name}, {R} rows): "
                f"{ms:.4f} ms")
            return ms
        except RuntimeError as exc:
            log(f"  torch._grouped_mm refuses {name}: "
                f"{str(exc).splitlines()[0]}")
    return None


# the weight gradient's edges: (tag, experts of the blocks in order, block_t,
# M, N, E); -1 is an unused block, an expert missing from the list has no
# block.  In bf16 the ones at block_t 64 or 128 with M and N multiples of 8
# take the wgmma route (M 200 / N 136 are not multiples of its 64-column
# boxes; M 72 leaves the second consumer warpgroup's rows past M), the rest
# the mma route; every bf16 edge also runs on the mma route, and fp32 on
# simt.
WGRAD_EDGES = [
    ("ragged M72 N100, empty experts, bt16", [2, 0, 0, 1, -1], 16, 72, 100,
     4),
    ("bt64 M128 N64, expert 1 x3", [1, 1, 1, 0, -1], 64, 128, 64, 3),
    ("blocks of one expert apart, M136 N200", [0, 2, 0, 1, 2], 64, 136, 200,
     3),
    ("bt64 M200 N136, empty expert, unused blocks", [0, 2, 0, 2, -1, -1], 64,
     200, 136, 4),
    ("bt128 M72 N264, blocks apart, unused block", [2, 0, 0, 2, -1], 128, 72,
     264, 4),
    ("bt128 M256 N512, empty experts 2 and 4", [0, 0, 1, 3, 3, 3, -1, -1],
     128, 256, 512, 5),
]


def check_moe_gemm_wgrad(dev, timer):
    """The grouped GEMM's backward at Qwen3-30B-A3B's training shape: the
    weight gradient (``moe_gemm_wgrad``) of w1/w3 (D x F) and w2 (F x D)
    on its ``wgmma`` route against its plain version in bf16, equal bits
    over two launches, every launch on the route ``ops.route`` names; the
    edges (``WGRAD_EDGES``) on each route that takes them: wgmma, mma
    (every bf16 edge) and simt (fp32); dX through the forward kernel on
    the transposed weights (wgmma) against its plain version; each timed
    beside its bound, the weight gradient on the wgmma and mma routes
    alone in the profiler's trace on the same inputs, plain, and against
    one ``torch._grouped_mm`` (a yardstick only)."""
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.kernels.moe_gemm.ops import (grouped_gemm,
                                                  grouped_gemm_plain)
    from repro_torch.kernels.moe_gemm_wgrad import ops as wops
    from repro_torch.launch.profile import KERNEL_ENTRIES
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    T, E, k, D, Fe = (TRAIN_MOE[n] for n in ("T", "E", "k", "D", "F"))
    plan, rows_of = _routed(gen, dev, T, E, k)
    be, bt = plan.block_expert, plan.block_t
    n_choices = int(plan.keep.sum().item())
    rows, errs, timed = {}, {}, {}
    wgrad = wops.grouped_gemm_wgrad

    def on_route(r, x, dy, bee, Ee, bte):
        """The weight gradient on route ``r`` through the wrapper's own
        launch (a route ``ops.route`` would not name for this call, to
        time or hold it apart); counts nothing."""
        wops._check(x, dy, bee, Ee, bte)
        return wops.launch(wops._lib(), x, dy, bee, Ee, bte, r)

    for label, (M, N) in (("w1/w3 dW (D x F)", (D, Fe)),
                          ("w2 dW (F x D)", (Fe, D))):
        x = rows_of(_rand(gen, (T, M), torch.bfloat16, dev))
        dy = rows_of(_rand(gen, (T, N), torch.bfloat16, dev))
        wops.reset_routes()
        got = wgrad(x, dy, be, E, block_t=bt)
        torch.cuda.synchronize()
        if wops.ROUTE_LAUNCHES != {"wgmma": 1, "mma": 0, "simt": 0}:
            raise AssertionError(f"moe_gemm_wgrad {label}: launched by "
                                 f"route {wops.ROUTE_LAUNCHES} (expected "
                                 f"wgmma)")
        errs[label] = _check(f"moe_gemm_wgrad {label} bt{bt} rows "
                             f"{x.shape[0]} bf16 (wgmma)", got,
                             _wgrad_plain_blocks(x, dy, be, E, bt),
                             torch.bfloat16)
        again = wgrad(x, dy, be, E, block_t=bt)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"moe_gemm_wgrad {label}: two launches "
                                 f"gave other bits")
        log(f"  moe_gemm_wgrad bf16 {label} (wgmma): two launches, equal "
            f"bits")
        timed[label] = (x, dy, M, N)
        del got, again
    # the edges: the route ops.route names, the mma route for every bf16
    # edge, the simt route for fp32
    routes_seen = {"wgmma": 0, "mma": 0, "simt": 0}
    for dtype in (torch.bfloat16, torch.float32):
        for tag, experts, bte, M, N, Ee in WGRAD_EDGES:
            bee = torch.tensor(experts, dtype=torch.int32, device=dev)
            x = _rand(gen, (len(experts) * bte, M), dtype, dev)
            dy = _rand(gen, (len(experts) * bte, N), dtype, dev)
            want = wops.grouped_gemm_wgrad_plain(x, dy, bee, Ee, block_t=bte)
            scale = want.float().abs().max().item()
            tol = dict(atol=TOL[dtype]["atol"] * max(scale, 1.0),
                       rtol=TOL[dtype]["rtol"])
            wops.reset_routes()
            named = wops.route(dtype, bte, M, N, True)
            outs = {named: wgrad(x, dy, bee, Ee, block_t=bte)}
            if wops.ROUTE_LAUNCHES[named] != 1:
                raise AssertionError(f"moe_gemm_wgrad {tag}: launched by "
                                     f"route {wops.ROUTE_LAUNCHES} "
                                     f"(expected {named})")
            if named == "wgmma":
                outs["mma"] = on_route("mma", x, dy, bee, Ee, bte)
                again = wgrad(x, dy, bee, Ee, block_t=bte)
                torch.cuda.synchronize()
                if not torch.equal(outs["wgmma"], again):
                    raise AssertionError(f"moe_gemm_wgrad {tag}: two wgmma "
                                         f"launches gave other bits")
            torch.cuda.synchronize()
            for r, got in outs.items():
                routes_seen[r] += 1
                _check(f"moe_gemm_wgrad {tag} {str(dtype)[6:]} ({r})", got,
                       want, dtype, tol)
                if any(got[e].any() for e in set(range(Ee)) - set(experts)):
                    raise AssertionError(f"moe_gemm_wgrad {tag} ({r}): an "
                                         f"expert with no block is not "
                                         f"zeros")
    log(f"  moe_gemm_wgrad edges held on each route: {routes_seen}")
    # dX: the forward kernel on the transposed weights, w1^T (E, F, D) and
    # w2^T (E, D, F), as GroupedGemmFn's backward lays them out
    dx_rows = {}
    for label, (Fi, Do) in (("dX of w1/w3 (dy F -> D)", (Fe, D)),
                            ("dX of w2 (dy D -> F)", (D, Fe))):
        wt = (0.02 * torch.randn((E, Do, Fi), generator=gen, device=dev)) \
            .bfloat16().transpose(1, 2).contiguous()
        dy = rows_of(_rand(gen, (T, Fi), torch.bfloat16, dev))
        ops.reset_routes()
        got = grouped_gemm(dy, wt, be, block_t=bt)
        torch.cuda.synchronize()
        if ops.ROUTE_LAUNCHES["wgmma"] != 1:
            raise AssertionError(f"moe_gemm {label}: launched by route "
                                 f"{ops.ROUTE_LAUNCHES} (expected wgmma)")
        err = _check(f"moe_gemm {label} bt{bt} bf16", got,
                     grouped_gemm_plain(dy, wt, be, block_t=bt),
                     torch.bfloat16)
        bound, by, nbytes, flops = _gemm_bound(plan, dy, wt, n_choices)
        ms = timer(lambda: grouped_gemm(dy, wt, be, block_t=bt))
        dx_rows[label] = dict(max_abs_err=err, ms=ms, bound_ms=bound,
                              bound_by=by, route="wgmma")
        log(f"  moe_gemm bf16 {label} (training shape, {n_choices} kept "
            f"choices, rows {dy.shape[0]}): kernel {ms:.4f} ms, bound "
            f"{bound:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP)")
        del wt, dy, got
    # time the weight gradient at the training shape: the wgmma route
    # (what the wrapper names) and the mma route on the same inputs, each
    # alone in the profiler's trace, in the order mma, wgmma, wgmma, mma
    entries = KERNEL_ENTRIES["moe_gemm_wgrad"]
    for label, (x, dy, M, N) in timed.items():
        bound, by, nbytes, flops = _wgrad_bound(plan, n_choices, E, M, N, 2)
        ms = timer(lambda: wgrad(x, dy, be, E, block_t=bt), iters=10)
        alone = {"wgmma": [], "mma": []}
        for r in ("mma", "wgmma", "wgmma", "mma"):
            alone[r].append(timer.kernel_ms(
                lambda: on_route(r, x, dy, be, E, bt), entries, iters=10))
        plain_ms = timer(lambda: _wgrad_plain_blocks(x, dy, be, E, bt),
                         iters=2, warmup=1)
        lib = _grouped_mm_wgrad_ms(timer, gen, dev, T, E, k, M, N)
        rows[label] = dict(max_abs_err=errs[label], ms=ms,
                           kernel_alone_ms=statistics.median(alone["wgmma"]),
                           alone_ms_by_route=alone, plain_ms=plain_ms,
                           bound_ms=bound, bound_by=by, library_ms=lib,
                           rows=x.shape[0], block_t=bt,
                           kept_choices=n_choices, route="wgmma")
        log(f"  moe_gemm_wgrad bf16 {label} (T={T}, top-{k} of {E}, "
            f"{n_choices} kept choices, rows {x.shape[0]}, block_t {bt}): "
            f"wgmma route {ms:.4f} ms; alone in the profiler's trace wgmma "
            f"{alone['wgmma'][0]:.4f} / {alone['wgmma'][1]:.4f} ms, mma "
            f"{alone['mma'][0]:.4f} / {alone['mma'][1]:.4f} ms; plain "
            f"{plain_ms:.4f} ms, torch._grouped_mm {lib} ms, bound "
            f"{bound:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP)")
    print(json.dumps({"moe_gemm_train_shapes": {**rows, **dx_rows}}),
          flush=True)
    del timed
    r = rows["w1/w3 dW (D x F)"]
    return dict(name="moe_gemm_wgrad", route="cuda",
                source="src/repro_torch/csrc/moe_gemm_wgrad.cu",
                replaces=REPLACES["moe_gemm_wgrad"],
                max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=r["library_ms"],
                shape=f"w1/w3 dW at 4 x 4096 tokens, top-{k} of {E}, D{D} "
                      f"F{Fe} bf16, rows {r['rows']} block_t {bt}, wgmma "
                      f"route; library: torch._grouped_mm grouped along "
                      f"the rows")


def _scan_bound(states):
    """Least time for one scan: states and decay read once, prev and final
    written once, or 2 FLOP per element and chunk at the fp32 peak."""
    B, H, nc, N, P = states.shape
    nbytes = 4 * (2 * states.numel() + B * H * nc + B * H * N * P)
    flops = 2.0 * states.numel()
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[torch.float32]
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations", \
        nbytes


def check_ssd_scan(dev, timer):
    """The scan must give its plain version's bits (``torch.equal``) on
    ``prev`` and ``final``: it rounds the product and the sum separately,
    as the plain ``h * d + s`` does."""
    from repro_torch.kernels.ssd_scan.ops import (ssd_state_scan,
                                                  ssd_state_scan_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def case(tag, shape, offset=0):
        B, H, nc = shape[:3]
        # offset > 0: a contiguous view off the 16-byte grid (scalar path)
        s = torch.randn(math.prod(shape) + offset, generator=gen,
                        device=dev)[offset:].view(shape)
        d = torch.rand((B, H, nc), generator=gen, device=dev) * 0.9 + 0.05
        got = ssd_state_scan(s, d)
        torch.cuda.synchronize()
        want = ssd_state_scan_plain(s, d)
        for name, g, w in zip(("prev", "final"), got, want):
            if not torch.equal(g, w):
                err = (g - w).abs().max().item()
                raise AssertionError(f"ssd_scan {tag}: {name} differs from "
                                     f"its plain version (max abs err "
                                     f"{err})")
        log(f"  ssd_scan {tag} {shape}: prev and final equal in bits")
        return s, d

    # mamba2_370m's prefill of 8 x 256 tokens and of one 32768-token
    # prompt (H=32, N=128, P=64, chunks of 64); the JAX test's shapes; a
    # 64-token prompt (one chunk); a ragged N*P and an unaligned view
    main = {"prefill 8x256": case("prefill 8x256", (8, 32, 4, 128, 64)),
            "prompt 32768": case("prompt 32768", (1, 32, 512, 128, 64))}
    case("JAX test", (2, 4, 8, 16, 8))
    case("JAX test", (1, 2, 16, 32, 16))
    case("nc=1", (8, 32, 1, 128, 64))
    case("ragged N*P=21", (2, 3, 5, 7, 3))
    case("unaligned view", (2, 4, 6, 16, 8), offset=1)
    case("reduced mamba2 N16 P16", (4, 16, 2, 16, 16))

    from repro_torch.launch.profile import KERNEL_ENTRIES
    rows = {}
    for tag, (s, d) in main.items():
        bound, by, nbytes = _scan_bound(s)
        ms = timer(lambda: ssd_state_scan(s, d))
        alone_ms = timer.kernel_ms(lambda: ssd_state_scan(s, d),
                                   KERNEL_ENTRIES["ssd_scan"])
        plain_ms = timer(lambda: ssd_state_scan_plain(s, d), iters=5)
        log(f"  ssd_scan {tag} {tuple(s.shape)} fp32: kernel {ms:.4f} ms "
            f"({alone_ms:.4f} ms alone in the profiler's trace: "
            f"{bound / alone_ms:.3f} of its bound), plain {plain_ms:.4f} "
            f"ms, bound {bound:.4f} ms by {by} ({nbytes / 1e6:.1f} MB: "
            f"{nbytes / ms / 1e9:.3f} TB/s); no single PyTorch call "
            f"computes a linear recurrence")
        rows[tag] = dict(ms=ms, kernel_alone_ms=alone_ms, plain_ms=plain_ms,
                         bound=bound, by=by, nbytes=nbytes)
    p = rows["prefill 8x256"]
    return dict(name="ssd_scan", route="cuda",
                source="src/repro_torch/csrc/ssd_scan.cu",
                replaces=REPLACES["ssd_scan"], max_abs_err=0.0,
                ms=p["ms"], kernel_alone_ms=p["kernel_alone_ms"],
                plain_ms=p["plain_ms"], bound_ms=p["bound"],
                bound_by=p["by"], library_ms=None,
                long_prompt=rows["prompt 32768"],
                shape="(B,H,nc,N,P)=(8,32,4,128,64) fp32, mamba2_370m's "
                      "8x256 prefill; library: none (no single PyTorch "
                      "call computes a first-order linear recurrence)")


# Mamba2-370M's training microbatch for the scan's backward: 8 x 4096
# tokens, 32 heads, state 128 x head dim 64, chunks of 64 (phase 14)
SCAN_BWD_TRAIN = (8, 32, 64, 128, 64)


def _scan_bwd_bound(prev, with_final: bool):
    """Least time for one backward: prev and dprev read once, dstates
    written once, decay read and ddecay written once (dfinal read once
    when given), or 4 FLOP per element and chunk at the fp32 peak."""
    B, H, nc, N, P = prev.shape
    nbytes = 4 * (3 * prev.numel() + 2 * B * H * nc
                  + (B * H * N * P if with_final else 0))
    flops = 4.0 * prev.numel()
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[torch.float32]
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations", \
        nbytes


def check_ssd_scan_bwd(dev, timer):
    """The scan's backward (the adjoint recurrence) against its plain
    version: dstates in its bits (``torch.equal``: the update rounds the
    product and the sum separately, as ``dprev + d * G`` does), ddecay (a
    sum of N * P products over a cell's CTAs, in a fixed order) to atol
    1e-5 + 1e-7 x the sum of the products' magnitudes, rtol 1e-5, and
    both in equal bits over two launches.  Cases: the training microbatch
    (``SCAN_BWD_TRAIN``, dfinal None as training calls it), the serving
    shapes of ``check_ssd_scan`` (with a dfinal), the JAX test's shapes,
    one chunk, a ragged N*P and an unaligned view.  Timed at the training
    shape by CUDA events and alone in the profiler's trace (its two
    launches' medians summed), beside its bound; no PyTorch call computes
    a linear recurrence's adjoint, so it has no library yardstick."""
    from repro_torch.kernels.ssd_scan.ops import ssd_state_scan_plain
    from repro_torch.kernels.ssd_scan_bwd.ops import (
        ssd_state_scan_bwd, ssd_state_scan_bwd_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    worst = 0.0

    def case(tag, shape, final=False, offset=0):
        nonlocal worst
        B, H, nc, N, P = shape

        def view(shp):   # offset > 0: a contiguous view off the 16-byte grid
            return torch.randn(math.prod(shp) + offset, generator=gen,
                               device=dev)[offset:].view(shp)
        d = torch.rand((B, H, nc), generator=gen, device=dev) * 0.9 + 0.05
        prev = ssd_state_scan_plain(view(shape), d)[0]
        if offset:
            prev = view(shape).copy_(prev)
        dprev = view(shape)
        dfinal = view((B, H, N, P)) if final else None
        got = ssd_state_scan_bwd(prev, d, dprev, dfinal)
        again = ssd_state_scan_bwd(prev, d, dprev, dfinal)
        torch.cuda.synchronize()
        want = ssd_state_scan_bwd_plain(prev, d, dprev, dfinal)
        if not torch.equal(got[0], want[0]):
            err = (got[0] - want[0]).abs().max().item()
            raise AssertionError(f"ssd_scan_bwd {tag}: dstates differs from "
                                 f"its plain version (max abs err {err})")
        mag = (want[0].abs() * prev.abs()).sum(dim=(-2, -1))
        err = (got[1] - want[1]).abs()
        if not (err <= 1e-5 + 1e-7 * mag + 1e-5 * want[1].abs()).all():
            raise AssertionError(f"ssd_scan_bwd {tag}: ddecay max abs err "
                                 f"{err.max().item()} past atol 1e-5 + 1e-7 "
                                 f"x sum|dS * prev| (up to "
                                 f"{mag.max().item():.1f}), rtol 1e-5")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"ssd_scan_bwd {tag}: two launches differ")
        worst = max(worst, err.max().item())
        log(f"  ssd_scan_bwd {tag} {shape}{' dfinal' if final else ''}: "
            f"dstates equal in bits, ddecay max abs err "
            f"{err.max().item():.3e} (|ddecay| up to "
            f"{want[1].abs().max().item():.1f}), equal bits over two "
            f"launches")
        return prev, d, dprev, dfinal

    train = case("training 8x4096", SCAN_BWD_TRAIN)
    case("prefill 8x256", (8, 32, 4, 128, 64), final=True)
    case("prompt 32768", (1, 32, 512, 128, 64), final=True)
    case("JAX test", (2, 4, 8, 16, 8), final=True)
    case("JAX test", (1, 2, 16, 32, 16))
    case("nc=1", (8, 32, 1, 128, 64), final=True)
    case("ragged N*P=21", (2, 3, 5, 7, 3), final=True)
    case("ragged tile N*P=864", (1, 2, 7, 24, 36))
    case("unaligned view", (2, 4, 6, 16, 8), final=True, offset=1)
    case("reduced mamba2 N16 P16", (4, 16, 2, 16, 16))

    from repro_torch.launch.profile import KERNEL_ENTRIES
    prev, d, dprev, _ = train
    bound, by, nbytes = _scan_bwd_bound(prev, False)

    def call():
        return ssd_state_scan_bwd(prev, d, dprev)
    ms = timer(call)
    alone = {e: timer.kernel_ms(call, (e,))
             for e in KERNEL_ENTRIES["ssd_scan_bwd"]}
    alone_ms = sum(alone.values())
    plain_ms = timer(lambda: ssd_state_scan_bwd_plain(prev, d, dprev),
                     iters=5)
    log(f"  ssd_scan_bwd training 8x4096 {SCAN_BWD_TRAIN} fp32: kernel "
        f"{ms:.4f} ms ({alone_ms:.4f} ms alone in the profiler's trace, "
        + ", ".join(f"{e} {v:.4f}" for e, v in alone.items())
        + f": {bound / alone_ms:.3f} of its bound), plain {plain_ms:.4f} "
        f"ms, bound {bound:.4f} ms by {by} ({nbytes / 1e6:.1f} MB: "
        f"{nbytes / ms / 1e9:.3f} TB/s); no single PyTorch call computes a "
        f"linear recurrence's adjoint")
    return dict(name="ssd_scan_bwd", route="cuda",
                source="src/repro_torch/csrc/ssd_scan_bwd.cu",
                replaces=REPLACES["ssd_scan_bwd"], max_abs_err=worst,
                ms=ms, kernel_alone_ms=alone_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None,
                shape="(B,H,nc,N,P)=(8,32,64,128,64) fp32, dfinal None, "
                      "mamba2_370m's training microbatch of 8 x 4096; "
                      "library: none (no single PyTorch call computes a "
                      "linear recurrence's adjoint)")


# ---------------------------------------------------------------- phase 4
class _PageClock:
    """Host-clock spans of an engine's prefill and decode_page calls,
    each ended by a synchronize; decode pages are split into sampled
    (any non-greedy sequence active) and greedy."""

    def __init__(self, eng):
        self.eng = eng
        self.spans = {"prefill": [], "decode": [], "sampled": []}
        self.orig = (eng.prefill, eng.decode_page)
        eng.prefill = self._wrap("prefill", self.orig[0],
                                 lambda: eng.prefill_tokens)
        eng.decode_page = self._wrap("decode", self.orig[1],
                                     lambda: eng.decode_steps)

    def _wrap(self, kind, fn, count):
        def run(active, *a):
            sampled = kind == "decode" and any(
                not c.sampling.is_greedy_default for c in active)
            torch.cuda.synchronize()
            t = time.perf_counter()
            before = count()
            fn(active, *a)
            torch.cuda.synchronize()
            self.spans["sampled" if sampled else kind].append(
                (time.perf_counter() - t, count() - before))
        return run

    def restore(self):
        self.eng.prefill, self.eng.decode_page = self.orig

    def per_step(self, kind):
        s, n = map(sum, zip(*self.spans[kind])) if self.spans[kind] \
            else (0.0, 0)
        return s, n, s * 1e3 / max(n, 1)


def serve_main_path(dev):
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.models import transformer as T
    from repro_torch.runtime.api import BatchMaster, BatchRequest
    from repro_torch.runtime.engine import NodeEngine

    cfg = get_config("llama3_2_1b")
    page = 16
    t0 = time.perf_counter()
    eng = NodeEngine(cfg, max_active=8, max_len=2048, page_size=page,
                     seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"  engine + weights ({T.param_count(cfg) / 1e9:.3f} B params, "
        f"{cfg.dtype}) {time.perf_counter() - t0:.2f} s")
    master = BatchMaster([eng], SchedulerConfig(page_size=page))
    rng = np.random.default_rng(0)

    def prompt(n):
        return [int(t) for t in rng.integers(2, cfg.vocab_size, n)]

    # warm-up: one short request (below a page, so nothing is published)
    master.run(master.submit([BatchRequest("warm", prompt(8), 4)]))

    lens = [8, 24, 40, 64, 96, 128, 192, 256]
    outs = [16, 24, 32, 40, 48, 56, 64, 20]
    first = [BatchRequest(f"r{i}", prompt(n), m)
             for i, (n, m) in enumerate(zip(lens, outs))]
    # a resubmitted prefix: 15 shared pages of r7, then a new tail
    second = [BatchRequest("p0", first[7].prompt[:15 * page] + prompt(20),
                           32)]
    clock = _PageClock(eng)
    saved0 = eng.prefill_tokens_saved

    reset_counts()                              # the greedy path alone
    t0 = time.perf_counter()
    results = []
    for batch in (first, second):
        bo = master.run(master.submit(batch))
        results += bo.results
        if bo.request_counts["completed"] != len(batch) or \
                bo.request_counts["failed"]:
            raise AssertionError(f"requests not completed: "
                                 f"{bo.request_counts}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    clock.restore()

    want = {r.custom_id: r.max_tokens for r in first + second}
    vpad = T.padded_vocab(cfg)
    for row in results:
        toks = row["response"]["tokens"]
        if len(toks) != want[row["custom_id"]] or \
                not all(0 <= t < vpad for t in toks):
            raise AssertionError(f"{row['custom_id']}: bad tokens {toks}")
    saved = eng.prefill_tokens_saved - saved0
    if saved <= 0:
        raise AssertionError("the resubmitted prefix was not reused")
    check_launches("the greedy path", launches, DENSE_GREEDY)
    check_routes("the greedy path", launches)
    # the model's logits on a short prompt: finite, of the padded vocab
    logits, _ = T.prefill(cfg, eng.params, torch.tensor(
        [first[0].prompt], dtype=torch.int32, device=dev))
    if logits.shape != (1, 1, vpad) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits {tuple(logits.shape)}")

    out_tokens = sum(len(r["response"]["tokens"]) for r in results)
    pf_s, pf_tok, _ = clock.per_step("prefill")
    dc_s, dc_steps, dc_ms = clock.per_step("decode")
    log(f"  greedy: served {len(results)} requests, {out_tokens} output "
        f"tokens in {wall:.3f} s: {out_tokens / wall:.1f} output tokens/s")
    log(f"  greedy: prefill {pf_s * 1e3:.1f} ms for {pf_tok} prompt tokens "
        f"(prefix reuse saved {saved}); decode {dc_s * 1e3:.1f} ms for "
        f"{dc_steps} steps = {dc_ms:.2f} ms/step (greedy pages)")
    log("  greedy: prefill calls (ms, prompt tokens forwarded): "
        + ", ".join(f"({s * 1e3:.1f}, {n})"
                    for s, n in clock.spans["prefill"]))
    log(f"  kernel launches on the greedy path: {launches}")
    sampled = serve_sampled_path(dev, eng, master, prompt)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"  peak device memory {peak:.2f} GB")
    return launches, sampled


def serve_sampled_path(dev, eng, master, prompt):
    """The sampled path on the same engine: 8 requests of mixed
    SamplingParams, submitted twice with identical streams required."""
    from repro_torch import kernels
    from repro_torch.models import transformer as T
    from repro_torch.runtime.api import BatchRequest
    from repro_torch.sampling import SamplingParams

    cfg = eng.cfg
    prompts = [prompt(n) for n in (16, 40, 64, 96, 128, 24, 200, 48)]
    outs = [12, 40, 48, 32, 24, 40, 36, 44]
    sps = [SamplingParams(),                            # greedy rider
           SamplingParams(temperature=0.6, top_p=0.9, seed=1),
           SamplingParams(temperature=0.8, top_k=40, seed=2),
           SamplingParams(temperature=0.7, min_p=0.05, seed=3),
           SamplingParams(temperature=0.9, repetition_penalty=1.2,
                          presence_penalty=0.3, frequency_penalty=0.2,
                          seed=4),
           SamplingParams(temperature=1.0, top_k=50, top_p=0.95, seed=5),
           None,                                         # the stop row
           SamplingParams(temperature=0.8, top_p=0.8, seed=7)]

    def batch(stop):
        rows = []
        for i, (pr, m, sp) in enumerate(zip(prompts, outs, sps)):
            if sp is None:
                sp = SamplingParams(temperature=0.9, top_k=100, seed=6,
                                    stop=stop)
            rows.append(BatchRequest(f"s{i}", pr, m, sampling=sp,
                                     logprobs=i == 3, top_logprobs=5
                                     if i == 3 else 0))
        return rows

    def serve(reqs):
        bo = master.run(master.submit(reqs))
        if bo.request_counts["completed"] != len(reqs) or \
                bo.request_counts["failed"]:
            raise AssertionError(f"sampled requests not completed: "
                                 f"{bo.request_counts}")
        return {r["custom_id"]: r["response"] for r in bo.results}

    # a probe run without the stop set picks a token the stop row emits;
    # a first pass publishes the prompts, so the probe and the measured
    # runs all take the prefix-hit path (in bf16 a fresh prefill and a
    # teacher-forced tail may round a first token differently)
    serve(batch(()))
    probe = serve(batch(()))
    stop_tok = probe["s6"]["tokens"][5]
    runs, clocks, walls, launch = [], [], [], []
    for _ in range(2):
        clock = _PageClock(eng)
        reset_counts()                          # the sampled path alone
        t0 = time.perf_counter()
        runs.append(serve(batch((stop_tok,))))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launch.append(kernels.launches())
        check_routes("the sampled path", launch[-1])
        clock.restore()
        clocks.append(clock)
    check_launches("the sampled path", launch[0], DENSE_SAMPLED)
    if runs[0] != runs[1]:
        raise AssertionError("the resubmitted sampled batch gave other "
                             "streams")
    vpad = T.padded_vocab(cfg)
    for cid, resp in runs[0].items():
        toks = resp["tokens"]
        if not toks or not all(0 <= t < vpad for t in toks):
            raise AssertionError(f"{cid}: bad tokens {toks}")
    s6 = runs[0]["s6"]["tokens"]
    idx = probe["s6"]["tokens"].index(stop_tok)
    if s6 != probe["s6"]["tokens"][:idx + 1] or \
            runs[0]["s6"]["finish_reason"] != "stop":
        raise AssertionError(f"the stop row did not stop at {stop_tok}: "
                             f"{s6}")
    for cid in runs[0]:
        if cid != "s6" and runs[0][cid]["tokens"] != probe[cid]["tokens"]:
            raise AssertionError(f"{cid}: the stop row changed a "
                                 f"neighbour's stream")
    lp = runs[0]["s3"]["logprobs"]
    if len(lp["token_logprobs"]) != outs[3] or \
            any(len(row) != 5 for row in lp["top_logprobs"]) or \
            not all(math.isfinite(v) and v <= 0
                    for v in lp["token_logprobs"]):
        raise AssertionError(f"bad logprobs {lp['token_logprobs'][:4]}")
    out_tokens = sum(len(r["tokens"]) for r in runs[0].values())
    for i, (clock, wall) in enumerate(zip(clocks, walls)):
        s_s, s_n, s_ms = clock.per_step("sampled")
        g_s, g_n, g_ms = clock.per_step("decode")
        log(f"  sampled run {i}: {out_tokens} output tokens in {wall:.3f} "
            f"s: {out_tokens / wall:.1f} output tokens/s; decode "
            f"{s_ms:.2f} ms/step over {s_n} sampled steps, {g_ms:.2f} "
            f"ms/step over {g_n} greedy steps")
    log(f"  sampled: streams identical over two submits; the stop row "
        f"stopped at token {stop_tok} after {len(s6)} tokens; top-5 "
        f"logprobs on s3")
    log(f"  kernel launches on the sampled path: {launch[0]}")
    return launch[0]


# ---------------------------------------------------------------- phase 5
def _to(tree, target):
    return {k: _to(v, target) if isinstance(v, dict) else v.to(target)
            for k, v in tree.items()}


def reduced_cpu_vs_cuda(dev):
    from repro_torch.sampling import SamplingParams

    sps = [SamplingParams(), SamplingParams(),
           SamplingParams(temperature=0.8, top_k=20, seed=1),
           SamplingParams(temperature=1.1, top_p=0.9, min_p=0.02, seed=2),
           SamplingParams(temperature=0.7, repetition_penalty=1.3,
                          presence_penalty=0.2, seed=3, stop=(5, 6))]
    _reduced_pair(dev, "llama3_2_1b", {}, sps, DENSE_SAMPLED)
    _reduced_pair(dev, "qwen3_moe_30b",
                  dict(module_granularity=True, b_attn=2), sps, MOE_SAMPLED)
    # MLA at DeepSeek-R1's head dims, so its prefill runs the fp32 flash
    # kernel at q/k 192, v 128; monolithic (module granularity refuses MLA)
    _reduced_pair(dev, "deepseek_r1", {}, sps, MLA_SAMPLED,
                  over=dict(head_dim=MLA_HEADS[1],
                            rope_head_dim=MLA_HEADS[0] - MLA_HEADS[1]),
                  flash_dims=MLA_HEADS)
    _reduced_ssm_pair(dev)
    # the windowed decoders at the published head dims, so their prefill
    # runs the fp32 flash kernel at (80, 80) and (256, 256)
    _reduced_windowed_pair(dev, "h2o_danube_1_8b", 80)
    _reduced_windowed_pair(dev, "recurrentgemma_2b", 256)
    # the encoder-decoder and the vision decoder at their published head
    # dims and groups: Whisper's MHA of 64 (G = 1), Pixtral's 128 (G = 4)
    _reduced_encdec_pair(dev, "whisper_base",
                         dict(num_heads=4, num_kv_heads=4, head_dim=64))
    _reduced_encdec_pair(dev, "pixtral_12b",
                         dict(num_heads=8, num_kv_heads=2, head_dim=128))
    _reduced_train_pair(dev, "smollm_360m")
    # the MoE family: the grouped GEMM's forward, dX and weight gradient
    # (fp32: near-ties in top-k would make bf16 routing differ)
    _reduced_train_pair(dev, "qwen3_moe_30b")
    # the windowed decoder at Danube's head dim 80, S 160 past its reduced
    # window of 64: the backward kernel with a window at D 80
    _reduced_train_pair(dev, "h2o_danube_1_8b", over=dict(head_dim=80),
                        S=160)
    # the SSM: the scan under SsdScanFn and its backward kernel
    _reduced_train_pair(dev, "mamba2_370m")


def _reduced_train_pair(dev, arch, over=None, S=128):
    """A reduced fp32 model (``over`` replacing fields) trained on "cuda"
    (the flash forward with lse, the backward kernel and for MoE the
    grouped GEMM and its weight gradient, fp32 on the CUDA cores) and on
    "cpu" (the plain versions): ``forward_loss`` and every leaf's gradient
    (loss rtol 1e-5; gradients atol 1e-4, rtol 1e-3, as the CPU tests hold
    the port to JAX), then one ``train_step`` each: its loss and grad norm
    (rtol 1e-5) and the AdamW moments m and v it leaves, which carry the
    gradients (atol 1e-6, rtol 1e-3; the params themselves move by about
    lr * sign(g) in a first step, either way where g ~ 0).  Remat launches
    the flash forward twice a layer and the backward once; an MoE layer's
    grouped GEMM 9 times (3 forward, 3 recomputed, 3 dX) and its weight
    gradient 3 times; an SSM layer (no attention) its scan twice and the
    scan's backward once."""
    from repro_torch import kernels, optim
    from repro_torch.configs import reduced_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention_bwd import ops as bwd_ops
    from repro_torch.kernels.moe_gemm import ops as moe_ops
    from repro_torch.kernels.moe_gemm_wgrad import ops as wgrad_ops
    from repro_torch.launch.steps import loss_and_grads, train_step
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32",
                              **(over or {}))
    L = cfg.num_layers
    gen = torch.Generator().manual_seed(13)
    toks = torch.randint(2, cfg.vocab_size, (4, S), generator=gen,
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    params = {"cpu": T.init_params(cfg, seed=3, device="cpu")}
    params["cuda"] = optim.tree_map(lambda t: t.to(dev), params["cpu"])
    got = {}
    for device, pt in params.items():
        b = {k: t.to(pt["embed"].device) for k, t in batch.items()}
        reset_counts()
        loss, grads = loss_and_grads(cfg, pt, b)
        used = kernels.launches()
        if cfg.family == "ssm":
            want = {"ssd_scan": 2 * L, "ssd_scan_bwd": L}
        else:
            want = {"flash_attention": 2 * L, "flash_attention_bwd": L}
        if cfg.is_moe:
            want.update(moe_gemm=9 * L, moe_gemm_wgrad=3 * L)
        if device == "cpu":
            want = {}
        if {k: n for k, n in used.items() if n} != want or (
                device == "cuda" and (
                    ops.ROUTE_LAUNCHES != {
                        "wgmma": 0, "simt": want.get("flash_attention", 0)}
                    or bwd_ops.ROUTE_LAUNCHES != {
                        "simt": want.get("flash_attention_bwd", 0),
                        "wgmma": 0}
                    or moe_ops.ROUTE_LAUNCHES["simt"] !=
                    want.get("moe_gemm", 0)
                    or wgrad_ops.ROUTE_LAUNCHES["simt"] !=
                    want.get("moe_gemm_wgrad", 0))):
            raise AssertionError(f"reduced {arch} training on {device}: "
                                 f"launches {used}, flash routes "
                                 f"{ops.ROUTE_LAUNCHES}, backward routes "
                                 f"{bwd_ops.ROUTE_LAUNCHES}, grouped GEMM "
                                 f"routes {moe_ops.ROUTE_LAUNCHES}, weight "
                                 f"gradient routes "
                                 f"{wgrad_ops.ROUTE_LAUNCHES} (expected "
                                 f"{want}, all fp32)")
        opt = optim.init_opt_state(pt)
        out = train_step(cfg, pt, opt, b, optim.AdamWConfig(lr=1e-3,
                                                            zero1=False))
        got[device] = (loss, optim.tree_leaves(grads), out, opt)
    (lc, gc_, oc, optc), (lg, gg, og, optg) = got["cpu"], got["cuda"]
    gerr = max((a.cpu() - b).abs().max().item() for a, b in zip(gg, gc_))
    ok = torch.allclose(lg.cpu(), lc, rtol=1e-5, atol=0) and all(
        torch.allclose(a.cpu(), b, atol=1e-4, rtol=1e-3)
        for a, b in zip(gg, gc_))
    for key in ("loss", "grad_norm"):
        ok &= torch.allclose(og[key].cpu(), oc[key], rtol=1e-5, atol=0)
    merr = 0.0
    for (_, a), (_, b) in zip(optim._pairs(params["cuda"], optg["leaves"]),
                              optim._pairs(params["cpu"], optc["leaves"])):
        for key in ("m", "v"):
            merr = max(merr, (a[key].cpu() - b[key]).abs().max().item())
            ok &= torch.allclose(a[key].cpu(), b[key], atol=1e-6, rtol=1e-3)
    log(f"  reduced {arch} fp32 training (S {S}): loss cuda {lg.item():.6f} "
        f"cpu "
        f"{lc.item():.6f}, {len(gg)} leaf gradients max abs err "
        f"{gerr:.3e}; train_step loss {og['loss'].item():.6f} / "
        f"{oc['loss'].item():.6f}, grad norm {og['grad_norm'].item():.6f} / "
        f"{oc['grad_norm'].item():.6f}, AdamW moments max abs err "
        f"{merr:.3e}; launches {want} "
        f"(remat), all fp32 {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"reduced {arch}: training on cuda differs "
                             f"from cpu")


def _reduced_pair(dev, arch, engine_kw, sps, expected, over=None,
                  flash_dims=None):
    """The reduced fp32 model (``over`` replacing fields) served on "cuda"
    (the kernels) and on "cpu" (the plain versions): the tokens of one page
    must be identical.  With ``flash_dims`` every flash launch on "cuda"
    must be at those (q/k, v) head dims, on the fp32 route."""
    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.kernels.moe_gemm import ops as moe_ops
    from repro_torch.models import transformer as T
    from repro_torch.runtime.api import BatchMaster, BatchRequest
    from repro_torch.runtime.engine import NodeEngine

    cfg = dataclasses.replace(reduced_config(arch), dtype="float32",
                              **(over or {}))
    params = T.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    reqs = [(f"s{i}", [int(t) for t in rng.integers(2, cfg.vocab_size, n)],
             sp) for i, (n, sp) in enumerate(zip([5, 12, 16, 23, 9], sps))]
    page = 16
    out = {}
    for device in ("cuda", "cpu"):
        target = dev if device == "cuda" else torch.device("cpu")
        eng = NodeEngine(cfg, params=_to(params, target), max_active=4,
                         max_len=128, page_size=page, device=target,
                         **engine_kw)
        master = BatchMaster([eng], SchedulerConfig(page_size=page))
        moe_ops.reset_routes()
        before = kernels.launches()
        shapes = _FlashShapes()
        try:
            bo = master.run(master.submit(
                [BatchRequest(c, pr, page, sampling=sp)
                 for c, pr, sp in reqs]))
        finally:
            shapes.restore()
        after = kernels.launches()
        used = {k: after[k] - before[k] for k in after}
        if moe_ops.ROUTE_LAUNCHES != {"wgmma": 0, "mma": 0,
                                      "simt": used["moe_gemm"]}:
            raise AssertionError(f"reduced fp32 {arch}: moe_gemm launches "
                                 f"by route {moe_ops.ROUTE_LAUNCHES} (fp32 "
                                 f"takes simt)")
        out[device] = {r["custom_id"]: r["response"]["tokens"]
                       for r in bo.results}
        log(f"  {arch} {engine_kw} {device}: {bo.request_counts}, kernel "
            f"launches {used}")
        check_launches(f"reduced {arch} on {device}", used,
                       expected if device == "cuda" else ())
        if flash_dims is not None and device == "cuda":
            shapes.check(f"reduced {arch} on cuda", flash_dims, "simt")
    if out["cuda"] != out["cpu"]:
        raise AssertionError(f"{arch}: tokens differ: cuda {out['cuda']} "
                             f"vs cpu {out['cpu']}")
    log(f"  {arch}: greedy and sampled tokens of one page identical for "
        f"{len(reqs)} requests")


def _reduced_ssm_pair(dev):
    """Reduced fp32 Mamba-2 at model level (``launch/model_level.py``:
    prefill, then decode pages) on "cuda" (the scan kernel, the sampling
    kernel on sampled pages) and on "cpu" (the plain versions): greedy and
    sampled tokens must be identical, and the prefill's state must agree
    to atol/rtol 1e-4 (cuBLAS and the CPU sum the products in other
    orders; the scan itself gives its plain version's bits)."""
    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.launch.model_level import generate
    from repro_torch.models import transformer as T
    from repro_torch.sampling import SamplingParams

    cfg = dataclasses.replace(reduced_config("mamba2_370m"), dtype="float32")
    params = T.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    prompts = rng.integers(2, cfg.vocab_size, (4, 128)).tolist()
    sps = [SamplingParams(), SamplingParams(temperature=0.8, top_k=20,
                                            seed=1),
           SamplingParams(temperature=1.1, top_p=0.9, min_p=0.02, seed=2),
           SamplingParams(temperature=0.7, repetition_penalty=1.3,
                          presence_penalty=0.2, seed=3, stop=(5, 6))]
    out, state = {}, {}
    for device in ("cuda", "cpu"):
        target = dev if device == "cuda" else torch.device("cpu")
        p = _to(params, target)
        before = kernels.launches()
        g = generate(cfg, p, prompts, [16, 5, 12, 16])
        used_g = {k: v - before[k] for k, v in kernels.launches().items()}
        before = kernels.launches()
        smp_out = generate(cfg, p, prompts, 16, sampling=sps)
        used_s = {k: v - before[k] for k, v in kernels.launches().items()}
        _, cache = T.prefill(cfg, p, torch.tensor(prompts, dtype=torch.int32,
                                                  device=target))
        state[device] = cache["state"].cpu()
        out[device] = (g.tokens, smp_out.tokens)
        log(f"  mamba2_370m (reduced, model level) {device}: kernel "
            f"launches greedy {used_g}, sampled {used_s}")
        check_launches(f"reduced mamba2 greedy on {device}", used_g,
                       SSM_GREEDY if device == "cuda" else ())
        check_launches(f"reduced mamba2 sampled on {device}", used_s,
                       SSM_SAMPLED if device == "cuda" else ())
    if out["cuda"] != out["cpu"]:
        raise AssertionError(f"mamba2: tokens differ: cuda {out['cuda']} "
                             f"vs cpu {out['cpu']}")
    err = (state["cuda"] - state["cpu"]).abs().max().item()
    if not torch.allclose(state["cuda"], state["cpu"], atol=1e-4,
                          rtol=1e-4):
        raise AssertionError(f"mamba2: prefill state differs, max abs err "
                             f"{err}")
    log(f"  mamba2_370m: greedy and sampled tokens identical for "
        f"{len(prompts)} prompts of 128; prefill state max abs err "
        f"{err:.3e}")


def _reduced_windowed_pair(dev, arch, head_dim):
    """A reduced fp32 windowed decoder (window 64) at head dim
    ``head_dim`` at model level (``generate``: prefill, the rings
    re-laid, decode pages) on "cuda" (the flash kernel's fp32 route at
    (head_dim, head_dim), the sampling kernel on sampled pages; ring
    decode is PyTorch) and on "cpu" (the plain versions): 4 prompts of 96
    tokens, past the window, decoded past its wrap; greedy and sampled
    tokens must be identical."""
    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.launch.model_level import generate
    from repro_torch.models import transformer as T
    from repro_torch.sampling import SamplingParams

    cfg = dataclasses.replace(reduced_config(arch), dtype="float32",
                              head_dim=head_dim)
    params = T.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    prompts = rng.integers(2, cfg.vocab_size, (4, 96)).tolist()
    sps = [SamplingParams(), SamplingParams(temperature=0.8, top_k=20,
                                            seed=1),
           SamplingParams(temperature=1.1, top_p=0.9, min_p=0.02, seed=2),
           SamplingParams(temperature=0.7, repetition_penalty=1.3,
                          presence_penalty=0.2, seed=3, stop=(5, 6))]
    out = {}
    for device in ("cuda", "cpu"):
        target = dev if device == "cuda" else torch.device("cpu")
        p = _to(params, target)
        shapes = _FlashShapes()
        try:
            before = kernels.launches()
            g = generate(cfg, p, prompts, [16, 5, 12, 40])
            used_g = {k: v - before[k] for k, v in kernels.launches().items()}
            before = kernels.launches()
            smp_out = generate(cfg, p, prompts, 40, sampling=sps)
            used_s = {k: v - before[k] for k, v in kernels.launches().items()}
        finally:
            shapes.restore()
        out[device] = (g.tokens, smp_out.tokens)
        log(f"  {arch} (reduced, head dim {head_dim}, model level) {device}:"
            f" kernel launches greedy {used_g}, sampled {used_s}")
        check_launches(f"reduced {arch} greedy on {device}", used_g,
                       WINDOW_GREEDY if device == "cuda" else ())
        check_launches(f"reduced {arch} sampled on {device}", used_s,
                       WINDOW_SAMPLED if device == "cuda" else ())
        if device == "cuda":
            shapes.check(f"reduced {arch} on cuda", (head_dim, head_dim),
                         "simt")
    if out["cuda"] != out["cpu"]:
        raise AssertionError(f"{arch}: tokens differ: cuda {out['cuda']} vs "
                             f"cpu {out['cpu']}")
    log(f"  {arch}: greedy and sampled tokens identical for {len(prompts)} "
        f"prompts of 96 (window 64), decoded to position 135")


def _reduced_encdec_pair(dev, arch, over):
    """Reduced fp32 Whisper (32 stub frames) or Pixtral (8 stub patches)
    with the fields ``over`` replaced, at model level (``generate``:
    prefill, the cache installed, decode pages) on "cuda" (the flash
    kernel's fp32 route, non-causal in Whisper's encoder and
    cross-attention; ``paged_attention`` for every decode attention,
    twice a layer in Whisper; the sampling kernel on sampled pages) and
    on "cpu" (the plain versions): 4 prompts of 24, greedy and sampled
    tokens must be identical."""
    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.launch.model_level import generate
    from repro_torch.models import transformer as T
    from repro_torch.sampling import SamplingParams

    cfg = dataclasses.replace(reduced_config(arch), dtype="float32", **over)
    params = T.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    prompts = rng.integers(2, cfg.vocab_size, (4, 24)).tolist()
    n = cfg.encoder_seq if cfg.family == "audio" else cfg.num_patches
    stub = (rng.standard_normal((4, n, cfg.d_model)) * 0.02).astype(
        np.float32)
    extra = {"frames" if cfg.family == "audio" else "patches": stub}
    sps = [SamplingParams(), SamplingParams(temperature=0.8, top_k=20,
                                            seed=1),
           SamplingParams(temperature=1.1, top_p=0.9, min_p=0.02, seed=2),
           SamplingParams(temperature=0.7, repetition_penalty=1.3,
                          presence_penalty=0.2, seed=3, stop=(5, 6))]
    G, D = cfg.num_heads // cfg.num_kv_heads, cfg.head_dim
    out = {}
    for device in ("cuda", "cpu"):
        target = dev if device == "cuda" else torch.device("cpu")
        p = _to(params, target)
        shapes, paged = _FlashShapes(), _PagedShapes()
        try:
            before = kernels.launches()
            g = generate(cfg, p, prompts, [16, 5, 12, 40], **extra)
            used_g = {k: v - before[k] for k, v in kernels.launches().items()}
            before = kernels.launches()
            smp_out = generate(cfg, p, prompts, 40, sampling=sps, **extra)
            used_s = {k: v - before[k] for k, v in kernels.launches().items()}
        finally:
            shapes.restore()
            paged.restore()
        out[device] = (g.tokens, smp_out.tokens)
        log(f"  {arch} (reduced, G {G}, D {D}, model level) {device}: "
            f"kernel launches greedy {used_g}, sampled {used_s}")
        check_launches(f"reduced {arch} greedy on {device}", used_g,
                       DENSE_GREEDY if device == "cuda" else ())
        check_launches(f"reduced {arch} sampled on {device}", used_s,
                       DENSE_SAMPLED if device == "cuda" else ())
        if device == "cuda":
            shapes.check(f"reduced {arch} on cuda", (D, D), "simt")
            want_nc = 2 * (cfg.encoder_layers + cfg.num_layers) \
                if cfg.family == "audio" else 0
            if shapes.non_causal != want_nc:
                raise AssertionError(f"reduced {arch}: {shapes.non_causal} "
                                     f"non-causal flash launches, expected "
                                     f"{want_nc}")
            bad = [x for x in paged.seen if x[:2] != (G, D)
                   or x[3] != "simt"]
            if bad or not paged.seen:
                raise AssertionError(f"reduced {arch}: paged launches (G, "
                                     f"D, keys, route) off ({G}, {D}, ., "
                                     f"simt): {bad[:4]}")
    if out["cuda"] != out["cpu"]:
        raise AssertionError(f"{arch}: tokens differ: cuda {out['cuda']} vs "
                             f"cpu {out['cpu']}")
    log(f"  {arch}: greedy and sampled tokens identical for {len(prompts)} "
        f"prompts of 24 after {n} stub {next(iter(extra))}")


# ---------------------------------------------------------------- phase 6
def serve_moe_path(dev):
    """Full-width Qwen3-30B-A3B through one module-granularity engine:
    greedy, then sampled twice; then the greedy batch on a monolithic
    engine sharing the weights.  Returns the greedy and sampled launch
    counts."""
    from repro_torch import kernels
    from repro_torch.configs import default_sampling, get_config
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.models import transformer as T
    from repro_torch.runtime.api import BatchMaster, BatchRequest
    from repro_torch.runtime.engine import NodeEngine

    cfg = get_config("qwen3_moe_30b")
    page = 16
    kw = dict(max_active=8, max_len=2048, page_size=page, device=dev)
    t0 = time.perf_counter()
    eng = NodeEngine(cfg, seed=0, module_granularity=True, b_attn=4, **kw)
    torch.cuda.synchronize()
    log(f"  engine + weights ({T.param_count(cfg) / 1e9:.2f} B params, "
        f"{T.param_count(cfg, active_only=True) / 1e9:.2f} B active, "
        f"{cfg.dtype}) {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
    rng = np.random.default_rng(6)
    vpad = T.padded_vocab(cfg)

    def prompt(n):
        return [int(t) for t in rng.integers(2, cfg.vocab_size, n)]

    def serve(engine, reqs, tag, prefill=False):
        master = BatchMaster([engine], SchedulerConfig(page_size=page))
        clock = _PageClock(engine)
        gemms = _GemmRoutes()
        reset_counts()
        t = time.perf_counter()
        try:
            bo = master.run(master.submit(reqs))
        finally:
            gemms.restore()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        used = kernels.launches()
        check_routes(tag, used)
        gemms.check(tag, prefill)
        clock.restore()
        if bo.request_counts["completed"] != len(reqs) or \
                bo.request_counts["failed"]:
            raise AssertionError(f"{tag}: requests not completed: "
                                 f"{bo.request_counts}")
        out = {r["custom_id"]: r["response"] for r in bo.results}
        for cid, resp in out.items():
            toks = resp["tokens"]
            if not toks or not all(0 <= t < vpad for t in toks):
                raise AssertionError(f"{tag} {cid}: bad tokens {toks}")
        n_out = sum(len(r["tokens"]) for r in out.values())
        pf_s, pf_tok, _ = clock.per_step("prefill")
        kind = "decode" if tag.startswith("greedy") else "sampled"
        dc_s, dc_steps, dc_ms = clock.per_step(kind)
        log(f"  {tag}: {len(out)} requests, {n_out} output tokens in "
            f"{wall:.3f} s: {n_out / wall:.1f} output tokens/s; prefill "
            f"{pf_s * 1e3:.1f} ms for {pf_tok} prompt tokens; decode "
            f"{dc_ms:.2f} ms/step over {dc_steps} steps; launches {used}")
        return out, used, dict(wall=wall, tokens=n_out, prefill_ms=pf_s * 1e3,
                               decode_ms=dc_ms, steps=dc_steps)

    serve(eng, [BatchRequest("warm", prompt(8), 4)], "greedy warm-up")
    lens = [8, 24, 40, 64, 96, 128, 192, 256]
    outs = [16, 20, 24, 28, 32, 36, 40, 48]
    prompts = [prompt(n) for n in lens]
    greedy = [BatchRequest(f"g{i}", pr, m)
              for i, (pr, m) in enumerate(zip(prompts, outs))]
    g_out, g_used, g_num = serve(eng, greedy, "greedy, module granularity",
                                 prefill=True)
    check_launches("the MoE greedy path", g_used, MOE_GREEDY)
    for r in greedy:
        if len(g_out[r.custom_id]["tokens"]) != r.max_tokens:
            raise AssertionError(f"{r.custom_id}: "
                                 f"{len(g_out[r.custom_id]['tokens'])} "
                                 f"tokens, asked for {r.max_tokens}")

    sampled = [BatchRequest(f"s{i}", pr, m, sampling=default_sampling(
        "qwen3_moe_30b", seed=100 + i))
        for i, (pr, m) in enumerate(zip(prompts, outs))]
    runs = [serve(eng, sampled, f"sampled run {j}, module granularity")
            for j in range(2)]
    check_launches("the MoE sampled path", runs[0][1], MOE_SAMPLED)
    if runs[0][0] != runs[1][0]:
        raise AssertionError("the resubmitted sampled MoE batch gave other "
                             "streams")
    log(f"  sampled ({default_sampling('qwen3_moe_30b')}): streams "
        f"identical over two submits")

    logits, _ = T.prefill(cfg, eng.params, torch.tensor(
        [prompts[0]], dtype=torch.int32, device=dev))
    if logits.shape != (1, 1, vpad) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad MoE logits {tuple(logits.shape)}")

    mono = NodeEngine(cfg, params=eng.params, **kw)
    serve(mono, [BatchRequest("warm", prompt(8), 4)], "greedy warm-up")
    m_out, m_used, m_num = serve(mono, greedy, "greedy, monolithic",
                                 prefill=True)
    check_launches("the MoE monolithic path", m_used, MOE_GREEDY)
    agree = sum(m_out[c]["tokens"] == g_out[c]["tokens"] for c in g_out)
    log(f"  monolithic vs module granularity: {agree} of {len(g_out)} "
        f"greedy streams identical (bf16: not a gate)")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"  peak device memory {peak:.2f} GB")
    return g_used, runs[0][1]


# ---------------------------------------------------------------- phase 7
def _ssd_peak_estimate(cfg, b: int, s: int) -> int:
    """Bytes of the fp32 intermediates one layer's ``ssd_chunked`` holds at
    its peak: x in chunks, the (b, h, nc, Q, Q) mask weights and their
    product with C.B, y, the chunk states and ``prev``, and B or C
    broadcast to every head inside a product."""
    h, p, n, Q = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, min(64, s)
    nc = s // Q
    return 4 * (3 * b * h * s * p + 3 * b * h * nc * Q * Q
                + 2 * b * h * nc * n * p + b * h * nc * Q * n)


def serve_ssm_path(dev):
    """Full-width Mamba2-370M (bf16, random weights from seed 0) at model
    level: 8 prompts of 256 greedy, the same prompts sampled twice
    (identical streams required, top-5 logprobs), then one 32768-token
    prompt and 16 greedy decode steps.  Returns the path's launch
    counts (every count set to 0 after the warm-up)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.model_level import generate
    from repro_torch.models import transformer as T
    from repro_torch.sampling import SamplingParams

    cfg = get_config("mamba2_370m")
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"  weights ({T.param_count(cfg) / 1e6:.3f} M params, {cfg.dtype}) "
        f"{time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated")
    rng = np.random.default_rng(7)
    vpad = T.padded_vocab(cfg)
    generate(cfg, params, rng.integers(2, cfg.vocab_size, (1, 64)).tolist(),
             4)                                         # warm-up
    torch.cuda.synchronize()

    def run(tag, prompts, outs, expected, **kw):
        before = kernels.launches()
        torch.cuda.reset_peak_memory_stats(dev)
        g = generate(cfg, params, prompts, outs, **kw)
        used = {k: v - before[k] for k, v in kernels.launches().items()}
        check_launches(f"the SSM path, {tag}", used, expected)
        want = np.broadcast_to(np.asarray(outs), (len(prompts),))
        for i, toks in enumerate(g.tokens):
            if len(toks) != want[i] or not all(0 <= t < vpad for t in toks):
                raise AssertionError(f"{tag} row {i}: bad tokens {toks}")
        wall = g.prefill_s + g.decode_s
        log(f"  {tag}: prefill {g.prefill_s * 1e3:.1f} ms for "
            f"{len(prompts)}x{len(prompts[0])} tokens; decode "
            f"{g.decode_s * 1e3 / g.decode_steps:.2f} ms/step over "
            f"{g.decode_steps} steps ({g.pages} pages); {g.out_tokens} "
            f"output tokens in {wall:.3f} s: {g.out_tokens / wall:.1f} "
            f"output tokens/s; peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; "
            f"launches {used}")
        return g, used

    kernels.reset_launches()                    # the SSM path alone
    prompts = rng.integers(2, cfg.vocab_size, (8, 256)).tolist()
    outs = [16, 20, 24, 28, 32, 36, 40, 48]
    run("greedy 8x256", prompts, outs, SSM_GREEDY)
    sps = [SamplingParams(temperature=0.8, top_k=40, top_p=0.95,
                          seed=100 + i) for i in range(8)]
    runs = [run(f"sampled run {j}, 8x256", prompts, outs, SSM_SAMPLED,
                sampling=sps, lp_k=5)[0] for j in range(2)]
    if runs[0].tokens != runs[1].tokens or \
            runs[0].logprobs != runs[1].logprobs:
        raise AssertionError("the resubmitted sampled SSM batch gave other "
                             "streams")
    chosen, vals, ids = runs[0].logprobs[3]
    if len(chosen) != outs[3] or any(len(v) != 5 for v in vals) or \
            not all(math.isfinite(c) and c <= 0 for c in chosen):
        raise AssertionError(f"bad SSM logprobs {chosen[:4]}")
    log("  sampled (T 0.8, top-k 40, top-p 0.95, a seed a row): streams "
        "and top-5 logprob planes identical over two submits")
    S = 32768
    est = _ssd_peak_estimate(cfg, 1, S)
    long_prompt = rng.integers(2, cfg.vocab_size, (1, S)).tolist()
    g, used = run(f"greedy 1x{S}", long_prompt, 17, SSM_GREEDY)
    if used["ssd_scan"] != cfg.num_layers:
        raise AssertionError(f"the {S}-token prefill launched ssd_scan "
                             f"{used['ssd_scan']} times, not once a layer")
    log(f"  {S}-token prompt: one layer's ssd_chunked intermediates "
        f"reckoned at {est / 1e9:.2f} GB (fp32); the weights "
        f"{T.param_count(cfg) * 2 / 1e9:.2f} GB")
    launches = kernels.launches()
    logits, cache = T.prefill(cfg, params, torch.tensor(
        [prompts[0]], dtype=torch.int32, device=dev))
    if logits.shape != (1, 1, vpad) or not torch.isfinite(logits).all() \
            or not torch.isfinite(cache["state"]).all():
        raise AssertionError(f"bad SSM logits {tuple(logits.shape)}")
    log(f"  kernel launches on the SSM path: {launches}")
    return launches


# ---------------------------------------------------------------- phase 8
JOB_N = 48


def write_job_input(path: Path, vocab: int) -> None:
    """Phase 8's job: 48 long-tail requests (prompts ~Poisson(128) up to
    1024, budgets lognormal of mean 48 up to 256); every fourth samples
    (T 0.8, seed 1000 + i)."""
    from repro_torch.data.pipeline import LongTailRequestStream
    with open(path, "w", encoding="utf-8", newline="\n") as f:
        for i, r in enumerate(LongTailRequestStream(
                JOB_N, seed=0, mean_in=128, mean_out=48, vocab=vocab,
                max_in_cap=1024, max_out_cap=256)):
            if i % 4 == 3:
                r["body"].update(temperature=0.8, seed=1000 + i)
            f.write(json.dumps(r) + "\n")


def _serve_tokens(cfg, params, dev, reqs):
    """{custom_id: tokens} of ``reqs`` served as one submit on a fresh
    engine (no prefix index carried over) sharing ``params``."""
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.launch import job
    from repro_torch.runtime.api import BatchMaster
    from repro_torch.runtime.engine import NodeEngine
    eng = NodeEngine(cfg, params=params, device=dev, **job.ENGINE)
    master = BatchMaster([eng], SchedulerConfig(page_size=16))
    bo = master.run(master.submit(reqs))
    if bo.request_counts["completed"] != len(reqs):
        raise AssertionError(f"probe requests not completed: "
                             f"{bo.request_counts}")
    return {r["custom_id"]: r["response"]["tokens"] for r in bo.results}


def gemm_row_counts(dev):
    """The row counts M at which row 0 of a bf16 (M, 8192) x (8192, 2048)
    product (Llama-3.2-1B's MLP down projection) differs in bits from the
    same row at M = 1: cuBLAS picks its kernel by the shape, which is why
    a dense engine prefills each prompt alone."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    x = _rand(gen, (4096, 8192), torch.bfloat16, dev)
    w = _rand(gen, (8192, 2048), torch.bfloat16, dev) * 0.02
    ref = torch.matmul(x[:1], w)
    return [m for m in (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
            if not torch.equal(torch.matmul(x[:m], w)[:1], ref)]


def probe_batch_invariance(cfg, params, dev, reqs):
    """Serve ``reqs[:8]`` one at a time, as one batch of 8, and mixed with
    ``reqs[8:16]`` (16 requests through 8 slots).  Returns the differences
    from the requests served alone: (variant, custom_id, token index,
    alone's token, the variant's token)."""
    alone = {}
    for r in reqs[:8]:
        alone.update(_serve_tokens(cfg, params, dev, [r]))
    diffs = []
    for variant, batch in (("batch of 8", reqs[:8]),
                           ("mixed with 8 others", reqs[:16])):
        got = _serve_tokens(cfg, params, dev, batch)
        for cid, want in alone.items():
            have = got[cid]
            if have != want:
                i = next((j for j, (a, b) in enumerate(zip(want, have))
                          if a != b), min(len(want), len(have)))
                diffs.append((variant, cid, i,
                              want[i] if i < len(want) else None,
                              have[i] if i < len(have) else None))
    return diffs


def _journaled(ledger_root: Path) -> int:
    """Distinct custom_ids with an output record in a ledger's segments,
    read without opening (and so without repairing) the ledger."""
    ids = set()
    for seg in sorted(ledger_root.glob("seg-*.jsonl")):
        for line in seg.read_bytes().splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue                            # a torn tail line
            if rec.get("kind") == "output":
                ids.add(rec["custom_id"])
    return len(ids)


def serve_batch_job(dev, card: str):
    """Full-width Llama-3.2-1B bf16 (random weights from seed 0) behind the
    port's streaming job driver: the batch-invariance probe; (a) the
    48-request job, two NodeEngine replicas sharing the weights, in this
    process; (b) the same job in a child SIGKILLed after 16 journaled
    rows; (c) a child resuming it, whose output must equal (a)'s bytes;
    (d) checkpoints of the weights and of a sequence pool.  Returns (a)'s
    launch counts."""
    import shutil
    import signal
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import CoroutineScheduler, SchedulerConfig
    from repro_torch.launch import job
    from repro_torch.models import transformer as T
    from repro_torch.runtime import checkpoint
    from repro_torch.runtime.api import BatchRequest
    from repro_torch.runtime.engine import NodeEngine

    t_phase = time.perf_counter()
    cfg = get_config("llama3_2_1b")
    params = job.load_params(cfg, device=dev)
    work = ROOT / "build" / "phase8"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    inp = work / "in.jsonl"
    write_job_input(inp, cfg.vocab_size)
    reqs = [BatchRequest.from_json(line)
            for line in inp.read_text().splitlines()]

    t0 = time.perf_counter()
    diffs = probe_batch_invariance(cfg, params, dev, reqs)
    if diffs:
        raise AssertionError(
            "bf16 decode depends on the batch: (variant, request, token "
            f"index, alone, batched) {diffs}")
    log(f"  batch-invariance probe: {reqs[0].custom_id}..{reqs[7].custom_id}"
        f" served alone, as a batch of 8 and mixed with 8 others give "
        f"identical tokens ({time.perf_counter() - t0:.1f} s); a bf16 "
        f"(M, 8192) x (8192, 2048) product's row 0 differs from M = 1 at "
        f"M in {gemm_row_counts(dev)}")

    # (a) the clean job, its launch counts read around it alone
    out_a = work / "clean.jsonl"
    drv = job.make_driver(str(inp), str(out_a), str(work / "led_clean"),
                          job.engine_factory(cfg, params, dev))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = drv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    check_launches("the batch job", launches, DENSE_SAMPLED)
    check_routes("the batch job", launches)
    rows = [json.loads(line) for line in out_a.read_text().splitlines()]
    want = {r.custom_id: r.max_tokens for r in reqs}
    vpad = T.padded_vocab(cfg)
    if res.status != "completed" or res.merged_records != JOB_N or \
            [r["custom_id"] for r in rows] != [r.custom_id for r in reqs]:
        raise AssertionError(f"clean job: {res.status}, "
                             f"{res.merged_records} rows merged")
    for row in rows:
        toks = row["response"]["tokens"]
        if row["status_code"] != 200 or \
                len(toks) != want[row["custom_id"]] or \
                not all(0 <= t < vpad for t in toks):
            raise AssertionError(f"{row['custom_id']}: bad row {row}")
    out_tokens = sum(len(r["response"]["tokens"]) for r in rows)
    led = res.report["ledger"]
    log(f"  (a) clean job: {JOB_N} requests, {out_tokens} output tokens in "
        f"{wall:.3f} s: {out_tokens / wall:.1f} output tokens/s; ledger "
        f"{led['sealed_segments']} sealed segments + the live one, "
        f"{led['partials_journaled']} partial blocks; {res.rounds} driver "
        f"rounds, 2 replicas, requeued {res.requeued}; on {card}")
    log(f"  kernel launches on the batch job: {launches}")
    del drv

    # (b) killed after 16 journaled rows, (c) resumed: children by exec
    out_k, led_k = work / "killed.jsonl", work / "led_killed"
    cmd = [sys.executable, "-m", "repro_torch.launch.job", str(inp),
           str(out_k), str(led_k)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    p = subprocess.run(cmd + ["--kill-after", "16"], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    t_kill = time.perf_counter() - t0
    if p.returncode != -signal.SIGKILL:
        raise AssertionError(f"the killed child exited {p.returncode}, not "
                             f"-SIGKILL:\n{p.stderr[-3000:]}")
    if out_k.exists():
        raise AssertionError("the killed child published a merged output")
    n_kill = _journaled(led_k)
    if n_kill < 16:
        raise AssertionError(f"the killed child journaled {n_kill} rows")
    log(f"  (b) child killed by SIGKILL after {n_kill} journaled rows "
        f"({t_kill:.1f} s with start-up); no merged output")
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=300)
    t_resume = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError(f"the resumed child exited {p.returncode}:\n"
                             f"{p.stderr[-3000:]}")
    info = json.loads(p.stdout.strip().splitlines()[-1])
    if info["status"] != "completed" or info["merged"] != JOB_N or \
            info["skipped"] < 16 or info["replayed"] > 1:
        raise AssertionError(f"the resumed child reported {info}")
    if out_k.read_bytes() != out_a.read_bytes():
        resumed = [json.loads(line) for line in
                   out_k.read_text().splitlines()]
        bad = [(x["custom_id"], x["response"]["tokens"][:8],
                y["response"]["tokens"][:8])
               for x, y in zip(rows, resumed) if x != y]
        raise AssertionError(f"resumed output differs from the clean run "
                             f"in {len(bad)} rows: {bad[:4]}")
    log(f"  (c) resumed child: {info}; output equals the clean run's "
        f"{out_a.stat().st_size} bytes ({t_resume:.1f} s with start-up)")

    # (d) checkpoints: the weights (bf16) and an in-flight sequence pool
    ck = work / "ckpt"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save(str(ck), params, extra={"arch": "llama3_2_1b"})
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    flat, extra = checkpoint.restore(str(ck), mmap=True)
    restored = checkpoint.unflatten_into(T.param_template(cfg), flat,
                                         device=dev)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    nbytes = sum(a.nbytes for a in flat.values())
    a_leaves = checkpoint._flatten(params)
    b_leaves = checkpoint._flatten(restored)
    if a_leaves.keys() != b_leaves.keys() or extra["arch"] != "llama3_2_1b" \
            or not all(b_leaves[k].dtype == v.dtype and
                       torch.equal(b_leaves[k], v)
                       for k, v in a_leaves.items()):
        raise AssertionError("restored checkpoint leaves differ")
    greedy = [BatchRequest(f"g{i}", reqs[i].prompt, 24) for i in range(4)]
    if _serve_tokens(cfg, restored, dev, greedy) != \
            _serve_tokens(cfg, params, dev, greedy):
        raise AssertionError("the restored weights serve other tokens")
    del flat, restored
    log(f"  (d) checkpoint of {len(a_leaves)} {cfg.dtype} leaves, "
        f"{nbytes / 1e9:.3f}"
        f" GB: save {t_save:.2f} s, restore (mmap) + copy to the card "
        f"{t_restore:.2f} s; every leaf torch.equal; 4 greedy requests "
        f"give the original's tokens")
    eng = NodeEngine(cfg, params=params, device=dev, **job.ENGINE)
    sched = CoroutineScheduler([eng], SchedulerConfig(page_size=16))
    sched.submit([r.prompt for r in reqs[:6]], [24] * 6)
    for _ in range(2):
        sched._node_tick(0, eng)
    checkpoint.snapshot_pool(str(work / "pool"), sched)
    eng2 = NodeEngine(cfg, params=params, device=dev, **job.ENGINE)
    sched2 = CoroutineScheduler([eng2], SchedulerConfig(page_size=16))
    n_pool = checkpoint.restore_pool(str(work / "pool"), sched2)
    rep = sched2.run(max_ticks=2000)
    if n_pool != 6 or rep["completed"] != 6 or \
            any(len(c.generated) != 24 for c in sched2.cos.values()):
        raise AssertionError(f"restored pool: {n_pool} sequences, "
                             f"{rep['completed']} completed")
    log(f"  (d) pool of {n_pool} sequences snapshotted after two ticks "
        f"restored into a fresh engine: all completed")
    shutil.rmtree(work, ignore_errors=True)
    log(f"  phase 8 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 9
def serve_mla_path(dev):
    """DeepSeek-R1 at every published width, its depth cut to 2 layers
    (bf16, random weights from seed 0), through ``BatchMaster`` and one
    monolithic ``NodeEngine``: 8 greedy requests and a resubmitted prefix
    (its tail through ``mla_decode``), then 8 requests under the model's
    default SamplingParams.  Returns the greedy and the sampled launch
    counts."""
    from repro_torch import kernels
    from repro_torch.configs import default_sampling, get_config
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.models import transformer as T
    from repro_torch.runtime.api import BatchMaster, BatchRequest
    from repro_torch.runtime.engine import NodeEngine

    full = get_config("deepseek_r1")
    cfg = dataclasses.replace(full, num_layers=2)
    log(f"  {cfg.name} at its published widths; one cut: num_layers "
        f"{full.num_layers} -> {cfg.num_layers} (the weights of 3 layers, "
        f"72.8 GB, would leave too little of the card)")
    page = 16
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"  weights ({T.param_count(cfg) / 1e9:.3f} B params, "
        f"{T.param_count(cfg, active_only=True) / 1e9:.3f} B active, "
        f"{cfg.dtype}) drawn in {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated, peak "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    eng = NodeEngine(cfg, params=params, max_active=8, max_len=2048,
                     page_size=page, device=dev)
    nbytes = sum(t.numel() * t.element_size() for t in eng.cache.values())
    log(f"  slot cache {({n: tuple(t.shape) for n, t in eng.cache.items()})}"
        f", {nbytes / 1e6:.1f} MB")
    master = BatchMaster([eng], SchedulerConfig(page_size=page))
    rng = np.random.default_rng(9)
    vpad = T.padded_vocab(cfg)

    def prompt(n):
        return [int(t) for t in rng.integers(2, cfg.vocab_size, n)]

    def serve(batches, tag, expected, prefill=True):
        clock = _PageClock(eng)
        gemms, shapes = _GemmRoutes(), _FlashShapes()
        reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        out = {}
        try:
            for reqs in batches:
                bo = master.run(master.submit(reqs))
                if bo.request_counts["completed"] != len(reqs) or \
                        bo.request_counts["failed"]:
                    raise AssertionError(f"{tag}: requests not completed: "
                                         f"{bo.request_counts}")
                out.update({r["custom_id"]: r["response"]
                            for r in bo.results})
        finally:
            gemms.restore()
            shapes.restore()
            clock.restore()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        used = kernels.launches()
        check_launches(tag, used, expected)
        gemms.check(tag, prefill)
        shapes.check(tag, MLA_HEADS, "wgmma")
        want = {r.custom_id: r.max_tokens for reqs in batches for r in reqs}
        for cid, resp in out.items():
            toks = resp["tokens"]
            if not toks or len(toks) > want[cid] or \
                    not all(0 <= t < vpad for t in toks):
                raise AssertionError(f"{tag} {cid}: bad tokens {toks}")
        n_out = sum(len(r["tokens"]) for r in out.values())
        pf_s, pf_tok, _ = clock.per_step("prefill")
        kind = "sampled" if expected == MLA_SAMPLED else "decode"
        _, dc_steps, dc_ms = clock.per_step(kind)
        log(f"  {tag}: {len(out)} requests, {n_out} output tokens in "
            f"{wall:.3f} s: {n_out / wall:.1f} output tokens/s; prefill "
            f"{pf_s * 1e3:.1f} ms for {pf_tok} prompt tokens (calls: "
            + ", ".join(f"{s * 1e3:.1f} ms / {n}"
                        for s, n in clock.spans["prefill"])
            + f"); decode {dc_ms:.2f} ms/step over {dc_steps} steps; peak "
            f"device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f}"
            f" GB; launches {used}")
        return out, used

    # one 64-token prompt: 512 choices over 256 experts, block_t 16 (mma)
    serve([[BatchRequest("warm", prompt(64), 4)]], "greedy warm-up",
          MLA_GREEDY, prefill=False)
    lens = [64, 96, 128, 192, 256, 320, 384, 512]
    outs = [32, 36, 40, 44, 48, 52, 56, 64]
    greedy = [BatchRequest(f"g{i}", prompt(n), m)
              for i, (n, m) in enumerate(zip(lens, outs))]
    # a resubmitted prefix: 15 shared pages of g7, then a new tail of 20
    # tokens teacher-forced through mla_decode
    hit = [BatchRequest("p0", greedy[7].prompt[:15 * page] + prompt(20), 32)]
    saved0 = eng.prefill_tokens_saved
    g_out, g_used = serve([greedy, hit], "greedy + prefix hit", MLA_GREEDY)
    if eng.prefill_tokens_saved - saved0 != 15 * page:
        raise AssertionError(f"the resubmitted prefix saved "
                             f"{eng.prefill_tokens_saved - saved0} tokens, "
                             f"not {15 * page}")
    for r in greedy + hit:
        if len(g_out[r.custom_id]["tokens"]) != r.max_tokens:
            raise AssertionError(f"{r.custom_id}: "
                                 f"{len(g_out[r.custom_id]['tokens'])} "
                                 f"tokens, asked for {r.max_tokens}")
    sampled = [BatchRequest(f"s{i}", prompt(n), m, sampling=default_sampling(
        "deepseek_r1", seed=200 + i)) for i, (n, m) in enumerate(zip(lens,
                                                                     outs))]
    _, s_used = serve([sampled], "sampled (the model card's T 0.6, top-p "
                      "0.95)", MLA_SAMPLED)

    # the model's logits on two prompts and one decode step after them:
    # finite, of the padded vocabulary
    toks = torch.tensor([greedy[0].prompt, greedy[1].prompt[:64]],
                        dtype=torch.int32, device=dev)
    logits, pc = T.prefill(cfg, params, toks)
    cache = T.init_cache(cfg, 2, 128, dev)
    for n, t in pc.items():
        cache[n][:, :, :64] = t
    step, _ = T.decode_step_logits(
        cfg, params, cache, torch.argmax(logits[:, 0], -1).to(torch.int32),
        torch.full((2,), 64, dtype=torch.int32, device=dev))
    if logits.shape != (2, 1, vpad) or step.shape != (2, vpad) or \
            not torch.isfinite(logits).all() or \
            not torch.isfinite(step).all():
        raise AssertionError(f"bad MLA logits {tuple(logits.shape)}, "
                             f"{tuple(step.shape)}")
    log(f"  prefill and decode-step logits finite, of V {vpad}")
    _mla_step_split(cfg, params, dev)
    return g_used, s_used


def _device_ms(fn, n: int = 4, names=None):
    """(device ms a call, {kernel class: device ms a call}) of ``fn``,
    from ``torch.profiler``'s trace of ``n`` calls after one warm-up: the
    kernels' own time, without the host's gaps between them.  ``names``, a
    dict, also gets each kernel name's device ms a call."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile import kernel_class
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = ev.device_time if hasattr(ev, "device_time") \
                else ev.cuda_time
            c = kernel_class(ev.name)
            by[c] = by.get(c, 0.0) + us / 1e3 / n
            if names is not None:
                names[ev.name] = names.get(ev.name, 0.0) + us / 1e3 / n
    return sum(by.values()), by


def _top_kernels(names, k: int = 8) -> str:
    """The ``k`` kernel names with the most device time, shortened."""
    top = sorted(names.items(), key=lambda kv: -kv[1])[:k]
    return "; ".join(f"{ms:.1f} ms {name[:90]}" for name, ms in top)


def _mla_step_split(cfg, params, dev):
    """Where one decode step's device time goes at phase 9's batch (8
    rows at position 1024 of a 2048-position cache of random latents):
    one layer's absorbed MLA decode attention (fp32 PyTorch), one layer's
    MoE FFN (router, dispatch, three ``moe_gemm`` launches, the shared
    expert) and the whole step (2 layers, final norm, LM head), each
    summed from the profiler's device trace; and the step's time on the
    host's clock beside it."""
    from repro_torch.models import layers
    from repro_torch.models import transformer as T

    B = 8
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    cache = {n: t.normal_(generator=gen)
             for n, t in T.init_cache(cfg, B, 2048, dev).items()}
    lengths = torch.full((B,), 1024, dtype=torch.int32, device=dev)
    toks = torch.randint(2, cfg.vocab_size, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    x = torch.randn((B, 1, cfg.d_model), generator=gen, device=dev) \
        .to(torch.bfloat16)
    tab = layers.rope_tables(lengths[:, None], cfg.rope_head_dim,
                             cfg.rope_theta)
    p0 = T._per_layer(params)[0]
    attn, _ = _device_ms(lambda: layers.mla_decode(
        cfg, p0["attn"], x, cache["ckv"][0], cache["kr"][0], lengths,
        rope_tab=tab))
    ffn, ffn_by = _device_ms(lambda: T.ffn(cfg, p0, x))
    step, step_by = _device_ms(lambda: T.decode_step_logits(
        cfg, params, cache, toks, lengths))
    t = time.perf_counter()
    for _ in range(4):
        T.decode_step_logits(cfg, params, cache, toks, lengths)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3 / 4
    log(f"  a B8 decode step at position 1024, device time from the "
        f"profiler's trace: MLA decode attention {attn:.3f} ms a layer, MoE "
        f"FFN {ffn:.3f} ms a layer ("
        + ", ".join(f"{c} {ms:.3f}" for c, ms in sorted(
            ffn_by.items(), key=lambda kv: -kv[1]))
        + f"), the whole step {step:.3f} ms ("
        + ", ".join(f"{c} {ms:.3f}" for c, ms in sorted(
            step_by.items(), key=lambda kv: -kv[1]))
        + f"); the step's wall {wall:.3f} ms (host clock): device busy "
        f"{step / wall:.3f}")


# --------------------------------------------------------------- phase 10
def serve_windowed_path(dev, arch: str, long_len: int):
    """A windowed decoder at every published width and full depth (bf16,
    random weights from seed 0) at model level (``generate``: prefill,
    the rings re-laid for decode, pages of 16): 8 prompts of 512 greedy
    (64 tokens), the model card's sampling twice with top-5 logprobs
    (identical streams required), then one prompt of ``long_len`` tokens,
    longer than the window, decoded 32 steps past it; then one B8 decode
    step's device time by kernel class (``_window_step_split``).  Every
    flash launch must be at the model's head dim on the wgmma route, the
    sampled runs must launch ``fused_sampling``, and no part the other
    kernels (ring decode is PyTorch).  Returns {part: numbers}."""
    from repro_torch import kernels
    from repro_torch.configs import default_sampling, get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.model_level import generate
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    D = cfg.head_dim
    window = cfg.sliding_window or cfg.local_window
    if long_len <= window:
        raise AssertionError(f"{arch}: the long prompt must outrun the "
                             f"window {window}")
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    weights_gb = sum(t.numel() * t.element_size() for t in
                     _leaves(params)) / 1e9
    log(f"  {arch}: {T.param_count(cfg) / 1e9:.3f} B parameters "
        f"({weights_gb:.3f} GB, {cfg.dtype}) drawn in "
        f"{time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated")
    rng = np.random.default_rng(11)
    vpad = T.padded_vocab(cfg)
    generate(cfg, params, rng.integers(2, cfg.vocab_size, (1, 64)).tolist(),
             4)                                         # warm-up
    torch.cuda.synchronize()
    parts = {}

    def run(tag, prompts, outs, expected, **kw):
        reset_counts()              # this part alone
        torch.cuda.reset_peak_memory_stats(dev)
        shapes = _FlashShapes()
        try:
            g = generate(cfg, params, prompts, outs, **kw)
        finally:
            shapes.restore()
        used = kernels.launches()
        check_launches(f"{arch} {tag}", used, expected)
        shapes.check(f"{arch} {tag}", (D, D), "wgmma")
        want = np.broadcast_to(np.asarray(outs), (len(prompts),))
        for i, toks in enumerate(g.tokens):
            if len(toks) != want[i] or not all(0 <= t < vpad for t in toks):
                raise AssertionError(f"{arch} {tag} row {i}: bad tokens "
                                     f"{toks[:8]}")
        wall = g.prefill_s + g.decode_s
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        parts[tag] = dict(prefill_ms=g.prefill_s * 1e3,
                          decode_ms_per_step=g.decode_s * 1e3
                          / g.decode_steps, steps=g.decode_steps,
                          out_tokens=g.out_tokens,
                          tokens_per_s=g.out_tokens / wall, peak_gb=peak,
                          launches=used,
                          flash_routes=dict(ops.ROUTE_LAUNCHES))
        log(f"  {arch} {tag}: prefill {g.prefill_s * 1e3:.1f} ms for "
            f"{len(prompts)}x{len(prompts[0])} tokens; decode "
            f"{g.decode_s * 1e3 / g.decode_steps:.2f} ms/step over "
            f"{g.decode_steps} steps ({g.pages} pages); {g.out_tokens} "
            f"output tokens in {wall:.3f} s ({g.out_tokens / wall:.1f} "
            f"tokens/s); peak device memory {peak:.2f} GB; launches "
            f"{used}, flash by route {dict(ops.ROUTE_LAUNCHES)}")
        return g

    prompts = rng.integers(2, cfg.vocab_size, (8, 512)).tolist()
    run("greedy 8x512", prompts, 64, WINDOW_GREEDY)
    sps = [default_sampling(arch, seed=100 + i) for i in range(8)]
    runs = [run(f"sampled run {j}, 8x512", prompts, 64, WINDOW_SAMPLED,
                sampling=sps, lp_k=5) for j in range(2)]
    if runs[0].tokens != runs[1].tokens or \
            runs[0].logprobs != runs[1].logprobs:
        raise AssertionError(f"{arch}: the resubmitted sampled batch gave "
                             f"other streams")
    chosen, vals, _ = runs[0].logprobs[3]
    if len(chosen) != 64 or any(len(v) != 5 for v in vals) or \
            not all(math.isfinite(c) and c <= 0 for c in chosen):
        raise AssertionError(f"{arch}: bad logprobs {chosen[:4]}")
    card = ", ".join(f"{k} {v}" for k, v in
                     dataclasses.asdict(sps[0]).items()
                     if k in ("temperature", "top_k", "top_p"))
    log(f"  {arch} sampled ({card}, a seed a row): streams and top-5 "
        f"logprob planes identical over two runs")
    long_prompt = rng.integers(2, cfg.vocab_size, (1, long_len)).tolist()
    run(f"greedy 1x{long_len}", long_prompt, 33, WINDOW_GREEDY)
    log(f"  {arch}: the {long_len}-token prompt outruns the window of "
        f"{window}: its ring of {window} slots wraps at every step")
    parts["B8 decode step"] = _window_step_split(cfg, params, dev, prompts)
    logits, _ = T.prefill(cfg, params, torch.tensor([prompts[0]],
                                                    dtype=torch.int32,
                                                    device=dev))
    if logits.shape != (1, 1, vpad) or not torch.isfinite(logits).all():
        raise AssertionError(f"{arch}: bad logits {tuple(logits.shape)}")
    secs = time.perf_counter() - t_phase
    log(f"  phase 10 {arch} took {secs:.1f} s")
    del params
    return dict(weights_gb=weights_gb, seconds=secs, parts=parts)


def _window_step_split(cfg, params, dev, prompts):
    """Where one decode step's device time goes at phase 10's batch: the
    8 prompts prefilled, their rings re-laid for 64 more positions, one
    step at position 512 (``decode_step_logits``; its cache writes land
    on the same slot each call), summed by kernel class from the
    profiler's trace, beside the step's wall on the host's clock."""
    from repro_torch.models import transformer as T
    toks = torch.tensor(prompts, dtype=torch.int32, device=dev)
    B, S = toks.shape
    _, pre = T.prefill(cfg, params, toks)
    cache = T.install_rings(cfg, T.init_cache(cfg, B, S + 64, dev), pre)
    del pre
    lengths = torch.full((B,), S, dtype=torch.int32, device=dev)

    def step():
        return T.decode_step_logits(cfg, params, cache, toks[:, -1], lengths)

    device_ms, by = _device_ms(step)
    t = time.perf_counter()
    for _ in range(4):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3 / 4
    log(f"  {cfg.name}: a B{B} decode step at position {S}, device time "
        f"from the profiler's trace {device_ms:.3f} ms ("
        + ", ".join(f"{c} {ms:.3f}" for c, ms in sorted(
            by.items(), key=lambda kv: -kv[1]))
        + f"); the step's wall {wall:.3f} ms (host clock): device busy "
        f"{device_ms / wall:.3f}")
    return dict(device_ms=device_ms, wall_ms=wall, busy=device_ms / wall,
                by_class=by)


# --------------------------------------------------------------- phase 11
def serve_encdec_vlm_path(dev, arch: str, prompt_len: int):
    """Whisper-base or Pixtral-12B at every published width and full depth
    (bf16, random weights from seed 0) at model level (``generate``:
    prefill, the cache installed at a multiple of 16 positions, pages of
    16): 8 rows of stub frames (1536) or patches (1024) from a seed at
    ``frontend_stub``'s 0.02 scale and prompts of ``prompt_len``, 64
    greedy tokens, then explicit sampling with a seed a row and top-5
    logprobs twice (identical streams required); then one B8 decode
    step's device time by kernel class.  Every flash launch must be at
    the model's head dim on wgmma (Whisper: its encoder's and
    cross-attention's launches non-causal, 12 of 18 a prefill; Pixtral:
    40 causal), ``paged_attention`` must run on every decode step
    (Whisper twice a layer at G = 1, its cross-attention over 1536 keys;
    Pixtral once a layer at G = 4), ``fused_sampling`` on the sampled runs
    only, and no MoE or scan kernel.  Returns {part: numbers}."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.launch.model_level import generate
    from repro_torch.models import transformer as T
    from repro_torch.sampling import SamplingParams

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    audio = cfg.family == "audio"
    D, G = cfg.head_dim, cfg.num_heads // cfg.num_kv_heads
    log(f"  {arch}: {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB "
        f"allocated before its weights are drawn")
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    weights_gb = sum(t.numel() * t.element_size() for t in
                     _leaves(params)) / 1e9
    log(f"  {arch}: {T.param_count(cfg) / 1e9:.3f} B parameters "
        f"({weights_gb:.3f} GB, {cfg.dtype}) drawn in "
        f"{time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated")
    rng = np.random.default_rng(11)
    vpad = T.padded_vocab(cfg)
    n_stub = cfg.encoder_seq if audio else cfg.num_patches
    name = "frames" if audio else "patches"

    def stub(B):
        return (rng.standard_normal((B, n_stub, cfg.d_model)) * 0.02) \
            .astype(np.float32)

    generate(cfg, params, rng.integers(2, cfg.vocab_size, (1, 16)).tolist(),
             4, **{name: stub(1)})                      # warm-up
    torch.cuda.synchronize()
    prompts = rng.integers(2, cfg.vocab_size, (8, prompt_len)).tolist()
    extra = {name: stub(8)}
    positions = prompt_len + (0 if audio else n_stub)
    # flash launches a prefill, and how many of them non-causal
    per_prefill = (cfg.encoder_layers + 2 * cfg.num_layers if audio
                   else cfg.num_layers)
    nc_per_prefill = cfg.encoder_layers + cfg.num_layers if audio else 0
    # paged launches a decode step
    per_step = 2 * cfg.num_layers if audio else cfg.num_layers
    parts = {}

    def run(tag, expected, **kw):
        reset_counts()              # this part alone
        torch.cuda.reset_peak_memory_stats(dev)
        shapes, paged = _FlashShapes(), _PagedShapes()
        try:
            g = generate(cfg, params, prompts, 64, **extra, **kw)
        finally:
            shapes.restore()
            paged.restore()
        used = kernels.launches()
        check_launches(f"{arch} {tag}", used, expected)
        shapes.check(f"{arch} {tag}", (D, D), "wgmma")
        if (len(shapes.seen), shapes.non_causal) != (per_prefill,
                                                     nc_per_prefill):
            raise AssertionError(f"{arch} {tag}: {len(shapes.seen)} flash "
                                 f"launches, {shapes.non_causal} "
                                 f"non-causal (expected {per_prefill}, "
                                 f"{nc_per_prefill})")
        keys = sorted({x[2] for x in paged.seen})
        bad = [x for x in paged.seen if x[0] != G or x[1] != D
               or x[3] != "mma"]
        if bad or len(paged.seen) != per_step * g.decode_steps or \
                dict(paged_ops.ROUTE_LAUNCHES)["simt"]:
            raise AssertionError(f"{arch} {tag}: {len(paged.seen)} paged "
                                 f"launches over {g.decode_steps} steps "
                                 f"(expected {per_step} a step, all at G "
                                 f"{G}, D {D} on mma): {bad[:4]}")
        if audio and cfg.encoder_seq not in keys:
            raise AssertionError(f"{arch} {tag}: no paged launch over the "
                                 f"{cfg.encoder_seq}-key cross cache")
        for i, toks in enumerate(g.tokens):
            if len(toks) != 64 or not all(0 <= t < vpad for t in toks):
                raise AssertionError(f"{arch} {tag} row {i}: bad tokens "
                                     f"{toks[:8]}")
        wall = g.prefill_s + g.decode_s
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        parts[tag] = dict(prefill_ms=g.prefill_s * 1e3,
                          decode_ms_per_step=g.decode_s * 1e3
                          / g.decode_steps, steps=g.decode_steps,
                          out_tokens=g.out_tokens,
                          tokens_per_s=g.out_tokens / wall, peak_gb=peak,
                          launches=used, non_causal_flash=shapes.non_causal,
                          paged_keys=keys,
                          flash_routes=dict(ops.ROUTE_LAUNCHES),
                          paged_routes=dict(paged_ops.ROUTE_LAUNCHES))
        log(f"  {arch} {tag}: prefill {g.prefill_s * 1e3:.1f} ms for 8 x "
            f"({n_stub} {name} + {prompt_len} tokens); decode "
            f"{g.decode_s * 1e3 / g.decode_steps:.2f} ms/step over "
            f"{g.decode_steps} steps ({g.pages} pages); {g.out_tokens} "
            f"output tokens in {wall:.3f} s ({g.out_tokens / wall:.1f} "
            f"tokens/s); peak device memory {peak:.2f} GB; launches "
            f"{used}; flash by route {dict(ops.ROUTE_LAUNCHES)}, "
            f"{shapes.non_causal} non-causal; paged by route "
            f"{dict(paged_ops.ROUTE_LAUNCHES)} at G {G}, D {D}, over "
            f"{keys} keys")
        return g

    run("greedy 8 rows", DENSE_GREEDY)
    sps = [SamplingParams(temperature=0.8, top_k=40, top_p=0.95,
                          seed=100 + i) for i in range(8)]
    runs = [run(f"sampled run {j}, 8 rows", DENSE_SAMPLED, sampling=sps,
                lp_k=5) for j in range(2)]
    if runs[0].tokens != runs[1].tokens or \
            runs[0].logprobs != runs[1].logprobs:
        raise AssertionError(f"{arch}: the resubmitted sampled batch gave "
                             f"other streams")
    chosen, vals, _ = runs[0].logprobs[3]
    if len(chosen) != 64 or any(len(v) != 5 for v in vals) or \
            not all(math.isfinite(c) and c <= 0 for c in chosen):
        raise AssertionError(f"{arch}: bad logprobs {chosen[:4]}")
    log(f"  {arch} sampled (T 0.8, top-k 40, top-p 0.95, a seed a row, V "
        f"{vpad}): streams and top-5 logprob planes identical over two "
        f"runs")
    parts["B8 decode step"] = _encdec_step_split(cfg, params, dev, prompts,
                                                 extra, positions)
    secs = time.perf_counter() - t_phase
    log(f"  phase 11 {arch} took {secs:.1f} s")
    del params
    return dict(weights_gb=weights_gb, seconds=secs, parts=parts)


def _encdec_step_split(cfg, params, dev, prompts, extra, positions):
    """Where one decode step's device time goes at phase 11's batch: the 8
    rows prefilled, their cache installed for 64 more positions, one step
    at the first generated position (``decode_step_logits``; its cache
    writes land on the same position each call), summed by kernel class
    from the profiler's trace, beside the step's wall on the host's
    clock."""
    from repro_torch.models import transformer as T
    toks = torch.tensor(prompts, dtype=torch.int32, device=dev)
    B = toks.shape[0]
    kw = {k: torch.from_numpy(v).to(dev) for k, v in extra.items()}
    _, pre = T.prefill(cfg, params, toks, **kw)
    cache = T.install_cache(cfg, T.init_cache(cfg, B, positions + 64, dev),
                            pre)
    del pre
    lengths = torch.full((B,), positions, dtype=torch.int32, device=dev)

    def step():
        return T.decode_step_logits(cfg, params, cache, toks[:, -1], lengths)

    device_ms, by = _device_ms(step)
    t = time.perf_counter()
    for _ in range(4):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3 / 4
    log(f"  {cfg.name}: a B{B} decode step at position {positions}, device "
        f"time from the profiler's trace {device_ms:.3f} ms ("
        + ", ".join(f"{c} {ms:.3f}" for c, ms in sorted(
            by.items(), key=lambda kv: -kv[1]))
        + f"); the step's wall {wall:.3f} ms (host clock): device busy "
        f"{device_ms / wall:.3f}")
    return dict(device_ms=device_ms, wall_ms=wall, busy=device_ms / wall,
                by_class=by)


# --------------------------------------------------------------- phase 12
def _model_flops(cfg, B: int, S: int, active_only: bool = False) -> float:
    """One training step's model operations (no recompute): 6 per
    parameter and token for every matrix product (all parameters but the
    embedding table, which is gathered; with ``active_only`` an MoE
    layer's routed experts count k of E), and attention's forward over the
    pairs its causal (and windowed) mask lets through (2 (D + D) a pair and
    head) plus its backward (2.5 times).  A Mamba-2 layer adds its SSD's
    own products, in chunks of Q = min(64, S) with state N and head dim
    P: C.B^T 2 Q N a token and group, M.X 2 Q P a token and head, the
    chunk states 2 N P and the term between chunks 2 N P a token and
    head, times 3 for the forward and the backward:
    3 B S L (2 Q N g + h (2 Q P + 4 N P))."""
    from repro_torch.models import transformer as T
    n = T.param_count(cfg, active_only=active_only) \
        - T.padded_vocab(cfg) * cfg.d_model
    pairs = _pairs(S, S, True, cfg.sliding_window)
    attn = 2.0 * 2 * cfg.head_dim * pairs * cfg.num_heads * B
    flops = 6.0 * n * B * S + 3.5 * attn * cfg.num_layers
    if cfg.family == "ssm":
        Q, N, P = min(64, S), cfg.ssm_state, cfg.ssm_head_dim
        per_token = 2 * Q * N * cfg.ssm_groups + cfg.ssm_heads * (
            2 * Q * P + 4 * N * P)
        flops += 3.0 * per_token * B * S * cfg.num_layers
    return flops


class _PlainCalls:
    """Counts the calls of the kernels' plain versions while a path runs
    (each wrapped in its module until ``restore``): a card's path must
    make none."""
    NAMES = (("repro_torch.kernels.flash_attention.ops",
              "flash_attention_plain"),
             ("repro_torch.kernels.flash_attention_bwd.ops",
              "flash_attention_bwd_plain"),
             ("repro_torch.kernels.moe_gemm.ops", "grouped_gemm_plain"),
             ("repro_torch.kernels.moe_gemm_wgrad.ops",
              "grouped_gemm_wgrad_plain"),
             ("repro_torch.kernels.ssd_scan.ops", "ssd_state_scan_plain"),
             ("repro_torch.kernels.ssd_scan_bwd.ops",
              "ssd_state_scan_bwd_plain"))

    def __init__(self):
        import importlib
        self.calls, self.orig = {}, []
        for mod_name, fn_name in self.NAMES:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, fn_name)
            self.orig.append((mod, fn_name, fn))
            self.calls[fn_name] = 0

            def counted(*a, _f=fn, _n=fn_name, **kw):
                self.calls[_n] += 1
                return _f(*a, **kw)
            setattr(mod, fn_name, counted)

    def restore(self):
        for mod, name, fn in self.orig:
            setattr(mod, name, fn)


def train_path(dev, arch: str, steps: int, GB: int, S: int, n_mb: int):
    """A full-width, full-depth dense decoder or SSM (bf16, random weights
    from seed 0) trained ``steps`` steps through
    ``launch/steps.py::train_step``: batches of GB x S from
    ``SyntheticLMStream`` (seed 0) in ``n_mb`` microbatches, remat on, AdamW
    lr 1e-3.  The loss must be finite and fall; each step must launch the
    flash forward (an SSM: the scan) 2 x L x n_mb times (remat runs each
    layer twice), all on wgmma, the backward wrapper (an SSM: the scan's)
    L x n_mb times, all on its bf16 route, no other kernel and no plain
    version.  Logs s/step, tokens/s, peak memory, a step's device time by
    kernel class beside its wall, the model FLOPs' share of the bf16 dense
    peak (``mfu``), and whether a second run from seed 0 gives the first
    two losses' bits (an SSM must give the first's).  Returns (launches
    of the steps, numbers)."""
    from repro_torch import kernels, optim
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention_bwd import ops as bwd_ops
    from repro_torch.launch.steps import train_step
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    L = cfg.num_layers
    ocfg = optim.AdamWConfig(lr=1e-3, zero1=False)
    stream = SyntheticLMStream(DataConfig(global_batch=GB, seq_len=S,
                                          vocab_size=cfg.vocab_size, seed=0))
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in stream.batch_at(i).items()}
               for i in range(steps + 2)]

    def run(n):
        params = T.init_params(cfg, 0, dev)
        opt = optim.init_opt_state(params)
        losses, secs = [], []
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = train_step(cfg, params, opt, batches[i], ocfg,
                             microbatches=n_mb, remat=True)
            losses.append(out["loss"].item())
            secs.append(time.perf_counter() - t0)
            log(f"  {arch} step {i}: loss {losses[-1]:.6f}, grad norm "
                f"{out['grad_norm'].item():.4f}, {secs[-1]:.3f} s")
        return params, opt, losses, secs

    gb = T.param_count(cfg) * 2 / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    plain = _PlainCalls()
    try:
        params, opt, losses, secs = run(steps)
    finally:
        plain.restore()
    used = kernels.launches()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    fwd, bwd = 2 * L * n_mb * steps, L * n_mb * steps
    names = ("ssd_scan", "ssd_scan_bwd") if cfg.family == "ssm" else \
        ("flash_attention", "flash_attention_bwd")
    want = dict(zip(names, (fwd, bwd)))
    n_flash = want.get("flash_attention", 0)
    if {k: n for k, n in used.items() if n} != want or \
            ops.ROUTE_LAUNCHES != {"wgmma": n_flash, "simt": 0} or \
            bwd_ops.ROUTE_LAUNCHES != {
                "simt": 0, "wgmma": want.get("flash_attention_bwd", 0)} or \
            any(plain.calls.values()):
        raise AssertionError(f"{arch} training: launches {used}, flash by "
                             f"route {ops.ROUTE_LAUNCHES}, backward by route "
                             f"{bwd_ops.ROUTE_LAUNCHES}, plain versions "
                             f"called {plain.calls} (expected {want}, flash "
                             f"and backward on wgmma, no plain version)")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{arch} training: losses {losses} (finite "
                             f"and falling expected)")
    step_s = statistics.median(secs[1:])
    tokens = GB * S
    flops = _model_flops(cfg, GB, S)
    mfu = flops / step_s / PEAK_FLOPS[torch.bfloat16]
    log(f"  {arch} bf16 ({T.param_count(cfg):,} parameters, {gb:.3f} GB, "
        f"window {cfg.sliding_window}), {steps} steps of {GB} x {S} in "
        f"{n_mb} microbatches, remat: losses "
        f"{[round(x, 4) for x in losses]}; {step_s:.3f} s/step (median of "
        f"steps 1-{steps - 1}; step 0 {secs[0]:.3f} s), "
        f"{tokens / step_s:.1f} tokens/s; peak device memory {peak:.2f} GB; "
        f"launches {used}; flash by route {dict(ops.ROUTE_LAUNCHES)}, "
        f"backward by route {dict(bwd_ops.ROUTE_LAUNCHES)} (a step: "
        f"{2 * L * n_mb} {names[0]}, {L * n_mb} {names[1]} calls); plain "
        f"versions called {plain.calls}")
    print(json.dumps({f"{arch}_train_mfu": mfu, "model_flop_per_step": flops,
                      "s_per_step": step_s}), flush=True)

    # a step's device time by kernel class (the profiler's trace), beside
    # the wall of the same step on the host's clock
    i = iter(range(steps, steps + 2))

    def one():
        train_step(cfg, params, opt, batches[next(i)], ocfg,
                   microbatches=n_mb, remat=True)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    names = {}
    device_ms, by = _device_ms(one, n=1, names=names)
    wall = (time.perf_counter() - t0) * 1e3 / 2
    log(f"  {arch} a training step: device time from the profiler's "
        f"trace {device_ms:.1f} ms ("
        + ", ".join(f"{c} {ms:.1f}" for c, ms in sorted(
            by.items(), key=lambda kv: -kv[1]))
        + f"); the step's wall {wall:.1f} ms (host clock, mean of the "
        f"untraced and the traced step): device busy {device_ms / wall:.3f}"
        f"; its top kernels: {_top_kernels(names)}")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    _, _, again, _ = run(2)
    same = again == losses[:2]
    log(f"  {arch} a second run from seed 0: losses {again} "
        f"{'equal' if same else 'NOT equal'} to the first run's bits "
        f"(the embedding's backward adds rows in an unspecified order)")
    if cfg.family == "ssm" and again[0] != losses[0]:
        raise AssertionError(f"{arch} training: a rerun of the first step "
                             f"gave the loss {again[0]}, not {losses[0]}")
    gc.collect()
    torch.cuda.empty_cache()
    secs_phase = time.perf_counter() - t_phase
    log(f"  training {arch} took {secs_phase:.1f} s")
    return used, dict(losses=losses, step_s=step_s, step_secs=secs,
                      tokens_per_s=tokens / step_s, peak_gb=peak, mfu=mfu,
                      device_ms=device_ms, wall_ms=wall, by_class=by,
                      rerun_equal=same, seconds=secs_phase)


def train_smollm_path(dev):
    """Phase 12's SmolLM-360M leg: 8 steps of 16 x 4096 in 2 microbatches
    (``train_path``)."""
    return train_path(dev, "smollm_360m", 8, 16, 4096, 2)


def train_danube_path(dev):
    """Phase 12's H2O-Danube-1.8B leg (24 layers, d_model 2560, 32/8 heads
    of 80, window 4096): 5 steps of 4 x 8192 in 2 microbatches, so that the
    window binds (``train_path``).  Five, not three: at AdamW's lr
    1e-3 the third step's loss rises past the first's (by ~0.9 nats, in
    bf16 and in fp32 on the CUDA-core kernels alike: the optimizer's
    dynamics at this width, PERF.md) and the fifth falls below it."""
    return train_path(dev, "h2o_danube_1_8b", 5, 4, 8192, 2)


# --------------------------------------------------------------- phase 14
def train_ssm_path(dev):
    """Phase 14: Mamba2-370M (48 layers, d_model 1024, d_inner 2048, 32
    heads of 64, state 128, vocab 50280) in bf16 at every published width
    and full depth, 5 steps of 16 x 4096 in 2 microbatches (phase 12's
    SmolLM shape; ``train_path``): the scan twice a layer and microbatch
    (remat), its backward kernel once, the first step's loss again on a
    rerun from seed 0.  Then the SSD's share of a step: one layer's
    ``ssd_chunked`` at a microbatch (random inputs from a seed at the
    block's scales), its forward and its forward + backward, on the
    device (the profiler's trace), times L x 2 microbatches x (forward +
    forward and backward: remat runs the forward twice) over the step's
    device time."""
    from repro_torch.configs import get_config
    from repro_torch.models.ssm import ssd_chunked
    cfg = get_config("mamba2_370m")
    b, S, n_mb = 8, 4096, 2
    log(f"  one layer's fp32 SSD intermediates in the forward at a "
        f"microbatch of {b} x {S}: "
        f"{_ssd_peak_estimate(cfg, b, S) / 1e9:.2f} GB reckoned")
    used, st = train_path(dev, "mamba2_370m", 5, b * n_mb, S, n_mb)
    gen = torch.Generator(device=dev).manual_seed(8)
    h, p, g, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, \
        cfg.ssm_state
    bf = torch.bfloat16

    def leaf(shape, scale=1.0, dtype=bf):
        return (scale * torch.randn(shape, generator=gen, device=dev)) \
            .to(dtype).requires_grad_(True)
    xh, Bm, Cm = leaf((b, S, h, p), 0.5), leaf((b, S, g, n), 0.5), \
        leaf((b, S, g, n), 0.5)
    dt = F.softplus(leaf((b, S, h), dtype=torch.float32)).detach() \
        .requires_grad_(True)
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    gy = torch.randn((b, S, h, p), generator=gen, device=dev)

    def fwd():
        ssd_chunked(xh, dt, A, Bm, Cm)

    def fwd_bwd():
        y, _ = ssd_chunked(xh, dt, A, Bm, Cm)
        y.backward(gy)
    f_ms, _ = _device_ms(fwd, n=2)
    fb_ms, fb_by = _device_ms(fwd_bwd, n=2)
    ssd_ms = cfg.num_layers * n_mb * (f_ms + fb_ms)
    share = ssd_ms / st["device_ms"]
    log(f"  one layer's ssd_chunked at {b} x {S} on the device: forward "
        f"{f_ms:.2f} ms, forward + backward {fb_ms:.2f} ms ("
        + ", ".join(f"{c} {ms:.2f}" for c, ms in sorted(
            fb_by.items(), key=lambda kv: -kv[1]))
        + f"); {cfg.num_layers} layers x {n_mb} microbatches x (forward + "
        f"forward and backward) = {ssd_ms:.1f} ms, {share:.3f} of the "
        f"step's {st['device_ms']:.1f} device ms")
    st.update(ssd_layer_fwd_ms=f_ms, ssd_layer_fwd_bwd_ms=fb_ms,
              ssd_share=share)
    return used, st


# --------------------------------------------------------------- phase 13
# Qwen3-30B-A3B trained at every published width, its depth cut 48 -> 4:
# 3.11 B parameters, ~49.8 GB of bf16 weights, fp32 masters and moments
# and bf16 gradients on the card's 80 GB
MOE_TRAIN_LAYERS = 4


def train_moe_path(dev):
    """Qwen3-30B-A3B (d_model 2048, 32/4 heads of 128, 128 experts top-8 of
    expert d_ff 768, vocab 151936) in bf16 at every published width with
    ``MOE_TRAIN_LAYERS`` of its 48 layers, random weights from seed 0,
    trained 4 steps through ``launch/steps.py::train_step`` on 4 x 4096
    tokens of ``SyntheticLMStream`` (seed 0), one microbatch, remat on,
    AdamW lr 1e-3.  The loss must be finite and fall and carry the aux
    (read off the first step: loss = cross-entropy + AUX_COEF x the layers'
    aux over their count, rtol 1e-5); each step must launch the flash
    forward twice a layer (remat) and the backward once, all on wgmma, the
    grouped GEMM 9 times a layer (3 forward, 3 recomputed, 3 dX), all on
    wgmma, its weight gradient 3 times a layer, all on wgmma, no other
    kernel and no plain version.  Logs s/step, tokens/s, peak memory, the
    capacity drops of the first step, a step's device time by kernel class
    beside its wall, and the model FLOPs over active parameters' share of
    the bf16 dense peak.  Returns (launches of the steps, numbers)."""
    from repro_torch import kernels, optim
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention_bwd import ops as bwd_ops
    from repro_torch.kernels.moe_gemm import ops as moe_ops
    from repro_torch.kernels.moe_gemm_wgrad import ops as wgrad_ops
    from repro_torch.launch.steps import train_step
    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    full = get_config("qwen3_moe_30b")
    cfg = dataclasses.replace(full, num_layers=MOE_TRAIN_LAYERS)
    L, steps, GB, S = cfg.num_layers, 4, 4, 4096
    ocfg = optim.AdamWConfig(lr=1e-3, zero1=False)
    stream = SyntheticLMStream(DataConfig(global_batch=GB, seq_len=S,
                                          vocab_size=cfg.vocab_size, seed=0))
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in stream.batch_at(i).items()}
               for i in range(steps + 2)]
    n_params = T.param_count(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = T.init_params(cfg, 0, dev)
    opt = optim.init_opt_state(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"  qwen3_moe_30b bf16, {L} of {full.num_layers} layers: "
        f"{n_params:,} parameters ({T.param_count(cfg, active_only=True):,} "
        f"active), weights + fp32 masters and moments drawn in "
        f"{init_s:.1f} s, {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB")

    # the first step's aux, cross-entropy and dispatch plans
    auxes, ces, plans = [], [], []
    orig_moe, orig_ce, orig_plan = moe.moe_fwd, T._chunked_ce, \
        moe_ops.dispatch_plan

    def rec_moe(c, p, x):
        y, aux = orig_moe(c, p, x)
        auxes.append(aux.detach())
        return y, aux

    def rec_ce(*a):
        ce = orig_ce(*a)
        ces.append(ce.detach())
        return ce

    def rec_plan(*a, **kw):
        plan = orig_plan(*a, **kw)
        plans.append(plan)
        return plan

    reset_counts()
    plain = _PlainCalls()
    losses, secs = [], []
    try:
        for i in range(steps):
            if i == 0:
                moe.moe_fwd, T._chunked_ce = rec_moe, rec_ce
                moe_ops.dispatch_plan = rec_plan
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = train_step(cfg, params, opt, batches[i], ocfg,
                             microbatches=1, remat=True)
            losses.append(out["loss"].item())
            secs.append(time.perf_counter() - t0)
            moe.moe_fwd, T._chunked_ce = orig_moe, orig_ce
            moe_ops.dispatch_plan = orig_plan
            log(f"  qwen3_moe_30b step {i}: loss {losses[-1]:.6f}, grad "
                f"norm {out['grad_norm'].item():.4f}, {secs[-1]:.3f} s")
    finally:
        moe.moe_fwd, T._chunked_ce = orig_moe, orig_ce
        moe_ops.dispatch_plan = orig_plan
        plain.restore()
    used = kernels.launches()
    routes = dict(moe_ops.ROUTE_LAUNCHES)
    wgrad_routes = dict(wgrad_ops.ROUTE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    want = {"flash_attention": 2 * L * steps,
            "flash_attention_bwd": L * steps, "moe_gemm": 9 * L * steps,
            "moe_gemm_wgrad": 3 * L * steps}
    if {k: n for k, n in used.items() if n} != want or \
            ops.ROUTE_LAUNCHES != {"wgmma": want["flash_attention"],
                                   "simt": 0} or \
            bwd_ops.ROUTE_LAUNCHES != {"simt": 0, "wgmma": L * steps} or \
            routes != {"wgmma": want["moe_gemm"], "mma": 0, "simt": 0} or \
            wgrad_routes != {"wgmma": want["moe_gemm_wgrad"], "mma": 0,
                             "simt": 0} or \
            any(plain.calls.values()):
        raise AssertionError(f"qwen3_moe_30b training: launches {used}, "
                             f"flash by route {ops.ROUTE_LAUNCHES}, "
                             f"backward by route {bwd_ops.ROUTE_LAUNCHES}, "
                             f"grouped GEMM by route {routes}, weight "
                             f"gradient by route {wgrad_routes}, plain "
                             f"versions called {plain.calls} (expected "
                             f"{want}, all on wgmma, no plain version)")
    # the first step's loss: its cross-entropy + the forward's L layers'
    # aux; the recompute (layers in reverse) must route as the forward did
    aux_first = [float(a) for a in auxes[:L]]
    want_loss = float(ces[0]) + T.AUX_COEF * sum(aux_first) / L
    if not all(math.isfinite(a) and a > 0 for a in aux_first) or \
            not math.isclose(losses[0], want_loss, rel_tol=1e-5):
        raise AssertionError(f"qwen3_moe_30b training: the first step's "
                             f"loss {losses[0]} is not its cross-entropy "
                             f"{float(ces[0])} + {T.AUX_COEF} x the aux "
                             f"{aux_first} / {L}")
    same_route = len(plans) == 2 * L and all(
        torch.equal(a.dest, b.dest) and torch.equal(a.block_expert,
                                                    b.block_expert)
        for a, b in zip(plans[:L], plans[L:][::-1]))
    if not same_route:
        raise AssertionError(f"qwen3_moe_30b training: the recompute routed "
                             f"otherwise than the forward ({len(plans)} "
                             f"plans for {L} layers)")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"qwen3_moe_30b training: losses {losses} "
                             f"(finite and falling expected)")
    kept = [(int(p.keep.sum()), p.keep.numel()) for p in plans[:L]]
    del plans
    step_s = statistics.median(secs[1:])
    tokens = GB * S
    flops = _model_flops(cfg, GB, S, active_only=True)
    mfu = flops / step_s / PEAK_FLOPS[torch.bfloat16]
    log(f"  qwen3_moe_30b {steps} steps of {GB} x {S}, one microbatch, "
        f"remat: losses {[round(x, 4) for x in losses]} (step 0: "
        f"cross-entropy {float(ces[0]):.6f} + {T.AUX_COEF} x aux "
        f"{[round(a, 4) for a in aux_first]} / {L}; the recompute routed "
        f"as the forward, bit for bit); {step_s:.3f} s/step "
        f"(median of steps 1-{steps - 1}; step 0 {secs[0]:.3f} s), "
        f"{tokens / step_s:.1f} tokens/s; peak device memory {peak:.2f} GB; "
        f"capacity drops of step 0 by layer "
        f"{[n - k for k, n in kept]} of {kept[0][1]} choices; launches "
        f"{used}; grouped GEMM by route {routes}; weight gradient by "
        f"route {wgrad_routes}; plain versions called "
        f"{plain.calls}; active-parameter MFU {mfu:.4f}")
    print(json.dumps({"qwen3_moe_train_mfu": mfu,
                      "model_flop_per_step": flops, "s_per_step": step_s}),
          flush=True)

    i = iter(range(steps, steps + 2))

    def one():
        train_step(cfg, params, opt, batches[next(i)], ocfg,
                   microbatches=1, remat=True)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    names = {}
    device_ms, by = _device_ms(one, n=1, names=names)
    wall = (time.perf_counter() - t0) * 1e3 / 2
    log(f"  qwen3_moe_30b a training step: device time from the profiler's "
        f"trace {device_ms:.1f} ms ("
        + ", ".join(f"{c} {ms:.1f}" for c, ms in sorted(
            by.items(), key=lambda kv: -kv[1]))
        + f"); the step's wall {wall:.1f} ms (host clock, mean of the "
        f"untraced and the traced step): device busy {device_ms / wall:.3f}"
        f"; its top kernels: {_top_kernels(names)}")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    secs_phase = time.perf_counter() - t_phase
    log(f"  phase 13 took {secs_phase:.1f} s")
    return used, dict(layers=L, params=n_params, losses=losses,
                      gemm_routes=routes, wgrad_routes=wgrad_routes,
                      step_s=step_s, step_secs=secs,
                      tokens_per_s=tokens / step_s, peak_gb=peak, mfu=mfu,
                      init_s=init_s, drops=[n - k for k, n in kept],
                      choices=kept[0][1], device_ms=device_ms, wall_ms=wall,
                      by_class=by, seconds=secs_phase)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ---------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available")
        return 2
    t_start = time.perf_counter()
    from repro_torch.kernels import build
    from repro_torch.launch.timing import Timer

    dev = torch.device("cuda", 0)
    # fp32 products in full fp32 (the fp32 tolerances assume it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("== 1. card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi failed: {smi.stderr.strip()}")
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    log("== 2. build")
    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"  built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
        f"(per kernel {secs})")
    for name in secs:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or \
                    "Compiling entry" in line:
                log(f"  {name}: {line.strip()}")

    log("== 3. kernels against their plain versions")
    timer = Timer(dev)
    stats = [check_flash(dev, timer), check_flash_bwd(dev, timer),
             check_paged(dev, timer), check_fused_sampling(dev, timer),
             check_moe_gemm(dev, timer), check_moe_gemm_wgrad(dev, timer),
             check_ssd_scan(dev, timer), check_ssd_scan_bwd(dev, timer)]
    log(f"  kernel-alone readings traced again after a dropped record: "
        f"{timer.retraced} rounds")
    del timer
    torch.cuda.empty_cache()

    log("== 4. serving paths: Llama-3.2-1B bf16, BatchMaster + NodeEngine")
    torch.cuda.reset_peak_memory_stats(dev)
    greedy, sampled = serve_main_path(dev)
    gc.collect()                    # the Llama engine sits in ref cycles
    torch.cuda.empty_cache()

    log("== 5. reduced fp32 models: cuda (kernels) vs cpu (plain versions)")
    reduced_cpu_vs_cuda(dev)

    log("== 6. the MoE path: Qwen3-30B-A3B bf16, module granularity")
    torch.cuda.reset_peak_memory_stats(dev)
    moe_greedy, _ = serve_moe_path(dev)
    gc.collect()                    # the MoE engines sit in ref cycles
    torch.cuda.empty_cache()

    log("== 7. the SSM path: Mamba2-370M bf16, model level")
    ssm = serve_ssm_path(dev)
    gc.collect()
    torch.cuda.empty_cache()

    log("== 8. the batch job: Llama-3.2-1B bf16, streaming driver, "
        "SIGKILL + resume, checkpoints")
    serve_batch_job(dev, card)
    gc.collect()
    torch.cuda.empty_cache()

    log("== 9. the MLA path: DeepSeek-R1 bf16 at its published widths, 2 "
        "layers")
    torch.cuda.reset_peak_memory_stats(dev)
    mla_greedy, mla_sampled = serve_mla_path(dev)
    log(f"  phase 9 launches: greedy {mla_greedy}, sampled {mla_sampled}")
    gc.collect()
    torch.cuda.empty_cache()

    log("== 10. the windowed decoders: H2O-Danube-1.8B and "
        "RecurrentGemma-2B bf16 at every published width, model level")
    windowed = {arch: serve_windowed_path(dev, arch, n) for arch, n in
                (("h2o_danube_1_8b", 6144), ("recurrentgemma_2b", 3072))}
    print(json.dumps({"windowed_path": windowed}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    log("== 11. the encoder-decoder and the vision decoder: Whisper-base "
        "and Pixtral-12B bf16 at every published width and full depth, "
        "model level")
    served = {}
    for arch, n in (("whisper_base", 32), ("pixtral_12b", 512)):
        served[arch] = serve_encdec_vlm_path(dev, arch, n)
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"encdec_vlm_path": served}), flush=True)

    log("== 12. training: SmolLM-360M bf16 at every published width and "
        "full depth, 8 steps of 16 x 4096; H2O-Danube-1.8B the same, 5 "
        "steps of 4 x 8192")
    trained, train_stats = train_smollm_path(dev)
    print(json.dumps({"train_path": train_stats}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    _, danube_stats = train_danube_path(dev)
    print(json.dumps({"train_path_danube": danube_stats}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"== 13. training: Qwen3-30B-A3B bf16 at every published width, "
        f"{MOE_TRAIN_LAYERS} of its 48 layers, 4 steps of 4 x 4096")
    moe_trained, moe_train_stats = train_moe_path(dev)
    print(json.dumps({"train_path_moe": moe_train_stats}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    log("== 14. training the SSM: Mamba2-370M bf16 at every published "
        "width and full depth, 5 steps of 16 x 4096")
    ssm_trained, ssm_train_stats = train_ssm_path(dev)
    print(json.dumps({"train_path_ssm": ssm_train_stats}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    for s in stats:     # each kernel's count from the path it was added for
        s["launches"] = {"fused_sampling": sampled, "moe_gemm": moe_greedy,
                         "ssd_scan": ssm, "flash_attention_bwd": trained,
                         "moe_gemm_wgrad": moe_trained,
                         "ssd_scan_bwd": ssm_trained}.get(
            s["name"], greedy)[s["name"]]

    log(f"== chip_smoke took {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(json.dumps({"kernels": [{k: s[k] for k in keys} for s in stats]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
