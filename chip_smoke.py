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
   30; RecurrentGemma-2B's B2 S8192 H10/1 at (256, 256) with its window of
   2048 and softcap of 30; DeepSeek-R1's B2 S4096 H128/128 at MLA's q/k
   192, v 128, causal; the windowed and softcapped rows with scores
   spread by SPREAD), in
   fp32 at SmolLM's, and in both types at the edges (S = 100, S = 1, G = 1
   and 3, non-causal at Sq != Skv, an offset q block; D 80 windowed and
   softcapped over ragged tiles and at an offset, tiles wholly past a
   window, a softcap at D 128, a window without the causal mask; D 256 at
   10 q heads on 1 causal, non-causal at Sq != Skv, and windowed and
   softcapped over ragged tiles; (192, 128) over ragged tiles, at S = 1,
   non-causal at Sq != Skv with G = 2 and at an offset q block);
   tolerances tied to the scale of the three gradients (fp32 atol 1e-4 x
   the largest |gradient|, rtol 1e-4; bf16 atol min(2e-2, 0.05 rms), rtol
   2e-2), and the plain version with a window one tile wider must fail a
   windowed bf16 row's; two launches must give equal bits (D 64, 128, the
   windowed D 80, RecurrentGemma's D 256 and DeepSeek-R1's (192, 128)) and
   every call land on its type's route; the training shapes are timed
   through the wrapper, alone (its three kernels' medians summed), plain,
   and against SDPA's backward (``autograd.grad``; the window as a
   boolean mask on the memory-efficient backend; none under a softcap,
   where a windowed row also times SDPA's masked backward without the
   cap, another function; at (192, 128) each backend that takes v's head
   dim apart from q's, the fastest named) beside the bound (2 (3 Dqk + 2
   Dv) operations a pair and head the mask lets through: 2.5 times the
   forward's where Dqk = Dv).
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
   its log-sum-exp output (``lse``, the decode regime's shard statistics)
   is held to the plain version's in both types (``LSE_TOL``; -1e30 on a
   length-0 row; the output equal in bits to a launch without it) at the
   first shape and at a rank's shard of Llama-3.2-1B's ``decode_32k``
   over four cards (``RANK_PAGED``: B32 over 32768, H32/8 D64), which is
   also timed with and without it;
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
   rows.  At phase 17's widths (DeepSeek-R1's 2 x 4096 tokens, top-8 of 16
   experts, D 7168, F 2048) the forward of w1/w3 and w2, dX on the
   transposed weights and the weight gradient of both are held to their
   plain versions in bf16 on wgmma (the weight gradient with equal bits
   over two launches) and timed beside their bounds.
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
   the scan launched twice a layer and its backward once; reduced fp32
   RecurrentGemma-2B (1 unit + 2 tail layers, window 64, S 160) the same
   way at head dim 32 and at its published 256, the flash kernels twice
   and once for its one attention sublayer; reduced fp32 Whisper-base (4
   heads of 64 on 4, 32 stub frames: the encoder's and the
   cross-attention's kernels non-causal), Pixtral-12B (8 heads of 128 on
   2, 8 stub patches) and DeepSeek-R1 at MLA's head dims (every flash
   launch at q/k 192, v 128 on the fp32 route, its grouped GEMM and
   weight gradient on simt) the same way;
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
    the SSD's own products counted: ``_model_flops``);
15. training the hybrid: RecurrentGemma-2B (26 layers: 8 units of RG-LRU,
    RG-LRU and local attention, 2 tail RG-LRU layers; d_model 2560, 10
    heads of 256 on one kv head, lru_width 2560, window 2048, softcap 30,
    vocab 256000) in bf16 at every published width and full depth, random
    weights from seed 0, 5 steps of 4 x 8192 tokens in
    ``HYBRID_MICROBATCHES`` (4) microbatches (so that the window binds; at
    2 the peak passed 76 GB), remat
    on (a unit or a tail layer a checkpoint), AdamW lr 3e-4 (at 1e-3 the
    loss swings and stands above the first after 5 steps): the loss must
    be finite and fall and a rerun from seed 0 must repeat the first
    step's loss bit for bit; every step must launch the flash forward 2 x
    8 x n_mb times and its backward 8 x n_mb times (the 8 attention
    sublayers), all on wgmma at D 256, no other kernel and no plain
    version; it logs s/step, tokens/s, peak memory, a step's device time
    by kernel class beside its wall, the MFU
    (``recurrentgemma_2b_train_mfu``: attention over the window in the 8
    attention sublayers) and one rec sublayer's RG-LRU forward and
    forward + backward device ms at a microbatch with the 18 rec
    sublayers' share of the step;
16. training the encoder-decoder and the vision decoder: Whisper-base at
    every published width and full depth, 5 steps of 16 rows of 448
    decoder tokens over 1536 stub frames in 2 microbatches, and
    Pixtral-12B at every published width, its depth cut 40 -> 8
    (``PIXTRAL_TRAIN_LAYERS``: 3.55 B parameters, 56.8 GB at 16 B a
    parameter), 5 steps of 4 x (1024 stub patches + 3072 tokens) in one
    microbatch, labels -1 over the patches; bf16, random weights from seed
    0, stubs from ``launch/train.py::step_batch``, remat on, AdamW at
    ``TRAIN_LR`` (Whisper 1e-3, Pixtral 1e-4: at 1e-3 and 3e-4 its loss
    rose within 5 steps): each loss finite and falling, the first loss again
    bit for bit on a rerun from seed 0; every step the flash forward twice
    and its backward once per attention call and microbatch (Whisper's 18
    a forward: 6 encoder, 6 decoder self- and 6 cross-attention, 12 of them
    non-causal; Pixtral's 8), all on wgmma, no other kernel and no plain
    version; each logs the reckoned memory before the run, s/step,
    tokens/s, peak memory, a step's device time by kernel class and the
    MFU (``whisper_base_train_mfu``, ``pixtral_12b_train_mfu``);
17. training MLA: DeepSeek-R1 (d_model 7168, MLA with 128 heads, q_lora
    1536, kv_lora 512, rope 64, top-8 of expert d_ff 2048 with one shared
    expert of 2048, vocab 129280) in bf16 at every published width, its
    depth cut 61 -> 2 and its experts 256 -> 16 (3.73 B parameters, 59.6
    GB at 16 B a parameter), random weights from seed 0, 5 steps of 2 x
    4096 tokens in one microbatch, remat on, AdamW lr 1e-4 (its loss rose
    at 1e-3; ``TRAIN_LR``) (phase 13's
    checks: a finite, falling loss holding the aux, the recompute routed
    as the forward; every flash launch, forward and backward, at q/k 192,
    v 128 on wgmma, the grouped GEMM 9 times and its weight gradient 3
    times a layer on wgmma, no plain version; ``deepseek_r1_train_mfu``);
18. the multi-GPU training path on one card.  (a) An NCCL process group
    of world size 1 on the card, the (1, 1) mesh realized over it, every
    collective of ``distributed/collectives.py`` sent through it once
    (each returns its input), then 3 steps of
    ``launch/steps.py::build_cell``'s sharded step of Qwen3-30B-A3B at
    phase 13's cut (4 layers, 4 x 4096 tokens, remat, AdamW lr 1e-3,
    ZeRO-1 on) from seed 0: each loss and grad norm must equal phase 13's
    in bits (a group of one skips its collectives; none is recorded), every
    flash, flash-backward, grouped-GEMM and weight-gradient launch on
    wgmma, no plain version; then the loss and its gradients once more
    with every group's collectives sent through NCCL (``skip_one=False``),
    so that the tensor-parallel callers run (``embed_share``'s reduce,
    ``_train_layer``'s ``copy_in`` / ``reduce_out`` pairs,
    ``_chunk_ce_tp``): loss rtol 1e-5, gradients TOL[bf16] of scale, only
    all-reduces.  (b) Rank by rank at tp 8, at full width, B2 S4096: one
    Llama-3.2-1B and one Qwen3-30B-A3B layer, each sublayer forward and
    backward through the port's shares (``attention_share``,
    ``ffn_share``) on each rank's slices (``shard_params``: 4 q heads over
    1 kv head, Qwen3's kv replicated and sliced to head m // 2; 1/8 of the
    MLP columns; 16 of 128 experts), the partials summed in rank order in
    bf16 where ``_train_layer`` all-reduces them, held with every gradient
    to the one-device sublayer within TOL[bf16] of each tensor's scale, 8
    launches of each flash kernel a layer and 48 grouped-GEMM and 24
    weight-gradient launches for the MoE, no plain version; Qwen3's
    embedding over 8 vocab shards (``embed_share``, equal bits) and its
    cross-entropy (``ce_shard`` merged by ``ce_merge``: value rtol 1e-5,
    dh and dlm_head TOL[bf16] of scale); the flash kernel timed at the
    head shard (H 4 over Hkv 1, D 64 and 128) beside the one-device
    heads.  It prints
    ``{"multi_gpu_path": ...}`` with the kernel shapes, step times and
    peak memory.  NCCL at world size above 1 is not exercised here (one
    card): ``tests/test_torch_cuda.py::test_sharded_training_over_every_card``
    runs it on a machine with more.
19. the multi-GPU serving path on one card: ``build_cell``'s prefill and
    decode cells of Llama-3.2-1B in bf16 at every published width and full
    depth on an NCCL group of one (random weights from seed 0; each cell's
    ``init_state`` equal in bits to ``init_params``).  (a) The prefill cell
    on 4 prompts of 2048 tokens into a cache of 32768, then 16 decode-cell
    steps: every token equal in bits to the one-device ``prefill`` (its
    cache installed in ``init_cache``'s) and ``decode_step``; then again
    with every collective sent through NCCL (``skip_one=False``: the
    decode regime's shard attention, ``merge_shards``, the vocabulary
    argmax and the prefill's re-layout run at tp 1): the same tokens and
    the collectives the design predicts (a prefill 1 + 2 L all-reduces,
    an all-gather and 2 all-to-alls; a step 1 + 3 L all-reduces and an
    all-gather).  (b) The decode cell at a rank's share of ``decode_32k``
    over four cards, B 32 x 32768 (a 34.4 GB cache of random bf16
    values, row i at length 32752 - i), 16 steps: ms a step, output
    tokens/s, peak memory, the paged kernel's launches by route (every
    one on mma), no plain version, with the collectives skipped and sent
    (the shard attention with its lse, ``merge_shards`` and the
    vocabulary argmax at tp 1).  (c) Rank by rank at tp 4 in one process:
    one layer of that cache split in 4 sequence shards, each rank's
    ``decode_attention_shard`` merged by ``merge_shards``, against the
    whole cache's launch within TOL[bf16] (the merge rounds twice) and
    the plain version in fp32.  It prints ``{"multi_gpu_serving": ...}``.  Four cards:
    ``tests/test_torch_cuda.py::test_sharded_serving_over_every_card``.
20. the rest of the training regimes on one card.  (a) ``build_cell``'s
    ``fsdp`` cell (ZeRO-3) of SmolLM-360M in bf16 at every published width
    with 8 of its 32 layers on an NCCL group of one, every collective sent
    (each leaf gathered where it is read, again in the recompute, and its
    gradient reduce-scattered), 3 steps of 4 x 4096: each loss and grad
    norm equal in bits to the one-device ``train_step``'s, the gathers and
    reduce-scatters a step as designed, every flash launch on wgmma.  (b)
    The ``seq`` attention shares (q rows over the ranks, K/V of every
    position) of one SmolLM-360M and one Qwen2-0.5B layer at tp 4, rank by
    rank, B2 S4096 bf16: the rank sum's output at ``_scaled_tol`` of the
    one-device sublayer and its gradients within TOL[bf16] of scale; the
    check refuses a sum without the last rank and shares whose q
    positions are not offset.  (c) Both flash kernels at each seq rank's
    shape of SmolLM's B8 S4096 H15/5 D64 (1024 q rows at their offset
    against 4096 keys) against their plain versions, timed alone, with
    their bounds and SDPA's times under the rank's mask.  (d) Qwen2-0.5B's
    prefill cell in the ``seq`` mode and its decode cell at full depth in
    fp32 over 4 ranks run as threads on the card: the one-device tokens,
    the collectives as designed.  It prints ``{"multi_gpu_seq_fsdp":
    ...}``.  Four cards: ``tests/test_torch_cuda.py``'s ``smollm_seq`` and
    ``smollm_fsdp`` training cases, Qwen2-0.5B in the serving case, and
    ``test_seq_and_fsdp_bf16_readings_over_every_card``.
21. the attention families over a model group on one card.  (a) One
    DeepSeek-R1 layer at every published width (16 of its 256 experts)
    rank by rank at tp 8, B2 S4096 bf16, as phase 18 (b): MLA's attention
    share (16 q heads a rank, the latent projections and norms read
    whole) and the MoE share with its shared expert's columns, outputs,
    input gradients and every leaf's gradient within TOL[bf16] of scale;
    the check refuses ``wq_a``'s gradient of one rank alone and the
    shared expert added whole on every rank.  (b) One DeepSeek-R1 layer's
    absorbed decode for a rank's B32 over a latent cache of 32768 in 4
    sequence shards rank by rank, merged after ``wv_b``, against the whole
    cache's at ``_scaled_tol``; the check refuses the merge without rank
    0's shard; the merge's bytes a rank beside the value- and
    latent-space reckonings.  (c) H2O-Danube-1.8B at full width and depth:
    ``build_cell``'s prefill cell (4 prompts of 6144, longer than the
    window, into 8192: a ring of 4096 slots) and 16 decode-cell steps on
    an NCCL group of one with every collective sent give the one-device
    tokens and logits in bits, with the design's collectives; then one
    layer's ring in 4 slot blocks rank by rank, merged, against the whole
    ring (the refusal as (b)), with the ring attention's and the merge's
    times.  (d) Pixtral-12B (8 layers) the same with 1024 patches before
    512 tokens into 2048, then one layer's paged decode in 4 shards.  (e)
    The flash forward and backward at a DeepSeek-R1 rank's 32 heads (B2
    S4096, q/k 192, v 128, causal) and the grouped GEMM's forward and dX
    at a rank's 64 of 256 experts, against their plain versions, timed
    alone, with their bounds and the library calls' times.  It prints
    ``{"multi_gpu_attention_families": ...}``.  Four cards:
    ``tests/test_torch_cuda.py``'s ``deepseek_tp`` and ``pixtral_tp``
    training cases, DeepSeek-R1, Pixtral-12B and H2O-Danube-1.8B in the
    serving case, and ``test_deepseek_decode_256_experts_over_every_card``.
22. the recurrent and encoder-decoder families over a model group on one
    card.  (a) ``build_cell``'s ``tp`` train cell on an NCCL group of one,
    3 steps each of Mamba2-370M (full depth, 4 x 4096), RecurrentGemma-2B
    (1 unit + 2 tail layers, 2 x 8192) and Whisper-base (full, 16 x 448
    over 1536 frames), bf16, AdamW lr 1e-4: losses and grad norms equal
    the one-device ``train_step``'s in bits; then the loss and its
    gradients with every collective sent, as many all-reduces as the
    design's, the loss within rtol 1e-5 and every gradient finite (their
    gap to the skipped run's recorded).  (b) One layer of each at every
    published width, rank by rank against the one-device layer:
    Mamba2-370M's SSM layer at tp 8 (its ranks as threads: the gated
    norm's mean square is summed over them), RecurrentGemma-2B's RG-LRU and local-attention sublayers
    at tp 2 (heads) and tp 4 (``seq``), Whisper-base's decoder layer with
    its cross-attention at tp 8; outputs and every gradient within
    TOL[bf16] of scale, and the check refuses the SSM norm over a rank's
    channels, B's gradient of one rank alone and Whisper's positions
    added before the embedding's reduce.  (c) Their serving cells on the
    NCCL group of one, collectives skipped and sent: Mamba2-370M 4 x 4096
    and 16 steps, RecurrentGemma-2B 4 x 3072 into 4096 (its ring of 2048
    wrapped), Whisper-base 4 x 32 into 448; tokens and logits equal the
    one-device path's bits, the sent collectives the design's; Whisper's
    cross cache in 4 shards merged against the whole at ``_scaled_tol``,
    refusing the merge without rank 0's shard.  (d) ``ssd_scan`` and
    ``ssd_scan_bwd`` at a Mamba2-370M rank's 4 of 32 heads, and the flash
    forward and backward at RecurrentGemma-2B's ``seq`` rank 3 of 4, timed
    against their plain versions and bounds.  It prints
    ``{"multi_gpu_recurrent_encdec": ...}``.  Four cards:
    ``tests/test_torch_cuda.py``'s ``mamba_tp``, ``recurrentgemma_tp`` and
    ``whisper_tp`` training cases and the three in the serving case.

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
# a rank's decode attention in the decode regime: Llama-3.2-1B's
# decode_32k (B 128 x 32768) over four cards of data 1 would hold B 128
# over 8192 a rank; phase 19 (b) serves the same bytes a layer as B 32
# over the whole 32768 on one card, rows at 32768 - 16 and below
RANK_PAGED = (32, 32768, 32, 8, 64, [32768 - 16 - i for i in range(32)])


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

        def record(lib, q, k_pool, v_pool, table, lengths, lse=None):
            self.seen.append((q.shape[1] // k_pool.shape[2], q.shape[2],
                              table.shape[1] * k_pool.shape[1],
                              ops.route(q.dtype)))
            return self.orig(lib, q, k_pool, v_pool, table, lengths, lse)
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
    fall outside the row's tolerance ``tol``.  Returns the wrong output's
    max abs err."""
    off = ~torch.isclose(wrong.float(), want.float(), **tol)
    err = (wrong.float() - want.float()).abs().max().item()
    log(f"  {name}: the check refuses the {what}: {int(off.sum())} of "
        f"{off.numel()} outputs out of tolerance, max abs err {err:.3e} "
        f"(atol {tol['atol']:.3e})")
    if not off.any():
        raise AssertionError(f"{name}: the check cannot see the {what}")
    return err


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
    # RecurrentGemma-2B's training shape (phase 15's microbatch): 10 q
    # heads on one kv head of 256, the window of 2048 and the softcap of
    # 30 on its scores
    "recurrentgemma B2 S8192 H10/1 D256 w2048 cap30": (2, 8192, 10, 1, 256,
                                                       2048, 30.0),
}
DANUBE_BWD = "danube B4 S8192 H32/8 D80 w4096"
RG_BWD = "recurrentgemma B2 S8192 H10/1 D256 w2048 cap30"
# DeepSeek-R1's training shape (phase 17's microbatch of 2 x 4096 tokens):
# 128 q heads on 128 kv heads, q/k 192 (128 + 64 rope columns), v 128
MLA_BWD = "deepseek B2 S4096 H128/128 D192/128"
MLA_TRAIN = (2, 4096, 128, 128)     # B, S, H, Hkv


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


def _flash_bwd_bound(q, k, v, causal=True, window=0, q0=None):
    """(bound ms, bound_by, GFLOP, MB) of one backward call: q, k, v, out,
    dout and lse read once, dq, dk, dv written once, at the card's memory
    rate, against the products of the pairs the mask lets through (causal
    and windowed; every batch row has the same positions here) at its peak
    for the storage type: S = Q K^T (recomputed) and dK = dS^T Q, dQ = dS K
    over q/k's head dim Dqk, dP = dO V^T and dV = P^T dO over v's Dv, 2 (3
    Dqk + 2 Dv) a pair and head (2.5 times the forward's 2 (Dqk + Dv) where
    Dqk = Dv).  The q rows sit at positions ``q0``.. (by default the last
    Sq of the keys' when causal)."""
    B, Sq, H, D = q.shape
    Skv, Dv = k.shape[1], v.shape[3]
    if q0 is None:
        q0 = Skv - Sq if causal else 0
    pairs = _pairs(Sq, Skv, causal, window, q0)
    flops = 2.0 * (3 * D + 2 * Dv) * pairs * B * H
    nbytes = (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
              + 2 * B * Sq * H * Dv) * q.element_size() \
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


def _sdpa_bwd_backends_ms(timer, q, k, v, dout, causal=True):
    """SDPA's backward (``autograd.grad`` of one call) on the same inputs
    under each backend forced in turn (flash, memory-efficient, cuDNN):
    {backend: ms} of those that take the call (q/k's head dim apart from
    v's is refused by some), the refusals logged."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    g = dout.transpose(1, 2)
    out = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        try:
            with sdpa_kernel(backend):
                o = F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=causal)
                out[name] = timer(lambda: torch.autograd.grad(
                    o, (qt, kt, vt), g, retain_graph=True), iters=10)
            log(f"  sdpa backward on {name} (q/k {q.shape[3]}, v "
                f"{v.shape[3]}): {out[name]:.4f} ms")
        except RuntimeError as exc:
            log(f"  sdpa backward on {name} refuses q/k {q.shape[3]}, v "
                f"{v.shape[3]}: {str(exc).splitlines()[0][:200]}")
        del qt, kt, vt
    return out


def check_flash_bwd(dev, timer):
    """The flash backward's kernel against its plain version on the same
    out and lse, in bf16 at the training shapes (windowed and softcapped
    ones with spread scores) and in both types at the edges; equal bits
    over two launches at D 64, 80 (windowed), 128, 256 and MLA's (192,
    128); every call on the route of its type (bf16 on wgmma); timed at
    the training shapes through the wrapper, alone (the sum of its three
    kernels' medians in the profiler's trace), its plain version and
    SDPA's backward (``autograd.grad`` of one
    ``scaled_dot_product_attention``, timed alone; with a boolean mask for
    the window, none under a softcap; at q/k 192, v 128 on each backend
    that takes the pair, the fastest named) beside the bound."""
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
             window=0, softcap=0.0, spread=False, Dv=None):
        Dv = D if Dv is None else Dv
        q = _rand(gen, (B, Sq, H, D), dtype, dev)
        if spread:
            q = (q.float() * SPREAD).to(dtype)
        k = _rand(gen, (B, Skv, Hkv, D), dtype, dev)
        v = _rand(gen, (B, Skv, Hkv, Dv), dtype, dev)
        qp = (torch.arange(Sq, dtype=torch.int32, device=dev) + q0)[None] \
            .expand(B, Sq).contiguous()
        kp = torch.arange(Skv, dtype=torch.int32, device=dev)[None] \
            .expand(B, Skv).contiguous()
        kw = dict(causal=causal, window=window, softcap=softcap)
        out, lse = flash.flash_attention(q, k, v, qp, kp, return_lse=True,
                                         **kw)
        dout = _rand(gen, (B, Sq, H, Dv), dtype, dev)
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
    B, S, H, Hkv = MLA_TRAIN
    timed[MLA_BWD] = case(f"{MLA_BWD} causal", torch.bfloat16, B, S, S, H,
                          Hkv, MLA_HEADS[0], Dv=MLA_HEADS[1])
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
        # D 256 (RecurrentGemma's heads): causal without a window, Sq !=
        # Skv, a ragged length under the window and the softcap
        case("D256 S1000 G10 causal", dtype, 1, 1000, 1000, 10, 1, 256)
        case("D256 non-causal Sq40 Skv130", dtype, 2, 40, 130, 4, 2, 256,
             causal=False)
        case("D256 S300 (ragged tiles) G10 w96 cap30", dtype, 2, 300, 300,
             10, 1, 256, window=96, softcap=30.0, spread=True)
        # MLA's q/k 192, v 128 (DeepSeek-R1: as many kv heads as q heads)
        Dq, Dv = MLA_HEADS
        case("D192/128 S100 (ragged tiles)", dtype, 2, 100, 100, 8, 8, Dq,
             Dv=Dv)
        case("D192/128 S1", dtype, 2, 1, 1, 8, 8, Dq, Dv=Dv)
        case("D192/128 non-causal Sq40 Skv130 G2", dtype, 2, 40, 130, 4, 2,
             Dq, causal=False, Dv=Dv)
        case("D192/128 offset q Sq64 Skv200", dtype, 1, 64, 200, 8, 8, Dq,
             q0=136, Dv=Dv)
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
                  DANUBE_BWD, RG_BWD, MLA_BWD):
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
            q, k, v, kw["causal"], kw["window"])
        ms = timer(lambda: flash_attention_bwd(*args, **kw), iters=10)
        alone_ms = sum(timer.kernel_ms(
            lambda: flash_attention_bwd(*args, **kw), (entry,), iters=10)
            for entry in KERNEL_ENTRIES["flash_attention_bwd"]
            if not entry.endswith("_simt"))     # bf16: wgmma
        plain_ms = timer(lambda: flash_attention_bwd_plain(*args, **kw),
                         iters=2, warmup=1)
        backend = None
        if v.shape[3] != q.shape[3]:
            # q/k's head dim apart from v's: each SDPA backend that takes
            # it, the fastest named
            by_backend = _sdpa_bwd_backends_ms(timer, q, k, v, dout,
                                               kw["causal"])
            backend = min(by_backend, key=by_backend.get) if by_backend \
                else None
            library_ms = by_backend.get(backend)
        else:
            library_ms = _sdpa_bwd_ms(timer, q, k, v, dout, kw)
        rows[shape] = dict(max_abs_err=e, ms=ms, kernel_alone_ms=alone_ms,
                           plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=library_ms,
                           window=kw["window"], softcap=kw["softcap"])
        if backend is not None:
            rows[shape]["library_backend"] = backend
        if kw["softcap"] and kw["window"]:
            # no library call computes a softcapped backward: SDPA's masked
            # backward at the same shape and window without the cap, a
            # yardstick of another function
            nocap = _sdpa_bwd_ms(timer, q, k, v, dout,
                                 dict(kw, softcap=0.0))
            rows[shape]["sdpa_masked_nocap_ms"] = nocap
            log(f"  flash_attention_bwd bf16 {shape}: sdpa's masked "
                f"backward at the same shape and window without the "
                f"softcap (another function) {nocap} ms")
        log(f"  flash_attention_bwd bf16 {shape} causal: kernel {ms:.4f} ms "
            f"({alone_ms:.4f} ms alone: its three kernels in the "
            f"profiler's trace), plain {plain_ms:.4f} ms, sdpa backward "
            f"{library_ms} ms{f' ({backend})' if backend else ''}, bound "
            f"{bound_ms:.4f} ms ({bound_by}; "
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

    def case(tag, dtype, q, kp, vp, table, lengths, tol=None):
        got = paged_attention(q, kp, vp, table, lengths)
        calls[ops.route(dtype)] += 1
        torch.cuda.synchronize()
        want = paged_attention_plain(q, kp, vp, table, lengths)
        for r in (lengths <= 0).nonzero().flatten().tolist():
            if got[r].any() or not torch.equal(got[r], want[r]):
                raise AssertionError(f"paged_attention {tag}: the length-0 "
                                     f"row {r} is not exact zeros")
        return _check(f"paged_attention {tag} {str(dtype)[6:]}", got, want,
                      dtype, tol)

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
    # the log-sum-exp output at the first shape and at a rank's shard of
    # the decode regime, in both types, two rows of each at length 0
    lse_err = {}
    for shape in (PAGED_SHAPES[0], RANK_PAGED):
        B, S, H, Hkv, D, lens = shape
        lens = [0] + list(lens[1:-1]) + [0]
        label = paged_label(B, S, H, Hkv, D, lens)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            q = _rand(gen, (B, H, D), dtype, dev)
            kp, vp, table, _, _ = dense_view(B, S, Hkv, D, dtype)
            lse = torch.empty((B, H), dtype=torch.float32, device=dev)
            got = paged_attention(q, kp, vp, table, lengths, lse)
            bare = paged_attention(q, kp, vp, table, lengths)
            calls[ops.route(dtype)] += 2
            want_lse = torch.empty_like(lse)
            want = paged_attention_plain(q, kp, vp, table, lengths, want_lse)
            torch.cuda.synchronize()
            tag = f"paged_attention lse {label} {str(dtype)[6:]}"
            if not torch.equal(got, bare):
                raise AssertionError(f"{tag}: the output with lse differs "
                                     f"from the launch without it")
            if not (lse[lengths == 0] == ops.NEG).all():
                raise AssertionError(f"{tag}: a length-0 row's lse is not "
                                     f"-1e30")
            _check(f"paged_attention {label} (with lse)", got, want, dtype,
                   _scaled_tol(want, dtype))
            lse_err[f"{label} {str(dtype)[6:]}"] = _check(
                tag, lse, want_lse, torch.float32, LSE_TOL[dtype])
            del q, kp, vp, table, lse, want_lse, got, bare, want
        torch.cuda.empty_cache()
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
    # a rank's shard of the decode regime, bf16, timed with lse as the
    # decode cell launches it (its alone time also without)
    B, S, H, Hkv, D, lens = RANK_PAGED
    rank_label = f"rank {paged_label(*RANK_PAGED)}"
    q = _rand(gen, (B, H, D), torch.bfloat16, dev)
    kp, vp, table, kc, vc = dense_view(B, S, Hkv, D, torch.bfloat16)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    rank_lse = torch.empty((B, H), dtype=torch.float32, device=dev)
    # rows ~32,750 keys long average N(0, 1) values to an rms of ~9e-3:
    # TOL's atol would pass a kernel that loses a shard of the row, so the
    # check is held to the output's scale and must refuse a V summed
    # wrong over one cluster rank's eighth of each row (its statistics,
    # from K alone, right)
    want = paged_attention_plain(q, kp, vp, table, lengths)
    tol = _scaled_tol(want, torch.bfloat16)
    err = case(rank_label, torch.bfloat16, q, kp, vp, table, lengths, tol)
    vw = vc.clone()
    vw[:, S - S // 8:] = 0
    rank_refused = _refuses_wrong(
        f"paged_attention {rank_label}", want, paged_attention_plain(
            q, kp, vw.view(vp.shape), table, lengths),
        "V of each row's last eighth zeroed", tol)
    log(f"  paged_attention {rank_label}: tolerance atol {tol['atol']:.3e} "
        f"rtol {tol['rtol']:.0e}; kernel err {err:.3e}, wronged plain "
        f"{rank_refused:.3e}")
    del want, vw
    timed[rank_label] = (err, (q, kp, vp, table, lengths, rank_lse), kc, vc)
    for label, (e, args, kc, vc) in timed.items():
        q, kp, vp, table, lengths = args[:5]
        bound_ms, bound_by, mb = bound(q, kp, table, lengths)
        ms = timer(lambda: paged_attention(*args))
        alone_ms = timer.kernel_ms(lambda: paged_attention(*args),
                                   KERNEL_ENTRIES["paged_attention"])
        plain_ms = timer(lambda: paged_attention_plain(*args), iters=5)
        extra = {}
        if len(args) > 5:       # timed with lse: alone without it too
            extra["kernel_alone_ms_without_lse"] = timer.kernel_ms(
                lambda: paged_attention(*args[:5]),
                KERNEL_ENTRIES["paged_attention"])
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
                           host_us=host_us, library_host_us=library_host_us,
                           **extra)
        log(f"  paged_attention {str(q.dtype)[6:]} {label}"
            f"{' with lse' if extra else ''}: kernel {ms:.4f} ms "
            f"({alone_ms:.4f} ms alone in the profiler's trace"
            + (f", {extra['kernel_alone_ms_without_lse']:.4f} without lse"
               if extra else "") + f"), plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{bound_ms:.6f} ms ({bound_by}; {mb:.2f} MB); host "
            f"{host_us:.1f} us a call, sdpa's {library_host_us:.1f} us")
    del timed, kc, vc, q, kp, vp
    torch.cuda.empty_cache()
    rows["lse_max_abs_err"] = lse_err
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
# DeepSeek-R1's experts at phase 17's cut: 2 x 4096 tokens, top-8 of 16 of
# its 256 experts, D 7168, expert F 2048
TRAIN_MLA_MOE = dict(T=2 * 4096, E=16, k=8, D=7168, F=2048)


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


def _check_mla_moe_train(dev, timer, gen):
    """The grouped GEMM at phase 17's widths (``TRAIN_MLA_MOE``), as the
    MoE layer and ``GroupedGemmFn`` call it: the forward of w1/w3 (D -> F)
    and w2 (F -> D), dX through the forward kernel on the transposed
    weights, and the weight gradient of both, each on the wgmma route
    against its plain version in bf16 (the weight gradient with equal bits
    over two launches), timed beside its bound.  Returns the rows."""
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.kernels.moe_gemm.ops import grouped_gemm
    from repro_torch.kernels.moe_gemm_wgrad import ops as wops
    T, E, k, D, Fe = (TRAIN_MLA_MOE[n] for n in ("T", "E", "k", "D", "F"))
    plan, rows_of = _routed(gen, dev, T, E, k)
    be, bt = plan.block_expert, plan.block_t
    n_choices = int(plan.keep.sum().item())
    bf = torch.bfloat16
    rows = {}

    def weights(Di, Do):
        return (0.02 * torch.randn((E, Di, Do), generator=gen,
                                   device=dev)).to(bf)

    # (label, the input's width, the weight (E, in, out) as the call gets
    # it): the forward on w, dX on w's transpose made contiguous
    w1, w2 = weights(D, Fe), weights(Fe, D)
    calls = [("w1/w3 forward (D -> F)", D, w1),
             ("w2 forward (F -> D)", Fe, w2),
             ("dX of w1/w3 (dy F -> D)", Fe, w1.transpose(1, 2).contiguous()),
             ("dX of w2 (dy D -> F)", D, w2.transpose(1, 2).contiguous())]
    for label, Di, w in calls:
        xs = rows_of(_rand(gen, (T, Di), bf, dev))
        ops.reset_routes()
        got = grouped_gemm(xs, w, be, block_t=bt)
        torch.cuda.synchronize()
        if ops.ROUTE_LAUNCHES["wgmma"] != 1:
            raise AssertionError(f"moe_gemm deepseek {label}: launched by "
                                 f"route {ops.ROUTE_LAUNCHES} (expected "
                                 f"wgmma)")
        err = _check(f"moe_gemm deepseek {label} bt{bt} rows "
                     f"{xs.shape[0]} bf16", got,
                     _plain_blocks(xs, w, be, block_t=bt), bf)
        bound, by, nbytes, flops = _gemm_bound(plan, xs, w, n_choices)
        ms = timer(lambda: grouped_gemm(xs, w, be, block_t=bt))
        rows[label] = dict(max_abs_err=err, ms=ms, bound_ms=bound,
                           bound_by=by, route="wgmma")
        log(f"  moe_gemm bf16 deepseek {label} (T={T}, top-{k} of {E}, "
            f"{n_choices} kept choices): kernel {ms:.4f} ms, bound "
            f"{bound:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP)")
        del xs, got
    del w1, w2, calls
    for label, (M, N) in (("w1/w3 dW (D x F)", (D, Fe)),
                          ("w2 dW (F x D)", (Fe, D))):
        x = rows_of(_rand(gen, (T, M), bf, dev))
        dy = rows_of(_rand(gen, (T, N), bf, dev))
        wops.reset_routes()
        got = wops.grouped_gemm_wgrad(x, dy, be, E, block_t=bt)
        again = wops.grouped_gemm_wgrad(x, dy, be, E, block_t=bt)
        torch.cuda.synchronize()
        if wops.ROUTE_LAUNCHES != {"wgmma": 2, "mma": 0, "simt": 0} or \
                not torch.equal(got, again):
            raise AssertionError(f"moe_gemm_wgrad deepseek {label}: routes "
                                 f"{wops.ROUTE_LAUNCHES} (expected wgmma), "
                                 f"equal bits {torch.equal(got, again)}")
        err = _check(f"moe_gemm_wgrad deepseek {label} bt{bt} bf16 (wgmma, "
                     f"two launches equal bits)", got,
                     _wgrad_plain_blocks(x, dy, be, E, bt, chunk=64), bf)
        bound, by, nbytes, flops = _wgrad_bound(plan, n_choices, E, M, N, 2)
        ms = timer(lambda: wops.grouped_gemm_wgrad(x, dy, be, E,
                                                   block_t=bt))
        rows[label] = dict(max_abs_err=err, ms=ms, bound_ms=bound,
                           bound_by=by, route="wgmma")
        log(f"  moe_gemm_wgrad bf16 deepseek {label} (T={T}, top-{k} of "
            f"{E}): kernel {ms:.4f} ms, bound {bound:.4f} ms by {by} "
            f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        del x, dy, got, again
    return rows


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
    one ``torch._grouped_mm`` (a yardstick only).  Then the forward, dX
    and weight gradient at DeepSeek-R1's phase-17 widths
    (``_check_mla_moe_train``)."""
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
    print(json.dumps({"moe_gemm_deepseek_train_shapes":
                      _check_mla_moe_train(dev, timer, gen)}), flush=True)
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
    # the hybrid (1 unit + 2 tail layers, window 64, softcap 30) at head
    # dim 32 and at its published 256, S 160 past the window: the RG-LRU
    # scan under LinearScanFn, the backward kernel's fp32 route at D 256
    _reduced_train_pair(dev, "recurrentgemma_2b", S=160)
    _reduced_train_pair(dev, "recurrentgemma_2b", over=dict(head_dim=256),
                        S=160)
    # the encoder-decoder (its encoder and cross-attention non-causal, 32
    # stub frames) and the vision decoder (8 stub patches) at their
    # published head dims and groups, and MLA at DeepSeek-R1's head dims,
    # so that its fp32 kernels run at q/k 192, v 128
    _reduced_train_pair(dev, "whisper_base",
                        over=dict(num_heads=4, num_kv_heads=4, head_dim=64))
    _reduced_train_pair(dev, "pixtral_12b",
                        over=dict(num_heads=8, num_kv_heads=2, head_dim=128))
    _reduced_train_pair(dev, "deepseek_r1",
                        over=dict(head_dim=MLA_HEADS[1],
                                  rope_head_dim=MLA_HEADS[0] - MLA_HEADS[1]),
                        flash_dims=MLA_HEADS)


def _attn_layers(cfg) -> int:
    """The attention calls of a config's forward: the hybrid's attention
    sublayers (``block_pattern``'s "attn" in each full unit), the SSM's
    none, the encoder-decoder's encoder layers and its decoder layers
    twice (self- and cross-attention), else every layer."""
    from repro_torch.models import transformer as T
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return T._hybrid_counts(cfg)[0] * cfg.block_pattern.count("attn")
    if cfg.family == "audio":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


def _reduced_train_pair(dev, arch, over=None, S=128, flash_dims=None):
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
    scan's backward once; the hybrid's attention sublayers as attention
    layers (its RG-LRU sublayers launch no kernel); the encoder-decoder's
    encoder layers once and decoder layers twice (``_attn_layers``).  The
    encoder-decoder's batch carries stub frames, the vision decoder's stub
    patches (``frontend_stub``, labels -1 over them).  With ``flash_dims``
    every flash launch on "cuda" must be at those (q/k, v) head dims."""
    from repro_torch import kernels, optim
    from repro_torch.configs import reduced_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention_bwd import ops as bwd_ops
    from repro_torch.kernels.moe_gemm import ops as moe_ops
    from repro_torch.kernels.moe_gemm_wgrad import ops as wgrad_ops
    from repro_torch.data.pipeline import frontend_stub
    from repro_torch.launch.steps import loss_and_grads, train_step
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32",
                              **(over or {}))
    L, La = cfg.num_layers, _attn_layers(cfg)
    gen = torch.Generator().manual_seed(13)
    toks = torch.randint(2, cfg.vocab_size, (4, S), generator=gen,
                         dtype=torch.int32).numpy()
    batch = {k: torch.from_numpy(v) for k, v in frontend_stub(
        cfg, {"tokens": toks, "labels": toks.copy()},
        np.random.default_rng(13)).items()}
    params = {"cpu": T.init_params(cfg, seed=3, device="cpu")}
    params["cuda"] = optim.tree_map(lambda t: t.to(dev), params["cpu"])
    got = {}
    for device, pt in params.items():
        b = {k: t.to(pt["embed"].device) for k, t in batch.items()}
        reset_counts()
        shapes = _FlashShapes()
        try:
            loss, grads = loss_and_grads(cfg, pt, b)
        finally:
            shapes.restore()
        if flash_dims and device == "cuda":
            shapes.check(f"reduced {arch} training on cuda", flash_dims,
                         "simt")
        used = kernels.launches()
        if cfg.family == "ssm":
            want = {"ssd_scan": 2 * L, "ssd_scan_bwd": L}
        else:
            want = {"flash_attention": 2 * La, "flash_attention_bwd": La}
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
    log(f"  reduced {arch} fp32 training (S {S}, head dim {cfg.head_dim}): "
        f"loss cuda {lg.item():.6f} "
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
    3 B S L (2 Q N g + h (2 Q P + 4 N P)).  The hybrid counts attention
    in its attention sublayers only (``_attn_layers``: n_units x
    block_pattern.count("attn")) over ``cfg.local_window``'s pairs; its
    block-diagonal gates are products whose parameters ``param_count``
    has, and the RG-LRU scan's elementwise work is left out:
    6 n B S + 3.5 x 4 dh H B pairs(S, local_window) x n_attn.  MLA's
    attention takes 2 (Dqk + Dv) a pair and head forward and 2 (3 Dqk + 2
    Dv) backward (q/k heads of head_dim + rope_head_dim, v heads of
    head_dim).  The vision decoder's S counts text tokens: its layers see
    P + S positions and ``adapter`` the P patches only.  The
    encoder-decoder's S counts decoder tokens: its encoder layers,
    ``adapter`` and the cross-attention's K/V projections see the
    encoder_seq frames, the rest the S tokens; attention adds the
    encoder's non-causal pairs, the decoder's causal ones and the
    cross-attention's S x encoder_seq."""
    from repro_torch.models import transformer as T
    n = T.param_count(cfg, active_only=active_only) \
        - T.padded_vocab(cfg) * cfg.d_model
    window = cfg.local_window if cfg.family == "hybrid" else \
        cfg.sliding_window
    H, dh = cfg.num_heads, cfg.head_dim
    if cfg.family == "audio":
        Se, D = cfg.encoder_seq, cfg.d_model
        spec = T.param_shapes(cfg)
        on_frames = _spec_count(spec["enc_layers"]) + \
            _spec_count(spec["enc_norm"]) + D * D + sum(
                _spec_count(spec["layers"]["xattn"][w]) for w in ("wk", "wv"))
        attn = 2.0 * 2 * dh * H * B * (
            cfg.encoder_layers * Se * Se
            + cfg.num_layers * (_pairs(S, S, True, 0) + S * Se))
        return 6.0 * B * ((n - on_frames) * S + on_frames * Se) + 3.5 * attn
    P = cfg.num_patches if cfg.family == "vlm" else 0
    pairs = _pairs(S + P, S + P, True, window)
    if cfg.use_mla:
        dqk = dh + cfg.rope_head_dim
        per_pair = 2.0 * (dqk + dh) + 2.0 * (3 * dqk + 2 * dh)
    else:
        per_pair = 3.5 * 2.0 * 2 * dh
    flops = 6.0 * n * B * (S + P) + per_pair * pairs * H * B * \
        _attn_layers(cfg)
    if P:       # adapter sees the patches only
        flops -= 6.0 * cfg.d_model ** 2 * B * S
    if cfg.family == "ssm":
        Q, N, P = min(64, S), cfg.ssm_state, cfg.ssm_head_dim
        per_token = 2 * Q * N * cfg.ssm_groups + cfg.ssm_heads * (
            2 * Q * P + 4 * N * P)
        flops += 3.0 * per_token * B * S * cfg.num_layers
    return flops


def _spec_count(spec) -> int:
    """Parameters of a ``param_shapes`` subtree."""
    if isinstance(spec, dict):
        return sum(_spec_count(v) for v in spec.values())
    return math.prod(spec[0])


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


def train_path(dev, arch: str, steps: int, GB: int, S: int, n_mb: int,
               lr: float = 1e-3, over=None):
    """A full-width dense decoder, SSM, hybrid, encoder-decoder or vision
    decoder (bf16, random weights from seed 0; full depth unless ``over``
    replaces fields) trained ``steps`` steps through
    ``launch/steps.py::train_step``: batches of GB x S from
    ``SyntheticLMStream`` (seed 0; ``launch/train.py::step_batch``, which
    adds the encoder-decoder's stub frames and the vision decoder's stub
    patches) in ``n_mb`` microbatches, remat on, AdamW at ``lr`` (1e-3, the
    reference driver's).  The loss must be finite and fall; each step must
    launch the flash forward (an SSM: the scan) 2 x L x n_mb times (remat
    runs each layer twice; L the attention calls of a forward,
    ``_attn_layers``), all on wgmma, the backward wrapper (an SSM: the
    scan's) L x n_mb times, all on its bf16 route, no other kernel and no
    plain version.  Logs the reckoned memory of the weights, fp32 masters
    and moments and bf16 gradients (16 B a parameter) before the run,
    s/step, tokens/s, peak memory, a step's device time by kernel class
    beside its wall, the model FLOPs' share of the bf16 dense peak
    (``mfu``), and whether a second run from seed 0 gives the first two
    losses' bits (the SSM, the hybrid, the encoder-decoder and the vision
    decoder must give the first's).  Returns (launches of the steps,
    numbers)."""
    from repro_torch import kernels, optim
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention_bwd import ops as bwd_ops
    from repro_torch.launch.steps import train_step
    from repro_torch.launch.train import step_batch
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), **(over or {}))
    L = cfg.num_layers if cfg.family == "ssm" else _attn_layers(cfg)
    ocfg = optim.AdamWConfig(lr=lr, zero1=False)
    stream = SyntheticLMStream(DataConfig(global_batch=GB, seq_len=S,
                                          vocab_size=cfg.vocab_size, seed=0))
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in step_batch(cfg, stream, i).items()}
               for i in range(steps + 2)]
    log(f"  {arch}: {T.param_count(cfg):,} parameters (layers "
        f"{cfg.num_layers}{f', cut by {over}' if over else ''}), reckoned "
        f"{T.param_count(cfg) * 16 / 1e9:.2f} GB of weights, fp32 masters "
        f"and moments and bf16 gradients (16 B a parameter) before "
        f"activations; batch "
        + ", ".join(f"{k} {tuple(t.shape)}" for k, t in batches[0].items()))

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
    window = cfg.local_window if cfg.family == "hybrid" else \
        cfg.sliding_window
    log(f"  {arch} bf16 ({T.param_count(cfg):,} parameters, {gb:.3f} GB, "
        f"window {window}), {steps} steps of {GB} x {S} in "
        f"{n_mb} microbatches, remat, AdamW lr {lr:g}: losses "
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
    if cfg.family in ("ssm", "hybrid", "audio", "vlm") and \
            again[0] != losses[0]:
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


# --------------------------------------------------------------- phase 15
# microbatches of phase 15's 4 x 8192 tokens: at 2 the peak reached 76.3
# GB of the card's 80 (46.6 GB of weights, fp32 masters and moments, 13.3
# GB of fp32 gradient sums; PERF.md), at 4 70.9 GB
HYBRID_MICROBATCHES = 4
# AdamW's lr in phase 15: at the reference driver's 1e-3 this model's loss
# swings by ~0.5 from step to step (clipped updates at grad norms of 1-6)
# and after 5 steps stands above the first; at 3e-4 it falls (PERF.md)
HYBRID_LR = 3e-4


def _rglru_block(cfg, gen, dev):
    """One RG-LRU block's leaves (``rglru.param_spec``) drawn from ``gen``
    in bf16 (``lam`` fp32, by ``lam_init``), each requiring grad."""
    from repro_torch.models import rglru
    out = {}
    for name, (shape, init, *dt) in rglru.param_spec(cfg).items():
        dtype = torch.float32 if dt else torch.bfloat16
        if init == "lam":
            t = rglru.lam_init(shape, gen, dev)
        elif init == "zeros":
            t = torch.zeros(shape, device=dev)
        else:
            t = torch.randn(shape, generator=gen, device=dev) * init
        out[name] = t.to(dtype).requires_grad_(True)
    return out


def train_hybrid_path(dev):
    """Phase 15: RecurrentGemma-2B (26 layers: 8 units of RG-LRU, RG-LRU
    and local-attention sublayers, then 2 RG-LRU tail layers; d_model
    2560, 10 q heads on 1 kv head of 256, lru_width 2560, window 2048,
    softcap 30, vocab 256000) in bf16 at every published width and full
    depth, 5 steps of 4 x 8192 tokens in ``HYBRID_MICROBATCHES``
    microbatches (phase 12's Danube tokens, so that the window binds),
    AdamW at ``HYBRID_LR`` (``train_path``): the flash forward twice and its backward once an
    attention sublayer and microbatch (8 x 2 x n_mb and 8 x n_mb a step),
    no other kernel, the first step's loss again on a rerun from seed 0.
    Then the RG-LRU's share of a step: one rec sublayer's ``rglru_fwd`` at
    a microbatch (random weights from a seed, x at the block's scale), its
    forward and its forward + backward on the device (the profiler's
    trace), times the 18 rec sublayers x the microbatches x (forward +
    forward and backward: remat runs the forward twice) over the step's
    device time."""
    from repro_torch.configs import get_config
    from repro_torch.models import rglru
    from repro_torch.models import transformer as T
    cfg = get_config("recurrentgemma_2b")
    n_mb, GB, S = HYBRID_MICROBATCHES, 4, 8192
    b = GB // n_mb
    used, st = train_path(dev, "recurrentgemma_2b", 5, GB, S, n_mb,
                          lr=HYBRID_LR)
    gen = torch.Generator(device=dev).manual_seed(15)
    p = _rglru_block(cfg, gen, dev)
    x = (0.5 * torch.randn((b, S, cfg.d_model), generator=gen,
                           device=dev)).to(torch.bfloat16) \
        .requires_grad_(True)
    gy = torch.randn((b, S, cfg.d_model), generator=gen, device=dev) \
        .to(torch.bfloat16)

    def fwd():
        with torch.no_grad():
            rglru.rglru_fwd(cfg, p, x)

    def fwd_bwd():
        rglru.rglru_fwd(cfg, p, x).backward(gy)
    f_ms, _ = _device_ms(fwd, n=2)
    fb_ms, fb_by = _device_ms(fwd_bwd, n=2)
    n_units, n_tail = T._hybrid_counts(cfg)
    n_rec = n_units * cfg.block_pattern.count("rec") + n_tail
    rec_ms = n_rec * n_mb * (f_ms + fb_ms)
    share = rec_ms / st["device_ms"]
    log(f"  one rec sublayer's rglru_fwd at {b} x {S} on the device: "
        f"forward {f_ms:.2f} ms, forward + backward {fb_ms:.2f} ms ("
        + ", ".join(f"{c} {ms:.2f}" for c, ms in sorted(
            fb_by.items(), key=lambda kv: -kv[1]))
        + f"); {n_rec} rec sublayers x {n_mb} microbatches x (forward + "
        f"forward and backward) = {rec_ms:.1f} ms, {share:.3f} of the "
        f"step's {st['device_ms']:.1f} device ms")
    st.update(rglru_fwd_ms=f_ms, rglru_fwd_bwd_ms=fb_ms, rglru_share=share,
              microbatches=n_mb)
    del p, x, gy
    return used, st


# --------------------------------------------------------------- phase 13
# Qwen3-30B-A3B trained at every published width, its depth cut 48 -> 4:
# 3.11 B parameters, ~49.8 GB of bf16 weights, fp32 masters and moments
# and bf16 gradients on the card's 80 GB
MOE_TRAIN_LAYERS = 4


def train_moe_path(dev, arch: str = "qwen3_moe_30b",
                   layers: int = MOE_TRAIN_LAYERS, experts=None,
                   GB: int = 4, S: int = 4096, steps: int = 4,
                   lr: float = 1e-3, phase: int = 13):
    """An MoE decoder in bf16 at every published width with ``layers`` of
    its layers (and ``experts`` of its experts, where given), random
    weights from seed 0, trained ``steps`` steps through
    ``launch/steps.py::train_step`` on GB x S tokens of
    ``SyntheticLMStream`` (seed 0), one microbatch, remat on, AdamW at
    ``lr``: by default phase 13's Qwen3-30B-A3B (d_model 2048, 32/4 heads of
    128, 128 experts top-8 of expert d_ff 768, vocab 151936) with
    ``MOE_TRAIN_LAYERS`` of its 48 layers, 4 steps of 4 x 4096, lr 1e-3.
    The loss must be finite and fall and carry the aux (read off the first
    step: loss = cross-entropy + AUX_COEF x the layers' aux over their
    count, rtol 1e-5); each step must launch the flash forward twice a
    layer (remat) and the backward once, all on wgmma at the model's
    (q/k, v) head dims (MLA: head_dim + rope_head_dim, head_dim), the
    grouped GEMM 9 times a layer (3 forward, 3 recomputed, 3 dX), all on
    wgmma, its weight gradient 3 times a layer, all on wgmma, no other
    kernel and no plain version (a shared expert is a plain gated MLP).
    Logs the reckoned memory (16 B a parameter) before the run, s/step,
    tokens/s, peak memory, the capacity drops of the first step, a step's
    device time by kernel class beside its wall, and the model FLOPs over
    active parameters' share of the bf16 dense peak.  Returns (launches of
    the steps, numbers)."""
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
    full = get_config(arch)
    cut = dict(num_layers=layers)
    if experts:
        cut["num_experts"] = experts
    cfg = dataclasses.replace(full, **cut)
    L = cfg.num_layers
    dims = (cfg.head_dim + cfg.rope_head_dim if cfg.use_mla
            else cfg.head_dim, cfg.head_dim)
    ocfg = optim.AdamWConfig(lr=lr, zero1=False)
    stream = SyntheticLMStream(DataConfig(global_batch=GB, seq_len=S,
                                          vocab_size=cfg.vocab_size, seed=0))
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in stream.batch_at(i).items()}
               for i in range(steps + 2)]
    n_params = T.param_count(cfg)
    log(f"  {arch}: {n_params:,} parameters with {L} of {full.num_layers} "
        f"layers and {cfg.num_experts} of {full.num_experts} experts, "
        f"reckoned {n_params * 16 / 1e9:.2f} GB of weights, fp32 masters "
        f"and moments and bf16 gradients (16 B a parameter) before "
        f"activations")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = T.init_params(cfg, 0, dev)
    opt = optim.init_opt_state(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"  {arch} bf16, {L} of {full.num_layers} layers: "
        f"{n_params:,} parameters ({T.param_count(cfg, active_only=True):,} "
        f"active), weights + fp32 masters and moments drawn in "
        f"{init_s:.1f} s, {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB")

    # the first step's aux, cross-entropy and dispatch plans
    auxes, ces, plans = [], [], []
    orig_moe, orig_ce, orig_plan = moe.moe_fwd, T._chunked_ce, \
        moe_ops.dispatch_plan

    def rec_moe(c, p, x, *share):
        y, aux = orig_moe(c, p, x, *share)
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
    shapes = _FlashShapes()
    losses, gnorms, secs = [], [], []
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
            gnorms.append(out["grad_norm"].item())
            secs.append(time.perf_counter() - t0)
            moe.moe_fwd, T._chunked_ce = orig_moe, orig_ce
            moe_ops.dispatch_plan = orig_plan
            log(f"  {arch} step {i}: loss {losses[-1]:.6f}, grad "
                f"norm {gnorms[-1]:.4f}, {secs[-1]:.3f} s")
    finally:
        moe.moe_fwd, T._chunked_ce = orig_moe, orig_ce
        moe_ops.dispatch_plan = orig_plan
        plain.restore()
        shapes.restore()
    shapes.check(f"{arch} training", dims, "wgmma")
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
        raise AssertionError(f"{arch} training: launches {used}, "
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
        raise AssertionError(f"{arch} training: the first step's "
                             f"loss {losses[0]} is not its cross-entropy "
                             f"{float(ces[0])} + {T.AUX_COEF} x the aux "
                             f"{aux_first} / {L}")
    same_route = len(plans) == 2 * L and all(
        torch.equal(a.dest, b.dest) and torch.equal(a.block_expert,
                                                    b.block_expert)
        for a, b in zip(plans[:L], plans[L:][::-1]))
    if not same_route:
        raise AssertionError(f"{arch} training: the recompute routed "
                             f"otherwise than the forward ({len(plans)} "
                             f"plans for {L} layers)")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{arch} training: losses {losses} "
                             f"(finite and falling expected)")
    kept = [(int(p.keep.sum()), p.keep.numel()) for p in plans[:L]]
    del plans
    step_s = statistics.median(secs[1:])
    tokens = GB * S
    flops = _model_flops(cfg, GB, S, active_only=True)
    mfu = flops / step_s / PEAK_FLOPS[torch.bfloat16]
    log(f"  {arch} {steps} steps of {GB} x {S}, one microbatch, "
        f"remat, AdamW lr {lr:g}: losses "
        f"{[round(x, 4) for x in losses]} (step 0: cross-entropy "
        f"{float(ces[0]):.6f} + {T.AUX_COEF} x aux "
        f"{[round(a, 4) for a in aux_first]} / {L}; the recompute routed "
        f"as the forward, bit for bit); {step_s:.3f} s/step "
        f"(median of steps 1-{steps - 1}; step 0 {secs[0]:.3f} s), "
        f"{tokens / step_s:.1f} tokens/s; peak device memory {peak:.2f} GB; "
        f"capacity drops of step 0 by layer "
        f"{[n - k for k, n in kept]} of {kept[0][1]} choices; launches "
        f"{used}; grouped GEMM by route {routes}; weight gradient by "
        f"route {wgrad_routes}; plain versions called "
        f"{plain.calls}; active-parameter MFU {mfu:.4f}")
    mfu_key = {"qwen3_moe_30b": "qwen3_moe_train_mfu"}.get(
        arch, f"{arch}_train_mfu")
    print(json.dumps({mfu_key: mfu, "model_flop_per_step": flops,
                      "s_per_step": step_s}), flush=True)

    i = iter(range(steps, steps + 2))

    def one():
        train_step(cfg, params, opt, batches[next(i)], ocfg,
                   microbatches=1, remat=True)

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
    secs_phase = time.perf_counter() - t_phase
    log(f"  phase {phase} took {secs_phase:.1f} s")
    return used, dict(layers=L, experts=cfg.num_experts, params=n_params,
                      losses=losses, grad_norms=gnorms, lr=lr,
                      gemm_routes=routes, wgrad_routes=wgrad_routes,
                      step_s=step_s, step_secs=secs,
                      tokens_per_s=tokens / step_s, peak_gb=peak, mfu=mfu,
                      init_s=init_s, drops=[n - k for k, n in kept],
                      choices=kept[0][1], device_ms=device_ms, wall_ms=wall,
                      by_class=by, seconds=secs_phase)


# --------------------------------------------------------------- phase 16
# Pixtral-12B trained at every published width, its depth cut 40 -> 8:
# 3,549,516,800 parameters, 56.8 GB of bf16 weights, fp32 masters and
# moments and bf16 gradients at 16 B a parameter, beside the activations of
# 4 x (1024 patches + 3072 tokens) in one microbatch (two microbatches
# would add 14.2 GB of fp32 gradient sums)
PIXTRAL_TRAIN_LAYERS = 8
# AdamW's lr in phases 16 and 17: Whisper-base's loss falls at the
# reference driver's 1e-3; at 1e-3 Pixtral-12B's and DeepSeek-R1's rose
# from step 2 on (12.29 -> 13.80 and 12.28 -> 14.30 in 5 steps, grad norms
# up to 24 and 15) and at 3e-4 Pixtral's spiked at step 3 (grad norm 57),
# so both train at 1e-4 (PERF.md)
TRAIN_LR = {"whisper_base": 1e-3, "pixtral_12b": 1e-4, "deepseek_r1": 1e-4}


def train_encdec_vlm_path(dev):
    """Phase 16 (``train_path``): Whisper-base (6 encoder and 6 decoder
    layers, d_model 512, 8 heads of 64, vocab 51865) at every published
    width and full depth, 5 steps of 16 rows of 448 decoder tokens over
    1536 stub frames in 2 microbatches; Pixtral-12B (d_model 5120, 32/8
    heads of 128, d_ff 14336, vocab 131072) at every published width with
    ``PIXTRAL_TRAIN_LAYERS`` of its 40 layers, 5 steps of 4 x (1024 stub
    patches + 3072 tokens) in one microbatch, labels -1 over the patches;
    both bf16, random weights from seed 0, AdamW at ``TRAIN_LR``'s
    (Whisper 1e-3, Pixtral 1e-4).
    Each: a finite, falling loss, the first loss again on a rerun from
    seed 0, the flash forward 2 x L x n_mb and its backward L x n_mb
    times a step (Whisper: L = 18 attention calls a forward, 12 of them
    non-causal), all on wgmma, no other kernel.  Returns (launches of both
    runs' steps summed, numbers by arch)."""
    used, stats = {}, {}
    for arch, GB, S, n_mb, over in (
            ("whisper_base", 16, 448, 2, None),
            ("pixtral_12b", 4, 3072, 1,
             dict(num_layers=PIXTRAL_TRAIN_LAYERS))):
        u, stats[arch] = train_path(dev, arch, 5, GB, S, n_mb,
                                    lr=TRAIN_LR[arch], over=over)
        for name, n in u.items():
            used[name] = used.get(name, 0) + n
        gc.collect()
        torch.cuda.empty_cache()
    return used, stats


# --------------------------------------------------------------- phase 17
# DeepSeek-R1 trained at every published width (d_model 7168, MLA with 128
# heads, q_lora 1536, kv_lora 512, rope 64, top-8, expert and shared d_ff
# 2048, vocab 129280), its depth cut 61 -> 2 (as phase 9) and its experts
# 256 -> 16: one full layer with 256 experts holds 13.36 B parameters, 214
# GB at 16 B a parameter; with 16 experts 2 layers hold 3,725,204,480
# parameters, 59.6 GB, beside the activations of 2 x 4096 tokens
MLA_TRAIN_LAYERS, MLA_TRAIN_EXPERTS = 2, 16


def train_mla_path(dev):
    """Phase 17 (``train_moe_path``): DeepSeek-R1 in bf16 at every
    published width with ``MLA_TRAIN_LAYERS`` of its 61 layers and
    ``MLA_TRAIN_EXPERTS`` of its 256 experts, 5 steps of 2 x 4096 tokens in
    one microbatch, AdamW at ``TRAIN_LR``'s 1e-4: every flash launch at q/k
    192, v 128 on wgmma (the backward too), the grouped GEMM and its
    weight gradient on wgmma, the aux in the loss, the recompute routed as
    the forward."""
    return train_moe_path(dev, "deepseek_r1", layers=MLA_TRAIN_LAYERS,
                          experts=MLA_TRAIN_EXPERTS, GB=2, S=4096, steps=5,
                          lr=TRAIN_LR["deepseek_r1"], phase=17)


# --------------------------------------------------------------- phase 18
# the (q/k, v) head dims and kernel shapes of a rank at tp 8 (phase 18b)
TP8 = 8
TP8_BATCH = (2, 4096)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _KernelShapes:
    """Records the shapes of every flash forward / backward, grouped-GEMM
    and weight-gradient launch while a path runs (each wrapper's
    ``launch``, wrapped here until ``restore``)."""

    def __init__(self):
        from repro_torch.kernels.flash_attention import ops as fa
        from repro_torch.kernels.flash_attention_bwd import ops as fb
        from repro_torch.kernels.moe_gemm import ops as mg
        from repro_torch.kernels.moe_gemm_wgrad import ops as mw
        self.seen = {"flash_attention": set(), "flash_attention_bwd": set(),
                     "moe_gemm": set(), "moe_gemm_wgrad": set()}
        self.orig = []

        def wrap(mod, name, shape_of):
            fn = mod.launch
            self.orig.append((mod, fn))

            def record(*a, **kw):
                self.seen[name].add(shape_of(*a, **kw))
                return fn(*a, **kw)
            mod.launch = record

        attn = lambda lib, q, k, v, *a, **kw: (  # noqa: E731
            f"B{q.shape[0]} S{q.shape[1]} H{q.shape[2]}/{k.shape[2]} "
            f"D{q.shape[3]}/{v.shape[3]}")
        wrap(fa, "flash_attention", attn)
        wrap(fb, "flash_attention_bwd", attn)
        wrap(mg, "moe_gemm", lambda lib, x, w, *a, **kw:
             f"rows {x.shape[0]} E{w.shape[0]} {w.shape[1]}x{w.shape[2]}")
        wrap(mw, "moe_gemm_wgrad", lambda lib, x, dy, be, E, *a, **kw:
             f"rows {x.shape[0]} E{E} {x.shape[1]}x{dy.shape[1]}")

    def restore(self):
        for mod, fn in self.orig:
            mod.launch = fn

    def shapes(self):
        return {k: sorted(v) for k, v in self.seen.items() if v}


def _nccl_world_one(mesh, dev):
    """Every collective of ``distributed/collectives.py`` sent through the
    NCCL group of one rank (``skip_one=False``): each returns its input
    and the conjugate pairs pass values and gradients through.  Returns
    the calls made."""
    from repro_torch.distributed import collectives as C
    g = dataclasses.replace(mesh.comm.world, skip_one=False)
    x = torch.arange(4096.0, device=dev).reshape(64, 64)
    C.reset_events()
    for fn in (g.all_reduce, g.all_gather, g.reduce_scatter, g.all_to_all):
        if not torch.equal(fn(x), x):
            raise AssertionError(f"NCCL at world size 1: {fn.__name__} "
                                 f"changed its input")
    xr = x.clone().requires_grad_(True)
    out = g.reduce_out(g.copy_in(xr) * 2.0)
    (dx,) = torch.autograd.grad(out.sum(), xr)
    if not (torch.equal(out, 2 * x) and torch.equal(dx, torch.full_like(
            x, 2.0))):
        raise AssertionError("NCCL at world size 1: the conjugate pairs "
                             "moved a value")
    torch.cuda.synchronize()
    n = len(C.EVENTS)
    C.reset_events()
    return n


def _sent_callers(cell, params, batch, comm):
    """The sharded loss and its gradients on ``batch`` through ``comm``
    and through the same groups with every collective sent
    (``skip_one=False``, a group of one is no longer trivial): the model
    group's callers run (``embed_share`` and its reduce,
    ``_train_layer``'s ``copy_in`` / ``reduce_out`` pairs around
    ``attention_share`` and ``ffn_share``, ``_chunk_ce_tp``'s
    ``ce_shard`` / ``ce_merge`` over the group), each all-reduce through
    NCCL at world size 1.  The loss within rtol 1e-5 of the skipped run's
    and every leaf's gradient within TOL[bf16] of its scale; every collective
    an all-reduce, as many as the design predicts at remat on (those of
    ``tests/test_torch_distributed.py``'s ``AR_LAYER`` / ``AR_CE_CHUNK``):
    the embedding's; a MoE layer's three row-parallel reduces, the
    attention's again in the recompute and three ``copy_in``s backward; a
    cross-entropy chunk's three reduces, again in the recompute, and h's
    ``copy_in``; the count of labels over the data group; no plain
    version.  Returns the numbers."""
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import transformer as T
    cfg = cell.cfg
    b = cell.local_batch(batch)
    l1, g1 = loss_and_grads(cfg, params, b, comm=comm)
    sent = C.Comm(**{f: dataclasses.replace(getattr(comm, f),
                                            skip_one=False)
                     for f in ("model", "data", "world")})
    C.reset_events()
    plain = _PlainCalls()
    try:
        l2, g2 = loss_and_grads(cfg, params, b, comm=sent)
        torch.cuda.synchronize()
    finally:
        plain.restore()
    kinds = {k for k, _, _ in C.EVENTS}
    n = len(C.EVENTS)
    C.reset_events()
    chunks = -(-b["tokens"].shape[1] // T.CE_CHUNK)
    want = 1 + 7 * cfg.num_layers + 7 * chunks + 1
    if kinds != {"all-reduce"} or n != want or any(plain.calls.values()):
        raise AssertionError(f"phase 18 (a), collectives sent: {n} "
                             f"{kinds} ({want} all-reduces expected), "
                             f"plain versions called {plain.calls}")
    rel = abs(l2.item() - l1.item()) / abs(l1.item())
    if not rel <= 1e-5:
        raise AssertionError(f"phase 18 (a), collectives sent: loss "
                             f"{l2.item()} vs {l1.item()}")
    worst = 0.0
    for (path, a), (_, w) in zip(_paths_of(g2), _paths_of(g1)):
        worst = max(worst, _scaled_check(
            f"collectives sent, d{'.'.join(path)}", a, w, quiet=True))
    del g1, g2
    return dict(collectives=n, loss=l2.item(),
                loss_rel_err=rel, worst_grad_err_over_scale=worst)


def train_sharded_path(dev, phase13):
    """Phase 18 (a): the multi-GPU training path on one card.  An NCCL
    process group of world size 1 on the card, the (1, 1) mesh realized
    over it (``launch/mesh.py``), and 3 steps of ``build_cell``'s sharded
    step of Qwen3-30B-A3B at phase 13's cut (``MOE_TRAIN_LAYERS`` layers,
    4 x 4096 tokens, one microbatch, remat, AdamW lr 1e-3 with ZeRO-1 on)
    from seed 0: each loss and grad norm must equal phase 13's one-device
    ``train_step`` in bits (every collective of a group of one is skipped),
    every flash, flash-backward, grouped-GEMM and weight-gradient launch on
    wgmma and no plain version.  Also sends every collective through the
    NCCL group once (``_nccl_world_one``).  Returns (launches, numbers)."""
    import torch.distributed as dist

    from repro_torch import kernels, optim
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention_bwd import ops as bwd_ops
    from repro_torch.kernels.moe_gemm import ops as moe_ops
    from repro_torch.kernels.moe_gemm_wgrad import ops as wgrad_ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import build_cell

    t_phase = time.perf_counter()
    steps, (GB, S), L = 3, (4, 4096), MOE_TRAIN_LAYERS
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = mesh_lib.Mesh(("data", "model"), (1, 1)).realize("cuda")
        n_nccl = _nccl_world_one(mesh, dev)
        cell = build_cell("qwen3_moe_30b", "train_4k", mesh,
                          batch_seq=(GB, S), over=dict(num_layers=L),
                          exact_microbatches=1,
                          opt_cfg=optim.AdamWConfig(lr=1e-3))
        cfg = cell.cfg
        stream = SyntheticLMStream(DataConfig(
            global_batch=GB, seq_len=S,
            vocab_size=get_config("qwen3_moe_30b").vocab_size, seed=0))
        batches = [{k: torch.from_numpy(v).to(dev)
                    for k, v in stream.batch_at(i).items()}
                   for i in range(steps)]
        torch.cuda.reset_peak_memory_stats(dev)
        params, opt = cell.init_state(0, dev)
        reset_counts()
        C.reset_events()
        plain = _PlainCalls()
        shapes = _KernelShapes()
        losses, gnorms, secs = [], [], []
        try:
            for i in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = cell.step(params, opt, batches[i])
                losses.append(out["loss"].item())
                gnorms.append(out["grad_norm"].item())
                secs.append(time.perf_counter() - t0)
                log(f"  sharded qwen3_moe_30b step {i}: loss "
                    f"{losses[-1]:.6f}, grad norm {gnorms[-1]:.4f}, "
                    f"{secs[-1]:.3f} s")
        finally:
            plain.restore()
            shapes.restore()
        used = kernels.launches()
        routes = (dict(ops.ROUTE_LAUNCHES), dict(bwd_ops.ROUTE_LAUNCHES),
                  dict(moe_ops.ROUTE_LAUNCHES),
                  dict(wgrad_ops.ROUTE_LAUNCHES))
        stats = C.collective_stats()
        n_events = len(C.EVENTS)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        del opt
        sent = _sent_callers(cell, params, batches[0], mesh.comm)
        del params
    finally:
        dist.destroy_process_group()
    want = {"flash_attention": 2 * L * steps,
            "flash_attention_bwd": L * steps, "moe_gemm": 9 * L * steps,
            "moe_gemm_wgrad": 3 * L * steps}
    if {k: n for k, n in used.items() if n} != want or \
            [r.get("wgmma", 0) for r in routes] != [
                want["flash_attention"], want["flash_attention_bwd"],
                want["moe_gemm"], want["moe_gemm_wgrad"]] or \
            any(plain.calls.values()):
        raise AssertionError(f"phase 18 (a): launches {used}, by route "
                             f"{routes}, plain versions called "
                             f"{plain.calls} (expected {want}, all on "
                             f"wgmma, no plain version)")
    want_l = phase13["losses"][:steps]
    want_g = phase13["grad_norms"][:steps]
    if losses != want_l or gnorms != want_g:
        raise AssertionError(f"phase 18 (a): losses {losses}, grad norms "
                             f"{gnorms}: not phase 13's bits ({want_l}, "
                             f"{want_g})")
    if n_events or stats["total_wire_bytes"]:
        raise AssertionError(f"phase 18 (a): {n_events} collectives "
                             f"recorded in groups of one: {stats}")
    step_s = statistics.median(secs[1:])
    log(f"  phase 18 (a) Qwen3-30B-A3B bf16, {L} layers, {steps} steps of "
        f"{GB} x {S} through build_cell's sharded step on an NCCL group of "
        f"one (mesh {mesh.shape}, ZeRO-1 on): losses {losses} and grad "
        f"norms {gnorms} equal phase 13's bits; {step_s:.3f} s/step (median "
        f"of steps 1-{steps - 1}; phase 13 {phase13['step_s']:.3f}); peak "
        f"device memory {peak:.2f} GB (phase 13 {phase13['peak_gb']:.2f}); "
        f"launches {used}, all on wgmma, no plain version; collectives "
        f"skipped in groups of one (none recorded); {n_nccl} collectives "
        f"sent through NCCL at world size 1 and returned their inputs; "
        f"the loss through the tensor-parallel callers with every "
        f"collective sent: {sent['collectives']} all-reduces, loss rel err "
        f"{sent['loss_rel_err']:.2e}, worst gradient |err| / scale "
        f"{sent['worst_grad_err_over_scale']:.2e}")
    secs_phase = time.perf_counter() - t_phase
    gc.collect()
    torch.cuda.empty_cache()
    return used, dict(losses=losses, grad_norms=gnorms, step_s=step_s,
                      step_secs=secs, phase13_step_s=phase13["step_s"],
                      peak_gb=peak, nccl_world1_calls=n_nccl,
                      tp_callers_through_nccl=sent,
                      kernel_shapes=shapes.shapes(), seconds=secs_phase,
                      equal_bits=True)


def _rank_mesh(m: int):
    """A (1, TP8) mesh's rank ``m`` without a process group: what
    ``shard_params`` reads."""
    from repro_torch.launch import mesh as mesh_lib
    return mesh_lib.Mesh(("data", "model"), (1, TP8), rank=m)


def _sum_grads(full, specs, local_grads):
    """The full gradient of each leaf from the ranks' local ones: a split
    leaf's slices put in place, a replicated leaf's parts summed (what the
    model group's ``copy_in`` sums)."""
    from repro_torch.distributed import sharding as shd
    out = {}
    for path, t in _paths_of(full):
        acc = torch.zeros(t.shape, dtype=torch.float32, device=t.device)
        sp = _at(specs, path)
        for m, grads in enumerate(local_grads):
            g = grads.get(path)
            if g is not None:
                sl = shd.dim_slices(sp, t.shape, {"data": 1, "model": TP8},
                                    {"data": 0, "model": m})
                acc[sl] += g.float()
        out[path] = acc
    return out


def _paths_of(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths_of(tree[k], path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tp8_layer(dev, arch: str, over=None):
    """One decoder layer of ``arch`` at every published width on B2 S4096,
    forward and backward, in its two sublayers as ``_train_layer`` runs
    them: ``attention_share`` on h, and ``ffn_share`` (the MLP or the MoE)
    on the one-device attention's output, so that the router sees the
    same bits on both sides.  Each runs on one device (tp 1) and rank by
    rank at tp 8 on each rank's slices (``shard_params``): its q-head
    shard (``layers.tp_attention_params``) and its MLP columns or its 16
    of 128 experts (``moe.moe_fwd``), the partial outputs summed in rank
    order in bf16 where ``_train_layer`` all-reduces them, one upstream
    gradient a sublayer.  The rank-summed outputs, input gradients, aux
    and every leaf's gradient (split leaves' slices put in place,
    replicated ones' parts summed: what ``copy_in`` sums) are held to the
    one device's within TOL[bf16] of each tensor's scale.  Returns
    (launches of the ranks, numbers).  ``over`` replaces config fields
    (phase 21's DeepSeek-R1: 16 experts); for MLA two wronged versions
    must fail the same checks: ``wq_a``'s gradient left unreduced (one
    rank's part), and the shared expert added whole on every rank."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers
    from repro_torch.models import transformer as T
    from repro_torch.models.api import MeshAxes

    cfg = dataclasses.replace(get_config(arch), num_layers=1, **(over or {}))
    B, S = TP8_BATCH
    gen = torch.Generator(device=dev).manual_seed(18)
    stack = T.init_params(cfg, 18, dev)["layers"]
    specs = shd.param_specs(cfg, MeshAxes(), TP8, "tp")["layers"]
    rand = lambda: torch.randn((B, S, cfg.d_model), generator=gen,  # noqa
                               device=dev).to(torch.bfloat16)
    h0, g_a, g_f = rand(), rand(), rand()
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
    tab = layers.rope_tables(pos, layers.rope_dim(cfg), cfg.rope_theta)

    def req(tree):
        return {k: req(v) if isinstance(v, dict) else
                v.detach().requires_grad_(True) for k, v in tree.items()}

    def loss_of(out, g, aux):
        return (out.float() * g.float()).sum() + (0.0 if aux is None
                                                  else aux)

    # one device
    one = req(stack)
    p1 = _map_layer(one, lambda t: t[0])
    ha = h0.detach().requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_a1 = ha + T.attention_share(cfg, p1, ha, pos, tab)
    hf = out_a1.detach().requires_grad_(True)
    y1, aux1 = T.ffn_share(cfg, p1, hf)
    out_f1 = hf + y1
    leaves1 = [t for _, t in _paths_of(one)]
    ga1 = torch.autograd.grad(loss_of(out_a1, g_a, None), [ha] + leaves1,
                              allow_unused=True)
    gf1 = torch.autograd.grad(loss_of(out_f1, g_f, aux1), [hf] + leaves1,
                              allow_unused=True)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0

    # rank by rank
    reset_counts()
    plain = _PlainCalls()
    shapes = _KernelShapes()
    try:
        locs = [req(shd.shard_params(stack, specs, _rank_mesh(m)))
                for m in range(TP8)]
        pms = [_map_layer(loc, lambda t: t[0]) for loc in locs]
        ha8 = h0.detach().requires_grad_(True)
        hf8 = hf.detach().requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = None
        for m, pm in enumerate(pms):
            part = T.attention_share(cfg, pm, ha8, pos, tab, m, TP8)
            a = part if a is None else a + part
        out_a8 = ha8 + a
        y, aux8 = None, None
        for m, pm in enumerate(pms):
            part, ap = T.ffn_share(cfg, pm, hf8, m, TP8)
            y = part if y is None else y + part
            if ap is not None:
                aux8 = ap if aux8 is None else aux8 + ap
        out_f8 = hf8 + y
        leaves8 = [t for loc in locs for _, t in _paths_of(loc)]
        ga8 = torch.autograd.grad(loss_of(out_a8, g_a, None),
                                  [ha8] + leaves8, allow_unused=True)
        gf8 = torch.autograd.grad(loss_of(out_f8, g_f, aux8),
                                  [hf8] + leaves8, allow_unused=True)
        torch.cuda.synchronize()
        tp_s = time.perf_counter() - t0
    finally:
        plain.restore()
        shapes.restore()
    used = kernels_launches()
    paths = [p for p, _ in _paths_of(one)]
    n = len(paths)
    errs = {"attention out": _scaled_check(f"{arch} tp8 attention out",
                                           out_a8, out_a1),
            "attention dh": _scaled_check(f"{arch} tp8 attention dh",
                                          ga8[0], ga1[0]),
            "ffn out": _scaled_check(f"{arch} tp8 ffn out", out_f8, out_f1),
            "ffn dh": _scaled_check(f"{arch} tp8 ffn dh", gf8[0], gf1[0])}
    for grads8, grads1 in ((ga8, ga1), (gf8, gf1)):
        local = [{p: grads8[1 + m * n + i] for i, p in enumerate(paths)}
                 for m in range(TP8)]
        full8 = _sum_grads(one, specs, local)
        for p, g1 in zip(paths, grads1[1:]):
            if g1 is None:
                continue
            name = ".".join(p)
            errs[name] = _scaled_check(f"{arch} tp8 d{name}", full8[p], g1,
                                       quiet=True)
    if cfg.is_moe:
        a8, a1 = aux8.item(), aux1.item()
        errs["aux"] = abs(a8 - a1) / a1
        if errs["aux"] > 1e-5:
            raise AssertionError(f"{arch} tp8: aux {a8} != "
                                 f"{a1}")
    controls = {}
    if cfg.use_mla:
        i = paths.index(("attn", "wq_a"))
        controls["wq_a unreduced"] = _refuses_scaled(
            f"{arch} tp8 dattn.wq_a", ga8[1 + i], ga1[1 + i],
            "gradient of rank 0 alone (unreduced)")
        with torch.no_grad():
            shared = layers.mlp_fwd(cfg, p1["moe"]["shared"],
                                    layers.apply_norm(cfg, p1["ln2"], hf))
        controls["shared whole on every rank"] = _refuses_scaled(
            f"{arch} tp8 ffn out", out_f8 + (TP8 - 1) * shared, out_f1,
            "shared expert added whole on every rank")
    want = {"flash_attention": TP8, "flash_attention_bwd": TP8}
    if cfg.is_moe:
        want.update(moe_gemm=6 * TP8, moe_gemm_wgrad=3 * TP8)
    if {k: v for k, v in used.items() if v} != want or \
            any(plain.calls.values()):
        raise AssertionError(f"{arch} tp8: launches {used}, plain versions "
                             f"called {plain.calls} (expected {want})")
    worst = max(v for k, v in errs.items() if k != "aux")
    log(f"  {arch} one layer at B{B} S{S}, tp {TP8} rank by rank: both "
        f"blocks' outputs, input gradients and all {n} leaves' gradients "
        f"within TOL[bf16] of each tensor's scale (worst |err| / scale "
        f"{worst:.3e}{', aux rel err %.2e' % errs['aux'] if cfg.is_moe else ''}"
        f"); launches {used}; kernel shapes {shapes.shapes()}; fwd + bwd "
        f"one device {one_s * 1e3:.1f} ms, 8 ranks in turn "
        f"{tp_s * 1e3:.1f} ms (host clock)")
    del locs, pms, one, ga1, gf1, ga8, gf8
    return used, dict(worst_err_over_scale=worst,
                      aux_rel_err=errs.get("aux"), controls=controls,
                      one_device_ms=one_s * 1e3, ranks_in_turn_ms=tp_s * 1e3,
                      kernel_shapes=shapes.shapes(), launches=used)


def _refuses_scaled(name, wrong, want, what):
    """``_scaled_check``'s tolerance must refuse ``wrong`` (a wronged
    version's result) in place of ``want``.  Returns max |err| / scale."""
    wrong, want = wrong.float(), want.float()
    scale = max(want.abs().max().item(), 1e-30)
    tol = TOL[torch.bfloat16]
    err = (wrong - want).abs().max().item()
    ok = torch.allclose(wrong, want, atol=tol["atol"] * scale,
                        rtol=tol["rtol"])
    log(f"  {name}: the check refuses the {what}: max_abs_err={err:.3e} "
        f"(scale {scale:.3e})")
    if ok:
        raise AssertionError(f"{name}: the check cannot see the {what}")
    return err / scale


def kernels_launches():
    from repro_torch import kernels
    return kernels.launches()


def _map_layer(tree, fn):
    return {k: _map_layer(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _scaled_check(name, got, want, quiet=False):
    """|got - want| within TOL[bf16] of ``want``'s scale: atol 2e-2 x
    max |want|, rtol 2e-2.  Returns max |err| / scale."""
    got, want = got.float(), want.float()
    scale = max(want.abs().max().item(), 1e-30)
    err = (got - want).abs().max().item()
    tol = TOL[torch.bfloat16]
    ok = torch.isfinite(got).all() and torch.allclose(
        got, want, atol=tol["atol"] * scale, rtol=tol["rtol"])
    if not quiet or not ok:
        log(f"  {name}: max_abs_err={err:.3e} (scale {scale:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: the ranks' sum disagrees with one "
                             f"device (max abs err {err}, scale {scale})")
    return err / scale


def _tp8_vocab(dev):
    """Qwen3-30B-A3B's vocabulary-parallel ends at tp 8 on B2 S4096, each
    rank on its shard of 18,992 rows or columns, as ``forward_loss`` runs
    them over a model group: the embedding (``embed_share``, the ranks'
    rows summed in rank order where ``forward_loss`` all-reduces them)
    against ``_embed_tokens`` (equal bits: one rank owns each token), its
    ``embed`` gradient within TOL[bf16] of its scale; and the
    cross-entropy, chunk by chunk (``CE_CHUNK``), each rank's
    ``ce_shard`` merged by ``ce_merge`` over a leading rank axis (the max
    and the sums ``_chunk_ce_tp`` takes over the group), its value and the
    gradients of h and ``lm_head`` held to the one-device
    ``_chunked_ce``'s (value rtol 1e-5; gradients TOL[bf16] of their
    scale)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("qwen3_moe_30b")
    B, S = TP8_BATCH
    V = T.padded_vocab(cfg)
    Vl = V // TP8
    gen = torch.Generator(device=dev).manual_seed(19)
    W = (torch.randn((cfg.d_model, V), generator=gen, device=dev)
         / math.sqrt(cfg.d_model)).to(torch.bfloat16)
    E = torch.randn((V, cfg.d_model), generator=gen, device=dev) \
        .to(torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev, dtype=torch.int32)
    g_e = torch.randn((B, S, cfg.d_model), generator=gen, device=dev) \
        .to(torch.bfloat16)
    h0 = torch.randn((B, S, cfg.d_model), generator=gen, device=dev) \
        .to(torch.bfloat16)
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev, dtype=torch.int32)
    labels[:, :7] = -1

    # the embedding
    E1 = E.detach().requires_grad_(True)
    e1 = T._embed_tokens(cfg, {"embed": E1}, tokens)
    (dE1,) = torch.autograd.grad((e1.float() * g_e.float()).sum(), [E1])
    Es = [E[m * Vl:(m + 1) * Vl].contiguous().requires_grad_(True)
          for m in range(TP8)]
    e8 = None
    for m, Em in enumerate(Es):
        part = T.embed_share(cfg, {"embed": Em}, tokens, m, TP8)
        e8 = part if e8 is None else e8 + part
    dEs = torch.autograd.grad((e8.float() * g_e.float()).sum(), Es)
    if not torch.equal(e8, e1):
        raise AssertionError("qwen3_moe_30b tp8 embedding: the ranks' sum "
                             "is not the one-device embedding's bits")
    e_e = _scaled_check("qwen3_moe_30b tp8 dembed", torch.cat(dEs), dE1)
    del E1, e1, dE1, Es, e8, dEs

    # the cross-entropy
    W1, h1 = W.detach().requires_grad_(True), h0.detach().requires_grad_(True)
    t0 = time.perf_counter()
    loss1 = T._chunked_ce(cfg, {"lm_head": W1}, h1, labels)
    dh1, dW1 = torch.autograd.grad(loss1, [h1, W1])
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    Ws = [W[:, m * Vl:(m + 1) * Vl].contiguous().requires_grad_(True)
          for m in range(TP8)]
    h8 = h0.detach().requires_grad_(True)
    t0 = time.perf_counter()
    tot = torch.zeros((), dtype=torch.float32, device=dev)
    cnt = torch.zeros((), dtype=torch.float32, device=dev)
    for s0 in range(0, S, T.CE_CHUNK):
        hc, lc = h8[:, s0:s0 + T.CE_CHUNK], labels[:, s0:s0 + T.CE_CHUNK]
        stats = [T.ce_shard(cfg, {"lm_head": w}, hc, lc, m, TP8)
                 for m, w in enumerate(Ws)]
        lse, ll = (torch.stack(t) for t in zip(*stats))
        t, n = T.ce_merge(lse, ll, lc, lambda x: x.amax(0),
                          lambda x: x.sum(0))
        tot, cnt = tot + t, cnt + n
    loss8 = tot / cnt
    grads = torch.autograd.grad(loss8, [h8] + Ws)
    torch.cuda.synchronize()
    tp_ms = (time.perf_counter() - t0) * 1e3
    if not math.isclose(loss8.item(), loss1.item(), rel_tol=1e-5):
        raise AssertionError(f"tp8 cross-entropy {loss8.item()} != "
                             f"{loss1.item()}")
    e_h = _scaled_check("qwen3_moe_30b tp8 CE dh", grads[0], dh1)
    e_w = _scaled_check("qwen3_moe_30b tp8 CE dlm_head",
                        torch.cat(grads[1:], dim=1), dW1)
    log(f"  qwen3_moe_30b embedding over {TP8} vocab shards of {Vl} rows, "
        f"B{B} S{S}: equal bits, dembed |err| / scale {e_e:.2e}; "
        f"cross-entropy over {TP8} shards of {Vl} columns: "
        f"{loss8.item():.6f} vs one device {loss1.item():.6f}; one device "
        f"{one_ms:.1f} ms, 8 shards in turn {tp_ms:.1f} ms (host clock)")
    return dict(loss=loss8.item(), one_device_loss=loss1.item(),
                dh_err_over_scale=e_h, dlm_head_err_over_scale=e_w,
                embed_equal_bits=True, dembed_err_over_scale=e_e,
                vocab_shard=Vl, one_device_ms=one_ms, shards_in_turn_ms=tp_ms)


def _tp8_flash_times(dev):
    """The flash forward, and forward + backward under autograd, at a
    rank's tp-8 head shard (H 4 over Hkv 1) and at the one-device layer's
    heads, B2 S4096 bf16, causal: CUDA-event medians of 20 (``Timer``)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.timing import Timer
    timer = Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(20)
    B, S = TP8_BATCH
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S) \
        .contiguous()
    out = {}
    for tag, H, Hkv, D in (("llama tp8 rank", 4, 1, 64),
                           ("llama one device", 32, 8, 64),
                           ("qwen3 tp8 rank", 4, 1, 128),
                           ("qwen3 one device", 32, 4, 128)):
        q, k, v = (_rand(gen, (B, S, h, D), torch.bfloat16, dev)
                   .requires_grad_(True) for h in (H, Hkv, Hkv))
        dout = _rand(gen, (B, S, H, D), torch.bfloat16, dev)
        with torch.no_grad():
            fwd = timer(lambda: flash_attention(q, k, v, pos, pos))
        both = timer(lambda: torch.autograd.grad(
            flash_attention(q, k, v, pos, pos), (q, k, v), dout))
        out[f"B{B} S{S} H{H}/{Hkv} D{D} ({tag})"] = dict(fwd_ms=fwd,
                                                        fwd_bwd_ms=both)
        log(f"  flash at B{B} S{S} H{H}/{Hkv} D{D} ({tag}): forward "
            f"{fwd:.3f} ms, forward + backward {both:.3f} ms")
    del timer
    return out


def tp8_layers_path(dev):
    """Phase 18 (b): rank by rank at tp 8 on one card, at full width: one
    Llama-3.2-1B decoder layer and one Qwen3-30B-A3B MoE layer
    (``_tp8_layer``), Qwen3-30B-A3B's vocab-parallel cross-entropy
    and embedding (``_tp8_vocab``), and the flash kernel's times at the head shard
    (``_tp8_flash_times``); the peak device memory over them.  Returns
    (launches of the layers, numbers)."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    used, stats = {}, {}
    for arch in ("llama3_2_1b", "qwen3_moe_30b"):
        u, stats[arch] = _tp8_layer(dev, arch)
        for name, n in u.items():
            used[name] = used.get(name, 0) + n
        gc.collect()
        torch.cuda.empty_cache()
    stats["vocab_parallel"] = _tp8_vocab(dev)
    gc.collect()
    torch.cuda.empty_cache()
    stats["flash_times"] = _tp8_flash_times(dev)
    stats["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    stats["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 18 (b) took {stats['seconds']:.1f} s, peak device memory "
        f"{stats['peak_gb']:.2f} GB")
    return used, stats


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# --------------------------------------------------------------- phase 19
SERVE_PROMPTS = (4, 2048)       # (a): prompts x tokens
SERVE_MAX_LEN = 32768
SERVE_STEPS = 16


class _ServePlainCalls(_PlainCalls):
    """``_PlainCalls`` and the paged kernel's plain version."""
    NAMES = _PlainCalls.NAMES + (("repro_torch.kernels.paged_attention.ops",
                                  "paged_attention_plain"),)


def _kinds(events):
    out = {}
    for kind, _, _ in events:
        out[kind] = out.get(kind, 0) + 1
    return out


def _serve_cells(cfg, mesh, params, prompts):
    """``build_cell``'s prefill cell on ``prompts`` into ``SERVE_MAX_LEN``,
    then ``SERVE_STEPS`` decode-cell steps from its cache: (the tokens, the
    prefill's logits, the collectives of the prefill and of each step, ms
    of each step)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.steps import build_cell
    B, S = prompts.shape
    pc = build_cell(cfg, "prefill_32k", mesh, batch_seq=(B, S),
                    max_len=SERVE_MAX_LEN)
    dc = build_cell(cfg, "decode_32k", mesh, batch_seq=(B, SERVE_MAX_LEN))
    C.reset_events()
    logits, cache = pc.step(params, {"tokens": prompts})
    events = [_kinds(C.EVENTS)]
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    lengths = torch.full((B,), S, dtype=torch.int32, device=prompts.device)
    tokens, secs = [tok], []
    for _ in range(SERVE_STEPS):
        C.reset_events()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, cache, lengths = dc.step(params, cache, tok, lengths)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        events.append(_kinds(C.EVENTS))
        tokens.append(tok)
    C.reset_events()
    del cache
    return torch.stack(tokens), logits, events, secs


def serve_sharded_path(dev):
    """Phase 19: the multi-GPU serving path on one card (see the module's
    docstring).  Returns (launches of the cells' runs, numbers)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    cfg = get_config("llama3_2_1b")
    L = cfg.num_layers
    B, S = SERVE_PROMPTS
    gen = torch.Generator(device=dev).manual_seed(19)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=dev, dtype=torch.int32)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = mesh_lib.Mesh(("data", "model"), (1, 1)).realize("cuda")
        params = T.init_params(cfg, 0, dev)
        for shape in ("prefill_32k", "decode_32k"):
            drawn = build_cell("llama3_2_1b", shape, mesh).init_state(0, dev)
            if not all(torch.equal(a, b) for a, b in zip(_leaves(drawn),
                                                         _leaves(params))):
                raise AssertionError(f"phase 19: the {shape} cell's "
                                     f"init_state is not init_params' bits")
            del drawn
        # the one-device reference
        logits0, cache = T.prefill(cfg, params, prompts)
        cache = T.install_cache(cfg, T.init_cache(cfg, B, SERVE_MAX_LEN,
                                                  dev), cache)
        tok = torch.argmax(logits0[:, -1], dim=-1).to(torch.int32)
        want = [tok]
        for i in range(SERVE_STEPS):
            tok, cache = T.decode_step(cfg, params, cache, tok,
                                       torch.full((B,), S + i,
                                                  dtype=torch.int32,
                                                  device=dev))
            want.append(tok)
        want = torch.stack(want)
        del cache
        gc.collect()
        torch.cuda.empty_cache()

        reset_counts()
        plain = _ServePlainCalls()
        try:
            got, logits1, ev_skip, secs = _serve_cells(cfg, mesh, params,
                                                       prompts)
            sent = dataclasses.replace(mesh, comm=C.Comm(**{
                f: dataclasses.replace(getattr(mesh.comm, f), skip_one=False)
                for f in ("model", "data", "world")}))
            got_s, logits_s, ev_sent, secs_s = _serve_cells(cfg, sent,
                                                            params, prompts)
            del params
            gc.collect()
            torch.cuda.empty_cache()
            bench, layer0 = _rank_decode(dev, {"skipped": mesh,
                                               "sent": sent})
        finally:
            plain.restore()
        used = kernels_launches()
        routes = dict(paged_ops.ROUTE_LAUNCHES)
        merge = _merge_rank_by_rank(dev, *layer0)
        del layer0
    finally:
        dist.destroy_process_group()
    if not (torch.equal(got, want) and torch.equal(logits1, logits0)):
        raise AssertionError("phase 19 (a): the cells' tokens or logits are "
                             "not the one-device path's bits")
    if not (torch.equal(got_s, want) and torch.equal(logits_s, logits0)):
        raise AssertionError("phase 19 (a), collectives sent: the tokens or "
                             "logits are not the one-device path's bits")
    if any(ev_skip):
        raise AssertionError(f"phase 19 (a): collectives recorded in groups "
                             f"of one: {ev_skip}")
    design = [{"all-reduce": 1 + 2 * L, "all-gather": 1, "all-to-all": 2}] \
        + [{"all-reduce": 1 + 3 * L, "all-gather": 1}] * SERVE_STEPS
    if ev_sent != design:
        raise AssertionError(f"phase 19 (a), collectives sent: {ev_sent[:2]} "
                             f"..., the design {design[:2]} ...")
    steps_b = bench["steps"]
    want_used = {"flash_attention": 2 * L,
                 "paged_attention": (2 * SERVE_STEPS + steps_b) * L}
    if {k: n for k, n in used.items() if n} != want_used or \
            routes != {"mma": want_used["paged_attention"], "simt": 0} or \
            any(plain.calls.values()):
        raise AssertionError(f"phase 19: launches {used}, paged by route "
                             f"{routes}, plain versions called "
                             f"{plain.calls} (expected {want_used}, paged "
                             f"all on mma, no plain version)")
    step_ms = statistics.median(secs) * 1e3
    step_ms_s = statistics.median(secs_s) * 1e3
    n_sent = sum(sum(e.values()) for e in ev_sent)
    log(f"  phase 19 (a) Llama-3.2-1B bf16, {B} prompts of {S} into "
        f"{SERVE_MAX_LEN}, {SERVE_STEPS} steps through build_cell's prefill "
        f"and decode cells on an NCCL group of one: tokens and logits equal "
        f"the one-device prefill + decode_step in bits, collectives skipped "
        f"({step_ms:.3f} ms/step) and sent ({n_sent} collectives, as "
        f"designed: {ev_sent[0]} the prefill, {ev_sent[1]} a step; "
        f"{step_ms_s:.3f} ms/step)")
    log(f"  phase 19 (b) the decode cell at B{bench['batch']} x "
        f"{bench['seq']} ({bench['cache_gb']:.1f} GB of cache), collectives "
        f"skipped: {bench['skipped']['ms_per_step']:.3f} ms/step, "
        f"{bench['skipped']['tokens_per_s']:.1f} output tokens/s; sent "
        f"(shard attention with lse, merge, vocabulary argmax): "
        f"{bench['sent']['ms_per_step']:.3f} ms/step, "
        f"{bench['sent']['tokens_per_s']:.1f} tokens/s; peak "
        f"{bench['peak_gb']:.2f} GB; launches {used}, paged by route "
        f"{routes}, no plain version")
    secs_phase = time.perf_counter() - t_phase
    log(f"  phase 19 took {secs_phase:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return used, dict(equal_bits=True, step_ms=step_ms,
                      step_ms_collectives_sent=step_ms_s,
                      collectives_sent=ev_sent[:2], rank_decode=bench,
                      merge_rank_by_rank=merge,
                      launches=used, paged_routes=routes,
                      seconds=secs_phase)


def _rank_decode(dev, meshes):
    """Phase 19 (b): ``RANK_PAGED``'s batch and cache through the decode
    cell of Llama-3.2-1B on each mesh of ``meshes`` (tag -> mesh: the
    group of one with its collectives skipped, which decodes as one
    device does, and sent, which runs the decode regime's shard attention
    with its lse, ``merge_shards`` and the vocabulary argmax), the cache
    filled once with random bf16 values, ``SERVE_STEPS`` steps a mesh from
    the same lengths, each timed on the host clock after a synchronize."""
    from repro_torch.launch.steps import build_cell
    B, S = RANK_PAGED[0], RANK_PAGED[1]
    torch.cuda.reset_peak_memory_stats(dev)
    cells = {tag: build_cell("llama3_2_1b", "decode_32k", m,
                             batch_seq=(B, S)) for tag, m in meshes.items()}
    cell = next(iter(cells.values()))
    params = cell.init_state(0, dev)
    cache = cell.init_cache(dev)
    gen = torch.Generator(device=dev).manual_seed(191)
    for leaf in cache.values():
        for i in range(leaf.shape[0]):
            leaf[i].normal_(generator=gen)
    tok0 = torch.randint(0, cell.cfg.vocab_size, (B,), generator=gen,
                         device=dev, dtype=torch.int32)
    cache_gb = sum(t.numel() * t.element_size() for t in cache.values()) / 1e9
    out = dict(batch=B, seq=S, steps=len(cells) * SERVE_STEPS,
               cache_gb=cache_gb)
    for tag, c in cells.items():
        tok = tok0
        start = torch.tensor(RANK_PAGED[5], dtype=torch.int32, device=dev)
        lengths, secs = start, []
        for _ in range(SERVE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, cache, lengths = c.step(params, cache, tok, lengths)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        if not torch.equal(lengths, start + SERVE_STEPS) or \
                not ((tok >= 0) & (tok < cell.cfg.vocab_size)).all():
            raise AssertionError(f"phase 19 (b) {tag}: lengths "
                                 f"{lengths.tolist()[:4]}")
        out[tag] = dict(ms_per_step=statistics.median(secs[1:]) * 1e3,
                        step_ms=[x * 1e3 for x in secs],
                        tokens_per_s=B * (SERVE_STEPS - 1) / sum(secs[1:]))
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    layer0 = (cache["k"][0].clone(), cache["v"][0].clone())
    del params, cache
    return out, layer0


class _StackedGroup:
    """A stand-in model group over the ranks' tensors stacked on dim 0
    (rank by rank in one process): its all-reduce folds them in rank
    order and hands every rank the result."""
    trivial = False

    def __init__(self, size):
        self.size = size

    def all_reduce(self, x, op="sum"):
        r = x[0]
        for t in x[1:]:
            r = torch.maximum(r, t) if op == "max" else r + t
        return torch.stack([r] * self.size)


def _merge_rank_by_rank(dev, k, v, tp: int = 4):
    """Phase 19 (c): one layer's decode attention over a cache (B, S, Hkv,
    dh) in bf16 split in ``tp`` sequence shards, each rank's
    ``decode_attention_shard`` (the kernel with its lse) merged by
    ``merge_shards`` over a stand-in group, against the whole cache's
    kernel launch (one bf16 rounding; the merge rounds each shard's output
    and then the sum) and the plain version in fp32, at ``_scaled_tol``:
    the outputs, averages over ~32,750 keys, have an rms of ~9e-3.  The
    check must refuse the merge with the last shard left out.  Rows at
    ``RANK_PAGED``'s lengths, one of them 0, one at a shard boundary.
    Returns the errors and the tolerance."""
    from repro_torch.kernels.paged_attention.ops import paged_attention_plain
    from repro_torch.models import layers
    B, S, Hkv, dh = k.shape
    H = RANK_PAGED[2]
    S_l = S // tp
    gen = torch.Generator(device=dev).manual_seed(192)
    q = _rand(gen, (B, 1, H, dh), torch.bfloat16, dev)
    lens = list(RANK_PAGED[5])
    lens[1], lens[-1] = 0, S_l          # an empty row, one at a boundary
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    whole = layers.decode_attention(q, k, v, lengths)
    parts = [layers.decode_attention_shard(
        q, k[:, m * S_l:(m + 1) * S_l].contiguous(),
        v[:, m * S_l:(m + 1) * S_l].contiguous(), lengths, m, S_l)
        for m in range(tp)]
    merged = layers.merge_shards(torch.stack([o for o, _ in parts]),
                                 torch.stack([x for _, x in parts]),
                                 _StackedGroup(tp))
    page = math.gcd(S, 16)
    table = torch.arange(B * S // page, dtype=torch.int32,
                         device=dev).reshape(B, S // page)
    plain = paged_attention_plain(
        q[:, 0].float(), k.float().view(-1, page, Hkv, dh),
        v.float().view(-1, page, Hkv, dh), table, lengths)
    torch.cuda.synchronize()
    if any(not torch.equal(merged[m], merged[0]) for m in range(tp)) or \
            merged[0][1].any():
        raise AssertionError("phase 19 (c): the ranks' merges differ, or "
                             "the empty row is not zeros")
    name = f"phase 19 (c) decode attention over {tp} shards of {S_l}, merged"
    tol = _scaled_tol(whole, torch.bfloat16)
    err = _check(f"{name}, vs the whole cache", merged[0], whole,
                 torch.bfloat16, tol)
    err_plain = _check(f"{name}, vs the plain version in fp32",
                       merged[0][:, 0].float(), plain, torch.bfloat16,
                       _scaled_tol(plain, torch.bfloat16))
    err_whole = (whole[:, 0].float() - plain).abs().max().item()
    log(f"  phase 19 (c): the whole cache's launch vs fp32 plain "
        f"max_abs_err={err_whole:.3e}")
    # the check must refuse a merge that leaves the last rank's shard out
    dropped = layers.merge_shards(torch.stack([o for o, _ in parts[:-1]]),
                                  torch.stack([x for _, x in parts[:-1]]),
                                  _StackedGroup(tp - 1))[0]
    err_dropped = _refuses_wrong(f"{name}, vs the whole cache", whole,
                                 dropped, "merge without the last shard",
                                 tol)
    return dict(tp=tp, atol=tol["atol"], rtol=tol["rtol"],
                merged_vs_whole=err, merged_vs_plain_fp32=err_plain,
                whole_vs_plain_fp32=err_whole,
                without_last_shard_vs_whole=err_dropped)


# --------------------------------------------------------------- phase 20
SEQ_TP = 4
# (a): SmolLM-360M's depth cut and batch for the fsdp step on a group of one
FSDP_LAYERS, FSDP_BATCH, FSDP_STEPS = 8, (4, 4096), 3
# (b): one layer, B2 S4096
SEQ_SHARE_BATCH = (2, 4096)
# (c): the seq ranks' flash shapes, phase 3's SmolLM B8 S4096 H15/5 D64
SEQ_FLASH = (8, 4096, 15, 5, 64)
# (d): Qwen2-0.5B fp32 prompts x tokens, the cache's positions, steps
SEQ_SERVE = (4, 2048, 4096, 8)


def _expect_launches(path, used, want, plain, routes=()):
    """The path launched each kernel of ``want`` as many times as it
    says and no other, called no plain version (``plain``, a
    ``_PlainCalls``), and each (name, launches by route, route) of
    ``routes`` took that route every time."""
    got = {k: n for k, n in used.items() if n}
    off = [(name, r) for name, r, route in routes
           if r.get(route, 0) != want.get(name, 0)]
    if got != want or off or any(plain.calls.values()):
        raise AssertionError(f"{path}: launches {got}, expected {want}; "
                             f"by route {off}; plain versions called "
                             f"{plain.calls}")


def _sent(mesh):
    """``mesh`` with every group's collectives sent (``skip_one=False``)."""
    from repro_torch.distributed import collectives as C
    return dataclasses.replace(mesh, comm=C.Comm(**{
        f: dataclasses.replace(getattr(mesh.comm, f), skip_one=False)
        for f in ("model", "data", "world")}))


def _fsdp_design(cfg):
    """The collectives of an fsdp step at remat on over a world whose
    size divides every leaf's largest dim (one card's): each leaf
    gathered where it is read (a layer's leaves twice: the recompute
    gathers again) and its gradient reduce-scattered once; the label
    count, the loss and the grad norm all-reduced."""
    from repro_torch.models import transformer as T
    shapes = T.param_shapes(cfg)
    per_layer = sum(1 for _ in _leaves(shapes["layers"]))
    top = sum(1 for k, v in shapes.items() if k != "layers"
              for _ in (_leaves(v) if isinstance(v, dict) else [v]))
    L = cfg.num_layers
    return {"all-gather": top + 2 * L * per_layer,
            "reduce-scatter": top + L * per_layer, "all-reduce": 3}


def train_fsdp_path(dev):
    """Phase 20 (a): ``build_cell``'s fsdp cell (ZeRO-3) of SmolLM-360M at
    every published width, ``FSDP_LAYERS`` of its 32 layers, on an NCCL
    group of one with every collective sent (``skip_one=False``: each
    leaf's shard gathered where it is read and its gradient
    reduce-scattered, through NCCL at world size 1), ``FSDP_STEPS`` steps
    of ``FSDP_BATCH`` from seed 0 (lr 1e-3, remat): each loss and grad
    norm equal in bits to the one-device ``train_step``'s on the same
    weights and batches, each step's collectives as ``_fsdp_design``
    predicts, every flash and flash-backward launch on wgmma, no plain
    version.  Returns (launches of the fsdp steps, numbers)."""
    import torch.distributed as dist

    from repro_torch import optim
    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention_bwd import ops as bwd_ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import build_cell, train_step
    from repro_torch.models import transformer as T

    L, (GB, S), steps = FSDP_LAYERS, FSDP_BATCH, FSDP_STEPS
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = _sent(mesh_lib.Mesh(("data", "model"), (1, 1))
                     .realize("cuda"))
        cell = build_cell("smollm_360m", "train_4k", mesh,
                          batch_seq=(GB, S), over=dict(num_layers=L),
                          train_regime="fsdp",
                          opt_cfg=optim.AdamWConfig(lr=1e-3))
        cfg = cell.cfg
        stream = SyntheticLMStream(DataConfig(
            global_batch=GB, seq_len=S, vocab_size=cfg.vocab_size, seed=0))
        batches = [{k: torch.from_numpy(v).to(dev)
                    for k, v in stream.batch_at(i).items()}
                   for i in range(steps)]
        # the one-device step
        p0 = T.init_params(cfg, 0, dev)
        o0 = optim.init_opt_state(p0)
        ocfg0 = optim.AdamWConfig(lr=1e-3, zero1=False)
        want_l, want_g, secs0 = [], [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = train_step(cfg, p0, o0, b, ocfg0)
            want_l.append(out["loss"].item())
            want_g.append(out["grad_norm"].item())
            secs0.append(time.perf_counter() - t0)
        del p0, o0
        gc.collect()
        torch.cuda.empty_cache()
        # the fsdp cell, every collective sent
        torch.cuda.reset_peak_memory_stats(dev)
        params, opt = cell.init_state(0, dev)
        reset_counts()
        plain = _PlainCalls()
        losses, gnorms, secs, events, wire = [], [], [], [], []
        try:
            for b in batches:
                C.reset_events()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = cell.step(params, opt, b)
                losses.append(out["loss"].item())
                gnorms.append(out["grad_norm"].item())
                secs.append(time.perf_counter() - t0)
                events.append(_kinds(C.EVENTS))
                wire.append(sum(n for _, n, _ in C.EVENTS))
        finally:
            plain.restore()
        used = kernels_launches()
        routes = (dict(ops.ROUTE_LAUNCHES), dict(bwd_ops.ROUTE_LAUNCHES))
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        C.reset_events()
        del params, opt
    finally:
        dist.destroy_process_group()
    design = _fsdp_design(cfg)
    _expect_launches("phase 20 (a)", used, {
        "flash_attention": 2 * L * steps, "flash_attention_bwd": L * steps},
        plain, [("flash_attention", routes[0], "wgmma"),
                ("flash_attention_bwd", routes[1], "wgmma")])
    if losses != want_l or gnorms != want_g:
        raise AssertionError(f"phase 20 (a): fsdp losses {losses}, grad "
                             f"norms {gnorms}: not the one-device step's "
                             f"bits ({want_l}, {want_g})")
    if events != [design] * steps:
        raise AssertionError(f"phase 20 (a): collectives {events}, the "
                             f"design {design} a step")
    step_s, one_s = statistics.median(secs[1:]), statistics.median(secs0[1:])
    log(f"  phase 20 (a) SmolLM-360M bf16, {L} layers, {steps} steps of "
        f"{GB} x {S} through build_cell's fsdp cell on an NCCL group of one, "
        f"every collective sent: losses {losses} and grad norms {gnorms} "
        f"equal the one-device step's bits; {events[0]} a step, as "
        f"designed ({wire[0] / 1e6:.1f} MB raw); {step_s:.3f} s/step "
        f"(one device {one_s:.3f}); peak {peak:.2f} GB; launches {used}, "
        f"all on wgmma, no plain version")
    gc.collect()
    torch.cuda.empty_cache()
    return used, dict(losses=losses, grad_norms=gnorms, equal_bits=True,
                      collectives_a_step=events[0], raw_mb_a_step=wire[0]
                      / 1e6, step_s=step_s, one_device_step_s=one_s,
                      step_secs=secs, one_device_step_secs=secs0,
                      peak_gb=peak)


def _seq_share_layer(dev, arch: str):
    """Phase 20 (b) for ``arch``: one layer's attention sublayer at every
    published width on ``SEQ_SHARE_BATCH``, bf16, forward and backward, on
    one device and rank by rank at tp ``SEQ_TP`` in the ``seq`` mode
    (``attention_share``: each rank's q rows against every key, the
    attention leaves whole), the ranks' outputs and every gradient summed
    in rank order in bf16 (what ``_train_layer``'s reduce and ``copy_in``
    sum), held to the one-device sublayer: the output (each row from one
    rank) at ``_scaled_tol``, the gradients of h and of every leaf (sums
    of the ranks' bf16 partials, each rounded before the sum) within
    TOL[bf16] of each tensor's scale (``_scaled_check``, as phase 18 (b)
    holds its rank sums).  The output's check must refuse the sum without
    the last rank's rows and shares whose q positions are not offset.  Attention biases are drawn (zeros at
    ``init_params``).  Returns (launches, numbers)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(arch), num_layers=1)
    tp, (B, S) = SEQ_TP, SEQ_SHARE_BATCH
    if not T.seq_split(cfg, tp):
        raise AssertionError(f"{arch}: its heads split over {tp}")
    gen = torch.Generator(device=dev).manual_seed(20)
    stack = T.init_params(cfg, 20, dev)["layers"]
    p = _map_layer({k: stack[k] for k in ("ln1", "attn")}, lambda t: t[0])
    del stack
    for k in ("bq", "bk", "bv"):
        if k in p["attn"]:
            p["attn"][k] = _rand(gen, p["attn"][k].shape, torch.bfloat16,
                                 dev) * 0.1
    h0 = _rand(gen, (B, S, cfg.d_model), torch.bfloat16, dev)
    up = _rand(gen, (B, S, cfg.d_model), torch.bfloat16, dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
    tab = layers.rope_tables(pos, layers.rope_dim(cfg), cfg.rope_theta)

    def req(tree):
        return {k: req(v) if isinstance(v, dict) else
                v.detach().requires_grad_(True) for k, v in tree.items()}

    def run(ranks, n):
        """The shares of ``ranks`` of ``n`` summed in bf16, and the
        gradients of h and of each leaf (the ranks' parts summed)."""
        h = h0.detach().requires_grad_(True)
        locs = [req(p) for _ in ranks]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = None
        for m, loc in zip(ranks, locs):
            part = T.attention_share(cfg, loc, h, pos, tab, m, n)
            out = part if out is None else out + part
        leaves = [t for loc in locs for _, t in _paths_of(loc)]
        grads = torch.autograd.grad((out.float() * up.float()).sum(),
                                    [h] + leaves)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k = len(leaves) // len(locs)
        summed = {}
        for i, (path, _) in enumerate(_paths_of(p)):
            for m in range(len(locs)):
                g = grads[1 + m * k + i]
                summed[path] = g if path not in summed else summed[path] + g
        return out, grads[0], summed, secs

    reset_counts()
    plain = _PlainCalls()
    try:
        one, dh1, g1, one_s = run([0], 1)
        out, dh, g, tp_s = run(range(tp), tp)
        # wronged: the last rank's rows dropped; q positions from 0
        parts_off = None
        flash = layers.chunked_attention
        layers.chunked_attention = lambda q, k, v, qp, kp, **kw: flash(
            q, k, v, kp[:, :q.shape[1]], kp, **kw)
        try:
            with torch.no_grad():
                parts_off = sum(T.attention_share(cfg, p, h0, pos, tab, m,
                                                  tp) for m in range(tp))
        finally:
            layers.chunked_attention = flash
        with torch.no_grad():
            dropped = sum(T.attention_share(cfg, p, h0, pos, tab, m, tp)
                          for m in range(tp - 1))
    finally:
        plain.restore()
    used = kernels_launches()
    tol = _scaled_tol(one, torch.bfloat16)
    errs = {"out": _check(f"phase 20 (b) {arch} seq tp{tp} out", out, one,
                          torch.bfloat16, tol),
            "dh over scale": _scaled_check(f"phase 20 (b) {arch} seq tp{tp} "
                                           f"dh", dh, dh1)}
    for path, w in g1.items():
        name = ".".join(path)
        errs[f"d{name} over scale"] = _scaled_check(
            f"phase 20 (b) {arch} seq tp{tp} d{name}", g[path], w)
    wrong = {"without the last rank": _refuses_wrong(
        f"phase 20 (b) {arch} seq tp{tp} out", one, dropped,
        "sum without the last rank's rows", tol),
        "q positions not offset": _refuses_wrong(
        f"phase 20 (b) {arch} seq tp{tp} out", one, parts_off,
        "shares whose q positions are not offset", tol)}
    # forward: one device, the ranks, the wronged positions' ranks and all
    # but the last rank; backward: one device and the ranks
    _expect_launches(f"phase 20 (b) {arch}", used, {
        "flash_attention": 1 + tp + tp + tp - 1,
        "flash_attention_bwd": 1 + tp}, plain)
    log(f"  phase 20 (b) {arch} attention at B{B} S{S}, seq mode over "
        f"{tp} ranks ({[T.seq_rows(S, m, tp) for m in range(tp)]}): out, "
        f"dh and {len(g1)} leaves' gradients within _scaled_tol; fwd + bwd "
        f"one device {one_s * 1e3:.1f} ms, {tp} ranks in turn "
        f"{tp_s * 1e3:.1f} ms (host clock)")
    return used, dict(max_abs_err=errs, atol_out=tol["atol"],
                      wronged_max_abs_err=wrong, one_device_ms=one_s * 1e3,
                      ranks_in_turn_ms=tp_s * 1e3)


def _sdpa_masked(timer, q, k, v, qp, kp, dout=None):
    """SDPA on q (B, Sq, H, D) at positions qp against k, v at kp under
    their causal mask as an explicit boolean ``attn_mask`` (GQA through
    ``enable_gqa``, else K/V repeated to the q heads): the forward's ms,
    or with ``dout`` the backward's (``autograd.grad`` of one call).  None
    where every route refuses."""
    mask = kp[0][None, :] <= qp[0][:, None]
    G = q.shape[2] // k.shape[2]
    for gqa in (True, False):
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(
            dout is not None) for x in (
            q, k if gqa else k.repeat_interleave(G, 2),
            v if gqa else v.repeat_interleave(G, 2)))
        try:
            if dout is None:
                with torch.no_grad():
                    return timer(_sdpa(qt, kt, vt, attn_mask=mask)
                                 if gqa else lambda: F.
                                 scaled_dot_product_attention(
                                     qt, kt, vt, attn_mask=mask))
            o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                               enable_gqa=gqa)
            g = dout.transpose(1, 2)
            return timer(lambda: torch.autograd.grad(
                o, (qt, kt, vt), g, retain_graph=True), iters=10)
        except RuntimeError as exc:
            log(f"  sdpa with a mask (enable_gqa={gqa}) refuses "
                f"Sq{q.shape[1]} Skv{k.shape[1]}: "
                f"{str(exc).splitlines()[0][:160]}")
    return None


def seq_flash_ranks(dev):
    """Phase 20 (c): both flash kernels at each seq rank's shape of
    ``SEQ_FLASH`` (SmolLM-360M, B8 S4096 H15/5 D64 bf16, causal; rank m
    of ``SEQ_TP`` the q rows [1024 m, 1024 (m+1)) at their positions
    against all 4096 keys) against their plain versions (the forward at
    ``_scaled_tol``, the backward at ``_grad_tol``; the keys past the
    rank's last row get no gradient), timed through the wrapper (CUDA
    events), alone (``Timer.kernel_ms``; the backward's three kernels
    summed), the plain versions, SDPA with the rank's causal mask as a
    boolean ``attn_mask`` (and for the last rank, whose mask is the
    lower-right causal one, ``causal_lower_right``), and the bound (the
    rank's pairs).  Returns {rank: numbers}."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.flash_attention_bwd.ops import (
        flash_attention_bwd, flash_attention_bwd_plain)
    from repro_torch.launch.profile import KERNEL_ENTRIES
    from repro_torch.launch.timing import Timer
    from repro_torch.models import flash, transformer as T
    timer = Timer(dev)
    B, S, H, Hkv, D = SEQ_FLASH
    gen = torch.Generator(device=dev).manual_seed(21)
    k = _rand(gen, (B, S, Hkv, D), torch.bfloat16, dev)
    v = _rand(gen, (B, S, Hkv, D), torch.bfloat16, dev)
    kp = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S) \
        .contiguous()
    out = {}
    for m in range(SEQ_TP):
        lo, hi = T.seq_rows(S, m, SEQ_TP)
        tag = f"rank {m} rows [{lo}, {hi})"
        q = _rand(gen, (B, hi - lo, H, D), torch.bfloat16, dev)
        qp = kp[:, lo:hi].contiguous()
        fwd = lambda: flash_attention(q, k, v, qp, kp)  # noqa: E731
        want = flash_attention_plain(q, k, v, qp, kp)
        e_fwd = _check(f"phase 20 (c) flash_attention {tag}", fwd(), want,
                       torch.bfloat16, _scaled_tol(want, torch.bfloat16))
        o, lse = flash.flash_attention(q, k, v, qp, kp, return_lse=True)
        dout = _rand(gen, o.shape, torch.bfloat16, dev)
        args = (q, k, v, qp, kp, o, lse, dout)
        got = flash_attention_bwd(*args)
        wants = flash_attention_bwd_plain(*args)
        tol = _grad_tol(wants, torch.bfloat16)
        e_bwd = [_check(f"phase 20 (c) flash_attention_bwd {tag} {name}", g,
                        w, torch.bfloat16, tol)
                 for g, w, name in zip(got, wants, ("dq", "dk", "dv"))]
        if got[1][:, hi:].any() or got[2][:, hi:].any():
            raise AssertionError(f"phase 20 (c) {tag}: keys past the rank's "
                                 f"rows got a gradient")
        bwd = lambda: flash_attention_bwd(*args)  # noqa: E731
        b_fwd, by_fwd, _, _ = _flash_bound(q, k, v, qp, kp)
        b_bwd, by_bwd, _, _ = _flash_bwd_bound(q, k, v, q0=lo)
        row = dict(
            fwd=dict(max_abs_err=e_fwd, ms=timer(fwd),
                     alone_ms=timer.kernel_ms(
                         fwd, KERNEL_ENTRIES["flash_attention"]),
                     plain_ms=timer(lambda: flash_attention_plain(
                         q, k, v, qp, kp), iters=2, warmup=1),
                     bound_ms=b_fwd, bound_by=by_fwd,
                     sdpa_mask_ms=_sdpa_masked(timer, q, k, v, qp, kp)),
            bwd=dict(max_abs_err=max(e_bwd), ms=timer(bwd, iters=10),
                     alone_ms=sum(timer.kernel_ms(bwd, (entry,), iters=10)
                                  for entry in KERNEL_ENTRIES[
                                      "flash_attention_bwd"]
                                  if not entry.endswith("_simt")),
                     plain_ms=timer(lambda: flash_attention_bwd_plain(
                         *args), iters=2, warmup=1),
                     bound_ms=b_bwd, bound_by=by_bwd,
                     sdpa_mask_ms=_sdpa_masked(timer, q, k, v, qp, kp,
                                               dout)))
        if hi == S:
            from torch.nn.attention.bias import causal_lower_right
            qt = q.transpose(1, 2)
            kt, vt = (x.transpose(1, 2).repeat_interleave(H // Hkv, 1)
                      for x in (k, v))
            row["fwd"]["sdpa_lower_right_ms"] = timer(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=causal_lower_right(hi - lo, S)))
        for d in ("fwd", "bwd"):
            r = row[d]
            log(f"  phase 20 (c) flash {d} {tag}: kernel {r['ms']:.4f} ms "
                f"({r['alone_ms']:.4f} alone), plain {r['plain_ms']:.4f}, "
                f"sdpa with the mask {r['sdpa_mask_ms']}, bound "
                f"{r['bound_ms']:.4f} ({r['bound_by']})"
                + (f", sdpa causal_lower_right "
                   f"{r['sdpa_lower_right_ms']:.4f}"
                   if "sdpa_lower_right_ms" in r else ""))
        out[tag] = row
        del got, wants, args, o, lse, dout
    del timer
    return out


class _ThreadGroup:
    """A model group of ``size`` ranks run as threads of one process on
    one card (the serving cells' collectives, rank by rank with the
    ranks in step): each collective puts the rank's tensor in its slot,
    waits for every rank, and folds the slots in rank order; the calls
    by kind are counted a rank."""

    def __init__(self, size: int):
        import threading
        self.size, self.slots = size, [None] * size
        self.barrier = threading.Barrier(size, timeout=300)
        self.calls = [dict() for _ in range(size)]

    def rank(self, m: int):
        return _ThreadRank(self, m)


class _ThreadRank:
    trivial = False

    def __init__(self, group, m):
        self.group, self.rank, self.size = group, m, group.size

    def _exchange(self, kind, x):
        g = self.group
        g.calls[self.rank][kind] = g.calls[self.rank].get(kind, 0) + 1
        g.slots[self.rank] = x
        g.barrier.wait()
        xs = list(g.slots)
        g.barrier.wait()
        return xs

    def all_reduce(self, x, op="sum"):
        xs = self._exchange("all-reduce", x.detach())
        r = xs[0]
        for t in xs[1:]:
            r = torch.maximum(r, t) if op == "max" else r + t
        return r

    def all_gather(self, x):
        return torch.cat(self._exchange("all-gather", x.contiguous()), 0)

    def reduce_out(self, x):            # forward only: serving
        return self.all_reduce(x)

    def copy_in(self, *xs):
        return xs[0] if len(xs) == 1 else xs


def _in_threads(fns):
    """Each of ``fns`` in a thread of its own; their results in order (the
    first exception raised again, the others' barriers broken)."""
    import threading
    res, errs = [None] * len(fns), []

    def run(i):
        try:
            res[i] = fns[i]()
        except BaseException as exc:  # noqa: BLE001 - raised below
            errs.append(exc)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return res


def serve_seq_path(dev):
    """Phase 20 (d): Qwen2-0.5B's serving cells at every published width
    and full depth, fp32, over a model group of ``SEQ_TP`` ranks run rank
    by rank as threads on the card (``_ThreadGroup``): its 14 q heads do
    not split over 4, so the prefill cell runs the ``seq`` mode (each
    rank's q rows against every key, the cache's block of every kv head
    kept without an all-to-all), then the decode cell's steps.  Prompts
    and cache of ``SEQ_SERVE``; random weights from seed 0, each rank's
    slices cut by ``shard_params``.  Every rank's tokens equal the
    one-device ``prefill`` + ``decode_step``'s; the logits and the ranks'
    cache blocks joined within TOL[fp32] of the one device's; each rank's
    collectives as designed (a prefill 1 + 2 L all-reduces and an
    all-gather, a step 1 + 3 L and one).  Returns (launches of the
    cells, numbers)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import transformer as T

    B, S, n, steps = SEQ_SERVE
    tp = SEQ_TP
    cfg = dataclasses.replace(get_config("qwen2_0_5b"), dtype="float32")
    L = cfg.num_layers
    gen = torch.Generator(device=dev).manual_seed(22)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=dev, dtype=torch.int32)
    params = T.init_params(cfg, 0, dev)
    reset_counts()
    t0 = time.perf_counter()
    logits0, cache0 = T.prefill(cfg, params, prompts, max_len=n)
    tok = torch.argmax(logits0[:, -1], dim=-1).to(torch.int32)
    want = [tok]
    for i in range(steps):
        tok, cache0 = T.decode_step(cfg, params, cache0, tok, torch.full(
            (B,), S + i, dtype=torch.int32, device=dev))
        want.append(tok)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    group = _ThreadGroup(tp)
    meshes = [mesh_lib.Mesh(("data", "model"), (1, tp), rank=m,
                            comm=C.Comm(model=group.rank(m)))
              for m in range(tp)]
    pcs = [build_cell(cfg, "prefill_32k", mm, batch_seq=(B, S), max_len=n)
           for mm in meshes]
    dcs = [build_cell(cfg, "decode_32k", mm, batch_seq=(B, n))
           for mm in meshes]
    if pcs[0].note != "attention=seq":
        raise AssertionError(f"phase 20 (d): {pcs[0].note}")
    pp = [shd.shard_params(params, c.param_specs, c.mesh) for c in pcs]
    dp = [shd.shard_params(params, c.param_specs, c.mesh) for c in dcs]
    del params

    def rank(m):
        logits, cache = pcs[m].step(pp[m], {"tokens": prompts})
        block = {k: t.clone() for k, t in cache.items()}
        calls = dict(group.calls[m])
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
        toks = [tok]
        for _ in range(steps):
            tok, cache, lengths = dcs[m].step(dp[m], cache, tok, lengths)
            toks.append(tok)
        return logits, block, calls, torch.stack(toks)

    reset_counts()
    plain = _ServePlainCalls()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = _in_threads([lambda m=m: rank(m) for m in range(tp)])
        torch.cuda.synchronize()
        tp_s = time.perf_counter() - t0
    finally:
        plain.restore()
    used = kernels_launches()
    want = torch.stack(want)
    for m, (logits, block, calls, toks) in enumerate(res):
        if not torch.equal(toks, want):
            raise AssertionError(f"phase 20 (d) rank {m}: tokens "
                                 f"{toks[:, 0].tolist()} ... not the one "
                                 f"device's {want[:, 0].tolist()} ...")
        _check(f"phase 20 (d) rank {m} prefill logits", logits, logits0,
               torch.float32)
        prefill_calls = {"all-reduce": 1 + 2 * L, "all-gather": 1}
        if calls != prefill_calls or group.calls[m] != {
                "all-reduce": 1 + 2 * L + steps * (1 + 3 * L),
                "all-gather": 1 + steps}:
            raise AssertionError(f"phase 20 (d) rank {m}: collectives "
                                 f"{calls} then {group.calls[m]}")
    for name in ("k", "v"):
        joined = torch.cat([r[1][name] for r in res], dim=2)
        _check(f"phase 20 (d) the ranks' cache blocks joined, {name}",
               joined[:, :, :S], cache0[name][:, :, :S], torch.float32)
        if joined[:, :, S:].any():
            raise AssertionError("phase 20 (d): cache past the prompt")
    _expect_launches("phase 20 (d)", used, {
        "flash_attention": L * tp, "paged_attention": L * steps * tp},
        plain)
    log(f"  phase 20 (d) Qwen2-0.5B fp32, {B} prompts of {S} into {n}, "
        f"{steps} steps, the cells over {tp} ranks as threads (seq "
        f"prefill): tokens equal the one device's; {res[0][2]} a prefill "
        f"and {1 + 3 * L} all-reduces + 1 all-gather a step a rank; one "
        f"device {one_s:.2f} s, the ranks {tp_s:.2f} s (host clock)")
    del pp, dp, cache0, res
    gc.collect()
    torch.cuda.empty_cache()
    return used, dict(tokens_equal=True, one_device_s=one_s,
                      ranks_in_threads_s=tp_s, launches=used)


def seq_fsdp_path(dev):
    """Phase 20: (a) ``train_fsdp_path``, (b) ``_seq_share_layer`` of
    SmolLM-360M and Qwen2-0.5B, (c) ``seq_flash_ranks``, (d)
    ``serve_seq_path``.  Returns (launches of (a), (b) and (d), numbers)."""
    t_phase = time.perf_counter()
    torch.cuda.set_device(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    used, stats = {}, {}

    def add(u):
        for name, k in u.items():
            used[name] = used.get(name, 0) + k

    u, stats["fsdp_step"] = train_fsdp_path(dev)
    add(u)
    for arch in ("smollm_360m", "qwen2_0_5b"):
        u, stats[f"seq_share_{arch}"] = _seq_share_layer(dev, arch)
        add(u)
        gc.collect()
        torch.cuda.empty_cache()
    stats["seq_flash_ranks"] = seq_flash_ranks(dev)
    gc.collect()
    torch.cuda.empty_cache()
    u, stats["seq_serving"] = serve_seq_path(dev)
    add(u)
    stats["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    stats["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 20 took {stats['seconds']:.1f} s, peak device memory "
        f"{stats['peak_gb']:.2f} GB")
    return used, stats


# ---------------------------------------------------------------- main
# --------------------------------------------------------------- phase 21
ATTN_TP = 4
# (a): DeepSeek-R1's experts in the one layer rank by rank at tp 8
MLA_LAYER_EXPERTS = 16
# (b): a DeepSeek-R1 rank's decode batch over its latent cache
MLA_DECODE = (32, 32768)
# (c), (d): prompts, tokens a prompt (Pixtral's after its patches), the
# cache's positions; decode steps
WINDOW_SERVE = (4, 6144, 8192)
VLM_SERVE = (4, 512, 2048)
ATTN_STEPS = 16
# (e): a DeepSeek-R1 rank's flash shape at tp 4 and its experts' GEMMs
MLA_RANK_FLASH = (2, 4096, 128 // ATTN_TP)
MLA_RANK_MOE = dict(T=2 * 4096, E=256, El=256 // ATTN_TP, k=8, D=7168,
                    F=2048)


class _RecordingGroup(_StackedGroup):
    """``_StackedGroup`` that records the bytes one rank sends into each
    all-reduce (its slice of the stacked tensor)."""

    def __init__(self, size):
        super().__init__(size)
        self.sent = []

    def all_reduce(self, x, op="sum"):
        self.sent.append(x[0].numel() * x[0].element_size())
        return super().all_reduce(x, op)


def _shards_vs_whole(name, whole, parts, tp):
    """The ranks' (out, lse) ``parts`` merged by ``merge_shards`` over a
    recording stand-in group against the whole cache's output ``whole``
    at ``_scaled_tol``; the check must refuse the merge without rank 0's
    shard (every row holds positions there).  Returns (numbers, the bytes a rank sent)."""
    from repro_torch.models import layers
    group = _RecordingGroup(tp)
    merged = layers.merge_shards(torch.stack([o for o, _ in parts]),
                                 torch.stack([x for _, x in parts]), group)
    torch.cuda.synchronize()
    if any(not torch.equal(merged[m], merged[0]) for m in range(tp)):
        raise AssertionError(f"{name}: the ranks' merges differ")
    tol = _scaled_tol(whole, torch.bfloat16)
    err = _check(f"{name}, {tp} shards merged vs the whole cache",
                 merged[0], whole, torch.bfloat16, tol)
    dropped = layers.merge_shards(
        torch.stack([o for o, _ in parts[1:]]),
        torch.stack([x for _, x in parts[1:]]), _StackedGroup(tp - 1))[0]
    err_dropped = _refuses_wrong(f"{name}, vs the whole cache", whole,
                                 dropped, "merge without rank 0's shard",
                                 tol)
    return dict(tp=tp, atol=tol["atol"], rtol=tol["rtol"],
                merged_vs_whole=err,
                without_first_shard_vs_whole=err_dropped), sum(group.sent)


def _mla_decode_ranks(dev, attn, cfg, timer):
    """Phase 21 (b): one DeepSeek-R1 layer's absorbed decode
    (``layers.mla_decode_shard``, every MLA weight replicated) for a
    rank's ``MLA_DECODE`` batch over a random bf16 latent cache, split in
    ``ATTN_TP`` sequence shards rank by rank and merged in value space
    (after ``wv_b``) against the whole cache's; rows at the cache's end,
    one at a shard boundary, one finished (its write dropped).  The token
    is written once, by the owner.  Returns numbers: the merge's bytes a
    rank (lse max and weighted sum, measured off the calls) beside the
    reckonings in value and in latent space, and CUDA-event times."""
    from repro_torch.models import layers
    B, S = MLA_DECODE
    tp, S_l = ATTN_TP, S // ATTN_TP
    H, dn, r = cfg.num_heads, cfg.head_dim, cfg.kv_lora_rank
    gen = torch.Generator(device=dev).manual_seed(211)
    ckv = _rand(gen, (B, S, r), torch.bfloat16, dev)
    kr = _rand(gen, (B, S, cfg.rope_head_dim), torch.bfloat16, dev)
    x = _rand(gen, (B, 1, cfg.d_model), torch.bfloat16, dev)
    lens = [S - 16 - i for i in range(B)]
    lens[1], lens[2] = S_l - 1, S           # a boundary, a finished row
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    tab = layers.rope_tables(lengths[:, None], cfg.rope_head_dim,
                             cfg.rope_theta)
    wc, wr = ckv.clone(), kr.clone()
    whole, _ = layers.mla_decode_shard(cfg, attn, x, wc, wr, lengths,
                                       rope_tab=tab)
    shards = [(ckv[:, m * S_l:(m + 1) * S_l].clone(),
               kr[:, m * S_l:(m + 1) * S_l].clone()) for m in range(tp)]
    parts = [layers.mla_decode_shard(cfg, attn, x, c, k, lengths, m,
                                     rope_tab=tab)
             for m, (c, k) in enumerate(shards)]
    if not (torch.equal(torch.cat([c for c, _ in shards], 1), wc) and
            torch.equal(torch.cat([k for _, k in shards], 1), wr)):
        raise AssertionError("phase 21 (b): the owners' writes are not the "
                             "whole cache's")
    out, sent = _shards_vs_whole("phase 21 (b) MLA decode", whole, parts, tp)
    out.update(batch=B, seq=S, heads=H,
               merge_bytes_a_rank=sent,
               reckoned_value_space=B * H * (dn + 1) * 4 + B * H * 4,
               reckoned_latent_space=B * H * (r + 1) * 4 + B * H * 4,
               whole_ms=timer(lambda: layers.mla_decode_shard(
                   cfg, attn, x, wc, wr, lengths, rope_tab=tab), iters=5),
               shard_ms=timer(lambda: layers.mla_decode_shard(
                   cfg, attn, x, *shards[-1], lengths, tp - 1,
                   rope_tab=tab), iters=5),
               merge_ms=timer(lambda: layers.merge_shards(
                   torch.stack([o for o, _ in parts]),
                   torch.stack([z for _, z in parts]), _StackedGroup(tp)),
                   iters=5))
    log(f"  phase 21 (b) MLA decode B{B} over {S} at tp {tp}: merge "
        f"{sent} B a rank a layer (value space reckoned "
        f"{out['reckoned_value_space']}, latent space "
        f"{out['reckoned_latent_space']}); whole cache "
        f"{out['whole_ms']:.4f} ms, a shard {out['shard_ms']:.4f} ms, the "
        f"merge's arithmetic {out['merge_ms']:.4f} ms (CUDA events)")
    return out


def _ring_ranks(dev, cfg, attn, c, lengths, timer):
    """Phase 21 (c): one H2O-Danube-1.8B layer's windowed decode over the
    decode cell's ring ``c`` (k, v (B, Wd, Hkv, dh), pos (B, Wd)) split in
    ``ATTN_TP`` slot blocks rank by rank (``layers.ring_decode_shard``:
    the owner writes k, v and the position) and merged, against the whole
    ring's; the slots written equal.  Times: the ring attention's einsums
    over the whole ring and over a block, and the merge's arithmetic."""
    from repro_torch.models import layers
    tp = ATTN_TP
    Wd = c["pos"].shape[1]
    Wl = Wd // tp
    gen = torch.Generator(device=dev).manual_seed(212)
    x = _rand(gen, (lengths.shape[0], 1, cfg.d_model), torch.bfloat16, dev)
    tab = layers.rope_tables(lengths[:, None], cfg.head_dim, cfg.rope_theta)
    whole_c = {k: t.clone() for k, t in c.items()}
    whole, _ = layers.ring_decode_shard(cfg, attn, x, whole_c["k"],
                                        whole_c["v"], whole_c["pos"],
                                        lengths, rope_tab=tab)
    shards = [{k: t[:, m * Wl:(m + 1) * Wl].clone() for k, t in c.items()}
              for m in range(tp)]
    parts = [layers.ring_decode_shard(cfg, attn, x, sh["k"], sh["v"],
                                      sh["pos"], lengths, m, tp,
                                      rope_tab=tab)
             for m, sh in enumerate(shards)]
    for k in c:
        if not torch.equal(torch.cat([sh[k] for sh in shards], 1),
                           whole_c[k]):
            raise AssertionError(f"phase 21 (c): the owners' writes of "
                                 f"{k} are not the whole ring's")
    out, sent = _shards_vs_whole("phase 21 (c) ring decode", whole, parts,
                                 tp)
    q = _rand(gen, (lengths.shape[0], 1, cfg.num_heads, cfg.head_dim),
              torch.bfloat16, dev)
    ring = lambda t: layers.decode_attention_ring(  # noqa: E731
        q, t["k"], t["v"], t["pos"], lengths + 1, window=cfg.sliding_window)
    out.update(slots=Wd, merge_bytes_a_rank=sent,
               einsum_whole_ms=timer(lambda: ring(whole_c), iters=10),
               einsum_shard_ms=timer(lambda: ring(shards[0]), iters=10),
               merge_ms=timer(lambda: layers.merge_shards(
                   torch.stack([o for o, _ in parts]),
                   torch.stack([z for _, z in parts]), _StackedGroup(tp)),
                   iters=10))
    log(f"  phase 21 (c) ring decode over {Wd} slots at tp {tp}: the "
        f"attention's einsums {out['einsum_whole_ms']:.4f} ms whole, "
        f"{out['einsum_shard_ms']:.4f} ms a block of {Wl}; the merge's "
        f"arithmetic {out['merge_ms']:.4f} ms, {sent} B a rank a layer "
        f"(CUDA events)")
    return out


def _paged_ranks(dev, cfg, c, lengths):
    """Phase 21 (d): one Pixtral-12B layer's decode attention over the
    decode cell's cache (k, v (B, S, Hkv, dh)) in ``ATTN_TP`` sequence
    shards, each rank's ``decode_attention_shard`` (the paged kernel with
    its lse) merged, against the whole cache's kernel launch."""
    from repro_torch.models import layers
    tp = ATTN_TP
    k, v = c["k"], c["v"]
    S_l = k.shape[1] // tp
    gen = torch.Generator(device=dev).manual_seed(213)
    q = _rand(gen, (k.shape[0], 1, cfg.num_heads, cfg.head_dim),
              torch.bfloat16, dev)
    whole = layers.decode_attention(q, k, v, lengths)
    parts = [layers.decode_attention_shard(
        q, k[:, m * S_l:(m + 1) * S_l].contiguous(),
        v[:, m * S_l:(m + 1) * S_l].contiguous(), lengths, m, S_l)
        for m in range(tp)]
    return _shards_vs_whole("phase 21 (d) paged decode", whole, parts,
                            tp)[0]


def _serve_one_card(dev, arch, cfg, params, prompts, n, patches=None):
    """Phase 21 (c), (d): the one-device serving (``prefill``, its cache
    installed: a ring's re-laid into ``init_cache``'s, ``decode_step``s)
    against ``build_cell``'s prefill and decode cells on an NCCL group of
    one with every collective sent: tokens and logits equal in bits, the
    collectives the design's.  Returns (launches of the cells, numbers,
    the decode cell's cache and lengths after its steps)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import transformer as T
    B, S = prompts.shape
    P = 0 if patches is None else patches.shape[1]
    L = cfg.num_layers
    logits0, cache = T.prefill(cfg, params, prompts, patches=patches)
    full = T.init_cache(cfg, B, n, dev)
    cache = T.install_rings(cfg, full, cache) if cfg.sliding_window else \
        T.install_cache(cfg, full, cache)
    tok = torch.argmax(logits0[:, -1], dim=-1).to(torch.int32)
    want = [tok]
    for i in range(ATTN_STEPS):
        tok, cache = T.decode_step(cfg, params, cache, tok, torch.full(
            (B,), S + P + i, dtype=torch.int32, device=dev))
        want.append(tok)
    want = torch.stack(want)
    del cache, full
    gc.collect()
    torch.cuda.empty_cache()
    mesh = _sent(mesh_lib.Mesh(("data", "model"), (1, 1)).realize("cuda"))
    pc = build_cell(cfg, "prefill_32k", mesh, batch_seq=(B, S + P),
                    max_len=n)
    dc = build_cell(cfg, "decode_32k", mesh, batch_seq=(B, n))
    reset_counts()
    plain = _ServePlainCalls()
    try:
        C.reset_events()
        batch = {"tokens": prompts}
        if patches is not None:
            batch["patches"] = patches
        logits1, cache = pc.step(params, batch)
        events = [_kinds(C.EVENTS)]
        tok = torch.argmax(logits1[:, -1], dim=-1).to(torch.int32)
        lengths = torch.full((B,), S + P, dtype=torch.int32, device=dev)
        got, secs = [tok], []
        for _ in range(ATTN_STEPS):
            C.reset_events()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, cache, lengths = dc.step(params, cache, tok, lengths)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            events.append(_kinds(C.EVENTS))
            got.append(tok)
    finally:
        plain.restore()
    used = kernels_launches()
    C.reset_events()
    if not (torch.equal(torch.stack(got), want) and
            torch.equal(logits1, logits0)):
        raise AssertionError(f"phase 21 {arch}: the cells' tokens or logits "
                             f"are not the one-device path's bits")
    design = [dryrun.design_collectives(cfg, "prefill", 2, 1, 1, S + P, 0,
                                        0)] + [dryrun.design_collectives(
                                            cfg, "decode", 2, 1, 1, n, 0,
                                            0)] * ATTN_STEPS
    if events != design:
        raise AssertionError(f"phase 21 {arch}: collectives {events[:2]} "
                             f"..., the design {design[:2]} ...")
    decode = "paged_attention" if not cfg.sliding_window else None
    want_used = {"flash_attention": L}
    if decode:
        want_used[decode] = ATTN_STEPS * L
    _expect_launches(f"phase 21 {arch}", used, want_used, plain)
    step_ms = statistics.median(secs[1:]) * 1e3
    n_sent = sum(sum(e.values()) for e in events)
    log(f"  phase 21 {arch} bf16, {B} prompts of {S + P} positions into "
        f"{n}, {ATTN_STEPS} steps through build_cell's cells on an NCCL "
        f"group of one, every collective sent ({n_sent}: {events[0]} the "
        f"prefill, {events[1]} a step, as designed): tokens and logits "
        f"equal the one-device path in bits; {step_ms:.3f} ms a step; "
        f"launches {used}")
    return used, dict(equal_bits=True, step_ms=step_ms,
                      collectives=events[:2], launches=used), cache, lengths


def _mla_rank_kernels(dev):
    """Phase 21 (e): the flash forward and backward at a DeepSeek-R1
    rank's head count (``MLA_RANK_FLASH``: 32 of 128 heads at tp 4, q/k
    192, v 128, causal, bf16) and the grouped GEMM's forward and dX at a
    rank's 64 of 256 experts (``MLA_RANK_MOE``: the choices of B2 S4096's
    top-8 that fall to the rank, routed as ``_moe_shard_body`` routes
    them), each against its plain version, timed through the wrapper
    (CUDA events), alone (``Timer.kernel_ms``), the plain version, the
    library call and the bound."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.flash_attention_bwd.ops import (
        flash_attention_bwd, flash_attention_bwd_plain)
    from repro_torch.kernels.moe_gemm import ops as mops
    from repro_torch.launch.profile import KERNEL_ENTRIES
    from repro_torch.launch.timing import Timer
    from repro_torch.models import flash
    timer = Timer(dev)
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(214)
    B, S, H = MLA_RANK_FLASH
    Dq, Dv = MLA_HEADS
    q = _rand(gen, (B, S, H, Dq), bf, dev)
    k = _rand(gen, (B, S, H, Dq), bf, dev)
    v = _rand(gen, (B, S, H, Dv), bf, dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S) \
        .contiguous()
    tag = f"B{B} S{S} H{H}/{H} D{Dq}/{Dv} causal"
    want = flash_attention_plain(q, k, v, pos, pos)
    e_fwd = _check(f"phase 21 (e) flash_attention {tag}",
                   flash_attention(q, k, v, pos, pos), want, bf,
                   _scaled_tol(want, bf))
    o, lse = flash.flash_attention(q, k, v, pos, pos, return_lse=True)
    dout = _rand(gen, o.shape, bf, dev)
    args = (q, k, v, pos, pos, o, lse, dout)
    wants = flash_attention_bwd_plain(*args)
    tol = _grad_tol(wants, bf)
    e_bwd = max(_check(f"phase 21 (e) flash_attention_bwd {tag} {nm}", g, w,
                       bf, tol)
                for g, w, nm in zip(flash_attention_bwd(*args), wants,
                                    ("dq", "dk", "dv")))
    del wants
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fwd = lambda: flash_attention(q, k, v, pos, pos)  # noqa: E731
    bwd = lambda: flash_attention_bwd(*args)  # noqa: E731
    b_fwd, by_fwd, _, _ = _flash_bound(q, k, v, pos, pos)
    b_bwd, by_bwd, _, _ = _flash_bwd_bound(q, k, v)
    by_backend = _sdpa_bwd_backends_ms(timer, q, k, v, dout)
    try:
        sdpa_ms = timer(_sdpa(qt, kt, vt, is_causal=True))
    except RuntimeError as e:
        sdpa_ms = None
        log(f"  sdpa refuses {tag}: {str(e).splitlines()[0]}")
    rows = {"flash_attention": dict(
        shape=tag, max_abs_err=e_fwd, ms=timer(fwd),
        alone_ms=timer.kernel_ms(fwd, KERNEL_ENTRIES["flash_attention"]),
        plain_ms=timer(lambda: flash_attention_plain(q, k, v, pos, pos),
                       iters=2, warmup=1),
        bound_ms=b_fwd, bound_by=by_fwd, library_ms=sdpa_ms),
        "flash_attention_bwd": dict(
        shape=tag, max_abs_err=e_bwd, ms=timer(bwd, iters=10),
        alone_ms=sum(timer.kernel_ms(bwd, (entry,), iters=10)
                     for entry in KERNEL_ENTRIES["flash_attention_bwd"]
                     if not entry.endswith("_simt")),
        plain_ms=timer(lambda: flash_attention_bwd_plain(*args), iters=2,
                       warmup=1),
        bound_ms=b_bwd, bound_by=by_bwd,
        library_ms=min(by_backend.values()) if by_backend else None,
        library_by_backend=by_backend)}
    del args, o, lse, dout, q, k, v, qt, kt, vt, want
    torch.cuda.empty_cache()

    cfgm = MLA_RANK_MOE
    T_, E, El, kk, D, Fe = (cfgm[x] for x in ("T", "E", "El", "k", "D", "F"))
    ids = torch.topk(torch.randn((T_, E), generator=gen, device=dev),
                     kk).indices.reshape(-1)
    local = torch.where(ids < El, ids, El)      # rank 0's experts
    plan = mops.dispatch_plan(local, El, mops.pick_block_t(T_ * kk, E))
    tok = torch.arange(T_, device=dev).repeat_interleave(kk)
    be, bt = plan.block_expert, plan.block_t
    n_choices = int(plan.keep.sum().item())
    w1 = (0.02 * torch.randn((El, D, Fe), generator=gen, device=dev)).to(bf)
    for label, Di, w in (("w1 forward (D -> F)", D, w1),
                         ("dX of w1 (dy F -> D)", Fe,
                          w1.transpose(1, 2).contiguous())):
        xs = mops.gather_rows(_rand(gen, (T_, Di), bf, dev), plan, tok)
        mops.reset_routes()
        got = mops.grouped_gemm(xs, w, be, block_t=bt)
        torch.cuda.synchronize()
        if mops.ROUTE_LAUNCHES["wgmma"] != 1:
            raise AssertionError(f"phase 21 (e) moe_gemm {label}: routes "
                                 f"{mops.ROUTE_LAUNCHES}")
        err = _check(f"phase 21 (e) moe_gemm {label} at {El} of {E} experts",
                     got, _plain_blocks(xs, w, be, block_t=bt), bf)
        bound, by, nbytes, flops = _gemm_bound(plan, xs, w, n_choices)
        call = lambda: mops.grouped_gemm(xs, w, be, block_t=bt)  # noqa
        gmm_ms = None
        if hasattr(torch, "_grouped_mm"):
            counts = torch.bincount(local[local < El], minlength=El)
            xa = _rand(gen, (int(counts.sum().item()), Di), bf, dev)
            offs = torch.cumsum(counts, 0).to(torch.int32)
            gmm_ms = timer(lambda: torch._grouped_mm(xa, w, offs=offs))
        rows[f"moe_gemm {label}"] = dict(
            shape=f"{n_choices} choices of T{T_} top-{kk} on {El} of {E} "
                  f"experts, D{D} F{Fe}",
            max_abs_err=err, ms=timer(call),
            alone_ms=timer.kernel_ms(call, KERNEL_ENTRIES["moe_gemm"]),
            plain_ms=timer(lambda: _plain_blocks(xs, w, be, block_t=bt),
                           iters=2, warmup=1),
            bound_ms=bound, bound_by=by, library_ms=gmm_ms)
        del xs, got
    del w1
    for name, r in rows.items():
        log(f"  phase 21 (e) {name} {r['shape']}: kernel {r['ms']:.4f} ms "
            f"({r['alone_ms']:.4f} alone), plain {r['plain_ms']:.4f}, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.4f} "
            f"({r['bound_by']})")
    del timer
    return rows


def attn_families_path(dev):
    """Phase 21: the attention families over a model group on one card
    (see the module's docstring).  Returns (launches of the paths,
    numbers)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.timing import Timer
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    torch.cuda.set_device(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    stats, used = {}, {}

    def add(u):
        for name, n in u.items():
            used[name] = used.get(name, 0) + n

    # (a) one DeepSeek-R1 layer rank by rank at tp 8
    u, stats["mla_layer_tp8"] = _tp8_layer(
        dev, "deepseek_r1", over=dict(num_experts=MLA_LAYER_EXPERTS))
    add(u)
    gc.collect()
    torch.cuda.empty_cache()
    # (b) its decode shards at tp 4
    timer = Timer(dev)
    cfg = dataclasses.replace(get_config("deepseek_r1"), num_layers=1,
                              num_experts=MLA_LAYER_EXPERTS)
    attn = T.init_params(cfg, 21, dev, part=lambda path, shape: tuple(
        slice(None) if path[:2] == ("layers", "attn") else slice(0, 1)
        for _ in shape))["layers"]["attn"]
    stats["mla_decode_tp4"] = _mla_decode_ranks(
        dev, {k: t[0] for k, t in attn.items()}, cfg, timer)
    del attn
    gc.collect()
    torch.cuda.empty_cache()

    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        # (c) Danube's ring over a prompt longer than its window
        cfg = get_config("h2o_danube_1_8b")
        B, S, n = WINDOW_SERVE
        gen = torch.Generator(device=dev).manual_seed(215)
        prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                device=dev, dtype=torch.int32)
        params = T.init_params(cfg, 0, dev)
        u, stats["danube"], cache, lengths = _serve_one_card(
            dev, "h2o_danube_1_8b", cfg, params, prompts, n)
        add(u)
        stats["danube"]["ring_tp4"] = _ring_ranks(
            dev, cfg, T._per_layer(params)[0]["attn"],
            {k: t[0] for k, t in cache.items()}, lengths, timer)
        del params, cache
        gc.collect()
        torch.cuda.empty_cache()
        # (d) Pixtral's patch prefix, phase 16's depth
        cfg = dataclasses.replace(get_config("pixtral_12b"),
                                  num_layers=PIXTRAL_TRAIN_LAYERS)
        B, S, n = VLM_SERVE
        prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                device=dev, dtype=torch.int32)
        patches = _rand(gen, (B, cfg.num_patches, cfg.d_model),
                        torch.bfloat16, dev)
        params = T.init_params(cfg, 0, dev)
        u, stats["pixtral"], cache, lengths = _serve_one_card(
            dev, "pixtral_12b", cfg, params, prompts, n, patches)
        add(u)
        stats["pixtral"]["paged_tp4"] = _paged_ranks(
            dev, cfg, {k: t[0] for k, t in cache.items()}, lengths)
        del params, cache
    finally:
        dist.destroy_process_group()
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    # (e) the kernels at a DeepSeek-R1 rank's shapes
    stats["rank_kernels"] = _mla_rank_kernels(dev)
    stats["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    stats["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 21 took {stats['seconds']:.1f} s, peak device memory "
        f"{stats['peak_gb']:.2f} GB")
    return used, stats


# --------------------------------------------------------------- phase 22
REC_TP_STEPS = 3
# (a): the tp train cell on an NCCL group of one: (arch, config overrides,
# global batch, sequence); RecurrentGemma-2B cut to 1 unit + 2 tail
REC_TRAIN = (("mamba2_370m", {}, 4, 4096),
             ("recurrentgemma_2b", dict(num_layers=5), 2, 8192),
             ("whisper_base", {}, 16, 448))
REC_TRAIN_LR = 1e-4
# (b): one layer rank by rank: (batch, sequence) and the tp of each case
REC_LAYER = (2, 4096)
REC_LAYER_WHISPER = (2, 448)
# (c): (arch, prompts, prompt tokens, cache positions); decode steps
REC_SERVE = (("mamba2_370m", 4, 4096, 4096),
             ("recurrentgemma_2b", 4, 3072, 4096),
             ("whisper_base", 4, 32, 448))
REC_STEPS = 16
# (d): the kernels at a rank's shapes: Mamba2-370M's 4 of 32 heads at
# tp 8 over (a)'s 4 x 4096 tokens; RecurrentGemma-2B's seq rank 3 of 4
# over (a)'s 2 x 8192
REC_RANK_SCAN = (4, 32 // 8, 4096 // 64, 128, 64)
REC_RANK_FLASH = (2, 8192, 4, 3)


class _ThreadSum:
    """A model group of ``size`` ranks whose forwards run as threads on
    one card (each rank's handle from ``rank``), its collectives in the
    autograd graph: an all-reduce puts the rank's tensor in its slot,
    waits for every rank and returns the slots' sum in rank order, a
    differentiable sum over tensors of every rank's graph; ``copy_in`` is
    the identity (the ranks read one h, whose gradient autograd sums) and
    ``reduce_out`` and ``reduce_whole`` are that sum.  One backward from
    the main thread then runs the ranks' graphs as one: the card's
    autograd engine runs a device's nodes on one thread, so ranks that
    wait for each other in their backward could not."""

    def __init__(self, size: int):
        import threading
        self.size, self.slots = size, [None] * size
        self.barrier = threading.Barrier(size, timeout=300)

    def rank(self, m: int):
        return _ThreadSumRank(self, m)


class _ThreadSumRank:
    trivial = False

    def __init__(self, group, m):
        self.group, self.rank, self.size = group, m, group.size

    def all_reduce(self, x, op="sum"):
        g = self.group
        g.slots[self.rank] = x
        g.barrier.wait()
        r = g.slots[0]
        for t in g.slots[1:]:
            r = torch.maximum(r, t) if op == "max" else r + t
        g.barrier.wait()
        return r

    reduce_out = reduce_whole = all_reduce

    def copy_in(self, *xs):
        return xs[0] if len(xs) == 1 else xs


def _rank_leaves(stack, specs, tp, m):
    """Rank ``m`` of ``tp``'s slices of layer 0 of a stacked tree, as
    leaves that require grad."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as mesh_lib
    loc = shd.shard_params(stack, specs, mesh_lib.Mesh(
        ("data", "model"), (1, tp), rank=m))
    return _map_layer(loc, lambda t: t[0].detach().requires_grad_(True))


def _layer_specs(specs):
    return _map_layer(specs, lambda sp: sp[1:])


def _full_grad(path, one, specs, locs, tp, reduced):
    """The whole gradient of the leaf at ``path`` from the ranks' local
    ones: a split leaf's slices put in place; a replicated leaf's rank 0
    gradient when ``reduced`` (its ranks' parts summed by ``copy_in``),
    else the ranks' parts summed."""
    from repro_torch.distributed import sharding as shd
    t, sp = _at(one, path), _at(specs, path)
    acc = torch.zeros(t.shape, dtype=torch.float32, device=t.device)
    if reduced and all(e is None for e in sp):
        return _at(locs[0], path).grad.float()
    for m, loc in enumerate(locs):
        g = _at(loc, path).grad
        if g is not None:
            acc[shd.dim_slices(sp, t.shape, {"data": 1, "model": tp},
                               {"data": 0, "model": m})] += g.float()
    return acc


def _rank_sum_check(name, run, stack, specs, h0, up, tp, extra=()):
    """``run(p, h, m, tp, *extra)`` on one device and summed over the
    ranks in one process (``copy`` the identity: a whole leaf's gradient
    is the ranks' parts summed) on layer 0 of ``stack``: the outputs, the
    gradients of h and of the ``extra`` inputs, and every leaf's gradient
    within TOL[bf16] of scale (``_scaled_check``).  Returns (the worst
    error over scale, the one-device output, the ranks' local leaves)."""
    lsp = _layer_specs(specs)
    one = _map_layer(stack, lambda t: t[0].detach().requires_grad_(True))
    locs = [_rank_leaves(stack, specs, tp, m) for m in range(tp)]
    sides = []
    for n, ps in ((1, [one]), (tp, locs)):
        h = h0.clone().requires_grad_(True)
        xs = [x.clone().requires_grad_(True) for x in extra]
        y = None
        for m, p in enumerate(ps):
            part = run(p, h, m, n, *xs)
            y = part if y is None else y + part
        (y.float() * up).sum().backward()
        sides.append([y.detach(), h.grad] + [x.grad for x in xs])
    worst = 0.0
    for what, got, want in zip(["out", "dh"] + [f"d{i}" for i in
                                                range(len(extra))],
                               sides[1], sides[0]):
        worst = max(worst, _scaled_check(f"{name} {what}", got, want,
                                         quiet=True))
    for path, t in _paths_of(one):
        if t.grad is not None:
            worst = max(worst, _scaled_check(
                f"{name} d{'.'.join(path)}",
                _full_grad(path, one, lsp, locs, tp, False), t.grad,
                quiet=True))
    log(f"  {name}: outputs, input and leaf gradients of the ranks' sum "
        f"within TOL[bf16] of scale (worst |err| / scale {worst:.2e})")
    return worst, sides[0][0], locs


def _ssm_layer_threads(dev, cfg, stack, specs, h0, up, tp, *,
                       norm_group=True):
    """The SSM layer's share on each of ``tp`` ranks, its forward run as
    threads over a ``_ThreadSum`` on the card (the gated norm's mean
    square summed over them), then one backward of rank 0's reduced
    output against ``up``: (the reduced output, h with its gradient, the
    ranks' local leaves with their gradients: a replicated leaf's, B's
    and C's among them, its part)."""
    from repro_torch.models import transformer as T
    group = _ThreadSum(tp)
    locs = [_rank_leaves(stack, specs, tp, m) for m in range(tp)]
    h = h0.clone().requires_grad_(True)

    def rank(m):
        torch.cuda.set_device(dev)
        g = group.rank(m)
        return g.reduce_out(T.ssm_share(cfg, locs[m], h, g.copy_in,
                                        g if norm_group else None))

    y = _in_threads([lambda m=m: rank(m) for m in range(tp)])[0]
    (y.float() * up).sum().backward()
    return y.detach(), h, locs


def _rec_layers_rank_by_rank(dev):
    """Phase 22 (b): one layer of each family at every published width,
    bf16, B2 S4096 (Whisper's decoder S448 over 1536 encoder states),
    rank by rank against the one-device layer: Mamba2-370M's SSM layer at
    tp 8 (its ranks' forwards as threads over a ``_ThreadSum``: the gated
    norm's mean square is summed over them; B and C read whole),
    RecurrentGemma-2B's RG-LRU sublayer and its local attention
    sublayer at tp 2 (heads) and tp 4 (``seq``), Whisper-base's
    decoder layer (self-attention, cross-attention on the states, MLP)
    at tp 8.  Outputs, input gradients and every leaf's gradient within
    TOL[bf16] of scale; the check refuses the SSM norm over a rank's
    channels alone, B's gradient left unreduced and Whisper's positions
    added on every rank before the embedding's reduce."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers
    from repro_torch.models import transformer as T
    from repro_torch.models.api import MeshAxes
    bf = torch.bfloat16
    B, S = REC_LAYER
    gen = torch.Generator(device=dev).manual_seed(221)
    out = {}

    def setup(arch, tp, n_layers, S):
        cfg = dataclasses.replace(get_config(arch), num_layers=n_layers)
        params = T.init_params(cfg, 22, dev)
        specs = shd.param_specs(cfg, MeshAxes(), tp, "tp")
        h0 = _rand(gen, (B, S, cfg.d_model), bf, dev)
        up = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
        return cfg, params, specs, h0, up

    # Mamba-2 at tp 8, threads
    tp = 8
    cfg, params, specs, h0, up = setup("mamba2_370m", tp, 1, S)
    stack, sp = params["layers"], specs["layers"]
    one = _map_layer(stack, lambda t: t[0].detach().requires_grad_(True))
    h1 = h0.clone().requires_grad_(True)
    y1 = T.ssm_share(cfg, one, h1)
    (y1.float() * up).sum().backward()
    y8, h8, locs = _ssm_layer_threads(dev, cfg, stack, sp, h0, up, tp)
    worst = max(_scaled_check("phase 22 (b) SSM tp8 out", y8, y1),
                _scaled_check("phase 22 (b) SSM tp8 dh", h8.grad, h1.grad))
    lsp = _layer_specs(sp)
    for path, t in _paths_of(one):
        worst = max(worst, _scaled_check(
            f"phase 22 (b) SSM tp8 d{'.'.join(path)}",
            _full_grad(path, one, lsp, locs, tp, False), t.grad,
            quiet=True))
    wrong, _, _ = _ssm_layer_threads(dev, cfg, stack, sp, h0, up, tp,
                                     norm_group=False)
    e_norm = _refuses_scaled("phase 22 (b) SSM tp8 out", wrong, y1,
                             "gated norm over a rank's channels alone")
    e_wb = _refuses_scaled("phase 22 (b) SSM tp8 dwB",
                           locs[0]["ssm"]["wB"].grad, one["ssm"]["wB"].grad,
                           "wB's gradient of one rank alone (unreduced)")
    out["ssm_tp8"] = dict(worst_err_over_scale=worst,
                          norm_over_rank_refused=e_norm,
                          wB_unreduced_refused=e_wb)
    del params, stack, one, locs, h8, wrong
    # RecurrentGemma-2B: the RG-LRU and the ring sublayers
    for tp in (2, 4):
        cfg, params, specs, h0, up = setup("recurrentgemma_2b", tp, 3, S)
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None] \
            .expand(B, S)
        tab = layers.rope_tables(pos, layers.rope_dim(cfg), cfg.rope_theta)
        mode = "seq" if T.seq_split(cfg, tp) else "heads"
        w_rec, _, _ = _rank_sum_check(
            f"phase 22 (b) RG-LRU sublayer tp{tp}",
            lambda p, h, m, n: T.rglru_share(cfg, p, h),
            params["units"]["b0"], specs["units"]["b0"], h0, up, tp)
        w_att, _, _ = _rank_sum_check(
            f"phase 22 (b) local attention tp{tp} ({mode})",
            lambda p, h, m, n: T.attention_share(
                cfg, p, h, pos, tab, m, n, leaves="t",
                window=cfg.local_window),
            params["units"]["b2"], specs["units"]["b2"], h0, up, tp)
        out[f"recurrentgemma_tp{tp}"] = dict(mode=mode, rglru_worst=w_rec,
                                             attention_worst=w_att)
        del params
    # Whisper-base's decoder layer at tp 8
    tp = 8
    Bw, Sw = REC_LAYER_WHISPER
    B = Bw
    cfg, params, specs, h0, up = setup("whisper_base", tp, 1, Sw)
    pos = torch.arange(Sw, dtype=torch.int32, device=dev)[None].expand(B, Sw)
    Se = cfg.encoder_seq
    enc = _rand(gen, (B, Se, cfg.d_model), bf, dev)
    enc_pos = torch.arange(Se, dtype=torch.int32, device=dev)[None] \
        .expand(B, Se)
    stack, sp = params["layers"], specs["layers"]
    w = max(
        _rank_sum_check("phase 22 (b) Whisper self-attention tp8",
                        lambda p, h, m, n: T.attention_share(
                            cfg, p, h, pos, None, m, n), stack, sp, h0, up,
                        tp)[0],
        _rank_sum_check("phase 22 (b) Whisper cross-attention tp8",
                        lambda p, h, m, n, e: T.attention_share(
                            cfg, p, h, pos, None, m, n, leaves="xattn",
                            norm="ln2", causal=False, states=(e, enc_pos)),
                        stack, sp, h0, up, tp, (enc,))[0],
        _rank_sum_check("phase 22 (b) Whisper MLP tp8",
                        lambda p, h, m, n: T.ffn_share(
                            cfg, p, h, m, n, norm="ln3")[0], stack, sp, h0,
                        up, tp)[0])
    tokens = torch.randint(0, cfg.vocab_size, (B, Sw), generator=gen,
                           device=dev)
    want, _ = T._assemble_inputs(cfg, params, tokens)
    Vl = T.padded_vocab(cfg) // tp
    shares = [T.embed_share(cfg, dict(params, embed=params["embed"][
        m * Vl:(m + 1) * Vl]), tokens, m, tp) for m in range(tp)]
    got, _ = T.embed_finish(cfg, params, sum(shares))
    if not torch.equal(got, want):
        raise AssertionError("phase 22 (b): Whisper's embedding reduced, "
                             "then its positions, is not the one-device "
                             "input's bits")
    e_pos = _refuses_scaled("phase 22 (b) Whisper embedding", sum(
        T.embed_finish(cfg, params, s)[0] for s in shares), want,
        "positions added on every rank before the reduce")
    out["whisper_tp8"] = dict(worst_err_over_scale=w,
                              positions_before_reduce_refused=e_pos)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _rec_train_one_card(dev, arch, over, GB, S):
    """Phase 22 (a) for one family: ``REC_TP_STEPS`` one-device
    ``train_step``s from seed 0, then the same steps through
    ``build_cell``'s ``tp`` cell on the NCCL group of one (its groups of
    one skip their collectives): equal losses and grad norms in bits;
    then the loss and its gradients with every collective of the model
    and data groups sent: as many all-reduces as the design's
    (``dryrun._train_all_reduces``, a cross-entropy chunk's
    ``AR_CE_CHUNK``, the label count), the loss and every gradient the
    skipped run's bits (both runs merge the cross-entropy's shards,
    ``ce_merge``; at world size 1 NCCL's sums are identities).  Returns
    (launches, numbers)."""
    from repro_torch import kernels, optim
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
    from repro_torch.distributed import collectives as C
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import build_cell, train_step
    from repro_torch.launch.train import step_batch
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config(arch), **over)
    stream = SyntheticLMStream(DataConfig(global_batch=GB, seq_len=S,
                                          vocab_size=cfg.vocab_size, seed=0))
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in step_batch(cfg, stream, i).items()}
               for i in range(REC_TP_STEPS)]
    reset_counts()
    plain = _PlainCalls()
    try:
        params = T.init_params(cfg, 0, dev)
        opt = optim.init_opt_state(params)
        ocfg = optim.AdamWConfig(lr=REC_TRAIN_LR, zero1=False)
        want = [train_step(cfg, params, opt, b, ocfg) for b in batches]
        want = [(w["loss"].item(), w["grad_norm"].item()) for w in want]
        del params, opt
        gc.collect()
        torch.cuda.empty_cache()
        mesh = mesh_lib.Mesh(("data", "model"), (1, 1)).realize("cuda")
        cell = build_cell(cfg, "train_4k", mesh, batch_seq=(GB, S),
                          exact_microbatches=1,
                          opt_cfg=optim.AdamWConfig(lr=REC_TRAIN_LR))
        params, opt = cell.init_state(0, dev)
        C.reset_events()
        got, secs = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = cell.step(params, opt, b)
            got.append((r["loss"].item(), r["grad_norm"].item()))
            secs.append(time.perf_counter() - t0)
        skipped = len(C.EVENTS)
        del opt
        if got != want:
            raise AssertionError(f"phase 22 (a) {arch}: the tp cell's losses "
                                 f"and grad norms {got} are not the "
                                 f"one-device step's bits {want}")
        from repro_torch.launch.steps import loss_and_grads
        comm = mesh.comm
        l1, g1 = loss_and_grads(cfg, params, batches[0], comm=comm)
        sent = C.Comm(**{f: dataclasses.replace(getattr(comm, f),
                                                skip_one=False)
                         for f in ("model", "data", "world")})
        C.reset_events()
        l2, g2 = loss_and_grads(cfg, params, batches[0], comm=sent)
        torch.cuda.synchronize()
        events = _kinds(C.EVENTS)
        C.reset_events()
    finally:
        plain.restore()
    used = kernels.launches()
    if skipped:
        raise AssertionError(f"phase 22 (a) {arch}: {skipped} collectives "
                             f"recorded in groups of one")
    chunks = -(-batches[0]["labels"].shape[1] // T.CE_CHUNK)
    design = {"all-reduce": dryrun._train_all_reduces(cfg)
              + chunks * dryrun.AR_CE_CHUNK + 1}
    if events != design:
        raise AssertionError(f"phase 22 (a) {arch}: collectives sent "
                             f"{events}, the design's {design}")
    if not torch.equal(l2, l1):
        raise AssertionError(f"phase 22 (a) {arch}, collectives sent: loss "
                             f"{l2.item()} is not the skipped run's bits "
                             f"{l1.item()}")
    unequal = [".".join(path) for (path, a), (_, w)
               in zip(_paths_of(g2), _paths_of(g1)) if not torch.equal(a, w)]
    if unequal:
        raise AssertionError(f"phase 22 (a) {arch}, collectives sent: the "
                             f"gradients of {unequal} are not the skipped "
                             f"run's bits")
    if any(plain.calls.values()):
        raise AssertionError(f"phase 22 (a) {arch}: plain versions called "
                             f"{plain.calls}")
    step_s = statistics.median(secs[1:])
    log(f"  phase 22 (a) {arch} bf16 ({cfg.num_layers} layers), "
        f"{REC_TP_STEPS} steps of {GB} x {S} through build_cell's tp cell on "
        f"an NCCL group of one: losses and grad norms {got} equal the "
        f"one-device step's bits; {step_s:.3f} s a step; with every "
        f"collective sent {events} (the design's), the loss and "
        f"{sum(1 for _ in _paths_of(g1))} gradients the skipped run's "
        f"bits; launches {used}")
    del params, g1, g2
    gc.collect()
    torch.cuda.empty_cache()
    return used, dict(losses=[g[0] for g in got],
                      grad_norms=[g[1] for g in got], step_s=step_s,
                      collectives_sent=events, equal_bits=True)


def _rec_serve_one_card(dev, arch, cfg, params, prompts, n, frames=None):
    """Phase 22 (c) for one family: the one-device serving (``prefill``,
    its cache installed: the hybrid's rings re-laid, Whisper's K/V into
    ``init_cache``'s; ``REC_STEPS`` ``decode_step``s) against
    ``build_cell``'s prefill and decode cells on the NCCL group of one,
    its collectives skipped and then sent: tokens and logits equal in
    bits, the sent collectives the design's.  Returns (launches, numbers,
    the decode cell's cache and lengths after its steps)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import transformer as T
    B, S = prompts.shape
    logits0, cache = T.prefill(cfg, params, prompts, frames=frames)
    if cfg.family == "hybrid":
        cache = T.install_rings(cfg, T.init_cache(cfg, B, n, dev), cache)
    elif cfg.family == "audio":
        cache = T.install_cache(cfg, T.init_cache(cfg, B, n, dev), cache)
    tok = torch.argmax(logits0[:, -1], dim=-1).to(torch.int32)
    want = [tok]
    for i in range(REC_STEPS):
        tok, cache = T.decode_step(cfg, params, cache, tok, torch.full(
            (B,), S + i, dtype=torch.int32, device=dev))
        want.append(tok)
    want = torch.stack(want)
    del cache
    batch = {"tokens": prompts}
    if frames is not None:
        batch["frames"] = frames
    base = mesh_lib.Mesh(("data", "model"), (1, 1)).realize("cuda")
    stats = {}
    plain = _ServePlainCalls()
    try:
        for sent in (False, True):
            mesh = _sent(base) if sent else base
            pc = build_cell(cfg, "prefill_32k", mesh, batch_seq=(B, S),
                            max_len=n)
            dc = build_cell(cfg, "decode_32k", mesh, batch_seq=(B, n))
            C.reset_events()
            logits1, cache = pc.step(params, batch)
            events = [_kinds(C.EVENTS)]
            tok = torch.argmax(logits1[:, -1], dim=-1).to(torch.int32)
            lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
            got, secs = [tok], []
            for _ in range(REC_STEPS):
                C.reset_events()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tok, cache, lengths = dc.step(params, cache, tok, lengths)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                events.append(_kinds(C.EVENTS))
                got.append(tok)
            if not (torch.equal(torch.stack(got), want) and
                    torch.equal(logits1, logits0)):
                raise AssertionError(f"phase 22 (c) {arch}: the cells' tokens "
                                     f"or logits, collectives "
                                     f"{'sent' if sent else 'skipped'}, are "
                                     f"not the one-device path's bits")
            design = [dryrun.design_collectives(
                cfg, "prefill", 2, 1, 1, S, 0, 0)] + [
                dryrun.design_collectives(cfg, "decode", 2, 1, 1, n, 0,
                                          0)] * REC_STEPS
            if events != (design if sent else [{}] * (REC_STEPS + 1)):
                raise AssertionError(f"phase 22 (c) {arch}: collectives "
                                     f"{events[:2]} ..., the design "
                                     f"{design[:2]} ...")
            stats["sent" if sent else "skipped"] = dict(
                step_ms=statistics.median(secs[1:]) * 1e3,
                collectives=events[:2])
    finally:
        plain.restore()
    C.reset_events()
    if any(plain.calls.values()):
        raise AssertionError(f"phase 22 (c) {arch}: plain versions called "
                             f"{plain.calls}")
    log(f"  phase 22 (c) {arch} bf16, {B} prompts of {S} into {n}, "
        f"{REC_STEPS} steps through build_cell's cells on an NCCL group of "
        f"one, collectives skipped and sent ({stats['sent']['collectives']} "
        f"the prefill and a step, as designed): tokens and logits equal "
        f"the one-device path in bits; "
        f"{stats['skipped']['step_ms']:.3f} / {stats['sent']['step_ms']:.3f} "
        f"ms a step skipped / sent")
    return dict(stats, equal_bits=True), cache, lengths


def _cross_ranks(dev, cfg, c):
    """Phase 22 (c): one Whisper-base layer's cross-attention over the
    decode cell's cross cache (xk, xv (B, 1536, 8, 64)) in ``ATTN_TP``
    sequence shards, each rank's ``decode_attention_shard`` at the
    encoder's whole length merged, against the whole cache's launch."""
    from repro_torch.models import layers
    tp = ATTN_TP
    k, v = c["xk"], c["xv"]
    Se = k.shape[1]
    S_l = Se // tp
    gen = torch.Generator(device=dev).manual_seed(223)
    q = _rand(gen, (k.shape[0], 1, cfg.num_heads, cfg.head_dim),
              torch.bfloat16, dev)
    enc_len = torch.full((k.shape[0],), Se, dtype=torch.int32, device=dev)
    whole = layers.decode_attention(q, k, v, enc_len)
    parts = [layers.decode_attention_shard(
        q, k[:, m * S_l:(m + 1) * S_l].contiguous(),
        v[:, m * S_l:(m + 1) * S_l].contiguous(), enc_len, m, S_l)
        for m in range(tp)]
    return _shards_vs_whole("phase 22 (c) cross decode", whole, parts,
                            tp)[0]


def _rec_rank_kernels(dev):
    """Phase 22 (d): ``ssd_scan`` and ``ssd_scan_bwd`` at a Mamba2-370M
    rank's 4 of 32 heads at tp 8 (``REC_RANK_SCAN``, fp32), and the flash
    forward and backward at RecurrentGemma-2B's ``seq`` rank 3 of 4 (its
    q rows [6144, 8192) of B2 S8192 against every key, 10 heads on 1 of
    256, window 2048, softcap 30, bf16), each against its plain version,
    timed through the wrapper (CUDA events), alone (``Timer.kernel_ms``;
    the backward's kernels summed), the plain version and the bound; no
    library call takes the softcap or computes the scans."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.flash_attention_bwd.ops import (
        flash_attention_bwd, flash_attention_bwd_plain)
    from repro_torch.kernels.ssd_scan.ops import (ssd_state_scan,
                                                  ssd_state_scan_plain)
    from repro_torch.kernels.ssd_scan_bwd.ops import (
        ssd_state_scan_bwd, ssd_state_scan_bwd_plain)
    from repro_torch.launch.profile import KERNEL_ENTRIES
    from repro_torch.launch.timing import Timer
    from repro_torch.models import flash
    from repro_torch.models import transformer as T
    timer = Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(224)
    rows = {}
    shape = REC_RANK_SCAN
    Bs, Hs, nc = shape[:3]
    s = torch.randn(shape, generator=gen, device=dev)
    d = torch.rand((Bs, Hs, nc), generator=gen, device=dev) * 0.9 + 0.05
    got, want = ssd_state_scan(s, d), ssd_state_scan_plain(s, d)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("phase 22 (d) ssd_scan at a rank's heads: not "
                             "its plain version's bits")
    bound, by, _ = _scan_bound(s)
    call = lambda: ssd_state_scan(s, d)  # noqa: E731
    tag = f"(B,H,nc,N,P)={shape} fp32, a tp-8 rank's 4 of 32 heads"
    rows["ssd_scan"] = dict(
        shape=tag, max_abs_err=0.0, ms=timer(call),
        alone_ms=timer.kernel_ms(call, KERNEL_ENTRIES["ssd_scan"]),
        plain_ms=timer(lambda: ssd_state_scan_plain(s, d), iters=5),
        bound_ms=bound, bound_by=by, library_ms=None)
    prev = want[0]
    dprev = torch.randn(shape, generator=gen, device=dev)
    got = ssd_state_scan_bwd(prev, d, dprev)
    want = ssd_state_scan_bwd_plain(prev, d, dprev)
    if not torch.equal(got[0], want[0]):
        raise AssertionError("phase 22 (d) ssd_scan_bwd at a rank's heads: "
                             "dstates not its plain version's bits")
    mag = (want[0].abs() * prev.abs()).sum(dim=(-2, -1))
    err = (got[1] - want[1]).abs()
    if not (err <= 1e-5 + 1e-7 * mag + 1e-5 * want[1].abs()).all():
        raise AssertionError(f"phase 22 (d) ssd_scan_bwd: ddecay max abs err "
                             f"{err.max().item()}")
    bound, by, _ = _scan_bwd_bound(prev, False)
    call = lambda: ssd_state_scan_bwd(prev, d, dprev)  # noqa: E731
    rows["ssd_scan_bwd"] = dict(
        shape=tag, max_abs_err=err.max().item(), ms=timer(call),
        alone_ms=sum(timer.kernel_ms(call, (e,))
                     for e in KERNEL_ENTRIES["ssd_scan_bwd"]),
        plain_ms=timer(lambda: ssd_state_scan_bwd_plain(prev, d, dprev),
                       iters=5),
        bound_ms=bound, bound_by=by, library_ms=None)
    del s, d, prev, dprev, got, want
    bf = torch.bfloat16
    B, S, tp, m = REC_RANK_FLASH
    H, Hkv, D, W, cap = 10, 1, 256, 2048, 30.0
    lo, hi = T.seq_rows(S, m, tp)
    q = (0.5 * torch.randn((B, hi - lo, H, D), generator=gen, device=dev)) \
        .to(bf)
    k = (0.5 * torch.randn((B, S, Hkv, D), generator=gen, device=dev)).to(bf)
    v = _rand(gen, (B, S, Hkv, D), bf, dev)
    kp = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S) \
        .contiguous()
    qp = kp[:, lo:hi].contiguous()
    kw = dict(window=W, softcap=cap)
    tag = (f"rank {m} of {tp}: rows [{lo}, {hi}) of B{B} S{S} H{H}/{Hkv} "
           f"D{D} window {W} softcap {cap:g}")
    fwd = lambda: flash_attention(q, k, v, qp, kp, **kw)  # noqa: E731
    want = flash_attention_plain(q, k, v, qp, kp, **kw)
    e_fwd = _check(f"phase 22 (d) flash_attention {tag}", fwd(), want, bf,
                   _scaled_tol(want, bf))
    o, lse = flash.flash_attention(q, k, v, qp, kp, return_lse=True, **kw)
    dout = _rand(gen, o.shape, bf, dev)
    args = (q, k, v, qp, kp, o, lse, dout)
    wants = flash_attention_bwd_plain(*args, **kw)
    tol = _grad_tol(wants, bf)
    e_bwd = max(_check(f"phase 22 (d) flash_attention_bwd {tag} {nm}", g, w,
                       bf, tol)
                for g, w, nm in zip(flash_attention_bwd(*args, **kw), wants,
                                    ("dq", "dk", "dv")))
    del wants
    bwd = lambda: flash_attention_bwd(*args, **kw)  # noqa: E731
    b_fwd, by_fwd, _, _ = _flash_bound(q, k, v, qp, kp, window=W)
    b_bwd, by_bwd, _, _ = _flash_bwd_bound(q, k, v, window=W, q0=lo)
    rows["flash_attention"] = dict(
        shape=tag, max_abs_err=e_fwd, ms=timer(fwd),
        alone_ms=timer.kernel_ms(fwd, KERNEL_ENTRIES["flash_attention"]),
        plain_ms=timer(lambda: flash_attention_plain(q, k, v, qp, kp, **kw),
                       iters=2, warmup=1),
        bound_ms=b_fwd, bound_by=by_fwd, library_ms=None)
    rows["flash_attention_bwd"] = dict(
        shape=tag, max_abs_err=e_bwd, ms=timer(bwd, iters=10),
        alone_ms=sum(timer.kernel_ms(bwd, (entry,), iters=10)
                     for entry in KERNEL_ENTRIES["flash_attention_bwd"]
                     if not entry.endswith("_simt")),
        plain_ms=timer(lambda: flash_attention_bwd_plain(*args, **kw),
                       iters=2, warmup=1),
        bound_ms=b_bwd, bound_by=by_bwd, library_ms=None)
    del args, o, lse, dout, q, k, v
    for name, r in rows.items():
        log(f"  phase 22 (d) {name} {r['shape']}: kernel {r['ms']:.4f} ms "
            f"({r['alone_ms']:.4f} alone), plain {r['plain_ms']:.4f}, "
            f"bound {r['bound_ms']:.4f} ({r['bound_by']}), "
            f"{r['bound_ms'] / r['alone_ms']:.3f} of it alone; no library "
            f"call")
    del timer
    torch.cuda.empty_cache()
    return rows


def rec_encdec_path(dev):
    """Phase 22: the recurrent and encoder-decoder families over a model
    group on one card (see the module's docstring).  Returns (launches of
    the paths, numbers)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    torch.cuda.set_device(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    stats, used = {}, {}

    def add(u):
        for name, n in u.items():
            used[name] = used.get(name, 0) + n

    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        # (a) the tp train cell
        stats["train"] = {}
        for arch, over, GB, S in REC_TRAIN:
            u, stats["train"][arch] = _rec_train_one_card(dev, arch, over,
                                                          GB, S)
            add(u)
        # (c) the serving cells
        stats["serve"] = {}
        gen = torch.Generator(device=dev).manual_seed(222)
        for arch, B, S, n in REC_SERVE:
            cfg = get_config(arch)
            params = T.init_params(cfg, 0, dev)
            prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                    device=dev, dtype=torch.int32)
            frames = None if cfg.family != "audio" else _rand(
                gen, (B, cfg.encoder_seq, cfg.d_model), torch.float32, dev)
            reset_counts()
            st, cache, _ = _rec_serve_one_card(dev, arch, cfg, params,
                                               prompts, n, frames)
            add(kernels_launches())
            if arch == "whisper_base":
                st["cross_tp4"] = _cross_ranks(
                    dev, cfg, {k: t[0] for k, t in cache.items()})
            stats["serve"][arch] = st
            del params, cache
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    # (b) one layer rank by rank
    reset_counts()
    stats["layers"] = _rec_layers_rank_by_rank(dev)
    add(kernels_launches())
    missed = [k for k in ("flash_attention", "flash_attention_bwd",
                          "paged_attention", "ssd_scan", "ssd_scan_bwd")
              if not used.get(k)]
    if missed:
        raise AssertionError(f"phase 22: the families' paths launched no "
                             f"{missed} (launches {used})")
    # (d) the kernels at a rank's shapes
    stats["rank_kernels"] = _rec_rank_kernels(dev)
    stats["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    stats["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 22 took {stats['seconds']:.1f} s, peak device memory "
        f"{stats['peak_gb']:.2f} GB; launches {used}")
    return used, stats


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

    log("== 15. training the hybrid: RecurrentGemma-2B bf16 at every "
        "published width and full depth, 5 steps of 4 x 8192")
    hybrid_trained, hybrid_train_stats = train_hybrid_path(dev)
    print(json.dumps({"train_path_hybrid": hybrid_train_stats}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"== 16. training the encoder-decoder and the vision decoder: "
        f"Whisper-base bf16 at every published width and full depth, 5 "
        f"steps of 16 x 448 tokens over 1536 frames; Pixtral-12B at every "
        f"published width, {PIXTRAL_TRAIN_LAYERS} of its 40 layers, 5 steps "
        f"of 4 x (1024 patches + 3072 tokens)")
    encdec_trained, encdec_train_stats = train_encdec_vlm_path(dev)
    print(json.dumps({"train_path_encdec_vlm": encdec_train_stats}),
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"== 17. training MLA: DeepSeek-R1 bf16 at every published width, "
        f"{MLA_TRAIN_LAYERS} of its 61 layers and {MLA_TRAIN_EXPERTS} of "
        f"its 256 experts, 5 steps of 2 x 4096")
    mla_trained, mla_train_stats = train_mla_path(dev)
    print(json.dumps({"train_path_mla": mla_train_stats}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"== 18. the multi-GPU training path on one card: (a) an NCCL group "
        f"of one, build_cell's sharded step of Qwen3-30B-A3B at phase 13's "
        f"cut ({MOE_TRAIN_LAYERS} layers, 3 steps of 4 x 4096, ZeRO-1); (b) "
        f"rank by rank at tp {TP8}: a Llama-3.2-1B and a Qwen3-30B-A3B layer "
        f"and the vocab-parallel cross-entropy at B2 S4096")
    sharded_trained, sharded_stats = train_sharded_path(dev,
                                                        moe_train_stats)
    gc.collect()
    torch.cuda.empty_cache()
    tp8_used, tp8_stats = tp8_layers_path(dev)
    print(json.dumps({"multi_gpu_path": {"sharded_step": sharded_stats,
                                         "tp8_rank_by_rank": tp8_stats}}),
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    log("== 19. the multi-GPU serving path on one card: build_cell's "
        "prefill and decode cells of Llama-3.2-1B bf16 at every published "
        "width and full depth on an NCCL group of one, collectives skipped "
        "and sent; the decode cell at a rank's B32 x 32768")
    served_used, served_stats = serve_sharded_path(dev)
    print(json.dumps({"multi_gpu_serving": served_stats}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"== 20. the rest of the training regimes on one card: (a) "
        f"build_cell's fsdp cell of SmolLM-360M bf16 ({FSDP_LAYERS} layers) "
        f"on an NCCL group of one, every collective sent; (b) the seq "
        f"attention shares of SmolLM-360M and Qwen2-0.5B at tp {SEQ_TP}, "
        f"rank by rank; (c) both flash kernels at each seq rank's shape; "
        f"(d) Qwen2-0.5B's seq prefill and decode cells over {SEQ_TP} "
        f"ranks as threads")
    seq_used, seq_stats = seq_fsdp_path(dev)
    print(json.dumps({"multi_gpu_seq_fsdp": seq_stats}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"== 21. the attention families over a model group on one card: "
        f"(a) a DeepSeek-R1 layer ({MLA_LAYER_EXPERTS} experts) rank by "
        f"rank at tp {TP8}; (b) its latent decode in {ATTN_TP} shards; "
        f"(c) H2O-Danube-1.8B's and (d) Pixtral-12B's serving cells on an "
        f"NCCL group of one, every collective sent, and their decode "
        f"shards at tp {ATTN_TP}; (e) the kernels at a DeepSeek-R1 rank's "
        f"shapes")
    attn_used, attn_stats = attn_families_path(dev)
    print(json.dumps({"multi_gpu_attention_families": attn_stats}),
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"== 22. the recurrent and encoder-decoder families over a model "
        f"group on one card: (a) build_cell's tp cell of Mamba2-370M, "
        f"RecurrentGemma-2B (1 unit + 2 tail) and Whisper-base on an NCCL "
        f"group of one, {REC_TP_STEPS} steps each, collectives skipped "
        f"and sent; (b) one layer of each rank by rank (Mamba-2 at tp 8 "
        f"as threads, RecurrentGemma's RG-LRU and ring at tp 2 and 4, "
        f"Whisper's decoder layer at tp 8); (c) their serving cells, "
        f"collectives skipped and sent, Whisper's cross cache in "
        f"{ATTN_TP} shards; (d) the kernels at a rank's shapes")
    rec_used, rec_stats = rec_encdec_path(dev)
    print(json.dumps({"multi_gpu_recurrent_encdec": rec_stats}),
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    for s in stats:     # each kernel's count from the path it was added for
        s["launches"] = {"fused_sampling": sampled, "moe_gemm": moe_greedy,
                         "ssd_scan": ssm, "flash_attention_bwd": trained,
                         "moe_gemm_wgrad": moe_trained,
                         "ssd_scan_bwd": ssm_trained}.get(
            s["name"], greedy)[s["name"]]
        # the launches of phases 15-22 added (the attention kernels; phase
        # 17's and 18's grouped GEMM and its weight gradient too; phase
        # 22's scans)
        s["launches"] += sum(t.get(s["name"], 0) for t in (
            hybrid_trained, encdec_trained, mla_trained, sharded_trained,
            tp8_used, served_used, seq_used, attn_used, rec_used))

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
