"""The meta-device dry run: every (arch x shape) cell on the production
meshes, reckoned per rank from the sharding specs and the shapes alone.

The port's counterpart of ``repro.launch.dryrun``, which lowers and
compiles each cell against 256 or 512 placeholder TPU devices and reads
XLA's memory analysis.  Here nothing is compiled and nothing is
allocated on a device: for each cell on ``(16, 8)`` and ``(2, 16, 8)``
(``launch/mesh.py::make_production_mesh``) it sums one rank's bytes of

* parameters: each leaf's local slice under its spec (regime ``tp``; a
  decode shape's ``decode``), in its dtype;
* gradients, in the leaves' dtypes, and with more than one microbatch
  (``launch/steps.py::_auto_microbatches``) their fp32 sums beside them;
* the ZeRO-1 state: fp32 master, m and v of the rank's part of every
  flat leaf (``optim.py``'s layout, 12 B an element);
* the batch: int32 tokens and labels of the rank's rows, and the stub
  frames or patches (bf16);
* for a serving shape, the decode cache's local slice
  (``distributed/sharding.py::cache_specs``, sequence over ``model``),

and compares the sum with the card's 80 GB, as it does the peak while
the weights are drawn (``Cell.init_state``: each rank draws its slices,
``init_params`` with ``part``, beside the largest single draw's fp32
temporary and its cast, a whole unstacked leaf or one layer or expert
of a stacked one).  Activations and the
allocator's slack are left out: the sums are reckonings, not
measurements.  A serving cell reckons its parameters and cache only (no
gradients, optimizer or batch beyond its tokens).  Each cell is one JSON
file, as the reference's ``_save``; the run counts ok, skipped and
failed cells and exits 1 on a failure.  ``runs`` says whether the
port's ``build_cell`` takes the cell today: the train and serving cells
of every family (GQA, DeepSeek-R1's MLA, Pixtral-12B, H2O-Danube-1.8B's
ring, Mamba2-370M's channels, RecurrentGemma-2B's RG-LRU and local
attention, Whisper-base's encoder and cross-attention; ``long_500k``
where it applies), their attention over the q heads or, where the q
heads do not split over ``model`` (SmolLM-360M's 15, Qwen2-0.5B's 14 and
RecurrentGemma-2B's 10 over 8), over the q positions (the ``seq`` mode).
``collectives`` counts, by kind, what one rank sends a step as the
port's design issues it (``design_collectives``): a decoder's prefill 1
+ 2 L all-reduces and one all-gather, and in the ``heads`` mode two
all-to-alls (the K/V re-layout, a ring's over its slots; Whisper's four
with its cross K/V), none in the ``seq`` mode, none for MLA (every rank
holds the latent) or an SSM; a decoder's decode step 1 + 3 L
all-reduces and one all-gather, whatever the cache (an SSM's 1 + 2 L,
the hybrid's 2 an RG-LRU and 3 a ring sublayer, Whisper's 5 a layer).
The dry run stays in the ``tp`` and ``decode`` regimes, as the
reference's does.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch ID|all]
        [--shape NAME|all] [--mesh single|multi|both] [--outdir DIR]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Dict, List, Optional

from repro_torch import optim
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import transformer as T
from repro_torch.models.api import SHAPES, shape_applicable

HBM_BYTES = 80e9        # one H100 SXM's device memory, 80 GB


def _local(shape, spec, sizes: Dict[str, int]) -> int:
    n = 1
    for d, entry in zip(shape, spec):
        parts = 1
        for a in shd._axes_of(entry):
            parts *= sizes[a]
        n *= d // parts if d % parts == 0 else d
    return n


def _leaves(spec_tree, shape_tree, path=()):
    if isinstance(shape_tree, dict):
        for k in sorted(shape_tree):
            yield from _leaves(spec_tree[k], shape_tree[k], path + (k,))
    else:
        yield path, spec_tree, shape_tree


def _draw_bytes(path, leaf, dt) -> int:
    """Bytes of ``init_params``'s largest temporary for one leaf: its
    fp32 draw and the cast, of the whole leaf or of one unit (a layer;
    an expert of an (L, E, ., .) leaf) of a stacked one."""
    dims = leaf[0]
    if leaf[1] in ("ones", "zeros"):
        return 0
    if path[0] in ("layers", "enc_layers", "units", "tail"):
        dims = dims[2:] if path[-2] == "moe" and len(dims) == 4 \
            else dims[1:]
    return math.prod(dims) * (4 + dt.itemsize)


def reckon(arch: str, shape_name: str, mesh: mesh_lib.Mesh) -> Dict:
    """One rank's reckoned bytes of a cell on an abstract ``mesh``."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    axes = mesh_lib.mesh_axes(mesh)
    sizes = mesh.shape
    tp, n_dev = sizes["model"], mesh.size
    data = mesh_lib.batch_extent(mesh)
    B, S = shape.global_batch, shape.seq_len
    regime = "decode" if shape.kind == "decode" else "tp"
    pspecs = shd.param_specs(cfg, axes, tp, regime, n_dev=n_dev)
    pshapes = T.param_shapes(cfg)
    out = {"parameters": 0, "gradients": 0, "grad_accumulators": 0,
           "zero1_state": 0, "batch": 0, "cache": 0}
    n_params, draw = 0, 0
    for path, spec, leaf in _leaves(pspecs, pshapes):
        dims, dt = leaf[0], T._leaf_dtype(cfg, leaf)
        n = _local(dims, spec, sizes)
        n_params += n
        draw = max(draw, _draw_bytes(path, leaf, dt))
        out["parameters"] += n * dt.itemsize
        if shape.kind != "train":
            continue
        out["gradients"] += n * dt.itemsize
        split = tp > 1 and optim._model_split(spec)
        flat = n if split else math.prod(dims)
        parts = data if split else n_dev
        out["zero1_state"] += 12 * (-(-flat // parts))
    n_mb = 1
    rows = B // data if B % data == 0 else B
    if shape.kind == "train":
        n_mb = steps._auto_microbatches(cfg, B, S, data, 4)
        if n_mb > 1:
            out["grad_accumulators"] = 4 * n_params
        out["batch"] = rows * S * 4 * 2
        stub = cfg.num_patches if cfg.family == "vlm" else (
            cfg.encoder_seq if cfg.family == "audio" else 0)
        out["batch"] += rows * stub * cfg.d_model * 2
    else:
        out["batch"] = rows * (S * 4 if shape.kind == "prefill" else 8)
        cache = T.init_cache(cfg, B, S, device="meta")
        cspecs = shd.cache_specs(cfg, axes, tp, B, data)
        for _, spec, t in _leaves(cspecs, cache):
            out["cache"] += _local(t.shape, spec, sizes) * t.element_size()
    total = sum(out.values())
    init_peak = out["parameters"] + draw
    leaves = list(_leaves(pspecs, pshapes))
    split = sum(tp > 1 and optim._model_split(spec) for _, spec, _ in leaves)
    runs, why = True, ""
    try:
        steps.build_cell(arch, shape_name, mesh)
    except NotImplementedError as e:
        runs, why = False, str(e)
    return {"per_rank_bytes": out, "per_rank_total_bytes": total,
            "per_rank_init_peak_bytes": init_peak,
            "per_rank_parameters": n_params, "microbatches": n_mb,
            "fits_80gb": max(total, init_peak) < HBM_BYTES, "runs": runs,
            "why_not": why,
            "collectives": design_collectives(cfg, shape.kind, tp, data, n_mb,
                                              S, len(leaves), split),
            "note": shd.explain(cfg, tp)}


# all-reduces a layer sends in a training microbatch over a model group,
# at remat on: its row-parallel outputs (the attention's, the FFN's, an
# MoE's aux) forward, the attention's again in the recompute (which stops
# at the last saved tensor), and one a copy backward (the attention's
# input with its whole leaves, MLA's latent projections and norms among
# them, the FFN's input, a shared expert's too, an MoE's router); a
# cross-entropy chunk's three merges, again in the recompute, and its
# input's copy
AR_LAYER = {"dense": 2 + 1 + 2, "moe": 3 + 1 + 3}
AR_CE_CHUNK = 3 + 3 + 1


def _step_all_reduces(n: int) -> int:
    """All-reduces of one remat step (one ``torch.utils.checkpoint``)
    whose forward sends ``n``, each of a reduced sublayer, whose backward
    sends ``n`` (the copies and, for the SSM, its norm's sum), and whose
    recompute stops before the last: 3 n - 1."""
    return 3 * n - 1


def _train_all_reduces(cfg) -> int:
    """All-reduces one training microbatch sends over a model group of
    more than one rank, the cross-entropy aside: the embedding's, then a
    step each: a dense or MoE layer ``AR_LAYER``; an SSM layer the gated
    norm's sum and the block's output (``_step_all_reduces(2)``); a
    hybrid unit two a sublayer (RG-LRU or attention, and the MLP) and a
    tail layer the same; an encoder-decoder's encoder layers as a dense
    layer, its decoder layers three sublayers each, and the copy of the
    encoder's states every decoder layer reads."""
    L = cfg.num_layers
    if cfg.family == "hybrid":
        n_units, n_tail = T._hybrid_counts(cfg)
        return 1 + n_units * _step_all_reduces(2 * len(cfg.block_pattern)) \
            + n_tail * _step_all_reduces(2)
    if cfg.family == "audio":
        return 2 + cfg.encoder_layers * _step_all_reduces(2) \
            + L * _step_all_reduces(3)
    if cfg.family == "ssm":
        return 1 + L * _step_all_reduces(2)
    return 1 + L * AR_LAYER["moe" if cfg.is_moe else "dense"]


def _serve_all_reduces(cfg, kind: str) -> int:
    """All-reduces of a serving step over a model group: the embedding's,
    then a prefill's two a reduced sublayer (an SSM layer's norm and
    output; the encoder-decoder's encoder layers two, its decoder layers
    three), a decode step's a layer's lse max and merged sum (twice for
    the encoder-decoder: self and cross) and its FFN, an SSM's or RG-LRU
    sublayer's norm or output and (the RG-LRU) its MLP."""
    L = cfg.num_layers
    if cfg.family == "audio":
        return 1 + (2 * cfg.encoder_layers + 3 * L if kind == "prefill"
                    else 5 * L)
    if kind == "prefill" or cfg.family == "ssm":
        return 1 + 2 * L
    if cfg.family == "hybrid":
        n_units, n_tail = T._hybrid_counts(cfg)
        n_attn = n_units * cfg.block_pattern.count("attn")
        return 1 + 3 * n_attn + 2 * (L - n_attn)
    return 1 + 3 * L


def design_collectives(cfg, kind: str, tp: int, data: int, n_mb: int,
                       S: int, n_leaves: int, split: int) -> Dict[str, int]:
    """The collectives one rank issues a step, by kind, as the port's
    design predicts (groups of one send nothing).  A decode step: the
    all-reduces of ``_serve_all_reduces`` (1 + 3 L for a GQA cache, MLA's
    latent or a ring) and the argmax's all-gather.  A prefill: its
    all-reduces (1 + 2 L for a decoder or an SSM), the logits'
    all-gather, and in the ``heads`` attention mode an all-to-all of
    each K/V leaf (two; the encoder-decoder's four with its cross K/V; a
    ring's over its slots; its positions, the same on every rank, are
    cut without a send); the ``seq`` mode keeps its block, MLA, whose
    latent every rank holds, its ``seq_block``, and an SSM has no K/V.
    A train step (``tp`` regime): ``n_mb`` microbatches of
    ``_train_all_reduces`` and ``AR_CE_CHUNK`` a chunk's all-reduces over
    the model group, the label count a microbatch and the loss over the
    data group and the grad norm over the world; ZeRO-1's reduce-scatter
    of each of the ``n_leaves`` over the data group, and its all-gather
    of each (over the data group the ``split`` leaves split over
    ``model``, over the world the rest)."""
    out: Dict[str, int] = {}

    def add(k, n):
        if n:
            out[k] = out.get(k, 0) + n

    if tp > 1 and kind in ("decode", "prefill"):
        add("all-reduce", _serve_all_reduces(cfg, kind))
        add("all-gather", 1)
        if kind == "prefill" and not (cfg.use_mla or cfg.family == "ssm"
                                      or T.seq_split(cfg, tp)):
            add("all-to-all", 4 if cfg.family == "audio" else 2)
    elif kind == "train":
        chunks = -(-S // T.CE_CHUNK)
        add("all-reduce", (tp > 1) * n_mb * (_train_all_reduces(cfg)
                                             + chunks * AR_CE_CHUNK))
        add("all-reduce", (data > 1) * (n_mb + 1) + (tp * data > 1))
        add("reduce-scatter", (data > 1) * n_leaves)
        add("all-gather", (data > 1) * split
            + (tp * data > 1) * (n_leaves - split))
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             outdir: Optional[str]) -> Dict:
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    tag = f"{arch}.{shape_name}.{'multi' if multi_pod else 'single'}"
    ok, why = shape_applicable(get_config(arch), SHAPES[shape_name])
    if not ok:
        rec = {"cell": tag, "status": "skipped", "why": why}
        print(f"SKIP {tag}: {why}")
    else:
        t0 = time.perf_counter()
        try:
            rec = {"cell": tag, "status": "ok",
                   "kind": SHAPES[shape_name].kind, "mesh": mesh.shape,
                   **reckon(arch, shape_name, mesh),
                   "reckon_s": time.perf_counter() - t0}
            print(f"OK   {tag} {rec['per_rank_total_bytes'] / 1e9:.2f} GB "
                  f"a rank (parameters "
                  f"{rec['per_rank_bytes']['parameters'] / 1e9:.2f}, "
                  f"{rec['microbatches']} microbatches; drawing the "
                  f"weights {rec['per_rank_init_peak_bytes'] / 1e9:.2f}) "
                  f"fits={rec['fits_80gb']} runs={rec['runs']}")
        except Exception as e:  # noqa: BLE001 - record the failure, go on
            rec = {"cell": tag, "status": "fail",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"FAIL {tag}: {type(e).__name__}: {str(e)[:200]}")
    if outdir:
        _save(outdir, tag, rec)
    return rec


def _save(outdir: str, tag: str, rec: Dict) -> None:
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)


def run(archs: List[str], shapes: List[str], meshes: List[bool],
        outdir: Optional[str]) -> List[Dict]:
    """Every cell; prints the counts and raises ``SystemExit(1)`` on a
    failure.  Returns the records."""
    t0 = time.perf_counter()
    results = [run_cell(a, s, mp, outdir)
               for a in archs for s in shapes for mp in meshes]
    n = {k: sum(r["status"] == k for r in results)
         for k in ("ok", "skipped", "fail")}
    print(f"\n== dry run: {n['ok']} ok, {n['skipped']} skipped, "
          f"{n['fail']} failed in {time.perf_counter() - t0:.1f}s ==",
          flush=True)
    if n["fail"]:
        raise SystemExit(1)
    return results


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--outdir", default="build/dryrun")
    args = ap.parse_args(argv)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    return run(archs, shapes, meshes, args.outdir)


if __name__ == "__main__":
    main()
