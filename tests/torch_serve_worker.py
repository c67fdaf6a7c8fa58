"""One rank of ``tests/test_torch_cuda.py::test_sharded_serving_over_every_card``:
``build_cell``'s serving cells over every rank of the process group.

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        tests/torch_serve_worker.py OUT [--mode check|bench] [--data D] ...

The mesh is (D, N / D) over ("data", "model"); NCCL on the cards, gloo
with ``--device cpu``.  Rank 0 writes what it read to OUT (``torch.save``).

``check``: the prefill cell on ``--batch`` random prompts of ``--seq``
tokens (the vision decoder's after its ``num_patches`` random patches,
the encoder-decoder's over ``encoder_seq`` random frames) into a cache of
``--max-len`` (a window's ring of min(window, max-len) slots; an SSM's or
the hybrid's states beside), then ``--steps`` decode-cell steps: each
step's tokens and the first step's logits, gathered over the mesh.
Run as one process (no ``torch.distributed.run``) it runs the one-device
``prefill`` and ``decode_step`` instead, the reference the mesh is held
to.

``bench``: the decode cell alone at ``--batch`` x ``--seq`` (the cache
filled with random values, row i at length seq - 16 - i), ``--steps``
steps, each timed on the host clock after a synchronize: ms a step,
output tokens/s, the peak device memory of every rank, the paged
kernel's launches by route and one step's collectives (counts, raw and
ring wire bytes a rank).  Weights are random, drawn from ``--seed``.
"""
import argparse
import dataclasses
import os
import statistics
import time

import torch
import torch.distributed as dist

from repro_torch import compat
from repro_torch.configs import get_config, reduced_config
from repro_torch.distributed import collectives as C
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import build_cell
from repro_torch.models import transformer as T


def _config(args):
    cfg = (reduced_config if args.reduced else get_config)(args.arch)
    over = dict(dtype=args.dtype)
    if args.layers:
        over["num_layers"] = args.layers
    if args.experts:
        over["num_experts"] = args.experts
    return dataclasses.replace(cfg, **over)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _one_device(args, cfg, dev):
    """The reference: ``prefill`` (its cache installed in one of
    ``--max-len``) and ``decode_step`` on one device."""
    toks, stubs = _prompts(args, cfg, dev)
    params = T.init_params(cfg, args.seed, dev)
    logits, cache = T.prefill(cfg, params, toks, **stubs,
                              max_len=args.max_len)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    lengths = torch.full(tok.shape, _positions(args, cfg),
                         dtype=torch.int32, device=dev)
    first, _ = T.decode_step_logits(cfg, params, _clone(cache), tok,
                                    lengths)
    tokens = [tok]
    for i in range(args.steps):
        tok, cache = T.decode_step(cfg, params, cache, tok, lengths + i)
        tokens.append(tok)
    return {"tokens": torch.stack(tokens).cpu(), "logits0": first.cpu()}


def _prompts(args, cfg, dev):
    """(tokens, {the vision decoder's "patches" or the encoder-decoder's
    "frames"}), from ``--seed``."""
    gen = torch.Generator().manual_seed(args.seed)
    toks = torch.randint(0, cfg.vocab_size, (args.batch, args.seq),
                         generator=gen, dtype=torch.int32).to(dev)
    n = {"vlm": cfg.num_patches, "audio": cfg.encoder_seq}.get(cfg.family)
    if n is None:
        return toks, {}
    stub = torch.randn((args.batch, n, cfg.d_model), generator=gen)
    key = "patches" if cfg.family == "vlm" else "frames"
    return toks, {key: stub.to(dev, compat.torch_dtype(cfg.dtype))}


def _clone(cache):
    return T._map_spec(cache, lambda path, t: t.clone())


def _positions(args, cfg):
    """A prompt's positions: its tokens, after the vision decoder's
    patches."""
    return args.seq + (cfg.num_patches if cfg.family == "vlm" else 0)


def _check(args, cfg, mesh, dev):
    over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    n = _positions(args, cfg)
    pc = build_cell(args.arch, "prefill_32k", mesh,
                    batch_seq=(args.batch, n), over=over,
                    max_len=args.max_len)
    dc = build_cell(args.arch, "decode_32k", mesh,
                    batch_seq=(args.batch, args.max_len), over=over)
    comm = mesh.comm
    toks, stubs = _prompts(args, cfg, dev)
    batch = dict(stubs, tokens=toks)
    logits, cache = pc.step(pc.init_state(args.seed, dev), batch)
    params = dc.init_state(args.seed, dev)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    lengths = torch.full(tok.shape, n, dtype=torch.int32, device=dev)
    part, _ = T.decode_step_logits(cfg, params, _clone(cache), tok,
                                   lengths, comm)
    rows = comm.model.all_gather(part[None]).permute(1, 0, 2) \
        .reshape(part.shape[0], -1)
    tokens = [tok]
    for _ in range(args.steps):
        tok, cache, lengths = dc.step(params, cache, tok, lengths)
        tokens.append(tok)
    tokens = comm.data.all_gather(torch.stack(tokens).t().contiguous()).t()
    return {"tokens": tokens.cpu(),
            "logits0": comm.data.all_gather(rows).cpu()}


def _bench(args, cfg, mesh, dev):
    over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    cell = build_cell(args.arch, "decode_32k", mesh,
                      batch_seq=(args.batch, args.seq), over=over)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = cell.init_state(args.seed, dev)
    cache = cell.init_cache(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + mesh.rank)
    for leaf in _leaves(cache):
        for i in range(leaf.shape[0]):
            leaf[i].normal_(generator=gen)
    _sync(dev)
    setup_s = time.perf_counter() - t0
    B, S = args.batch, args.seq
    lengths = (S - 16 - torch.arange(B, dtype=torch.int32)).clamp_min(1)
    tokens = torch.randint(0, cfg.vocab_size, (B,), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    rows = cell.local_batch({"tokens": tokens.to(dev),
                             "lengths": lengths.to(dev)})
    tok, ln = rows["tokens"], rows["lengths"]
    paged_ops.reset_routes()
    secs, stats = [], None
    for i in range(args.steps):
        _sync(dev)
        C.reset_events()
        t0 = time.perf_counter()
        tok, cache, ln = cell.step(params, cache, tok, ln)
        _sync(dev)
        secs.append(time.perf_counter() - t0)
        if i == 0:
            stats = C.collective_stats()
    peak = torch.tensor([torch.cuda.max_memory_allocated(dev) / 1e9
                         if dev.type == "cuda" else 0.0], device=dev)
    peaks = mesh.comm.world.all_gather(peak)
    cache_gb = sum(t.numel() * t.element_size()
                   for t in _leaves(cache)) / 1e9
    param_gb = sum(t.numel() * t.element_size()
                   for t in _leaves(params)) / 1e9
    return {"arch": args.arch, "layers": cfg.num_layers, "dtype": args.dtype,
            "mesh": mesh.shape, "batch": B, "seq": S,
            "ms_per_step": statistics.median(secs[1:]) * 1e3,
            "step_ms": [s * 1e3 for s in secs],
            "tokens_per_s": B * (args.steps - 1) / sum(secs[1:]),
            "peak_gb_by_rank": peaks.cpu().tolist(),
            "cache_gb_rank": cache_gb, "params_gb_rank": param_gb,
            "setup_s": setup_s,
            "paged_launches_by_route": dict(paged_ops.ROUTE_LAUNCHES),
            "collectives_a_step": stats,
            "final_lengths_ok": bool((ln == rows["lengths"]
                                      + args.steps).all())}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out")
    ap.add_argument("--mode", choices=["check", "bench"], default="check")
    ap.add_argument("--arch", default="llama3_2_1b")
    ap.add_argument("--layers", type=int, default=0, help="0: full depth")
    ap.add_argument("--experts", type=int, default=0,
                    help="0: every routed expert")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--max-len", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    cfg = _config(args)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    dev = torch.device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    if "MASTER_ADDR" not in os.environ:
        if args.mode != "check":
            raise SystemExit("bench runs under torch.distributed.run")
        torch.save(_one_device(args, cfg, dev), args.out)
        return
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        mesh = mesh_lib.Mesh(("data", "model"),
                             (args.data, world // args.data)).realize(
                                 dev.type)
        rec = (_check if args.mode == "check" else _bench)(args, cfg, mesh,
                                                           dev)
        if rank == 0:
            torch.save(rec, args.out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
