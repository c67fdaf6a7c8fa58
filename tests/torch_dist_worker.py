"""One rank of the process groups of ``test_torch_distributed.py``,
``test_torch_decode_regime.py`` and ``test_torch_seq_fsdp.py``.

    python tests/torch_dist_worker.py RANK WORLD [POD,]DATA,MODEL INIT_FILE IN OUT

Joins a ``gloo`` group of WORLD ranks through ``file://INIT_FILE``,
realizes the (DATA, MODEL) or (POD, DATA, MODEL) mesh, runs every task of the pickled list IN
(numpy inputs, fp32) on its slices through the port's multi-GPU path,
and pickles its results (numpy) to OUT.  Imports the port only.
"""
import dataclasses
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import optim
from repro_torch.configs import reduced_config
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.api import MeshAxes


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _t(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _t(v, grad) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).requires_grad_(grad)


def config(arch, over):
    return dataclasses.replace(reduced_config(arch), dtype="float32",
                               **(over or {}))


def _leaves(tree):
    return optim.tree_leaves(tree)


def task_moe(mesh, job):
    """The expert-parallel MoE: this rank's experts, the partial output
    and aux all-reduced; gradients of x (through ``copy_in``), the router
    and the local experts."""
    cfg = config(job["arch"], job.get("over"))
    comm = mesh.comm
    m, tp = comm.model.rank, comm.tp
    El = cfg.num_experts // tp
    p = {"wg": _t(job["p"]["wg"], True)}
    for k in ("w1", "w3", "w2"):
        p[k] = _t(job["p"][k][m * El:(m + 1) * El], True)
    x = _t(job["x"], True)
    xin = comm.model.copy_in(x)
    pin = dict(p, wg=comm.model.copy_in(p["wg"]))
    y, aux = moe._moe_shard_body(cfg, pin, xin, m, tp)
    y, aux = comm.model.reduce_out(y), comm.model.reduce_out(aux)
    loss = (y * _t(job["g"])).sum() + aux
    grads = torch.autograd.grad(loss, [x, p["wg"], p["w1"], p["w3"],
                                       p["w2"]])
    return dict(y=_np(y), aux=_np(aux),
                grads=[g.numpy() for g in grads])


def task_layer(mesh, job):
    """One training layer (``_train_layer``, remat off) on this rank's
    slices: its output and the gradients of h and of its local leaves."""
    cfg = config(job["arch"], job.get("over"))
    specs = shd.param_specs(cfg, MeshAxes(), mesh.comm.tp, "tp")["layers"]
    stack = shd.shard_params(_t(job["p"]), specs, mesh)
    stack = optim.tree_map(lambda t: t.requires_grad_(True), stack)
    h = _t(job["h"], True)
    S = h.shape[1]
    pos = torch.arange(S, dtype=torch.int32)[None].expand(h.shape[0], S)
    tab = T.layers.rope_tables(pos, T.layers.rope_dim(cfg), cfg.rope_theta)
    out, aux = T._train_layer(cfg, stack, 0, h, pos, tab, comm=mesh.comm)
    loss = (out * _t(job["g"])).sum()
    if aux is not None:
        loss = loss + aux
    leaves = _leaves(stack)
    grads = torch.autograd.grad(loss, [h] + leaves)
    return dict(out=_np(out), dh=grads[0].numpy(),
                grads=[g.numpy() for g in grads[1:]])


def task_ce(mesh, job):
    """The vocab-parallel chunked cross-entropy on this rank's
    ``lm_head`` columns: its value and the gradients of h and the local
    columns."""
    cfg = config(job["arch"], job.get("over"))
    comm = mesh.comm
    W = _t(job["lm_head"])
    Vl = W.shape[1] // comm.tp
    W = W[:, comm.model.rank * Vl:(comm.model.rank + 1) * Vl] \
        .contiguous().requires_grad_(True)
    h = _t(job["h"], True)
    loss = T._chunked_ce(cfg, {"lm_head": W}, h, _t(job["labels"]), comm)
    dh, dw = torch.autograd.grad(loss, [h, W])
    return dict(loss=_np(loss), dh=dh.numpy(), dw=dw.numpy())


def _gathered(specs, params, opt, mesh, comm=None):
    full = shd.gather_params(params, specs, mesh)
    st = optim.gather_opt_state(opt, params, comm or mesh.comm, specs)
    st = {"leaves": shd.gather_params(st["leaves"], _opt_specs(specs),
                                      mesh), "step": st["step"]}
    return _np(full), {"leaves": _np(st["leaves"]),
                       "step": int(st["step"])}


def _opt_specs(specs):
    """Each leaf's spec for its gathered master, m and v (local shapes)."""
    return optim.tree_map(lambda sp: {"master": sp, "m": sp, "v": sp},
                          specs)


def task_zero(mesh, job):
    """ZeRO-1: ``apply_updates`` over every rank on this rank's slices of
    the full gradients (model-split leaves sliced, the rest whole); the
    grad norms and the gathered parameters and optimizer state after
    each step."""
    cfg = config(job["arch"], job.get("over"))
    specs = shd.param_specs(cfg, MeshAxes(), mesh.comm.tp, "tp")
    params = shd.shard_params(_t(job["params"]), specs, mesh)
    ocfg = optim.AdamWConfig(**job["ocfg"])
    opt = optim.init_opt_state(params, mesh.size, comm=mesh.comm,
                               specs=specs)
    out = {"init": _gathered(specs, params, opt, mesh), "steps": []}
    for g in job["grads"]:
        gl = shd.shard_params(_t(g), specs, mesh)
        # the data ranks' gradients sum to the full: rank 0 of each data
        # group holds it, the others zeros
        if mesh.comm.data.rank:
            gl = optim.tree_map(torch.zeros_like, gl)
        _, _, gn = optim.apply_updates(ocfg, params, gl, opt, mesh.size,
                                       comm=mesh.comm, specs=specs)
        out["steps"].append((float(gn), _gathered(specs, params, opt,
                                                  mesh)))
    return out


def _one_device(cfg, params, batches, ocfg, microbatches=1):
    """The one-device ``train_step`` from the full ``params`` on each of
    ``batches``: each step's loss, grad norm, parameters and optimizer
    state (copies)."""
    opt = optim.init_opt_state(params)
    ocfg = optim.AdamWConfig(**dict(ocfg, zero1=False))
    out = []
    for batch in batches:
        w = steps.train_step(cfg, params, opt, _t(batch), ocfg,
                             microbatches=microbatches)
        out.append((float(w["loss"]), float(w["grad_norm"]),
                    optim.tree_map(lambda t: t.detach().numpy().copy(),
                                   params),
                    {"leaves": optim.tree_map(lambda t: t.numpy().copy(),
                                              opt["leaves"]),
                     "step": int(opt["step"])}))
    return out


def task_train(mesh, job):
    """``build_cell``'s sharded step: each step's loss and grad norm, the
    gathered parameters and optimizer state after it, and each step's
    collective stats; with ``one_device``, also ``_one_device``'s steps
    from the same weights."""
    cfg = config(job["arch"], job.get("over"))
    over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    B, S = job["tokens"][0].shape
    cell = steps.build_cell(job["arch"], "train_4k", mesh,
                            batch_seq=(B, S), over=over,
                            exact_microbatches=job["microbatches"],
                            opt_cfg=optim.AdamWConfig(**job["ocfg"]))
    params = shd.shard_params(_t(job["params"]), cell.param_specs, mesh)
    opt = cell.init_opt(params)
    out = {"steps": [], "microbatches": cell.microbatches}
    for i, (toks, labels) in enumerate(zip(job["tokens"], job["labels"])):
        batch = {"tokens": _t(toks), "labels": _t(labels)}
        for k in ("patches", "frames"):     # the vision decoder's, Whisper's
            if k in job:
                batch[k] = _t(job[k][i])
        C.reset_events()
        r = cell.step(params, opt, batch)
        stats = C.collective_stats()
        out["steps"].append((float(r["loss"]), float(r["grad_norm"]),
                             stats, _gathered(cell.param_specs, params, opt,
                                              mesh)))
    if job.get("one_device"):
        out["one_device"] = _one_device(
            cfg, _t(job["params"]), [{"tokens": t, "labels": l} for t, l in
                                     zip(job["tokens"], job["labels"])],
            job["ocfg"], job["microbatches"])
    return out


def task_fsdp(mesh, job):
    """``build_cell``'s ``fsdp`` step (ZeRO-3 over every rank) on this
    rank's shards: the full weights of ``params`` cut by ``shard_params``,
    or with ``seed`` drawn by ``init_state``; each step's loss and grad
    norm, its collective stats, and the gathered parameters and optimizer
    state after it.  With ``seed``, also the one-device ``train_step`` on
    the whole batch in one microbatch from ``init_params(cfg, seed)``:
    its loss, grad norm, parameters and optimizer state after each
    step."""
    cfg = config(job["arch"], job.get("over"))
    over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    B, S = job["batches"][0]["tokens"].shape
    ocfg = optim.AdamWConfig(**job["ocfg"])
    cell = steps.build_cell(job["arch"], "train_4k", mesh, batch_seq=(B, S),
                            over=over, train_regime="fsdp", opt_cfg=ocfg)
    if "params" in job:
        params = shd.shard_params(_t(job["params"]), cell.param_specs, mesh)
        opt = cell.init_opt(params)
    else:
        params, opt = cell.init_state(job["seed"], "cpu")
    out = {"steps": [], "microbatches": cell.microbatches,
           "rows": cell.local_batch(_t(job["batches"][0]))["tokens"].shape}
    for batch in job["batches"]:
        C.reset_events()
        r = cell.step(params, opt, _t(batch))
        stats = C.collective_stats()
        out["steps"].append((float(r["loss"]), float(r["grad_norm"]),
                             stats, _gathered(cell.param_specs, params, opt,
                                              mesh, cell.comm)))
    if "seed" in job:
        out["one_device"] = _one_device(
            cfg, T.init_params(cfg, job["seed"], "cpu"), job["batches"],
            job["ocfg"])
    return out


def _events():
    """(kind, count) of the collectives recorded since the last reset,
    groups of one included."""
    out = {}
    for kind, _, _ in C.EVENTS:
        out[kind] = out.get(kind, 0) + 1
    return out


def task_serve(mesh, job):
    """``build_cell``'s prefill cell on the global prompts, then ``steps``
    decode-cell steps from its cache: the prefill logits of this rank's
    rows, the cache gathered from every rank (``gather_cache``) after the
    prefill and after the last step (and whether ``shard_cache`` cuts the
    gathered cache back into this rank's, each leaf contiguous), the first
    step's logits (gathered over the model group) and each step's tokens
    of this rank's rows, and the collectives of the prefill and of each
    step.  The vision decoder's prompts hold ``patches`` before the
    tokens; ``lengths``, where given, are the rows' positions at the first
    step (else the prompt's)."""
    cfg = config(job["arch"], job.get("over"))
    over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    toks = _t(job["tokens"])
    batch = {"tokens": toks}
    for k in ("patches", "frames"):
        if k in job:
            batch[k] = _t(job[k])
    B = toks.shape[0]
    S = toks.shape[1] + (batch["patches"].shape[1] if "patches" in job
                         else 0)
    n = job["max_len"]
    pc = steps.build_cell(job["arch"], "prefill_32k", mesh, batch_seq=(B, S),
                          over=over, max_len=n)
    dc = steps.build_cell(job["arch"], "decode_32k", mesh, batch_seq=(B, n),
                          over=over)
    full = _t(job["params"])
    pp = shd.shard_params(full, pc.param_specs, mesh)
    dp = shd.shard_params(full, dc.param_specs, mesh)
    C.reset_events()
    logits, cache = pc.step(pp, batch)
    out = {"prefill_events": _events(), "prefill_logits": _np(logits),
           "cache_shape": T._map_spec(cache, lambda _, t: tuple(t.shape))}
    whole = shd.gather_cache(cache, dc.cache_specs, mesh)
    out["cache0"] = _np(whole)
    recut = shd.shard_cache(whole, dc.cache_specs, mesh)
    out["recut_equal"] = all(
        torch.equal(a, b) and a.is_contiguous() for a, b in
        zip(optim.tree_leaves(recut), optim.tree_leaves(cache)))
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    lengths = torch.full(tok.shape, S, dtype=torch.int32)
    if "lengths" in job:
        lengths = dc.local_batch({"lengths": _t(job["lengths"])})["lengths"]
    model = mesh.comm.model
    part, _ = T.decode_step_logits(
        cfg, dp, T._map_spec(cache, lambda _, t: t.clone()), tok, lengths,
        mesh.comm)
    every = model.all_gather(part[None])
    out["step0_logits"] = _np(every.permute(1, 0, 2).reshape(
        part.shape[0], -1))
    out["tokens"], out["step_events"] = [tok.numpy()], []
    for _ in range(job["steps"]):
        C.reset_events()
        tok, cache, lengths = dc.step(dp, cache, tok, lengths)
        out["step_events"].append(_events())
        out["tokens"].append(tok.numpy())
    out["cache_end"] = _np(shd.gather_cache(cache, dc.cache_specs, mesh))
    out["lengths"] = lengths.numpy()
    return out


TASKS = {"moe": task_moe, "layer": task_layer, "ce": task_ce,
         "zero": task_zero, "train": task_train, "serve": task_serve,
         "fsdp": task_fsdp}


def main(argv):
    rank, world = int(argv[1]), int(argv[2])
    sizes = tuple(int(x) for x in argv[3].split(","))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{argv[4]}",
                            rank=rank, world_size=world)
    try:
        names = ("data", "model") if len(sizes) == 2 else \
            ("pod", "data", "model")
        mesh = mesh_lib.Mesh(names, sizes).realize("cpu")
        with open(argv[5], "rb") as f:
            jobs = pickle.load(f)
        results = [TASKS[job["task"]](mesh, job) for job in jobs]
        with open(argv[6], "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
