"""The rest of the port's training regimes on the CPU, held to the JAX
package: the ``seq`` attention mode (q positions over the model group,
K/V replicated) in the train step and the prefill cell, and the ``fsdp``
(ZeRO-3) train cell.  fp32, inputs from ``np.random.default_rng(seed)``.

Two ``gloo`` groups of two processes (``tests/torch_dist_worker.py``),
meshes (1, 2) and (2, 1), started once for the module; the JAX
references are computed while they run.  Weights are the port's
``init_params`` as numpy (the layout both packages take), attention
biases drawn.  Cases:

- (a) ``build_cell``'s train step in the ``seq`` mode at (1, 2): reduced
  SmolLM-360M (at d_model 129) and Qwen2-0.5B (QKV bias) with 3 q heads
  on 1 kv head, two steps against ``jax.value_and_grad(forward_loss)``
  and ``apply_updates(n_dev=2)`` as
  ``test_torch_distributed.test_sharded_train_step_matches_jax``, and
  reduced Qwen3-30B-A3B with 3 on 1 (an MoE decoder with non-splitting
  heads, none configured) against the port's one-device step in the same
  processes: losses rtol 1e-5, grad norms rtol 1e-4, the gathered state
  by ``_check_steps``; its collectives as the ``heads`` mode's (one
  all-reduce a sublayer's copy backward, so 5 a dense layer, 7 an MoE
  layer);
- (b) the ``seq`` shares rank by rank in one process: summed over the
  ranks, the outputs and the gradients of h and of every leaf equal the
  one-device sublayer (rtol 1e-5, atol 2e-6 of the largest magnitude) at
  tp 2 and at tp 4 over 22 positions (6, 6, 6 and 4 rows); the check
  refuses a share whose q positions are not offset and a sum that drops
  the last rank's rows;
- (c) the ``seq`` prefill cell at (1, 2), reduced Qwen2-0.5B with 3 q
  heads and drawn biases, 14 prompt tokens into a cache of 32, then 4
  decode-cell steps, against JAX's ``prefill`` and ``decode_step``:
  tokens equal, logits and the gathered cache within atol 1e-5; a
  prefill's collectives 1 + 2 L all-reduces and one all-gather, no
  all-to-all;
- (d) the ``fsdp`` cell over two ranks: (a)'s SmolLM-360M (its norms'
  129 split over no axis: replicated on (1, 2), over the trivial model
  axis on (2, 1), so every rule of ``_fsdp_rule`` runs), Qwen3-30B-A3B
  (capacity factor 0.5, so choices drop) and Mamba2-370M held to the
  JAX one-device step on the same global batch (the MoE routing the
  global batch: one capacity and one aux over every rank's tokens),
  with their gathers, the MoE's count gathers and the reduce-scatters
  counted; RecurrentGemma-2B, Whisper-base, Pixtral-12B and DeepSeek-R1
  held to the port's one-device ``train_step`` on the whole batch in one
  microbatch in the same processes, on (2, 1) (weights drawn by each
  rank's ``init_state``); in one process, the ranks' capacity blocks
  of the ``fsdp`` MoE keep what the whole batch's plan keeps;
- the refusals that remain (``test_torch_distributed.test_refusals``,
  ``test_torch_decode_regime.test_refusals``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.models import transformer as JT
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch import train as ttrain
from repro_torch.models import layers
from repro_torch.models import transformer as TT
from repro_torch.models.api import MeshAxes
from test_torch_distributed import (AX, OCFG, OCFG_B2, _cfgs, _close,
                                    _get, _walk, join_groups, start_groups)

SEQ = dict(num_heads=3, num_kv_heads=1)
# SmolLM's case also at d_model 129: its norms then split over no axis of
# the fsdp rule, so its fsdp case runs every rule (and shares its JAX
# reference with the seq case: same weights, same batches)
SMOLLM = dict(SEQ, d_model=129)
# held to JAX's step; an MoE decoder with non-splitting heads (none is
# configured) to the port's one-device step, which the MoE training tests
# hold to JAX's
SEQ_TRAIN = [("smollm_360m", SMOLLM), ("qwen2_0_5b", SEQ)]
SEQ_MOE = ("qwen3_moe_30b", SEQ)
# Qwen3's capacity at half: 32 slots an expert over the global batch's
# 256 choices of 4 experts (16 over a rank's rows), so the ranks' rows
# drop what the global batch's routing drops
FSDP_JAX = [("smollm_360m", SMOLLM),
            ("qwen3_moe_30b", dict(capacity_factor=0.5)),
            ("mamba2_370m", {})]
FSDP_PORT = ["recurrentgemma_2b", "whisper_base", "pixtral_12b",
             "deepseek_r1"]
B, S, STEPS = 4, 32, 2
SERVE_B, SERVE_S, MAX_LEN, SERVE_STEPS = 4, 14, 32, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- inputs

def _np_params(cfg, seed):
    """The port's weights from ``seed`` as numpy: the JAX package's
    layout, which both packages take."""
    return TT._map_spec(TT.init_params(cfg, seed, "cpu"),
                        lambda path, t: t.numpy())


def _biased(np_params, seed):
    """The attention biases drawn (the reference's are zeros)."""
    rng = np.random.default_rng(seed)
    attn = np_params["layers"].get("attn", {})
    for k in ("bq", "bk", "bv"):
        if k in attn:
            attn[k] = (rng.standard_normal(attn[k].shape) * 0.1) \
                .astype(np.float32)
    return np_params


def _stream_batches(cfg):
    stream = SyntheticLMStream(DataConfig(global_batch=B, seq_len=S,
                                          vocab_size=cfg.vocab_size, seed=3))
    batches = [ttrain.step_batch(cfg, stream, i, 3) for i in range(STEPS)]
    labels = batches[0]["labels"].copy()    # the stream's are its tokens
    labels[:, -S:][:, :3] = -1
    batches[0]["labels"] = labels
    return batches


def _seq_train_job(arch, over):
    _, cfg = _cfgs(arch, **over)
    batches = _stream_batches(cfg)
    return dict(task="train", arch=arch, over=over,
                params=_biased(_np_params(cfg, 10), 7),
                tokens=[b["tokens"] for b in batches],
                labels=[b["labels"] for b in batches], ocfg=OCFG,
                microbatches=1)


def _serve_job():
    _, cfg = _cfgs("qwen2_0_5b", **SEQ)
    toks = np.random.default_rng(51).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_S)).astype(np.int32)
    return dict(task="serve", arch="qwen2_0_5b", over=SEQ,
                params=_biased(_np_params(cfg, 8), 9), tokens=toks,
                max_len=MAX_LEN, steps=SERVE_STEPS)


def _fsdp_job(arch, over=None, jax_params=True):
    over = over or {}
    _, cfg = _cfgs(arch, **over)
    job = dict(task="fsdp", arch=arch, over=over, ocfg=OCFG,
               batches=_stream_batches(cfg))
    if jax_params:
        job["params"] = _biased(_np_params(cfg, 10), 7)
    else:
        job["seed"] = 11
    return job


def _groups():
    """The two groups' jobs, about equal in length: the seq cases and the
    fsdp cases held to JAX at (1, 2); SmolLM's fsdp case again and the
    families held to the port's one-device step at (2, 1)."""
    one_two = ([_seq_train_job(a, o) for a, o in SEQ_TRAIN]
               + [dict(_seq_train_job(*SEQ_MOE), one_device=True),
                  _serve_job()] + [_fsdp_job(a, o) for a, o in FSDP_JAX])
    two_one = [_fsdp_job(*FSDP_JAX[0])] + [_fsdp_job(a, jax_params=False)
                                           for a in FSDP_PORT]
    return [((1, 2), one_two), ((2, 1), two_one)]


# ---------------------------------------------------------------- references

def _jax_train(arch, over, np_params, batches):
    """Each step's (loss, grad norm, params, opt state) of the reference
    on one device, on the whole batch."""
    jcfg, _ = _cfgs(arch, **over)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.forward_loss(jcfg, AX, p, b, remat=False)))
    ocfg = joptim.AdamWConfig(**OCFG)
    update = jax.jit(lambda p, g, o: joptim.apply_updates(ocfg, p, g, o, 2))
    params = jax.tree.map(jnp.asarray, np_params)
    opt = joptim.init_opt_state(params, 2)
    out = []
    for b in batches:
        loss, grads = vg(params, {k: jnp.asarray(v) for k, v in b.items()})
        params, opt, gn = update(params, grads, opt)
        out.append((float(loss), float(gn), params, opt))
    return out


def _jax_serve(job):
    """The reference's one-device serving of the job: prefill logits, its
    cache installed in ``init_cache(MAX_LEN)``, the first step's logits,
    each step's tokens, the cache after the steps."""
    jcfg, _ = _cfgs(job["arch"], **job["over"])
    params = jax.tree.map(jnp.asarray, job["params"])
    logits, pc = JT.prefill(jcfg, AX, params,
                            {"tokens": jnp.asarray(job["tokens"])})
    cache = {n: JT.init_cache(jcfg, SERVE_B, MAX_LEN)[n]
             .at[:, :, :SERVE_S].set(pc[n]) for n in ("k", "v")}
    step = jax.jit(lambda p, c, t, ln: JT.decode_step_logits(jcfg, AX, p, c,
                                                             t, ln))
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    lengths = jnp.full((SERVE_B,), SERVE_S, jnp.int32)
    out = {"prefill_logits": np.asarray(logits), "cache0": jax.tree.map(
        np.asarray, cache), "tokens": [np.asarray(tok)]}
    for i in range(SERVE_STEPS):
        lg, cache = step(params, cache, tok, lengths)
        if i == 0:
            out["step0_logits"] = np.asarray(lg)
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        lengths = lengths + 1
        out["tokens"].append(np.asarray(tok))
    out["cache_end"] = jax.tree.map(np.asarray, cache)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group's jobs and per-rank results, and the JAX references,
    computed while the groups run."""
    groups = _groups()
    started = start_groups(tmp_path_factory.mktemp("seqfsdp"), groups)
    refs = {}
    jobs = groups[0][1]
    for job in jobs:
        key = (job["task"], job["arch"])
        if job.get("one_device"):
            continue
        if job["task"] == "train":
            batches = [{"tokens": t, "labels": l}
                       for t, l in zip(job["tokens"], job["labels"])]
            refs[key] = _jax_train(job["arch"], job["over"], job["params"],
                                   batches)
        elif job["task"] == "serve":
            refs[key] = _jax_serve(job)
        elif "params" in job and ("train", job["arch"]) in refs and \
                not _cfgs(job["arch"])[0].is_moe:   # the seq case's
            refs[key] = refs[("train", job["arch"])]
        elif "params" in job:
            refs[key] = _jax_train(job["arch"], job["over"], job["params"],
                                   job["batches"])
    res = join_groups(started)
    return {sizes: (jobs, r) for (sizes, jobs), r in zip(groups, res)}, refs


def _results(runs, sizes, task, arch):
    groups, _ = runs
    jobs, res = groups[sizes]
    i = next(i for i, j in enumerate(jobs)
             if j["task"] == task and j["arch"] == arch)
    return jobs[i], [r[i] for r in res]


def _check_steps(got, want):
    """Each step's gathered parameters and optimizer state (``got``: the
    worker's (params, state) a step) against the reference's (``want``:
    (params, opt) a step): m and v to atol 2e-6, rtol 1e-4; a parameter
    and its master to that plus, summed over the steps so far, 1e-2 lr
    for each step where the element's gradient RMS (sqrt(v / (1 -
    b2^t))) is 1e-4 or more and lr for each where it is less (the rule
    of ``test_torch_distributed._check_state``, carried over the steps:
    Adam moves an element whose gradient is ~0 by up to lr either way,
    and the element keeps that difference when its gradient grows)."""
    lr = OCFG["lr"]
    allow = {}
    for t, ((gp, gst), (params, opt)) in enumerate(zip(got, want), 1):
        b2c = 1.0 - OCFG_B2 ** t
        assert gst["step"] == t == int(opt["step"])
        for path, st in _walk(gst["leaves"], stop="master"):
            ref = _get(opt["leaves"], path)
            n = st["master"].size
            v = np.asarray(ref["v"]).reshape(-1)[:n]
            step = np.where(np.sqrt(v / b2c) < 1e-4, lr, 1e-2 * lr)
            allow[path] = allow.get(path, 0.0) + step
            for k in ("m", "v"):
                _close(st[k].reshape(-1), np.asarray(ref[k]).reshape(-1)[:n],
                       atol=2e-6, rtol=1e-4)
            for a, b in ((st["master"], ref["master"]),
                         (_get(gp, path), _get(params, path))):
                a = np.asarray(a).reshape(-1)
                b = np.asarray(b).reshape(-1)[:n]
                bad = np.abs(a - b) > 2e-6 + allow[path] + 1e-4 * np.abs(b)
                assert not bad.any(), (t, path, np.flatnonzero(bad)[:4],
                                       a[bad][:4], b[bad][:4])


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("arch,over", SEQ_TRAIN + [SEQ_MOE],
                         ids=["smollm", "qwen2_bias", "qwen3_moe"])
def test_seq_train_step_matches_jax(runs, arch, over):
    """(a); the MoE case against the port's one-device step."""
    job, res = _results(runs, (1, 2), "train", arch)
    want = runs[1].get(("train", arch)) or res[0]["one_device"]
    _, cfg = _cfgs(arch, **over)
    assert TT.seq_split(cfg, 2)
    specs = shd.param_specs(cfg, MeshAxes(), 2, "tp")
    leaves = list(_walk(specs))
    split = sum("model" in sp for _, sp in leaves)
    # the seq mode replicates every attention leaf
    assert all(sp == (None,) * len(sp) for path, sp in leaves
               if path[:2] == ("layers", "attn"))
    # the dry run's accounting, as the heads mode's: the seq share's copy
    # is one all-reduce, as the heads share's
    design = dryrun.design_collectives(cfg, "train", 2, 1, 1, S,
                                       len(leaves), split)
    assert design["all-gather"] == len(leaves) - split
    for r in res:
        for (loss, gn, _, _), (got_loss, got_gn, stats, _) in \
                zip(want, r["steps"]):
            _close(got_loss, loss, rtol=1e-5, atol=0)
            _close(got_gn, gn, rtol=1e-4, atol=0)
            assert stats["counts"] == design, (stats, design)
        _check_steps([s[3] for s in r["steps"]], [w[2:] for w in want])


# ---------------------------------------------------------------- (b)

def _leaf_tree(cfg, seed):
    stack = TT.init_params(cfg, seed, "cpu")["layers"]
    p = TT._map_spec(stack, lambda path, t: t[0].clone())
    gen = torch.Generator().manual_seed(seed)
    for k in ("bq", "bk", "bv"):
        if k in p["attn"]:
            p["attn"][k] = 0.1 * torch.randn(p["attn"][k].shape,
                                             generator=gen)
    return p


def _req(tree):
    return {k: _req(v) if isinstance(v, dict) else
            v.detach().clone().requires_grad_(True) for k, v in tree.items()}


def _share_sums(cfg, p, h0, up, pos, tab, tp, ranks):
    """The ranks' shares summed, and the gradients of h and of every leaf
    (each rank's parts summed, what ``copy_in`` sums)."""
    h = h0.clone().requires_grad_(True)
    locs = [_req(p) for _ in range(tp)]
    out = sum(TT.attention_share(cfg, locs[m], h, pos, tab, m, tp)
              for m in ranks)
    (out * up).sum().backward()
    grads = {}
    for path, _ in _walk(p):
        parts = [_get(loc, path).grad for loc in locs]
        if any(g is not None for g in parts):
            grads[path] = sum(g for g in parts if g is not None)
    return out, h.grad, grads


def _agree(got, want):
    want = want.detach().double().numpy()
    np.testing.assert_allclose(got.detach().double().numpy(), want,
                               rtol=1e-5, atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("arch,tp,seq", [("smollm_360m", 2, 24),
                                         ("qwen2_0_5b", 2, 24),
                                         ("qwen2_0_5b", 4, 22)],
                         ids=["smollm-tp2", "qwen2-tp2", "qwen2-tp4-S22"])
def test_rank_sum_of_a_seq_share_is_the_sublayer(arch, tp, seq, monkeypatch):
    _, cfg = _cfgs(arch, num_layers=1, **SEQ)
    p = _leaf_tree(cfg, 4)
    gen = torch.Generator().manual_seed(5)
    h0 = torch.randn((2, seq, cfg.d_model), generator=gen)
    up = torch.randn(h0.shape, generator=gen)
    pos = torch.arange(seq, dtype=torch.int32)[None].expand(2, seq)
    tab = layers.rope_tables(pos, layers.rope_dim(cfg), cfg.rope_theta)
    one, dh1, g1 = _share_sums(cfg, p, h0, up, pos, tab, 1, [0])
    out, dh, g = _share_sums(cfg, p, h0, up, pos, tab, tp, range(tp))
    assert [TT.seq_rows(seq, m, tp) for m in range(tp)] == [
        (m * -(-seq // tp), min(seq, (m + 1) * -(-seq // tp)))
        for m in range(tp)]
    _agree(out, one)
    _agree(dh, dh1)
    # ln1 and every attention leaf
    assert len(g) == len(g1) == len(list(_walk(p["attn"]))) + 1
    for path in g1:
        _agree(g[path], g1[path])
    # a sum without the last rank's rows, and shares whose q positions
    # start at 0, are refused
    dropped = _share_sums(cfg, p, h0, up, pos, tab, tp, range(tp - 1))[0]
    with pytest.raises(AssertionError):
        _agree(dropped, one)
    flash = layers.chunked_attention
    monkeypatch.setattr(layers, "chunked_attention",
                        lambda q, k, v, qp, kp, **kw: flash(
                            q, k, v, kp[:, :q.shape[1]], kp, **kw))
    unshifted = _share_sums(cfg, p, h0, up, pos, tab, tp, range(tp))[0]
    with pytest.raises(AssertionError):
        _agree(unshifted, one)


# ---------------------------------------------------------------- (c)

def test_seq_prefill_cell_matches_jax(runs):
    job, res = _results(runs, (1, 2), "serve", "qwen2_0_5b")
    want = runs[1][("serve", "qwen2_0_5b")]
    L = _cfgs("qwen2_0_5b", **SEQ)[1].num_layers
    for r in res:
        assert r["cache_shape"]["k"] == (L, SERVE_B, MAX_LEN // 2, 1, 32)
        assert r["recut_equal"]
        for name in ("prefill_logits", "step0_logits"):
            _close(r[name], want[name], atol=1e-5, rtol=1e-5)
        for name in ("k", "v"):
            _close(r["cache0"][name], want["cache0"][name], atol=1e-5,
                   rtol=1e-5)
            _close(r["cache_end"][name], want["cache_end"][name],
                   atol=1e-5, rtol=1e-5)
        for t, (got, w) in enumerate(zip(r["tokens"], want["tokens"])):
            assert np.array_equal(got, w), t
        assert r["prefill_events"] == {"all-reduce": 1 + 2 * L,
                                       "all-gather": 1} == \
            dryrun.design_collectives(_cfgs("qwen2_0_5b", **SEQ)[1],
                                      "prefill", 2, 1, 1, SERVE_S, 0, 0)
        assert r["step_events"] == [{"all-reduce": 1 + 3 * L,
                                     "all-gather": 1}] * SERVE_STEPS


# ---------------------------------------------------------------- (d)

def _fsdp_design(cfg, specs, sizes):
    """The collectives of an ``fsdp`` step at remat on, by kind: a leaf
    split over every axis gathered over the world where it is read (a
    stacked one a layer, twice: the recompute gathers again) and its
    gradient reduce-scattered once; a leaf split over ``model`` alone
    gathered over the model group, its gradient then all-reduced over
    the data group; a replicated leaf's gradient all-reduced over the
    world; an MoE layer's expert counts gathered over the world (twice);
    beside them the label count, the loss and the grad norm."""
    n = int(np.prod(sizes))
    sizes = dict(zip(("data", "model"), sizes))
    out = {"all-reduce": 3}

    def add(kind, k):
        if k:
            out[kind] = out.get(kind, 0) + k

    add("all-gather", 2 * cfg.num_layers * cfg.is_moe * (n > 1))

    for path, sp in _walk(specs):
        stacked = path[0] == "layers"
        reps, sp = (cfg.num_layers, sp[1:]) if stacked else (1, sp)
        entry = next((e for e in sp if e is not None), None)
        if entry is None:
            add("all-reduce", reps * (n > 1))
        elif entry == "model":
            add("all-gather", (1 + stacked) * reps * (sizes["model"] > 1))
            add("reduce-scatter", reps * (sizes["model"] > 1))
            add("all-reduce", reps * (sizes["data"] > 1))
        else:
            add("all-gather", (1 + stacked) * reps)
            add("reduce-scatter", reps)
    return out


@pytest.mark.parametrize("arch,over,sizes", [
    FSDP_JAX[0] + ((1, 2),), FSDP_JAX[0] + ((2, 1),),
    FSDP_JAX[1] + ((1, 2),), FSDP_JAX[2] + ((1, 2),)],
    ids=["smollm-d129-model2", "smollm-d129-data2", "qwen3_moe", "mamba2"])
def test_fsdp_step_matches_jax(runs, arch, over, sizes):
    job, res = _results(runs, sizes, "fsdp", arch)
    want = runs[1][("fsdp", arch)]
    _, cfg = _cfgs(arch, **over)
    specs = shd.param_specs(cfg, MeshAxes(batch=("data", "model"),
                                          model=None), sizes[1], "fsdp",
                            n_dev=2)
    kinds = {next((e for e in sp[1 if p[0] == "layers" else 0:]
                   if e is not None), None) for p, sp in _walk(specs)}
    if "d_model" in over:   # every rule: split over the world, the norms
        assert kinds == {("data", "model"), None if sizes[1] > 1
                         else "model"}
    design = _fsdp_design(cfg, specs, sizes)
    for r in res:
        assert r["microbatches"] == 1 and r["rows"] == (B // 2, S)
        for (loss, gn, _, _), (got_loss, got_gn, stats, _) in \
                zip(want, r["steps"]):
            _close(got_loss, loss, rtol=1e-5, atol=0)
            _close(got_gn, gn, rtol=1e-4, atol=0)
            assert stats["counts"] == design, (stats["counts"], design)
        _check_steps([s[3] for s in r["steps"]], [w[2:] for w in want])


@pytest.mark.parametrize("ranks", [2, 3, 4])
def test_rank_blocks_keep_what_the_whole_batch_keeps(ranks):
    """The ``fsdp`` MoE's capacity over ranks (``moe._moe_shard_body``
    with ``route``): each rank's tokens a contiguous block of the batch,
    expert e given C less the earlier ranks' choices of e, the ranks'
    plans keep exactly the choices the whole batch's plan keeps, and an
    (E,) capacity of C everywhere plans as the int C.  Each rank given C
    keeps more."""
    from repro_torch.kernels.moe_gemm import ops as moe_ops
    E, k, T, C = 4, 2, 48, 16
    rng = np.random.default_rng(21)
    ids = torch.from_numpy(rng.choice(E, size=(T, k),
                                      p=[0.5, 0.3, 0.15, 0.05]))
    whole = moe_ops.dispatch_plan(ids.reshape(-1), E, 16, capacity=C)
    full = moe_ops.dispatch_plan(ids.reshape(-1), E, 16,
                                 capacity=torch.full((E,), C))
    for a, b in zip(whole, full):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    kept, alone, before = [], [], torch.zeros(E, dtype=torch.long)
    for block in torch.tensor_split(ids, ranks):
        flat = block.reshape(-1)
        cap = (C - before).clamp(min=0)
        kept.append(moe_ops.dispatch_plan(flat, E, 16, capacity=cap).keep)
        alone.append(moe_ops.dispatch_plan(flat, E, 16, capacity=C).keep)
        before += torch.bincount(flat, minlength=E)
    assert int(whole.keep.sum()) < T * k
    assert torch.equal(torch.cat(kept), whole.keep)
    assert int(torch.cat(alone).sum()) > int(whole.keep.sum())


@pytest.mark.parametrize("arch", FSDP_PORT)
def test_fsdp_step_matches_the_one_device_step(runs, arch):
    """The other families: each rank's ``fsdp`` step against the port's
    one-device ``train_step`` on the whole batch in one microbatch, in
    the same process."""
    job, res = _results(runs, (2, 1), "fsdp", arch)
    for r in res:
        assert len(r["steps"]) == len(r["one_device"]) == STEPS
        for (got_loss, got_gn, _, _), (loss, gn, _, _) in zip(
                r["steps"], r["one_device"]):
            _close(got_loss, loss, rtol=1e-5, atol=0)
            _close(got_gn, gn, rtol=1e-4, atol=0)
        _check_steps([s[3] for s in r["steps"]],
                     [w[2:] for w in r["one_device"]])
