"""The attention families over a model group, held to the JAX package on
the CPU: DeepSeek-R1's MLA (with a shared expert) and Pixtral-12B's
vision decoder in the ``tp`` train step and both serving cells, and
H2O-Danube-1.8B's windowed ring in the serving cells.  fp32, reduced
configs (MLA's 4 q heads, 4 experts and a shared expert; Pixtral's 8
patches; Danube's window of 64), inputs from ``np.random.default_rng``,
weights the port's ``init_params`` from a seed, as numpy in the layout
both packages take.  Cases:

- (a) ``build_cell``'s train step at (1, 2), MLA and vision, two steps
  over two ``gloo`` ranks (``tests/torch_dist_worker.py``, one group for
  every tp-2 case, run while the references are computed): losses (rtol
  1e-5), grad norms (rtol 1e-4), gathered parameters and optimizer state
  (``test_torch_seq_fsdp._check_steps``) against ``jax.value_and_grad(
  forward_loss)`` and ``apply_updates(n_dev=2)``; the collectives each
  rank sent equal ``dryrun.design_collectives``;
- (b) the shares rank by rank in one process at tp 2 and 4: the MLA
  attention share and the MoE share with its shared expert summed over
  the ranks against the one-device sublayer, output and every leaf's
  gradient (rtol 1e-5, atol 2e-6 of the tensor's scale, as
  ``test_torch_tp_shares.py``); MLA's replicated leaves pass through one
  ``copy`` with the normed input, the MoE's shared expert reads the
  copied input and nothing is copied twice; the vision decoder's
  embedding (the ranks' ``embed_share`` summed, then the patches) in
  bits.  Wronged versions fail: ``wq_a``'s gradient left unreduced (one
  rank's part), the shared expert added whole on every rank, the patches
  placed before the embedding's reduce;
- (c) the serving cells at (1, 2): prefill into a longer cache, then four
  decode steps, against the reference's ``prefill`` (its cache installed
  in ``init_cache``'s; a ring re-laid by ``test_torch_window._relay``)
  and ``decode_step_logits``: tokens equal, prefill and first-step
  logits and the gathered cache after the prefill and after the steps
  within atol 1e-5; MLA with a row that finishes (its writes dropped
  past the cache), the ring with a prompt longer than the window (the
  ring wrapped) and rows whose writes land on each rank; the collectives
  equal ``dryrun.design_collectives`` (no all-to-all for MLA, two for the
  ring and the vision decoder);
- (d) ``ServeCell.init_cache`` of a ring: positions -1 (empty), k and v
  zeros.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import reduced_config as j_reduced
from repro.models import transformer as JT
from repro.models.api import MeshAxes as JAxes
from repro_torch.configs import reduced_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import layers, moe
from repro_torch.models import transformer as TT
from repro_torch.models.api import MeshAxes
from test_torch_distributed import OCFG, join_groups, start_groups
from test_torch_seq_fsdp import _check_steps
from test_torch_tp_shares import _close as _close_scaled
from test_torch_tp_shares import (_full_grads, _get, _layer, _rank, _req,
                                  _walk)
from test_torch_window import _relay

AX = JAxes()
MLA, VLM, RING = "deepseek_r1", "pixtral_12b", "h2o_danube_1_8b"
TRAIN_B, TRAIN_S, STEPS = 4, 32, 2
SERVE_B, SERVE_STEPS = 4, 4
# (prompt tokens, cache positions, first-step lengths or None) a case
SERVE = {MLA: (14, 32, [14, 14, 30, 14]),
         VLM: (6, 32, None),
         RING: (80, 96, [80, 95, 111, 127])}


def _cfgs(arch):
    return (dataclasses.replace(j_reduced(arch), dtype="float32"),
            dataclasses.replace(reduced_config(arch), dtype="float32"))


def _np_params(arch, seed):
    """The port's weights from ``seed`` as numpy, in the JAX package's
    layout, which both packages take (drawn faster than the JAX
    package's)."""
    return TT._map_spec(TT.init_params(_cfgs(arch)[1], seed, "cpu"),
                        lambda path, t: t.numpy())


def _patches(jcfg, rng, B):
    return rng.standard_normal((B, jcfg.num_patches, jcfg.d_model)) \
        .astype(np.float32)


def _train_job(arch):
    jcfg, _ = _cfgs(arch)
    rng = np.random.default_rng(60)
    P = jcfg.num_patches if jcfg.family == "vlm" else 0
    toks = [rng.integers(0, jcfg.vocab_size, (TRAIN_B, TRAIN_S - P))
            .astype(np.int32) for _ in range(STEPS)]
    # the vision decoder's labels run over the patches too, -1 there
    labels = [np.concatenate([np.full((TRAIN_B, P), -1, np.int32), t], 1)
              for t in toks]
    labels[0][:, P:P + 3] = -1
    job = dict(task="train", arch=arch, params=_np_params(arch, 61),
               tokens=toks, labels=labels, ocfg=OCFG, microbatches=1)
    if P:
        job["patches"] = [_patches(jcfg, rng, TRAIN_B) for _ in range(STEPS)]
    return job


def _serve_job(arch):
    jcfg, _ = _cfgs(arch)
    S, n, lengths = SERVE[arch]
    rng = np.random.default_rng(62)
    job = dict(task="serve", arch=arch, params=_np_params(arch, 63),
               tokens=rng.integers(0, jcfg.vocab_size, (SERVE_B, S))
               .astype(np.int32), max_len=n, steps=SERVE_STEPS)
    if jcfg.family == "vlm":
        job["patches"] = _patches(jcfg, rng, SERVE_B)
    if lengths is not None:
        job["lengths"] = np.array(lengths, np.int32)
    return job


# ---------------------------------------------------------------- references

def _jax_train(job):
    """Each step's (loss, grad norm, params, opt state) of the reference
    on one device, on the whole batch."""
    jcfg, _ = _cfgs(job["arch"])
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.forward_loss(jcfg, AX, p, b, remat=True)))
    ocfg = joptim.AdamWConfig(**OCFG)
    update = jax.jit(lambda p, g, o: joptim.apply_updates(ocfg, p, g, o, 2))
    params = jax.tree.map(jnp.asarray, job["params"])
    opt = joptim.init_opt_state(params, 2)
    out = []
    for i, (t, lab) in enumerate(zip(job["tokens"], job["labels"])):
        b = {"tokens": jnp.asarray(t), "labels": jnp.asarray(lab)}
        if "patches" in job:
            b["patches"] = jnp.asarray(job["patches"][i])
        loss, grads = vg(params, b)
        params, opt, gn = update(params, grads, opt)
        out.append((float(loss), float(gn), params, opt))
    return out


def _jax_serve(job):
    """The reference's one-device serving of the job: prefill logits, its
    cache installed in ``init_cache(max_len)`` (a ring re-laid into its
    slots), the first step's logits, each step's tokens, the cache after
    the steps."""
    jcfg, _ = _cfgs(job["arch"])
    params = jax.tree.map(jnp.asarray, job["params"])
    batch = {"tokens": jnp.asarray(job["tokens"])}
    if "patches" in job:
        batch["patches"] = jnp.asarray(job["patches"])
    logits, pc = JT.prefill(jcfg, AX, params, batch)
    n = job["max_len"]
    empty = jax.tree.map(np.asarray, JT.init_cache(jcfg, SERVE_B, n))
    if "pos" in pc:
        cache = _relay(pc, empty)
    else:
        S = np.asarray(next(iter(pc.values()))).shape[2]
        cache = {k: empty[k].copy() for k in pc}
        for k in pc:
            cache[k][:, :, :S] = np.asarray(pc[k])
    cache = jax.tree.map(jnp.asarray, cache)
    step = jax.jit(lambda p, c, t, ln: JT.decode_step_logits(jcfg, AX, p, c,
                                                             t, ln))
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    S0 = job["tokens"].shape[1] + (jcfg.num_patches if "patches" in job
                                   else 0)
    lengths = jnp.asarray(job.get("lengths", np.full((SERVE_B,), S0,
                                                     np.int32)))
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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every tp-2 case in one group of two ranks, and the JAX references,
    computed while the group runs."""
    jobs = [_train_job(MLA), _train_job(VLM)] + [_serve_job(a) for a in
                                                 (MLA, VLM, RING)]
    started = start_groups(tmp_path_factory.mktemp("attn_tp"),
                           [((1, 2), jobs)])
    refs = [_jax_train(j) if j["task"] == "train" else _jax_serve(j)
            for j in jobs]
    res = join_groups(started)[0]
    return jobs, refs, res


def _case(runs, task, arch):
    jobs, refs, res = runs
    i = next(i for i, j in enumerate(jobs)
             if j["task"] == task and j["arch"] == arch)
    return jobs[i], refs[i], [r[i] for r in res]


def _close(got, want, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("arch", [MLA, VLM], ids=["mla", "vision"])
def test_tp_train_step_matches_jax(runs, arch):
    job, want, res = _case(runs, "train", arch)
    _, cfg = _cfgs(arch)
    specs = shd.param_specs(cfg, MeshAxes(), 2, "tp")
    leaves = list(_walk(specs))
    split = sum("model" in sp for _, sp in leaves)
    # MLA's latent projections and norms, and the adapter, replicated
    for path, sp in leaves:
        if path[-1] in TT.MLA_WHOLE + ("adapter",):
            assert sp == (None,) * len(sp), path
    design = dryrun.design_collectives(cfg, "train", 2, 1, 1, TRAIN_S,
                                       len(leaves), split)
    for r in res:
        for (loss, gn, _, _), (got_loss, got_gn, stats, _) in \
                zip(want, r["steps"]):
            _close(got_loss, loss, rtol=1e-5, atol=0)
            _close(got_gn, gn, rtol=1e-4, atol=0)
            assert stats["counts"] == design, (stats["counts"], design)
        _check_steps([s[3] for s in r["steps"]], [w[2:] for w in want])


# ---------------------------------------------------------------- (b)

class _Copies:
    """A stand-in ``copy``: the identity, recording each call's tensors."""

    def __init__(self):
        self.calls, self.out = [], set()

    def __call__(self, *xs):
        ys = tuple(x.view_as(x) for x in xs)
        self.calls.append(len(xs))
        self.out.update(id(y) for y in ys)
        return ys[0] if len(ys) == 1 else ys


def _mla_setup(tp):
    cfg = dataclasses.replace(_cfgs(MLA)[1], num_layers=1)
    stack = TT.init_params(cfg, 3, "cpu")["layers"]
    specs = shd.param_specs(cfg, MeshAxes(), tp, "tp")["layers"]
    gen = torch.Generator().manual_seed(4)
    B, S = 2, 24
    h0 = torch.randn((B, S, cfg.d_model), generator=gen)
    up = torch.randn((B, S, cfg.d_model), generator=gen)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    tab = layers.rope_tables(pos, layers.rope_dim(cfg), cfg.rope_theta)
    locs = [_req(shd.shard_params(stack, specs, _rank(tp, m)))
            for m in range(tp)]
    return cfg, stack, specs, h0, up, pos, tab, locs


def _not_close(got, want):
    with pytest.raises(AssertionError):
        _close_scaled(got, want)


@pytest.mark.parametrize("tp", [2, 4])
def test_mla_attention_share_sums_to_the_sublayer(tp):
    cfg, stack, specs, h0, up, pos, tab, locs = _mla_setup(tp)
    one = _req(stack)
    h1 = h0.clone().requires_grad_(True)
    y1 = TT.attention_share(cfg, _layer(one), h1, pos, tab)
    (y1 * up).sum().backward()
    h8 = h0.clone().requires_grad_(True)
    copies = _Copies()
    y8 = sum(TT.attention_share(cfg, _layer(loc), h8, pos, tab, m, tp,
                                copy=copies) for m, loc in enumerate(locs))
    (y8 * up).sum().backward()
    # one copy a rank: the normed input and the four replicated leaves
    assert copies.calls == [1 + len(TT.MLA_WHOLE)] * tp
    _close_scaled(y8, y1)
    _close_scaled(h8.grad, h1.grad)
    full = _full_grads(one, specs, tp, locs)
    used = [path for path, t in _walk(one) if t.grad is not None]
    assert {p for p in used if p[0] == "attn"} == \
        {p for p, _ in _walk(one) if p[0] == "attn"}
    for path in used:
        _close_scaled(full[path], _get(one, path).grad)
    # wronged: wq_a's gradient left unreduced (one rank's part)
    _not_close(locs[0]["attn"]["wq_a"].grad, one["attn"]["wq_a"].grad)


@pytest.mark.parametrize("tp", [2, 4])
def test_moe_share_with_a_shared_expert_sums_to_the_sublayer(tp,
                                                             monkeypatch):
    cfg, stack, specs, h0, up, pos, tab, locs = _mla_setup(tp)
    assert cfg.num_shared_experts == 1
    one = _req(stack)
    h1 = h0.clone().requires_grad_(True)
    y1, aux1 = TT.ffn_share(cfg, _layer(one), h1)
    ((y1 * up).sum() + aux1).backward()
    seen = []
    mlp = layers.mlp_fwd
    monkeypatch.setattr(moe.layers, "mlp_fwd",
                        lambda c, p, x: seen.append(id(x)) or mlp(c, p, x))
    h8 = h0.clone().requires_grad_(True)
    copies = _Copies()
    parts = [TT.ffn_share(cfg, _layer(loc), h8, m, tp, copy=copies)
             for m, loc in enumerate(locs)]
    y8, aux8 = sum(p[0] for p in parts), sum(p[1] for p in parts)
    ((y8 * up).sum() + aux8).backward()
    # the normed input and the router copied once a rank; the shared
    # expert reads the copied input, once a rank
    assert copies.calls == [1, 1] * tp
    assert len(seen) == tp and set(seen) <= copies.out
    _close_scaled(y8, y1)
    _close_scaled(aux8, aux1)
    _close_scaled(h8.grad, h1.grad)
    full = _full_grads(one, specs, tp, locs)
    used = [path for path, t in _walk(one) if t.grad is not None]
    assert {p for p in used if p[0] == "moe"} == \
        {p for p, _ in _walk(one) if p[0] == "moe"}
    for path in used:
        _close_scaled(full[path], _get(one, path).grad)
    # wronged: the shared expert added whole on every rank
    with torch.no_grad():
        whole = _layer(one)["moe"]["shared"]
        wrong = sum(TT.ffn_share(cfg, dict(_layer(loc), moe=dict(
            _layer(loc)["moe"], shared=whole)), h0, m, tp)[0]
            for m, loc in enumerate(locs))
    _not_close(wrong, y1)


@pytest.mark.parametrize("tp", [2, 4])
def test_vision_embedding_places_the_patches_after_the_reduce(tp):
    _, cfg = _cfgs(VLM)
    params = TT.init_params(cfg, 5, "cpu")
    gen = torch.Generator().manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
    patches = torch.randn((2, cfg.num_patches, cfg.d_model), generator=gen)
    want, wpos = TT._assemble_inputs(cfg, params, tokens, patches)
    Vl = TT.padded_vocab(cfg) // tp

    def share(m):
        return TT.embed_share(cfg, dict(params, embed=params["embed"][
            m * Vl:(m + 1) * Vl]), tokens, m, tp)

    got, pos = TT.place_patches(cfg, params, sum(share(m) for m in
                                                 range(tp)), patches)
    assert torch.equal(got, want) and torch.equal(pos, wpos)
    assert pos.shape == (2, cfg.num_patches + 12)
    # wronged: each rank places the patches before the reduce
    wrong = sum(TT.place_patches(cfg, params, share(m), patches)[0]
                for m in range(tp))
    assert torch.equal(wrong[:, cfg.num_patches:], want[:, cfg.num_patches:])
    _not_close(wrong, want)


# ---------------------------------------------------------------- (c)

@pytest.mark.parametrize("arch", [MLA, VLM, RING],
                         ids=["mla", "vision", "ring"])
def test_serving_cells_match_the_reference(runs, arch):
    job, want, res = _case(runs, "serve", arch)
    _, cfg = _cfgs(arch)
    L, n = cfg.num_layers, job["max_len"]
    S0 = job["tokens"].shape[1] + (cfg.num_patches if "patches" in job
                                   else 0)
    Wd = TT.ring_slots(cfg, n, 2)
    if arch == RING:            # the prompt wrapped the ring
        assert S0 > cfg.sliding_window == Wd
    if arch == MLA:             # a row finishes within the steps
        assert max(job["lengths"]) + SERVE_STEPS > n
    for r in res:
        assert r["recut_equal"]
        shapes = r["cache_shape"]
        if arch == MLA:
            assert shapes == {"ckv": (L, SERVE_B, n // 2, cfg.kv_lora_rank),
                              "kr": (L, SERVE_B, n // 2, cfg.rope_head_dim)}
        elif arch == RING:
            assert shapes["pos"] == (L, SERVE_B, Wd // 2)
            assert shapes["k"] == (L, SERVE_B, Wd // 2, cfg.num_kv_heads,
                                   cfg.head_dim)
        else:
            assert shapes["k"] == (L, SERVE_B, n // 2, cfg.num_kv_heads,
                                   cfg.head_dim)
        for name in ("prefill_logits", "step0_logits"):
            _close(r[name], want[name])
        for stage in ("cache0", "cache_end"):
            assert set(r[stage]) == set(want[stage])
            for k in want[stage]:
                if k == "pos":
                    assert np.array_equal(r[stage][k], want[stage][k])
                else:
                    _close(r[stage][k], want[stage][k])
        for t, (got, w) in enumerate(zip(r["tokens"], want["tokens"])):
            assert np.array_equal(got, w), (t, got, w)
        assert r["prefill_events"] == dryrun.design_collectives(
            cfg, "prefill", 2, 1, 1, S0, 0, 0)
        assert r["prefill_events"].get("all-to-all", 0) == (
            0 if arch == MLA else 2)
        assert r["step_events"] == [dryrun.design_collectives(
            cfg, "decode", 2, 1, 1, n, 0, 0)] * SERVE_STEPS


# ---------------------------------------------------------------- (d)

def test_ring_cells_init_cache_is_empty():
    _, cfg = _cfgs(RING)
    over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for m in range(2):
        mesh = mesh_lib.Mesh(("data", "model"), (1, 2), rank=m)
        dc = steps.build_cell(RING, "decode_32k", mesh, batch_seq=(4, 96),
                              over=over)
        c = dc.init_cache("cpu")
        Wl = cfg.sliding_window // 2
        assert c["pos"].shape == (cfg.num_layers, 4, Wl)
        assert c["pos"].dtype == torch.int32 and (c["pos"] == -1).all()
        assert not c["k"].any() and not c["v"].any()
        assert all(t.is_contiguous() for t in c.values())
    # a ring that does not split over the model group refuses
    with pytest.raises(ValueError, match="ring of 63 slots"):
        steps.build_cell(RING, "decode_32k", mesh_lib.make_test_mesh(1, 2),
                         batch_seq=(4, 96), over=dict(over,
                                                      sliding_window=63))
