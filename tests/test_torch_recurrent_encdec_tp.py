"""The recurrent and encoder-decoder families over a model group, held to
the JAX package on the CPU: Mamba-2's channel split, RecurrentGemma's
RG-LRU blocks and local-attention ring, Whisper's encoder and
cross-attention, in the ``tp`` train step and both serving cells.  fp32,
reduced configs, inputs from ``np.random.default_rng``, weights the
port's ``init_params`` from a seed, as numpy in the layout both packages
take.  Cases:

- (a) ``build_cell``'s train step at (1, 2), two steps over two ``gloo``
  ranks (``tests/torch_dist_worker.py``, one group for every tp-2 case,
  run while the references are computed): Mamba-2 at S 128 (two scan
  chunks), RecurrentGemma with 5 q heads on 1 kv head (so that tp 2 takes
  the ``seq`` mode, as the real 10 heads do at tp 4 and 8) and Whisper;
  losses (rtol 1e-5), grad norms (rtol 1e-4), gathered parameters and
  optimizer state (``test_torch_seq_fsdp._check_steps``) against
  ``jax.value_and_grad(forward_loss)`` and ``apply_updates(n_dev=2)``;
  the collectives each rank sent equal ``dryrun.design_collectives``;
- (b) the shares rank by rank in one process at tp 2 and 4, against the
  one-device sublayer, output and every leaf's gradient (rtol 1e-5, atol
  2e-6 of the tensor's scale; ``A_log``'s and ``dt_bias``'s 1e-4,
  ``SSM_ILL``): the SSM layer (its ranks as threads over
  a stand-in group, ``ThreadGroup``: the gated norm's mean square needs
  every rank's channels), the RG-LRU sublayer, the ring sublayer in the
  ``heads`` mode (10 heads at tp 2) and the ``seq`` mode (tp 4),
  Whisper's encoder layer and decoder layer with cross-attention (4 heads
  at tp 2; 6 heads at tp 4, the ``seq`` mode).  Wronged versions fail:
  the SSM norm over the rank's channels alone, ``wB``'s gradient left
  unreduced, Whisper's decoder positions added on every rank before the
  embedding's reduce;
- (c) the serving cells at (1, 2): a prefill into a longer cache, then
  four decode steps, against the reference's ``prefill`` (its cache
  installed in ``init_cache``'s; the hybrid's ring re-laid by
  ``test_torch_window._jax_decode_cache``) and ``decode_step_logits``:
  tokens equal, prefill and first-step logits and the gathered cache
  after the prefill and after the steps within atol 1e-5 (the SSM's
  cache within 2e-5 of each leaf's scale: ``SSM_CACHE_OF_SCALE``).
  Mamba-2 at S 128; RecurrentGemma with a prompt longer than its window
  (the ring wrapped) and rows whose writes land on each rank; Whisper's cross cache
  split over both ranks and a row that finishes (its writes dropped past
  the cache).  The collectives equal ``dryrun.design_collectives``.
"""
import dataclasses
import threading

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
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.models import layers
from repro_torch.models import transformer as TT
from repro_torch.models.api import MeshAxes
from test_torch_distributed import OCFG, join_groups, start_groups
from test_torch_seq_fsdp import _check_steps
from test_torch_tp_shares import _close as _close_scaled
from test_torch_tp_shares import _full_grads, _get, _rank, _req, _walk
from test_torch_window import _jax_decode_cache

AX = JAxes()
SSM, HYB, ENC = "mamba2_370m", "recurrentgemma_2b", "whisper_base"
TRAIN_B, STEPS = 4, 2
# (sequence, config overrides) a training case
TRAIN = {SSM: (128, {}), HYB: (32, dict(num_heads=5)), ENC: (32, {})}
SERVE_B, SERVE_STEPS = 4, 4
# (prompt tokens, cache positions, first-step lengths or None) a case
SERVE = {SSM: (128, 128, None),
         HYB: (80, 96, [80, 95, 111, 127]),
         ENC: (6, 32, [6, 6, 30, 6])}


def _cfgs(arch, over=None):
    over = over or {}
    return (dataclasses.replace(j_reduced(arch), dtype="float32", **over),
            dataclasses.replace(reduced_config(arch), dtype="float32",
                                **over))


def _np_params(arch, seed, over=None):
    return TT._map_spec(TT.init_params(_cfgs(arch, over)[1], seed, "cpu"),
                        lambda path, t: t.numpy())


def _frames(jcfg, rng, B):
    return rng.standard_normal((B, jcfg.encoder_seq, jcfg.d_model)) \
        .astype(np.float32)


def _train_job(arch):
    S, over = TRAIN[arch]
    jcfg, _ = _cfgs(arch, over)
    rng = np.random.default_rng(70)
    toks = [rng.integers(0, jcfg.vocab_size, (TRAIN_B, S)).astype(np.int32)
            for _ in range(STEPS)]
    labels = [np.roll(t, -1, 1) for t in toks]
    labels[0][:, :3] = -1
    job = dict(task="train", arch=arch, over=over,
               params=_np_params(arch, 71, over), tokens=toks, labels=labels,
               ocfg=OCFG, microbatches=1)
    if jcfg.family == "audio":
        job["frames"] = [_frames(jcfg, rng, TRAIN_B) for _ in range(STEPS)]
    return job


def _serve_job(arch):
    jcfg, _ = _cfgs(arch)
    S, n, lengths = SERVE[arch]
    rng = np.random.default_rng(72)
    job = dict(task="serve", arch=arch, params=_np_params(arch, 73),
               tokens=rng.integers(0, jcfg.vocab_size, (SERVE_B, S))
               .astype(np.int32), max_len=n, steps=SERVE_STEPS)
    if jcfg.family == "audio":
        job["frames"] = _frames(jcfg, rng, SERVE_B)
    if lengths is not None:
        job["lengths"] = np.array(lengths, np.int32)
    return job


# ---------------------------------------------------------------- references

def _jax_train(job):
    """Each step's (loss, grad norm, params, opt state) of the reference
    on one device, on the whole batch."""
    jcfg, _ = _cfgs(job["arch"], job["over"])
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.forward_loss(jcfg, AX, p, b, remat=True)))
    ocfg = joptim.AdamWConfig(**OCFG)
    update = jax.jit(lambda p, g, o: joptim.apply_updates(ocfg, p, g, o, 2))
    params = jax.tree.map(jnp.asarray, job["params"])
    opt = joptim.init_opt_state(params, 2)
    out = []
    for i, (t, lab) in enumerate(zip(job["tokens"], job["labels"])):
        b = {"tokens": jnp.asarray(t), "labels": jnp.asarray(lab)}
        if "frames" in job:
            b["frames"] = jnp.asarray(job["frames"][i])
        loss, grads = vg(params, b)
        params, opt, gn = update(params, grads, opt)
        out.append((float(loss), float(gn), params, opt))
    return out


def _jax_serve(job):
    """The reference's one-device serving of the job: prefill logits, its
    cache in ``init_cache(max_len)``'s layout (K/V in the first S
    positions, the hybrid's rings re-laid, SSM and RG-LRU states as the
    prefill left them), the first step's logits, each step's tokens, the
    cache after the steps."""
    jcfg, _ = _cfgs(job["arch"])
    params = jax.tree.map(jnp.asarray, job["params"])
    batch = {"tokens": jnp.asarray(job["tokens"])}
    if "frames" in job:
        batch["frames"] = jnp.asarray(job["frames"])
    logits, pc = jax.jit(lambda p, b: JT.prefill(jcfg, AX, p, b))(params,
                                                                   batch)
    n, S = job["max_len"], job["tokens"].shape[1]
    if jcfg.family == "hybrid":
        cache = _jax_decode_cache(jcfg, pc, SERVE_B, n)
    elif jcfg.family == "audio":
        cache = jax.tree.map(np.array, JT.init_cache(jcfg, SERVE_B, n))
        for k in ("k", "v"):
            cache[k][:, :, :S] = np.asarray(pc[k])
        for k in ("xk", "xv"):
            cache[k] = np.asarray(pc[k])
        cache = jax.tree.map(jnp.asarray, cache)
    else:
        cache = pc
    step = jax.jit(lambda p, c, t, ln: JT.decode_step_logits(jcfg, AX, p, c,
                                                             t, ln))
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    lengths = jnp.asarray(job.get("lengths", np.full((SERVE_B,), S,
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
    jobs = [_train_job(a) for a in (SSM, HYB, ENC)] + \
        [_serve_job(a) for a in (SSM, HYB, ENC)]
    started = start_groups(tmp_path_factory.mktemp("rec_tp"),
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

@pytest.mark.parametrize("arch", [SSM, HYB, ENC],
                         ids=["ssm", "hybrid_seq", "encdec"])
def test_tp_train_step_matches_jax(runs, arch):
    job, want, res = _case(runs, "train", arch)
    _, cfg = _cfgs(arch, job["over"])
    specs = shd.param_specs(cfg, MeshAxes(), 2, "tp")
    leaves = list(_walk(specs))
    split = sum("model" in sp for _, sp in leaves)
    if arch == HYB:             # the seq mode replicates the attention
        assert TT.seq_split(cfg, 2)
        assert all(sp == (None,) * len(sp) for path, sp in leaves
                   if path[:3] == ("units", "b2", "t"))
    if arch == SSM:             # B and C and their convolutions whole
        for path, sp in leaves:
            if path[-1] in TT.SSM_WHOLE:
                assert sp == (None,) * len(sp), path
    design = dryrun.design_collectives(cfg, "train", 2, 1, 1,
                                       TRAIN[arch][0], len(leaves), split)
    for r in res:
        for (loss, gn, _, _), (got_loss, got_gn, stats, _) in \
                zip(want, r["steps"]):
            _close(got_loss, loss, rtol=1e-5, atol=0)
            _close(got_gn, gn, rtol=1e-4, atol=0)
            assert stats["counts"] == design, (stats["counts"], design)
        _check_steps([s[3] for s in r["steps"]], [w[2:] for w in want])


# ---------------------------------------------------------------- (b)

class _Hub:
    """The slots and barrier of a ``ThreadGroup``."""

    def __init__(self, size):
        self.slots = [None] * size
        self.barrier = threading.Barrier(size, timeout=60)

    def reduce(self, m, x, op):
        self.slots[m] = x
        self.barrier.wait()
        r = self.slots[0]
        for t in self.slots[1:]:
            r = torch.maximum(r, t) if op == "max" else r + t
        self.barrier.wait()
        return r


@dataclasses.dataclass(frozen=True)
class ThreadGroup(C.Group):
    """A model group of ranks run as threads of one process: each
    all-reduce puts the rank's tensor in its slot, waits for every rank
    and folds the slots in rank order; ``copy_in``, ``reduce_out`` and
    ``reduce_whole`` are the group's, over it."""
    hub: object = None

    def all_reduce(self, x, op="sum"):
        return self.hub.reduce(self.rank, x.detach().clone(), op)


def _threads(fns):
    """Each of ``fns`` in a thread; their results in order."""
    res, errs = [None] * len(fns), []

    def run(i):
        try:
            res[i] = fns[i]()
        except BaseException as exc:  # noqa: BLE001 - raised below
            errs.append(exc)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]
    return res


def _setup(arch, tp, over=None, seed=3, S=24):
    _, cfg = _cfgs(arch, over)
    cfg = dataclasses.replace(cfg, num_layers=3 if arch == HYB else 1)
    params = TT.init_params(cfg, seed, "cpu")
    specs = shd.param_specs(cfg, MeshAxes(), tp, "tp")
    gen = torch.Generator().manual_seed(seed + 1)
    B = 2
    h0 = torch.randn((B, S, cfg.d_model), generator=gen)
    up = torch.randn((B, S, cfg.d_model), generator=gen)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    return cfg, params, specs, h0, up, pos


def _layer0(tree):
    return TT._map_spec(tree, lambda path, t: t[0])


def _sub(params, specs, path):
    for k in path:
        params, specs = params[k], specs[k]
    return params, specs


# the SSM leaves whose gradient is ill-conditioned in fp32: a sum over
# every (row, position) of terms through exp(cumsum(dt A)), whose
# cumulative sums reach |873| at S 64; 1e-7 relative noise in the
# output's gradient moves A_log's by 1.6e-5 and dt_bias's by 5e-6 of
# their scale on one device, so they are held to 1e-4 of it
SSM_ILL = ("A_log", "dt_bias")


def _ssm_ranks(cfg, stack, specs, h0, up, tp, *, norm_group=True,
               copy_whole=True):
    """The SSM layer's share on each rank as a thread over a
    ``ThreadGroup``: (the reduced output, each rank's h and local
    leaves with their gradients)."""
    hub = _Hub(tp)
    locs = [_req(shd.shard_params(stack, specs, _rank(tp, m)))
            for m in range(tp)]
    hs = [h0.clone().requires_grad_(True) for _ in range(tp)]

    def rank(m):
        g = ThreadGroup("model", tp, m, hub=hub)
        copy = g.copy_in if copy_whole else \
            (lambda xn, *ws: (g.copy_in(xn),) + ws)
        y = g.reduce_out(TT.ssm_share(cfg, _layer0(locs[m]), hs[m], copy,
                                      g if norm_group else None))
        (y * up).sum().backward()
        return y.detach()

    outs = _threads([lambda m=m: rank(m) for m in range(tp)])
    return outs[0], hs, locs


@pytest.mark.parametrize("tp", [2, 4])
def test_ssm_layer_share_over_threads_is_the_layer(tp):
    cfg, params, specs, h0, up, _ = _setup(SSM, tp, S=64)
    stack, sp = params["layers"], specs["layers"]
    one = _req(stack)
    h1 = h0.clone().requires_grad_(True)
    y1 = TT.ssm_share(cfg, _layer0(one), h1)
    (y1 * up).sum().backward()
    y, hs, locs = _ssm_ranks(cfg, stack, sp, h0, up, tp)
    _close_scaled(y, y1)
    for h in hs:                # every rank's h gets the whole gradient
        _close_scaled(h.grad, h1.grad)
    # a split leaf's slices from their ranks; a whole leaf (SSM_WHOLE,
    # the norm) from rank 0, whose copy summed the ranks' parts
    full = _full_grads(one, sp, tp, locs)
    for path, t in _walk(one):
        got = _get(locs[0], path).grad if all(
            e is None for e in _get(sp, path)) else full[path]
        if path[-1] in SSM_ILL:
            want = t.grad.double().numpy()
            np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                                       atol=1e-4 * np.abs(want).max())
        else:
            _close_scaled(got, t.grad)
    # wronged: the gated norm over the rank's channels alone
    wrong, _, _ = _ssm_ranks(cfg, stack, sp, h0, up, tp, norm_group=False)
    with pytest.raises(AssertionError):
        _close_scaled(wrong, y1)
    # wronged: wB's gradient left unreduced (rank 0's part)
    _, _, parts = _ssm_ranks(cfg, stack, sp, h0, up, tp, copy_whole=False)
    with pytest.raises(AssertionError):
        _close_scaled(parts[0]["ssm"]["wB"].grad, one["ssm"]["wB"].grad)


def _summed(run, stack, specs, h0, up, tp, extra=()):
    """``run(p, h, m, tp, *extra)`` on one device and summed over the
    ranks (the all-reduce without a group; ``copy`` the identity, so a
    whole leaf's gradient is the sum of the ranks' parts) on layer 0 of
    ``stack``: the outputs and the gradients of h, of the ``extra``
    inputs and of every leaf, each pair held to the scaled tolerance."""
    lsp = TT._map_spec(specs, lambda path, sp: sp[1:])
    one = _req(_layer0(stack))
    locs = [_req(_layer0(shd.shard_params(stack, specs, _rank(tp, m))))
            for m in range(tp)]
    sides = []
    for n, ps in ((1, [one]), (tp, locs)):
        h = h0.clone().requires_grad_(True)
        xs = [x.clone().requires_grad_(True) for x in extra]
        y = sum(run(p, h, m, n, *xs) for m, p in enumerate(ps))
        (y * up).sum().backward()
        sides.append([y, h.grad] + [x.grad for x in xs])
    for got, want in zip(sides[1], sides[0]):
        _close_scaled(got, want)
    full = _full_grads(one, lsp, tp, locs)
    used = [path for path, t in _walk(one) if t.grad is not None]
    assert used
    for path in used:
        _close_scaled(full[path], _get(one, path).grad)
    return locs


@pytest.mark.parametrize("tp", [2, 4])
def test_rglru_sublayer_share_sums_to_the_sublayer(tp):
    cfg, params, specs, h0, up, _ = _setup(HYB, tp)
    stack, sp = _sub(params, specs, ("units", "b0"))
    locs = _summed(lambda p, h, m, n: TT.rglru_share(cfg, p, h), stack, sp,
                   h0, up, tp)
    # the rank's gate blocks are its channels' (16 blocks over tp)
    assert locs[0]["t"]["Wa"].shape[0] == 16 // tp
    assert locs[0]["t"]["lam"].shape[0] == cfg.lru_width // tp


@pytest.mark.parametrize("tp,heads", [(2, 10), (4, 10)],
                         ids=["heads-tp2", "seq-tp4"])
def test_ring_sublayer_share_sums_to_the_sublayer(tp, heads):
    cfg, params, specs, h0, up, pos = _setup(HYB, tp, dict(num_heads=heads),
                                             S=80)
    assert TT.seq_split(cfg, tp) == (tp == 4)
    assert h0.shape[1] > cfg.local_window      # the window cuts keys
    tab = layers.rope_tables(pos, layers.rope_dim(cfg), cfg.rope_theta)
    stack, sp = _sub(params, specs, ("units", "b2"))
    _summed(lambda p, h, m, n: TT.attention_share(
        cfg, p, h, pos, tab, m, n, leaves="t", window=cfg.local_window),
        stack, sp, h0, up, tp)


@pytest.mark.parametrize("tp,heads", [(2, 4), (4, 6)],
                         ids=["heads-tp2", "seq-tp4"])
def test_encoder_and_decoder_layer_shares_sum_to_the_layers(tp, heads):
    cfg, params, specs, h0, up, pos = _setup(ENC, tp, dict(num_heads=heads))
    assert TT.seq_split(cfg, tp) == (tp == 4)
    # the encoder layer: non-causal self-attention and the MLP
    stack, sp = params["enc_layers"], specs["enc_layers"]
    _summed(lambda p, h, m, n: TT.attention_share(cfg, p, h, pos, None, m, n,
                                                  causal=False),
            stack, sp, h0, up, tp)
    _summed(lambda p, h, m, n: TT.ffn_share(cfg, p, h, m, n)[0], stack, sp,
            h0, up, tp)
    # the decoder layer: causal self-attention, the cross-attention on
    # the encoder's states (their gradient summed over the ranks), the
    # MLP after ln3
    stack, sp = params["layers"], specs["layers"]
    _summed(lambda p, h, m, n: TT.attention_share(cfg, p, h, pos, None, m,
                                                  n), stack, sp, h0, up, tp)
    gen = torch.Generator().manual_seed(9)
    Se = cfg.encoder_seq
    enc = torch.randn((2, Se, cfg.d_model), generator=gen)
    enc_pos = torch.arange(Se, dtype=torch.int32)[None].expand(2, Se)
    _summed(lambda p, h, m, n, e: TT.attention_share(
        cfg, p, h, pos, None, m, n, leaves="xattn", norm="ln2",
        causal=False, states=(e, enc_pos)), stack, sp, h0, up, tp, (enc,))
    _summed(lambda p, h, m, n: TT.ffn_share(cfg, p, h, m, n, norm="ln3")[0],
            stack, sp, h0, up, tp)


@pytest.mark.parametrize("tp", [2, 4])
def test_decoder_positions_are_added_after_the_embeddings_reduce(tp):
    _, cfg = _cfgs(ENC)
    params = TT.init_params(cfg, 5, "cpu")
    gen = torch.Generator().manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
    want, wpos = TT._assemble_inputs(cfg, params, tokens)
    Vl = TT.padded_vocab(cfg) // tp

    def share(m):
        return TT.embed_share(cfg, dict(params, embed=params["embed"][
            m * Vl:(m + 1) * Vl]), tokens, m, tp)

    got, pos = TT.embed_finish(cfg, params, sum(share(m) for m in range(tp)))
    assert torch.equal(got, want) and torch.equal(pos, wpos)
    # wronged: each rank adds the positions before the reduce
    wrong = sum(TT.embed_finish(cfg, params, share(m))[0] for m in range(tp))
    with pytest.raises(AssertionError):
        _close_scaled(wrong, want)


# ---------------------------------------------------------------- (c)

# the SSM's cache against JAX, to 2e-5 of each leaf's largest magnitude:
# the one-device port (whose bits this slice keeps) is itself 1.2e-5 from
# JAX in conv_x and 1.0e-4 in the state (1.0e-5 of its scale) at S 128,
# the SSD's exponentials of cumulative sums amplifying the frameworks'
# rounding
SSM_CACHE_OF_SCALE = 2e-5


def _assert_tree_close(got, want, path=(), of_scale=0.0):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_tree_close(got[k], want[k], path + (k,), of_scale)
    elif path[-1] == "pos":
        assert np.array_equal(got, want), path
    else:
        _close(got, want, atol=max(1e-5, of_scale * np.abs(want).max()))


@pytest.mark.parametrize("arch", [SSM, HYB, ENC],
                         ids=["ssm", "hybrid_ring", "encdec"])
def test_serving_cells_match_the_reference(runs, arch):
    job, want, res = _case(runs, "serve", arch)
    _, cfg = _cfgs(arch)
    L, n = cfg.num_layers, job["max_len"]
    S0 = job["tokens"].shape[1]
    if arch == HYB:             # the prompt wrapped the ring
        Wd = TT.ring_slots(cfg, n, 2)
        assert S0 > cfg.local_window == Wd
    if arch == ENC:             # a row finishes within the steps
        assert max(job["lengths"]) + SERVE_STEPS > n
    for r in res:
        assert r["recut_equal"]
        shapes = r["cache_shape"]
        if arch == SSM:
            assert shapes["state"] == (L, SERVE_B, cfg.ssm_heads // 2,
                                       cfg.ssm_state, cfg.ssm_head_dim)
            assert shapes["conv_x"][-1] == cfg.d_inner // 2
            assert shapes["conv_B"][-1] == cfg.ssm_state
        elif arch == HYB:
            assert shapes["units"]["b2"]["pos"] == (1, SERVE_B, Wd // 2)
            assert shapes["units"]["b0"]["state"] == (
                1, SERVE_B, cfg.lru_width // 2)
            assert shapes["tail"]["conv"][-1] == cfg.lru_width // 2
        else:
            assert shapes["k"] == (L, SERVE_B, n // 2, cfg.num_kv_heads,
                                   cfg.head_dim)
            assert shapes["xk"] == (L, SERVE_B, cfg.encoder_seq // 2,
                                    cfg.num_kv_heads, cfg.head_dim)
        for name in ("prefill_logits", "step0_logits"):
            _close(r[name], want[name])
        for stage in ("cache0", "cache_end"):
            _assert_tree_close(r[stage], want[stage], of_scale=(
                SSM_CACHE_OF_SCALE if arch == SSM else 0.0))
        for t, (got, w) in enumerate(zip(r["tokens"], want["tokens"])):
            assert np.array_equal(got, w), (t, got, w)
        assert r["prefill_events"] == dryrun.design_collectives(
            cfg, "prefill", 2, 1, 1, S0, 0, 0)
        assert r["prefill_events"].get("all-to-all", 0) == {
            SSM: 0, HYB: 2, ENC: 4}[arch]
        assert r["step_events"] == [dryrun.design_collectives(
            cfg, "decode", 2, 1, 1, n, 0, 0)] * SERVE_STEPS
