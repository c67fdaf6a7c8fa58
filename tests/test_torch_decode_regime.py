"""The port's serving cells over a mesh, held to the JAX package on the CPU:
``build_cell``'s ``decode`` kind over a sequence-split KV cache
(``paged_attention`` with its log-sum-exp, the shards merged across the
model group) and its ``prefill`` kind, which hands the cache over in the
decode layout.  fp32, inputs from ``np.random.default_rng(seed)``,
weights from the JAX package's ``init_params``.  Cases:

- (a) the plain ``paged_attention``'s ``lse`` against ``jax.nn.logsumexp``
  of the reference's masked scaled scores, length-0 rows among them
  (atol 1e-5); its output unchanged by asking for it;
- (b) ``decode_attention_shard`` rank by rank in one process and
  ``merge_shards`` over a stand-in group that sums or maxes the ranks'
  tensors, at tp 2 and 4, against ``repro.models.layers.
  decode_attention`` on the whole cache: rows ending in every shard, at
  a shard boundary, at 0 and at S (atol 1e-5);
- the heads -> sequence re-layout of a prefill's cache, with tagged
  values, at Qwen3-30B-A3B's 4 kv heads over tp 8 (each kv head taken
  from its first owner, ranks 0, 2, 4, 6) and Llama-3.2-1B's 8 over 4;
- (c) the cells over two ``gloo`` processes (``tests/torch_dist_worker.py``
  through ``test_torch_distributed.run_groups``), reduced Llama-3.2-1B
  at (1, 2) and (2, 1) and reduced Qwen3-30B-A3B with one kv head
  (replicated at tp 2) at (1, 2): a 14-token prefill into a cache of 32
  (16 positions a rank at tp 2, so the steps cross the boundary), then
  4 decode steps, against the reference's one-device ``prefill`` (its
  cache installed in ``init_cache``'s) and ``decode_step``: tokens equal,
  prefill and first-step logits and the gathered cache after the prefill
  and after the steps within atol 1e-5;
- (d) the collectives the design predicts: a decode step at tp 2 1 + 3 L
  all-reduces (the embedding; a layer's lse max, merged sum and FFN)
  and one all-gather (the argmax); a prefill at tp 2 1 + 2 L
  all-reduces, one all-gather (the logits) and two all-to-alls (the
  cache's k and v); over data ranks only, none;
- (e) a (1, 1) mesh's cells equal to the one-device ``prefill`` and
  ``decode_step`` bit for bit, with the collectives skipped and with
  them sent through a stand-in group of one (the sharded code path at
  tp 1);
- (f) the refusals: the SSM, the hybrid and the encoder-decoder wait;
  MLA, the vision decoder and the window's ring build.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.api import MeshAxes as JAxes
from repro_torch.configs import get_config, reduced_config
from repro_torch.distributed import collectives as C
from repro_torch.kernels.paged_attention.ops import NEG, paged_attention_plain
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import layers
from repro_torch.models import transformer as TT
from test_torch_distributed import run_groups

AX = JAxes()
ATOL = 1e-5
KV1 = dict(num_kv_heads=1)
B, S, MAX_LEN, STEPS = 4, 14, 32, 4


def _cfgs(arch, **over):
    return (dataclasses.replace(j_reduced(arch), dtype="float32", **over),
            dataclasses.replace(reduced_config(arch), dtype="float32",
                                **over))


def _close(got, want, atol=ATOL, rtol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- (a), (b)

def _jax_scores(q, k, lengths):
    """The reference's masked scaled scores (B, Hkv, G, 1, S), as its
    ``decode_attention`` forms them."""
    Bq, _, H, dh = q.shape
    Hkv = k.shape[2]
    qg = jnp.asarray(q).reshape(Bq, 1, Hkv, H // Hkv, dh)
    s = jnp.einsum("bqhgd,bshd->bhgqs", qg * (1.0 / np.sqrt(dh)),
                   jnp.asarray(k))
    pos = jnp.arange(k.shape[1])[None, :]
    mask = pos < jnp.asarray(lengths)[:, None]
    return jnp.where(mask[:, None, None, None, :], s, -1e30)


def test_plain_lse_matches_jax_logsumexp():
    rng = np.random.default_rng(0)
    Bq, Sk, H, Hkv, dh, page = 5, 48, 8, 2, 32, 16
    q = rng.standard_normal((Bq, 1, H, dh)).astype(np.float32)
    k = rng.standard_normal((Bq, Sk, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((Bq, Sk, Hkv, dh)).astype(np.float32)
    lengths = np.array([0, 1, 17, 48, 0], np.int32)
    # the cache as a pool of shuffled pages
    n_pages = Bq * Sk // page
    perm = rng.permutation(n_pages)
    kp = np.zeros((n_pages, page, Hkv, dh), np.float32)
    vp = np.zeros_like(kp)
    kp[perm] = k.reshape(n_pages, page, Hkv, dh)
    vp[perm] = v.reshape(n_pages, page, Hkv, dh)
    table = perm.reshape(Bq, Sk // page).astype(np.int32)
    args = [torch.from_numpy(x) for x in (q[:, 0], kp, vp, table, lengths)]
    lse = torch.empty((Bq, H))
    out = paged_attention_plain(*args, lse=lse)
    assert torch.equal(out, paged_attention_plain(*args))
    want = jax.nn.logsumexp(_jax_scores(q, k, lengths), axis=-1)
    _close(lse, np.asarray(want).reshape(Bq, H))
    assert (lse[lengths == 0] == NEG).all()
    # a length-0 row: zeros here, the reference's a mean of every value
    # (ROADMAP Queue C); the others equal
    live = lengths > 0
    assert not out[~live].any()
    _close(out[live], np.asarray(JL.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths)))[live, 0])


class ListGroup:
    """A stand-in model group over the ranks' tensors stacked on dim 0:
    its all-reduce folds them in rank order (sum or max) and hands every
    rank the result."""
    trivial = False

    def __init__(self, size):
        self.size = size

    def all_reduce(self, x, op="sum"):
        fold = torch.maximum if op == "max" else torch.add
        r = functools.reduce(fold, list(x))
        return torch.stack([r] * self.size)


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_merge_to_the_whole_cache(tp):
    rng = np.random.default_rng(tp)
    Sk, H, Hkv, dh = 64, 8, 2, 32
    S_l = Sk // tp
    # rows ending in every shard, at each shard boundary, empty and full
    lengths = sorted({0, Sk, 1, S_l, S_l + 1, Sk - 1}
                     | {m * S_l + 3 for m in range(tp)}
                     | {m * S_l for m in range(1, tp)})
    Bq = len(lengths)
    lengths = np.array(lengths, np.int32)
    q = rng.standard_normal((Bq, 1, H, dh)).astype(np.float32)
    k = rng.standard_normal((Bq, Sk, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((Bq, Sk, Hkv, dh)).astype(np.float32)
    tq, tl = torch.from_numpy(q), torch.from_numpy(lengths)
    parts = [layers.decode_attention_shard(
        tq, torch.from_numpy(k[:, m * S_l:(m + 1) * S_l]).contiguous(),
        torch.from_numpy(v[:, m * S_l:(m + 1) * S_l]).contiguous(), tl, m,
        S_l) for m in range(tp)]
    o = torch.stack([p[0] for p in parts])
    lse = torch.stack([p[1] for p in parts])
    assert o.shape == (tp, Bq, 1, H, dh) and lse.shape == (tp, Bq, 1, H)
    # a rank that holds none of a row says so
    for m in range(tp):
        empty = (lengths <= m * S_l)
        assert (lse[m][empty] == NEG).all() and not o[m][empty].any()
    got = layers.merge_shards(o, lse, ListGroup(tp))
    want = np.asarray(JL.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths)))
    live = lengths > 0
    for m in range(tp):
        _close(got[m][live], want[live])
    assert not got[:, ~live].any()
    # the one-device kernel path agrees
    _close(got[0], layers.decode_attention(tq, torch.from_numpy(k),
                                           torch.from_numpy(v), tl))


@pytest.mark.parametrize("arch,tp,owners", [
    ("qwen3_moe_30b", 8, [0, 2, 4, 6]),
    ("llama3_2_1b", 4, [0, 0, 1, 1, 2, 2, 3, 3])])
def test_prefill_cache_takes_each_kv_head_from_its_first_owner(arch, tp,
                                                               owners):
    """Each rank's K of its kv heads over every position, tagged with (its
    rank, the position, the head's global index), re-laid as
    ``_to_decode_layout`` does (``seq_blocks``, the all-to-all as the
    exchange of blocks between ranks, ``heads_of_blocks``): rank m holds
    positions [m S_l, (m+1) S_l) of every kv head, each from its first
    owner, zeros past the prompt."""
    cfg = get_config(arch)
    L, Bq, Sp, n, dh = 2, 1, 40, 64, 1
    S_l = n // tp
    assert [r for r, _ in TT.kv_owners(cfg, tp)] == owners
    sent = []
    for r in range(tp):
        if cfg.num_kv_heads % tp == 0:
            lo, hi = r * cfg.num_kv_heads // tp, (r + 1) * cfg.num_kv_heads // tp
        else:
            lo, hi = layers.kv_heads_of_rank(cfg, r, tp)
        t = torch.zeros((L, Bq, Sp, hi - lo, dh))
        for j in range(lo, hi):
            t[:, :, :, j - lo, 0] = (1000 * r + torch.arange(Sp) + 1
                                     + 1e5 * j)[None, None]
        sent.append(TT.seq_blocks(t, tp, n))
    for m in range(tp):
        recv = torch.stack([sent[r][m] for r in range(tp)])
        got = TT.heads_of_blocks(cfg, recv, tp)
        assert got.shape == (L, Bq, S_l, cfg.num_kv_heads, dh)
        assert got.is_contiguous()
        for j, r in enumerate(owners):
            pos = torch.arange(m * S_l, (m + 1) * S_l)
            want = torch.where(pos < Sp, 1000 * r + pos + 1 + 1e5 * j, 0.0)
            assert torch.equal(got[0, 0, :, j, 0], want), (m, j)


# ---------------------------------------------------------------- (c), (d)

def _np_params(jcfg, seed):
    return jax.tree.map(np.asarray,
                        JT.init_params(jcfg, jax.random.PRNGKey(seed)))


def _serve_job(arch, over, seed):
    jcfg, _ = _cfgs(arch, **over)
    rng = np.random.default_rng(40 + seed)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return dict(task="serve", arch=arch, over=over,
                params=_np_params(jcfg, seed), tokens=toks, max_len=MAX_LEN,
                steps=STEPS)


MESHES = {(1, 2): lambda: [_serve_job("llama3_2_1b", {}, 1),
                           _serve_job("qwen3_moe_30b", KV1, 2)],
          (2, 1): lambda: [_serve_job("llama3_2_1b", {}, 1)]}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    groups = [(sizes, make()) for sizes, make in MESHES.items()]
    res = run_groups(tmp_path_factory.mktemp("serve"), groups)
    return {sizes: (jobs, r) for (sizes, jobs), r in zip(groups, res)}


@functools.lru_cache(maxsize=None)
def _reference(arch, over_items):
    """The reference's one-device serving of a job: prefill logits, its
    cache installed in ``init_cache(MAX_LEN)``, the first step's logits,
    each step's tokens, and the cache after the steps."""
    job = _serve_job(arch, dict(over_items), 1 if arch == "llama3_2_1b"
                     else 2)
    jcfg, _ = _cfgs(arch, **dict(over_items))
    params = jax.tree.map(jnp.asarray, job["params"])
    logits, pc = jax.jit(lambda p, t: JT.prefill(jcfg, AX, p, {"tokens": t}))(
        params, jnp.asarray(job["tokens"]))
    cache = {n: JT.init_cache(jcfg, B, MAX_LEN)[n].at[:, :, :S].set(pc[n])
             for n in ("k", "v")}
    step = jax.jit(lambda p, c, t, ln: JT.decode_step_logits(jcfg, AX, p, c,
                                                             t, ln))
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    lengths = jnp.full((B,), S, jnp.int32)
    out = {"prefill_logits": np.asarray(logits), "cache0": jax.tree.map(
        np.asarray, cache), "tokens": [np.asarray(tok)]}
    for i in range(STEPS):
        lg, cache = step(params, cache, tok, lengths)
        if i == 0:
            out["step0_logits"] = np.asarray(lg)
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        lengths = lengths + 1
        out["tokens"].append(np.asarray(tok))
    out["cache_end"] = jax.tree.map(np.asarray, cache)
    return out


CASES = [("llama3_2_1b", {}, (1, 2)), ("llama3_2_1b", {}, (2, 1)),
         ("qwen3_moe_30b", KV1, (1, 2))]
IDS = ["llama-model2", "llama-data2", "qwen3-kv1-model2"]


def _results(groups, sizes, arch):
    jobs, res = groups[sizes]
    i = next(i for i, j in enumerate(jobs) if j["arch"] == arch)
    return [r[i] for r in res]


@pytest.mark.parametrize("arch,over,sizes", CASES, ids=IDS)
def test_serving_cells_match_the_reference(groups, arch, over, sizes):
    want = _reference(arch, tuple(sorted(over.items())))
    data, tp = sizes
    rows = B // data
    for rank, r in enumerate(_results(groups, sizes, arch)):
        c = rank // tp
        sl = slice(c * rows, (c + 1) * rows)
        # each rank's own shard of the cache: its rows and S_l positions
        assert r["cache_shape"]["k"] == (2, rows, MAX_LEN // tp, 1 if over
                                         else 2, 32)
        assert r["recut_equal"]         # shard_cache(gather_cache(c)) == c
        _close(r["prefill_logits"], want["prefill_logits"][sl])
        _close(r["step0_logits"], want["step0_logits"][sl])
        for name in ("k", "v"):
            _close(r["cache0"][name], want["cache0"][name])
            _close(r["cache_end"][name], want["cache_end"][name])
        for t, (got, w) in enumerate(zip(r["tokens"], want["tokens"])):
            assert np.array_equal(got, w[sl]), (t, got, w[sl])
        assert (r["lengths"] == S + STEPS).all()


@pytest.mark.parametrize("arch,over,sizes", CASES, ids=IDS)
def test_serving_collectives_are_the_designs(groups, arch, over, sizes):
    L = reduced_config(arch).num_layers
    for r in _results(groups, sizes, arch):
        if sizes[-1] == 1:      # over data ranks only: nothing is sent
            assert r["prefill_events"] == {}
            assert r["step_events"] == [{}] * STEPS
            continue
        assert r["prefill_events"] == {"all-reduce": 1 + 2 * L,
                                       "all-gather": 1, "all-to-all": 2}
        assert r["step_events"] == [{"all-reduce": 1 + 3 * L,
                                     "all-gather": 1}] * STEPS


# ---------------------------------------------------------------- (e)

class SentOne:
    """A model group of one whose collectives are sent (not skipped),
    each returning a copy of its input, as one rank's NCCL or gloo call
    does: the sharded code path at tp 1, without a process group (its
    ``reduce_out`` and ``copy_in`` as forward: serving differentiates
    nothing)."""
    trivial, size, rank = False, 1, 0

    def __init__(self):
        self.calls = []

    def _call(self, kind, x):
        self.calls.append(kind)
        return x.detach().clone()

    def all_reduce(self, x, op="sum"):
        return self._call("all-reduce", x)

    def all_gather(self, x):
        return self._call("all-gather", x)

    def all_to_all(self, x):
        return self._call("all-to-all", x)

    def reduce_out(self, x):
        return self.all_reduce(x)

    def copy_in(self, *xs):
        return xs[0] if len(xs) == 1 else xs


@pytest.mark.parametrize("arch", ["llama3_2_1b", "qwen3_moe_30b"])
def test_one_rank_cells_are_the_one_device_functions(arch):
    _, cfg = _cfgs(arch)
    over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    mesh = mesh_lib.Mesh(("data", "model"), (1, 1), rank=0)
    job = _serve_job(arch, {}, 3)
    toks = torch.from_numpy(job["tokens"])
    p0 = TT.init_params(cfg, 3, "cpu")
    l0, c0 = TT.prefill(cfg, p0, toks)
    c0 = TT.install_cache(cfg, TT.init_cache(cfg, B, MAX_LEN, "cpu"), c0)
    want = [torch.argmax(l0[:, -1], -1).to(torch.int32)]
    lengths = torch.full((B,), S, dtype=torch.int32)
    for i in range(STEPS):
        t, c0 = TT.decode_step(cfg, p0, c0, want[-1], lengths + i)
        want.append(t)
    L = cfg.num_layers
    for sent in (False, True):
        group = SentOne()
        m = dataclasses.replace(mesh, comm=C.Comm(model=group)) if sent \
            else mesh
        pc = steps.build_cell(arch, "prefill_32k", m, batch_seq=(B, S),
                              over=over, max_len=MAX_LEN)
        dc = steps.build_cell(arch, "decode_32k", m, batch_seq=(B, MAX_LEN),
                              over=over)
        p1 = pc.init_state(3, "cpu")
        assert all(torch.equal(a, b) for a, b in zip(
            _leaves(dc.init_state(3, "cpu")), _leaves(p0)))
        l1, c1 = pc.step(p1, {"tokens": toks})
        assert torch.equal(l1, l0)
        assert group.calls == (["all-reduce"] * (1 + 2 * L) + ["all-gather"]
                               + ["all-to-all"] * 2 if sent else [])
        got = [torch.argmax(l1[:, -1], -1).to(torch.int32)]
        ln = torch.full((B,), S, dtype=torch.int32)
        for _ in range(STEPS):
            group.calls.clear()
            t, c1, ln = dc.step(p1, c1, got[-1], ln)
            got.append(t)
            assert group.calls == (["all-reduce"] * (1 + 3 * L)
                                   + ["all-gather"] if sent else [])
        assert all(torch.equal(a, b) for a, b in zip(got, want)), sent
        assert all(torch.equal(c1[k], c0[k]) for k in ("k", "v")), sent


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


# ---------------------------------------------------------------- (f)

def test_refusals():
    m2 = mesh_lib.make_test_mesh(1, 2)
    # the SSM, the RG-LRU hybrid and the encoder-decoder serve; where
    # their rules leave a part replicated, or the hybrid's ring does not
    # split, the cell refuses, naming it
    # (31 SSM heads over 2; 16 gate blocks over 32 ranks)
    for arch, item, over, tp in (
            ("mamba2_370m", "SSM channels", dict(d_model=1000), 2),
            ("recurrentgemma_2b", "RG-LRU gate blocks", None, 32),
            ("whisper_base", "replicated MLP", dict(d_ff=2049), 2)):
        for shape, cell in (("decode_32k", steps.DecodeCell),
                            ("prefill_32k", steps.PrefillCell)):
            assert isinstance(steps.build_cell(arch, shape, m2), cell)
            with pytest.raises(NotImplementedError, match=item):
                steps.build_cell(arch, shape, mesh_lib.make_test_mesh(1, tp),
                                 over=over)
    with pytest.raises(ValueError, match="ring of 2047 slots"):
        steps.build_cell("recurrentgemma_2b", "decode_32k", m2,
                         over=dict(local_window=2047))
    # MLA's latent cache, the vision decoder and the window's ring serve
    for arch in ("deepseek_r1", "pixtral_12b", "h2o_danube_1_8b"):
        assert isinstance(steps.build_cell(arch, "prefill_32k", m2),
                          steps.PrefillCell)
        assert isinstance(steps.build_cell(arch, "decode_32k", m2),
                          steps.DecodeCell)
    # a prefill runs the q-head split, or where the heads do not split
    # (qwen2's 14 over 4 ranks) the seq mode; its decode replicates the
    # attention
    m4 = mesh_lib.make_test_mesh(1, 4)
    pc = steps.build_cell("qwen2_0_5b", "prefill_32k", m4)
    assert isinstance(pc, steps.PrefillCell) and pc.note == "attention=seq"
    assert isinstance(steps.build_cell("qwen2_0_5b", "decode_32k", m4),
                      steps.DecodeCell)
    m3 = mesh_lib.make_test_mesh(1, 3)
    with pytest.raises(NotImplementedError, match="replicated vocabulary"):
        steps.build_cell("qwen2_0_5b", "decode_32k", m3)
    with pytest.raises(NotImplementedError, match="replicated MLP"):
        steps.build_cell("llama3_2_1b", "decode_32k", m3)
    with pytest.raises(NotImplementedError, match="replicated experts"):
        steps.build_cell("phi3_5_moe", "decode_32k", m3)
    # the cache must split over the model axis; a decode cell's is its
    # sequence
    with pytest.raises(ValueError, match="does not split"):
        steps.build_cell("llama3_2_1b", "decode_32k", m4,
                         batch_seq=(8, 30))
    with pytest.raises(ValueError, match="max_len"):
        steps.build_cell("llama3_2_1b", "decode_32k", m4, max_len=64)
    with pytest.raises(ValueError, match="abstract"):
        steps.build_cell("llama3_2_1b", "decode_32k", m4).comm
