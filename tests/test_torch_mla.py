"""MLA (DeepSeek-R1's latent attention) in the port, held to the JAX package
on the CPU.

Reduced ``deepseek_r1`` in fp32 (2 layers, d_model 128, 4 heads of
head_dim 32 + rope_head_dim 16, q_lora 64, kv_lora 32, 4 experts top-2
and one shared expert).  Weights come from the JAX package's
``init_params`` and reach the port through ``params_from_numpy``; other
inputs are made with numpy from a seed.  Tolerances: 1e-5 abs/rel for
single functions; 1e-4 for whole forwards, as in ``test_torch_model.py``
(the two frameworks' summation orders differ and their errors add up over
the layers); tokens must be identical.

The engine legs serve the greedy workload of ``test_torch_engine.py``
(its second submit has a cross-submit prefix hit, whose tail runs through
``mla_decode``) and its sampled workload with logprobs through each
package's ``BatchMaster`` and ``NodeEngine`` (monolithic: module
granularity refuses MLA in both packages).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig
from repro.kernels.flash_attention.flash_attention import flash_attention_tpu
from repro.models import flash as jflash
from repro.models import layers as jl
from repro.models import transformer as JT
from repro.models.api import MeshAxes
from repro.runtime.api import BatchMaster as JBatchMaster
from repro.runtime.api import BatchRequest as JBatchRequest
from repro.runtime.engine import NodeEngine as JNodeEngine
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import flash as tflash
from repro_torch.models import layers as tl
from repro_torch.models import transformer as TT
from repro_torch.runtime.api import BatchMaster, BatchRequest
from repro_torch.runtime.engine import NodeEngine
from test_torch_engine import (PAGE, _sampled_parity, _serve,
                               _spy_host_pages, _workload)

AXES = MeshAxes()
TOL = dict(atol=1e-5, rtol=1e-5)
FWD_TOL = dict(atol=1e-4, rtol=1e-4)
ENGINE_KW = dict(max_active=3, max_len=128, page_size=PAGE)


def _cfgs():
    return (dataclasses.replace(j_reduced("deepseek_r1"), dtype="float32"),
            dataclasses.replace(reduced_config("deepseek_r1"),
                                dtype="float32"))


def _np_params(jcfg, seed=0):
    return jax.tree.map(np.asarray,
                        JT.init_params(jcfg, jax.random.PRNGKey(seed)))


def _layer0(jcfg, tcfg, seed=0):
    """Layer 0's attention params in both packages."""
    np_params = _np_params(jcfg, seed)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      np_params["layers"]["attn"])
    tp = TT._per_layer(TT.params_from_numpy(np_params, tcfg,
                                            device="cpu"))[0]["attn"]
    return jp, tp


def _x_pos(rng, B, S, D):
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return x, pos


def test_reduced_config_is_mla():
    jcfg, tcfg = _cfgs()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.use_mla and tcfg.num_shared_experts == 1
    full = get_config("deepseek_r1")
    assert (full.d_model, full.num_heads, full.head_dim, full.rope_head_dim,
            full.q_lora_rank, full.kv_lora_rank, full.num_experts,
            full.experts_per_token, full.moe_d_ff, full.shared_d_ff,
            full.vocab_size) == (7168, 128, 128, 64, 1536, 512, 256, 8,
                                 2048, 2048, 129280)


def test_mla_project_matches():
    jcfg, tcfg = _cfgs()
    jp, tp = _layer0(jcfg, tcfg)
    x, pos = _x_pos(np.random.default_rng(1), 2, 12, jcfg.d_model)
    pos[1] += 37                              # rows at other positions
    want = jl.mla_project(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    got = tl.mla_project(tcfg, tp, torch.from_numpy(x),
                         torch.from_numpy(pos))
    for name, g, w in zip(("q_nope", "q_rope", "c_kv", "k_rope"), got,
                          want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("S", [16, 64])
def test_mla_fwd_output_and_latent_cache_match(S):
    jcfg, tcfg = _cfgs()
    jp, tp = _layer0(jcfg, tcfg)
    x, pos = _x_pos(np.random.default_rng(S), 2, S, jcfg.d_model)
    want, (wc, wr) = jl.mla_fwd(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    got, (gc, gr) = tl.mla_fwd(tcfg, tp, torch.from_numpy(x),
                               torch.from_numpy(pos))
    assert got.shape == (2, S, tcfg.d_model)
    assert gc.shape == (2, S, tcfg.kv_lora_rank)
    assert gr.shape == (2, S, tcfg.rope_head_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), **TOL)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), **TOL)


def test_mla_decode_three_steps_match():
    """Three absorbed decode steps over a latent cache with one row at
    length 0: outputs and both caches (written in place) agree."""
    jcfg, tcfg = _cfgs()
    jp, tp = _layer0(jcfg, tcfg)
    r = np.random.default_rng(3)
    B, S = 3, 24
    ckv = r.standard_normal((B, S, tcfg.kv_lora_rank)).astype(np.float32)
    kr = r.standard_normal((B, S, tcfg.rope_head_dim)).astype(np.float32)
    lengths = np.array([0, 5, 20], np.int32)
    jc, jr = jnp.asarray(ckv), jnp.asarray(kr)
    tc, tr = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    for step in range(3):
        x = r.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
        ln = lengths + step
        want, jc, jr = jl.mla_decode(jcfg, jp, jnp.asarray(x), jc, jr,
                                     jnp.asarray(ln))
        got, tc2, tr2 = tl.mla_decode(tcfg, tp, torch.from_numpy(x), tc, tr,
                                      torch.from_numpy(ln))
        assert tc2 is tc and tr2 is tr
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)


def test_cache_update_writes_a_latent_row():
    """``cache_update`` at rank 3 (B, S, r): the row at ``lengths`` is
    written, rows at or past S and negative rows are no-op writes."""
    r = np.random.default_rng(4)
    cache = r.standard_normal((4, 8, 6)).astype(np.float32)
    new = r.standard_normal((4, 1, 6)).astype(np.float32)
    lengths = np.array([0, 7, 8, -1], np.int32)
    want = np.asarray(jl._cache_update_2d(jnp.asarray(cache),
                                          jnp.asarray(new),
                                          jnp.asarray(lengths)))
    t = torch.from_numpy(cache.copy())
    tl.cache_update(t, torch.from_numpy(new), torch.from_numpy(lengths))
    np.testing.assert_array_equal(t.numpy(), want)
    np.testing.assert_array_equal(t.numpy()[2:], cache[2:])


@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)])
def test_plain_flash_with_a_narrower_v(H, Hkv):
    """The plain prefill attention at q/k heads of 48 and v heads of 32
    (causal, aligned S = 128), scale 1/sqrt(48): equal to the JAX
    package's ``models.flash`` and to the Pallas kernel in interpret
    mode (run as ``tests/test_kernels.py`` runs it)."""
    r = np.random.default_rng(5)
    B, S, dh, dv = 2, 128, 48, 32
    q = r.standard_normal((B, S, H, dh)).astype(np.float32)
    k = r.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    v = r.standard_normal((B, S, Hkv, dv)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    got = tflash.flash_attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                                 causal=True, chunk=64).numpy()
    assert got.shape == (B, S, H, dv)
    want = jflash.flash_attention((True, 0, 64, 0.0),
                                  *map(jnp.asarray, (q, k, v, pos, pos)))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    pallas = flash_attention_tpu(*map(jnp.asarray, (q, k, v)), causal=True,
                                 block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("dqk,dv,ok", [(192, 128, True), (128, 128, True),
                                       (192, 192, False), (128, 64, False),
                                       (48, 32, False)])
def test_flash_wrapper_takes_only_instantiated_head_dims(dqk, dv, ok):
    """The kernel's wrapper accepts a v narrower than q/k only for a pair
    the kernel is instantiated for (``ops.HEAD_DIMS``); any other pair
    raises before a launch (V is never padded)."""
    B, S, H = 1, 16, 2
    q, k = torch.zeros((B, S, H, dqk)), torch.zeros((B, S, H, dqk))
    v = torch.zeros((B, S, H, dv))
    pos = torch.arange(S, dtype=torch.int32)[None]
    assert ((dqk, dv) in fa_ops.HEAD_DIMS) == ok
    if ok:
        fa_ops._check(q, k, v, pos, pos)
    else:
        with pytest.raises(ValueError, match="head dim"):
            fa_ops._check(q, k, v, pos, pos)


def test_flash_bf16_mla_key_limit_check(monkeypatch):
    """At (q/k 192, v 128) the tensor-core route's shared memory is the
    48 KiB Q tile, a 4-stage ring of 24 KiB K and 16 KiB V tiles, 2188
    bytes of barriers, positions and alignment, then 12 bytes a 64-key
    tile: the wrapper takes ``max_keys(192, 128)`` keys in bf16 and
    refuses one more, naming the limit; fp32 (the CUDA-core route) takes
    it.  The limit is the built kernel's (``repro_flash_max_keys``, held
    on the card by ``tests/test_torch_cuda.py``); here it is that layout's.
    The tensors are never written."""
    fixed = 128 * 192 * 2 + 4 * 64 * (192 + 128) * 2 + 2188
    n = (227 * 1024 - fixed) // 12 * 64
    monkeypatch.setattr(fa_ops, "max_keys",
                        lambda dqk, dv=None: n if (dqk, dv) == (192, 128)
                        else 0)
    q = torch.zeros((1, 1, 1, 192), dtype=torch.bfloat16)
    qp = torch.zeros((1, 1), dtype=torch.int32)
    for Skv in (n, n + 1):
        k = torch.empty((1, Skv, 1, 192), dtype=torch.bfloat16)
        v = torch.empty((1, Skv, 1, 128), dtype=torch.bfloat16)
        kp = torch.empty((1, Skv), dtype=torch.int32)
        if Skv > n:
            with pytest.raises(ValueError, match=f"at most {n} keys"):
                fa_ops._check(q, k, v, qp, kp)
            fa_ops._check(q.float(), k.float(), v.float(), qp, kp)
        else:
            fa_ops._check(q, k, v, qp, kp)


def test_params_from_numpy_takes_the_jax_tree():
    """The MLA leaves (``wq_a, q_norm, wq_b, wkv_a, kv_norm, wk_b, wv_b,
    wo``) and the MoE leaves with the shared expert arrive with the JAX
    tree's keys and shapes, unchanged; the port's own draw has the same
    shapes."""
    jcfg, tcfg = _cfgs()
    np_params = _np_params(jcfg)
    params = TT.params_from_numpy(np_params, tcfg, device="cpu")

    def shapes(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(shapes(v, path + (k,)))
            else:
                out[".".join(path + (k,))] = tuple(v.shape)
        return out

    want = shapes(np_params)
    assert shapes(params) == want
    assert shapes(TT.init_params(tcfg, seed=1, device="cpu")) == want
    L, D, H = tcfg.num_layers, tcfg.d_model, tcfg.num_heads
    dn, dr = tcfg.head_dim, tcfg.rope_head_dim
    assert sorted(k for k in want if k.startswith("layers.attn.")) == sorted(
        f"layers.attn.{n}" for n in ("wq_a", "q_norm", "wq_b", "wkv_a",
                                     "kv_norm", "wk_b", "wv_b", "wo"))
    assert want["layers.attn.wq_b"] == (L, tcfg.q_lora_rank, H, dn + dr)
    assert want["layers.attn.wo"] == (L, H, dn, D)
    assert want["layers.moe.shared.w1"] == (L, D, tcfg.shared_d_ff)
    for name, a in np_params["layers"]["attn"].items():
        np.testing.assert_array_equal(
            params["layers"]["attn"][name].numpy(), a, err_msg=name)


def test_param_count_counts_the_shared_expert_whole():
    """Totals agree; the active counts differ by exactly the shared
    expert's share x (1 - k/E): the JAX ``param_count`` scales the shared
    expert by k/E, the port counts it whole (it runs for every token)."""
    jcfg, tcfg = _cfgs()
    assert TT.param_count(tcfg) == JT.param_count(jcfg)
    L, D, F = tcfg.num_layers, tcfg.d_model, tcfg.shared_d_ff
    shared = 3 * L * D * F
    k, E = tcfg.experts_per_token, tcfg.num_experts
    diff = TT.param_count(tcfg, active_only=True) - \
        JT.param_count(jcfg, active_only=True)
    assert diff == shared * (E - k) // E > 0


def test_init_cache_has_latent_leaves():
    jcfg, tcfg = _cfgs()
    got = TT.init_cache(tcfg, 3, 40, "cpu")
    want = JT.init_cache(jcfg, 3, 40)
    assert {n: tuple(t.shape) for n, t in got.items()} == \
        {n: a.shape for n, a in want.items()} == {
            "ckv": (2, 3, 40, tcfg.kv_lora_rank),
            "kr": (2, 3, 40, tcfg.rope_head_dim)}


def test_prefill_logits_and_latent_cache_match():
    jcfg, tcfg = _cfgs()
    np_params = _np_params(jcfg)
    tparams = TT.params_from_numpy(np_params, tcfg, device="cpu")
    toks = np.random.default_rng(6).integers(2, jcfg.vocab_size, (2, 16),
                                             dtype=np.int32)
    jlog, jcache = JT.prefill(jcfg, AXES,
                              jax.tree.map(jnp.asarray, np_params),
                              {"tokens": jnp.asarray(toks)})
    tlog, tcache = TT.prefill(tcfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **FWD_TOL)
    assert set(tcache) == set(jcache) == {"ckv", "kr"}
    for name in jcache:
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), **FWD_TOL,
                                   err_msg=name)


def test_decode_page_tokens_match_over_two_pages():
    """Greedy ``decode_page`` from a prefilled latent cache: two pages of
    8 steps, one slot finishing mid-page and one never live, give the JAX
    scan's tokens, lengths and countdowns exactly."""
    jcfg, tcfg = _cfgs()
    np_params = _np_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = TT.params_from_numpy(np_params, tcfg, device="cpu")
    B, S0, max_len, P = 3, 8, 64, 8
    toks = np.random.default_rng(7).integers(2, jcfg.vocab_size, (B, S0),
                                             dtype=np.int32)
    jlog, jpc = JT.prefill(jcfg, AXES, jparams, {"tokens": jnp.asarray(toks)})
    first = np.argmax(np.asarray(jlog)[:, 0], axis=-1).astype(np.int32)
    jcache = {n: JT.init_cache(jcfg, B, max_len)[n].at[:, :, :S0].set(jpc[n])
              for n in jpc}
    tcache = TT.init_cache(tcfg, B, max_len, "cpu")
    for n in jpc:
        tcache[n][:, :, :S0] = torch.from_numpy(np.array(jpc[n]))
    lengths = np.full((B,), S0, np.int32)
    remaining = np.array([16, 11, 0], np.int32)
    jstate = tuple(map(jnp.asarray, (first, lengths, remaining)))
    tstate = tuple(map(torch.from_numpy, (first.copy(), lengths.copy(),
                                          remaining.copy())))
    for _ in range(2):
        jblk, jt, jln, jrem, jcache = JT.decode_page(
            jcfg, AXES, jparams, jcache, *jstate, P)
        tblk, tt, tln, trem, tcache = TT.decode_page(
            tcfg, tparams, tcache, *tstate, P)
        np.testing.assert_array_equal(tblk.numpy(), np.asarray(jblk))
        for g, w in zip((tt, tln, trem), (jt, jln, jrem)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        jstate, tstate = (jt, jln, jrem), (tt, tln, trem)


def test_engine_matches_jax_engine_through_batch_master():
    """The greedy workload, its cross-submit prefix hit and in-batch
    duplicate included, gives the JAX engine's tokens per ``custom_id``;
    the latent host pages agree to 1e-4 (whole forwards)."""
    jcfg, tcfg = _cfgs()
    jeng = JNodeEngine(jcfg, seed=0, **ENGINE_KW)
    params = TT.params_from_numpy(jax.tree.map(np.asarray, jeng.params),
                                  tcfg, device="cpu")
    teng = NodeEngine(tcfg, params=params, device="cpu", **ENGINE_KW)
    assert {n: tuple(t.shape) for n, t in teng.cache.items()} == {
        "ckv": (2, 3, 128, 32), "kr": (2, 3, 128, 16)}
    jpages, tpages = (_spy_host_pages(jeng.host_store),
                      _spy_host_pages(teng.host_store))
    batches = _workload(tcfg.vocab_size)
    want = _serve(JBatchMaster([jeng], JSchedulerConfig(page_size=PAGE)),
                  JBatchRequest, batches)
    got = _serve(BatchMaster([teng], SchedulerConfig(page_size=PAGE)),
                 BatchRequest, batches)
    assert got == want
    assert teng.prefill_tokens_saved == jeng.prefill_tokens_saved > 0
    assert teng.prefill_tokens == jeng.prefill_tokens
    assert teng.decode_steps == jeng.decode_steps
    assert [s for s, _ in tpages] == [s for s, _ in jpages]
    for (sid, tleaves), (_, jleaves) in zip(tpages, jpages):
        assert tleaves.keys() == jleaves.keys() == {"ckv", "kr"}
        for name, a in jleaves.items():
            np.testing.assert_allclose(tleaves[name], a, **FWD_TOL,
                                       err_msg=f"{sid}.{name}")


def test_sampled_engine_matches_jax_engine_through_batch_master(
        monkeypatch):
    """The sampled workload (temperature, top-k/p, min-p, penalties, a
    stop token, logprobs, a prefix hit): identical tokens, logprobs to
    1e-5, as ``test_torch_engine.py`` holds the dense engine."""
    monkeypatch.setenv("REPRO_SAMPLING_BACKEND", "pallas_interpret")
    _sampled_parity(*_cfgs(), ENGINE_KW)


def test_module_granularity_refuses_mla():
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="MLA"):
        NodeEngine(tcfg, device="cpu", module_granularity=True, b_attn=2)
