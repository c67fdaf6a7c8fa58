"""The tensor-parallel shares of the port, rank by rank in one process, on
the CPU.

``_train_layer`` over a model group runs each sublayer as this rank's
partial (``attention_share``, ``ffn_share``) and all-reduces it;
``forward_loss`` does the same with ``embed_share``, and ``_chunk_ce_tp``
merges the ranks' ``ce_shard`` statistics with ``ce_merge``.  Here every
rank's share runs in turn on its slices (``shard_params``) and the
partials are summed, which is the all-reduce without a process group (as
``chip_smoke.py`` phase 18 (b) does at full width on the card): reduced
Llama-3.2-1B and Qwen3-30B-A3B in fp32 at tp 2 and 4 (Qwen3's 2 kv heads
replicated at tp 4), each sum against the one-device sublayer (tp 1) to
rtol 1e-5 and atol 2e-6 of the tensor's largest magnitude (fp32 sums in
another order), gradients included; the embedding in equal bits;
the merged cross-entropy against the JAX package's ``_chunked_ce`` to
rtol 1e-5.  ``init_params`` with ``part`` gives ``shard_params`` of the
full tree in bits.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import transformer as JT
from repro_torch.configs import reduced_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import layers
from repro_torch.models import transformer as TT
from repro_torch.models.api import MeshAxes

RTOL, ATOL_OF_SCALE = 1e-5, 2e-6
CASES = [("llama3_2_1b", 2), ("llama3_2_1b", 4), ("qwen3_moe_30b", 2),
         ("qwen3_moe_30b", 4)]
IDS = [f"{a}-tp{tp}" for a, tp in CASES]


def _cfg(arch):
    return dataclasses.replace(reduced_config(arch), dtype="float32")


def _rank(tp, m):
    return mesh_lib.Mesh(("data", "model"), (1, tp), rank=m)


def _req(tree):
    return {k: _req(v) if isinstance(v, dict) else
            v.detach().requires_grad_(True) for k, v in tree.items()}


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _full_grads(one, specs, tp, locs):
    """Each leaf's gradient from the ranks' local ones: a split leaf's
    slices put in place, a replicated leaf's parts summed (what the model
    group's ``copy_in`` sums)."""
    out = {}
    for path, t in _walk(one):
        acc = torch.zeros(t.shape, dtype=torch.float64)
        for m, loc in enumerate(locs):
            g = _get(loc, path).grad
            if g is not None:
                sl = shd.dim_slices(_get(specs, path), t.shape,
                                    {"data": 1, "model": tp},
                                    {"data": 0, "model": m})
                acc[sl] += g.double()
        out[path] = acc
    return out


def _close(got, want):
    want = want.detach().double().numpy()
    np.testing.assert_allclose(got.detach().double().numpy(), want,
                               rtol=RTOL,
                               atol=ATOL_OF_SCALE * np.abs(want).max())


@pytest.mark.parametrize("arch,tp", CASES, ids=IDS)
@pytest.mark.parametrize("sub", ["attention", "ffn"])
def test_rank_sum_of_a_sublayer_share_is_the_sublayer(arch, tp, sub):
    cfg = dataclasses.replace(_cfg(arch), num_layers=1)
    stack = TT.init_params(cfg, 3, "cpu")["layers"]
    specs = shd.param_specs(cfg, MeshAxes(), tp, "tp")["layers"]
    gen = torch.Generator().manual_seed(4)
    B, S = 2, 24
    h0 = torch.randn((B, S, cfg.d_model), generator=gen)
    up = torch.randn((B, S, cfg.d_model), generator=gen)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    tab = layers.rope_tables(pos, layers.rope_dim(cfg), cfg.rope_theta)

    def run(p, h, m, n):
        if sub == "attention":
            return TT.attention_share(cfg, p, h, pos, tab, m, n), None
        return TT.ffn_share(cfg, p, h, m, n)

    one = _req(stack)
    h1 = h0.clone().requires_grad_(True)
    y1, aux1 = run(_layer(one), h1, 0, 1)
    ((y1 * up).sum() + (0 if aux1 is None else aux1)).backward()

    locs = [_req(shd.shard_params(stack, specs, _rank(tp, m)))
            for m in range(tp)]
    h8 = h0.clone().requires_grad_(True)
    y8, aux8 = None, None
    for m, loc in enumerate(locs):
        y, a = run(_layer(loc), h8, m, tp)
        y8 = y if y8 is None else y8 + y
        if a is not None:
            aux8 = a if aux8 is None else aux8 + a
    ((y8 * up).sum() + (0 if aux8 is None else aux8)).backward()

    _close(y8, y1)
    _close(h8.grad, h1.grad)
    if aux1 is not None:
        _close(aux8, aux1)
    full = _full_grads(one, specs, tp, locs)
    used = 0
    for path, t in _walk(one):
        if t.grad is not None:
            used += 1
            _close(full[path], t.grad)
    assert used > 0


def _layer(stack):
    return {k: _layer(v) if isinstance(v, dict) else v[0]
            for k, v in stack.items()}


@pytest.mark.parametrize("tp", [2, 4])
def test_rank_sum_of_the_embedding_share_is_the_embedding(tp):
    cfg = _cfg("qwen3_moe_30b")
    V = TT.padded_vocab(cfg)
    gen = torch.Generator().manual_seed(5)
    E = torch.randn((V, cfg.d_model), generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen)
    want = TT._embed_tokens(cfg, {"embed": E}, tokens)
    Vl = V // tp
    got = sum(TT.embed_share(cfg, {"embed": E[m * Vl:(m + 1) * Vl]},
                             tokens, m, tp) for m in range(tp))
    assert torch.equal(got, want)


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_merged_cross_entropy_shards_match_jax(tp, softcap):
    """Each rank's ``ce_shard`` of a vocab shard of ``lm_head``, stacked on
    a leading rank axis and merged by ``ce_merge`` (max and sum over it),
    chunk by chunk: the mean loss against JAX's ``_chunked_ce`` and the
    gradients of h and ``lm_head`` against the port's one-device
    ``_chunked_ce``."""
    jcfg = dataclasses.replace(j_reduced("qwen3_moe_30b"), dtype="float32",
                               logit_softcap=softcap)
    cfg = dataclasses.replace(_cfg("qwen3_moe_30b"), logit_softcap=softcap)
    V = TT.padded_vocab(cfg)
    r = np.random.default_rng(6)
    B, S = 2, 2 * TT.CE_CHUNK
    h = r.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    W = (r.standard_normal((cfg.d_model, V)) / 8).astype(np.float32)
    labels = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[:, :9] = -1
    want = JT._chunked_ce(jcfg, {"lm_head": jnp.asarray(W)},
                          jnp.asarray(h), jnp.asarray(labels))

    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(W).requires_grad_(True)
    tl = torch.from_numpy(labels)
    one = TT._chunked_ce(cfg, {"lm_head": tw}, th, tl)
    dh1, dw1 = torch.autograd.grad(one, [th, tw])

    Vl = V // tp
    ws = [torch.from_numpy(W[:, m * Vl:(m + 1) * Vl].copy())
          .requires_grad_(True) for m in range(tp)]
    hh = torch.from_numpy(h).requires_grad_(True)
    tot, cnt = 0.0, 0.0
    for s0 in range(0, S, TT.CE_CHUNK):
        hc, lc = hh[:, s0:s0 + TT.CE_CHUNK], tl[:, s0:s0 + TT.CE_CHUNK]
        stats = [TT.ce_shard(cfg, {"lm_head": w}, hc, lc, m, tp)
                 for m, w in enumerate(ws)]
        lse, ll = (torch.stack(t) for t in zip(*stats))
        t, n = TT.ce_merge(lse, ll, lc, lambda x: x.amax(0),
                           lambda x: x.sum(0))
        tot, cnt = tot + t, cnt + n
    loss = tot / cnt
    grads = torch.autograd.grad(loss, [hh] + ws)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    _close(grads[0], dh1)
    _close(torch.cat(grads[1:], dim=1), dw1)


@pytest.mark.parametrize("arch,tp", CASES, ids=IDS)
def test_init_params_part_is_shard_params_of_the_full_tree(arch, tp):
    cfg = reduced_config(arch)
    specs = shd.param_specs(cfg, MeshAxes(), tp, "tp")
    full = TT.init_params(cfg, 7, "cpu")
    for m in (0, tp - 1):
        mesh = _rank(tp, m)
        want = shd.shard_params(full, specs, mesh)
        got = TT.init_params(cfg, 7, "cpu", part=shd.part_of(specs, mesh))
        for (path, a), (_, b) in zip(_walk(got), _walk(want)):
            assert a.shape == b.shape and a.dtype == b.dtype, path
            assert torch.equal(a, b), path
