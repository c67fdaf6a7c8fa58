"""The port's CUDA kernels on the card, held to their plain PyTorch versions.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The first test builds the kernels from ``src/repro_torch/csrc`` with
``nvcc``.  Tolerances: fp32 atol/rtol 1e-4 (summation order), bf16
atol/rtol 2e-2 (one bf16 rounding of the output).  fp32 products run in
full fp32 (TF32 off), so the reduced engine's greedy tokens on the card
equal those of its plain CPU path.
"""
import dataclasses

import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import reduced_config
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_plain)
from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_attention_plain)
from repro_torch.models import transformer as TT
from repro_torch.runtime.api import BatchMaster, BatchRequest
from repro_torch.runtime.engine import NodeEngine

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _pos(B, start, n, dev):
    return (torch.arange(n, dtype=torch.int32, device=dev) + start)[None] \
        .expand(B, n).contiguous()


def _close(got, want, dtype):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == dtype
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


# (name, B, Sq, Skv, H, Hkv, D, causal, window, softcap)
FLASH_CASES = [
    ("causal_gqa4", 2, 130, 130, 8, 2, 64, True, 0, 0.0),
    ("offset_q", 2, 40, 200, 8, 2, 64, True, 0, 0.0),
    ("window_softcap", 1, 150, 150, 4, 2, 64, True, 37, 20.0),
    ("noncausal_skv96", 1, 96, 96, 4, 2, 64, False, 0, 0.0),
    ("gqa3_d32", 1, 40, 40, 6, 2, 32, True, 0, 0.0),
    ("mha_d128", 1, 70, 70, 4, 4, 128, True, 0, 0.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_kernel_matches_plain(dev, case, dtype):
    _, B, Sq, Skv, H, Hkv, D, causal, window, softcap = case
    gen = torch.Generator(device=dev).manual_seed(0)
    q = _randn(gen, (B, Sq, H, D), dtype, dev)
    k = _randn(gen, (B, Skv, Hkv, D), dtype, dev)
    v = _randn(gen, (B, Skv, Hkv, D), dtype, dev)
    qp, kp = _pos(B, Skv - Sq, Sq, dev), _pos(B, 0, Skv, dev)
    kw = dict(causal=causal, window=window, softcap=softcap)
    _close(flash_attention(q, k, v, qp, kp, **kw),
           flash_attention_plain(q, k, v, qp, kp, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("H,Hkv,D", [(8, 2, 64), (14, 2, 64), (6, 2, 32),
                                     (4, 4, 128)])
def test_paged_kernel_matches_plain(dev, H, Hkv, D, dtype):
    """A shuffled page table with spare pages, and lengths inside a page,
    across pages, at the table's end and past it (clamped)."""
    B, page, max_pages = 4, 16, 9
    gen = torch.Generator(device=dev).manual_seed(1)
    pool = B * max_pages + 5
    q = _randn(gen, (B, H, D), dtype, dev)
    kp = _randn(gen, (pool, page, Hkv, D), dtype, dev)
    vp = _randn(gen, (pool, page, Hkv, D), dtype, dev)
    table = torch.randperm(pool, generator=gen, device=dev)[:B * max_pages] \
        .reshape(B, max_pages).to(torch.int32)
    lengths = torch.tensor([3, 70, page * max_pages, page * max_pages + 1],
                           dtype=torch.int32, device=dev)
    _close(paged_attention(q, kp, vp, table, lengths),
           paged_attention_plain(q, kp, vp, table, lengths), dtype)


def test_each_launch_is_counted_once(dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    q = _randn(gen, (1, 16, 4, 64), torch.float32, dev)
    k = _randn(gen, (1, 16, 2, 64), torch.float32, dev)
    pos = _pos(1, 0, 16, dev)
    qd = _randn(gen, (1, 4, 64), torch.float32, dev)
    table = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    lengths = torch.tensor([16], dtype=torch.int32, device=dev)
    kernels.reset_launches()
    flash_attention(q, k, k, pos, pos)
    flash_attention(q, k, k, pos, pos)
    paged_attention(qd, k, k, table, lengths)
    flash_attention_plain(q, k, k, pos, pos)
    paged_attention_plain(qd, k, k, table, lengths)
    torch.cuda.synchronize()
    assert kernels.launches() == {"flash_attention": 2, "paged_attention": 1}


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    q = _randn(gen, (1, 16, 4, 64), torch.float32, dev)
    k = _randn(gen, (1, 16, 2, 64), torch.float32, dev)
    pos = _pos(1, 0, 16, dev)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                        k, k, pos, pos)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), k.half(), pos, pos)
    with pytest.raises(TypeError):
        flash_attention(q, k, k, pos.long(), pos.long())
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                        k[..., :48].contiguous(), pos, pos)
    with pytest.raises(ValueError):
        flash_attention(q, k, k, pos, pos.cpu())
    table = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    lengths = torch.tensor([16], dtype=torch.int32, device=dev)
    qd = _randn(gen, (1, 34, 64), torch.float32, dev)
    with pytest.raises(ValueError, match="q heads per kv head"):
        paged_attention(qd, k, k, table, lengths)    # a group of 17
    with pytest.raises(TypeError):
        paged_attention(qd[:, :4], k, k, table, lengths.long())


def test_reduced_engine_tokens_match_cpu(dev):
    """The reduced fp32 model served through BatchMaster on the card (the
    kernels) and on the CPU (the plain versions): identical greedy
    tokens, and the card's run launched both kernels."""
    cfg = dataclasses.replace(reduced_config("llama3_2_1b"), dtype="float32")
    params = TT.init_params(cfg, seed=4, device="cpu")
    gen = torch.Generator().manual_seed(4)
    reqs = [(f"s{i}", torch.randint(2, cfg.vocab_size, (n,),
                                    generator=gen).tolist())
            for i, n in enumerate([5, 12, 17, 30])]
    def to(tree, target):
        return {k: to(v, target) if isinstance(v, dict) else v.to(target)
                for k, v in tree.items()}

    out = {}
    for target in (dev, torch.device("cpu")):
        eng = NodeEngine(cfg, params=to(params, target), max_active=4,
                         max_len=128, page_size=8, device=target)
        master = BatchMaster([eng], SchedulerConfig(page_size=8))
        kernels.reset_launches()
        bo = master.run(master.submit(
            [BatchRequest(c, p, 20) for c, p in reqs]))
        assert bo.request_counts["completed"] == len(reqs)
        used = kernels.launches()
        assert (min(used.values()) > 0) == (target.type == "cuda"), used
        out[target.type] = {r["custom_id"]: r["response"]["tokens"]
                            for r in bo.results}
    assert out["cuda"] == out["cpu"]
