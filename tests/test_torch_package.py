"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points need a card unless the caller asks for the CPU."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import compat, kernels, sampling
from repro_torch.kernels import build
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import transformer as TT
from repro_torch.launch import job
from repro_torch.runtime import checkpoint
from repro_torch.runtime.engine import NodeEngine

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"

_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.modules["ml_dtypes"] = None
import repro_torch
from repro_torch.runtime.engine import NodeEngine
from repro_torch.runtime.api import BatchMaster
from repro_torch.launch import serve
from repro_torch.kernels.flash_attention import ops as f
from repro_torch.kernels.paged_attention import ops as p
from repro_torch.kernels.fused_sampling import ops as fs
from repro_torch.kernels.moe_gemm import ops as mg
from repro_torch.kernels.ssd_scan import ops as ss
from repro_torch.kernels import build
from repro_torch.core import forward
from repro_torch.models import moe, ssm
from repro_torch.launch import flash_ab, model_level, profile, timing
from repro_torch.sampling import processors, sample
from repro_torch.runtime import checkpoint, cluster, ledger
from repro_torch.data import pipeline
from repro_torch import driver
from repro_torch.driver import replica, source
from repro_torch.launch import job
from repro_torch.configs import pixtral_12b, whisper_base
from repro_torch.models import layers, transformer
from repro_torch import optim
from repro_torch.kernels.flash_attention_bwd import ops as fb
from repro_torch.launch import steps, train
from repro_torch.launch import dryrun, mesh
from repro_torch.distributed import collectives, sharding
print("imported", sorted(m for m, mod in sys.modules.items()
                         if mod is not None
                         and m.split(".")[0] in ("jax", "repro", "ml_dtypes")))
"""


def test_import_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED],
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "imported []" in proc.stdout


def test_no_source_imports_jax_or_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|ml_dtypes|repro)\b")
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    names = {str(f.relative_to(PKG)) for f in files}
    assert {"sampling/processors.py", "sampling/sample.py",
            "kernels/fused_sampling/ops.py", "core/forward.py",
            "models/moe.py", "kernels/moe_gemm/ops.py", "models/ssm.py",
            "kernels/ssd_scan/ops.py", "launch/model_level.py",
            "runtime/ledger.py", "runtime/cluster.py", "runtime/checkpoint.py",
            "data/pipeline.py", "driver/__init__.py", "driver/driver.py",
            "driver/replica.py", "driver/source.py", "launch/job.py",
            "configs/whisper_base.py", "configs/pixtral_12b.py",
            "optim.py", "launch/steps.py", "launch/train.py",
            "kernels/flash_attention_bwd/ops.py"} <= names
    bad = [f"{f.relative_to(SRC)}:{i}: {line.strip()}"
           for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pat.match(line)]
    assert not bad, bad


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config("llama3_2_1b")
    with pytest.raises(RuntimeError, match="CUDA"):
        NodeEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        compat.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        sampling.base_keys([1])
    assert sampling.base_keys([1], "cpu").device.type == "cpu"
    assert compat.resolve_device("cpu").type == "cpu"
    eng = NodeEngine(cfg, device="cpu", max_active=2, max_len=32,
                     page_size=8)
    assert eng.cache["k"].device.type == "cpu"


def test_job_and_checkpoint_restore_need_a_card_unless_asked_for_cpu(
        monkeypatch, tmp_path):
    """``launch.job`` and ``checkpoint.unflatten_into`` default to cuda and
    raise without a card; given ``device="cpu"`` they run there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config("llama3_2_1b")
    params = TT.init_params(cfg, 0, "cpu")
    checkpoint.save(str(tmp_path / "c"), params)
    flat, _ = checkpoint.restore(str(tmp_path / "c"))
    with pytest.raises(RuntimeError, match="CUDA"):
        checkpoint.unflatten_into(TT.param_template(cfg), flat)
    got = checkpoint.unflatten_into(TT.param_template(cfg), flat,
                                    device="cpu")
    assert got["embed"].device.type == "cpu"
    assert torch.equal(got["embed"], params["embed"])
    inp = tmp_path / "in.jsonl"
    inp.write_text('{"custom_id": "a", "body": {"prompt": [2, 3, 4], '
                   '"max_tokens": 3}}\n')
    args = [str(inp), str(tmp_path / "out.jsonl"), str(tmp_path / "led"),
            "--reduced"]
    with pytest.raises(RuntimeError, match="CUDA"):
        job.main(args)
    assert not (tmp_path / "led").exists()
    res = job.main(args + ["--device", "cpu", "--replicas", "1"])
    assert res.status == "completed" and res.merged_records == 1
    row = json.loads((tmp_path / "out.jsonl").read_text())
    assert row["custom_id"] == "a" and len(row["response"]["tokens"]) == 3


def test_configs_are_the_published_dense_ones():
    cfg = get_config("llama3_2_1b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.vocab_size, cfg.dtype) == \
        (16, 2048, 32, 8, 64, 128256, "bfloat16")
    assert get_config("qwen2_0_5b").attn_bias
    assert get_config("smollm_360m").num_kv_heads == 5
    q = get_config("qwen3_moe_30b")
    assert (q.family, q.num_layers, q.d_model, q.num_heads, q.num_kv_heads,
            q.head_dim, q.vocab_size, q.num_experts, q.experts_per_token,
            q.moe_d_ff, q.rope_theta) == \
        ("moe", 48, 2048, 32, 4, 128, 151936, 128, 8, 768, 1e6)
    assert round(TT.param_count(q) / 1e9, 2) == 30.53
    assert round(TT.param_count(q, active_only=True) / 1e9, 2) == 3.35
    p = get_config("phi3_5_moe")
    assert (p.num_layers, p.d_model, p.num_heads, p.num_kv_heads,
            p.vocab_size, p.num_experts, p.experts_per_token,
            p.moe_d_ff) == (32, 4096, 32, 8, 32064, 16, 2, 6400)


def test_ssm_config_is_the_published_one():
    """Mamba2-370M at full width: 48 layers, d_model 1024, d_inner 2048,
    32 SSM heads of 64, state 128, one group, conv 4, vocab 50280 padded
    to 50288, an untied head; 419,730,944 parameters, as the JAX
    package's ``param_count`` gives them."""
    m = get_config("mamba2_370m")
    assert (m.family, m.num_layers, m.d_model, m.d_inner, m.ssm_heads,
            m.ssm_head_dim, m.ssm_state, m.ssm_groups, m.ssm_conv,
            m.vocab_size, TT.padded_vocab(m), m.tie_embeddings,
            m.dtype) == ("ssm", 48, 1024, 2048, 32, 64, 128, 1, 4, 50280,
                         50288, False, "bfloat16")
    assert TT.param_count(m) == 419_730_944
    spec = TT.param_shapes(m)
    assert set(spec["layers"]) == {"ln1", "ssm"}
    assert spec["lm_head"][0] == (1024, 50288)


def test_encdec_and_vision_configs_are_the_published_ones(monkeypatch):
    """Whisper-base: 6 encoder and 6 decoder layers, d_model 512, 8 heads
    of 64 on 8 kv heads, d_ff 2048, vocab 51865 padded to 51872,
    LayerNorm, tanh GELU, 1536 stub frames; 110,034,944 parameters.
    Pixtral-12B: 40 layers, d_model 5120, 32 heads of 128 on 8, d_ff
    14336, vocab 131072, RoPE theta 1e9, 1024 stub patches; 12,273,996,800
    parameters (24.5 GB in bf16).  The counts are the JAX package's
    ``param_count``s.  The port's ``init_params`` needs a card unless
    asked for the CPU."""
    w = get_config("whisper_base")
    assert (w.family, w.num_layers, w.encoder_layers, w.d_model,
            w.num_heads, w.num_kv_heads, w.head_dim, w.d_ff, w.vocab_size,
            TT.padded_vocab(w), w.norm, w.act, w.encoder_seq) == \
        ("audio", 6, 6, 512, 8, 8, 64, 2048, 51865, 51872, "layernorm",
         "gelu", 1536)
    assert TT.param_count(w) == 110_034_944
    spec = TT.param_shapes(w)
    assert spec["adapter"][0] == (512, 512)
    assert spec["enc_layers"]["ln1"]["b"][0] == (6, 512)
    assert spec["layers"]["xattn"]["wq"][0] == (6, 512, 8, 64)
    p = get_config("pixtral_12b")
    assert (p.family, p.num_layers, p.d_model, p.num_heads, p.num_kv_heads,
            p.head_dim, p.d_ff, p.vocab_size, p.rope_theta,
            p.num_patches) == ("vlm", 40, 5120, 32, 8, 128, 14336, 131072,
                               1e9, 1024)
    assert TT.param_count(p) == 12_273_996_800
    assert TT.param_shapes(p)["adapter"][0] == (5120, 5120)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_params(reduced_config("whisper_base"))
    assert TT.init_params(reduced_config("pixtral_12b"), 0, "cpu")[
        "adapter"].device.type == "cpu"


def test_five_kernels_are_registered_each_with_its_source():
    """Every TPU kernel of the JAX package has its Hopper counterpart, and
    prefill attention's backward, the grouped GEMM's weight gradient and
    the SSD scan's backward their own kernels: eight registered names,
    each with a wrapper, a plain version, a launch counter and a
    ``csrc/<name>.cu`` that ``build.py`` finds."""
    assert set(kernels.KERNELS) == {"flash_attention", "flash_attention_bwd",
                                    "paged_attention", "fused_sampling",
                                    "moe_gemm", "moe_gemm_wgrad",
                                    "ssd_scan", "ssd_scan_bwd"}
    assert sorted(kernels.KERNELS) == build.kernel_names()
    assert set(kernels.launches()) == set(kernels.KERNELS)
    for name in kernels.KERNELS:
        op, plain = kernels.get_kernel(name)
        assert callable(op) and callable(plain)
