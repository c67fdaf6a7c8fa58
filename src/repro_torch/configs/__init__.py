"""Architecture registry of the PyTorch port: one module per architecture
of the JAX package, dense (H2O-Danube-1.8B's sliding window among them),
encoder-decoder (Whisper), vision (Pixtral), MoE (DeepSeek-R1's MLA among
them), SSM and hybrid (RecurrentGemma) (copies of ``repro.configs``).
``get_config(name)`` returns the full published config;
``reduced_config(name)`` returns a tiny same-family config for CPU smoke
tests (same code paths, small dims)."""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = [
    "llama3_2_1b",
    "qwen2_0_5b",
    "smollm_360m",
    "h2o_danube_1_8b",
    "whisper_base",
    "pixtral_12b",
    "phi3_5_moe",
    "qwen3_moe_30b",
    "mamba2_370m",
    "recurrentgemma_2b",
    "deepseek_r1",   # the paper's own model
]


# Published generation defaults per architecture (generation_config.json
# style): used by default_sampling() when a caller doesn't pin its own
# SamplingParams.  Architectures absent here default to greedy.
SAMPLING_DEFAULTS = {
    "llama3_2_1b": dict(temperature=0.6, top_p=0.9),
    "qwen2_0_5b": dict(temperature=0.7, top_p=0.8, top_k=20,
                       repetition_penalty=1.1),
    "smollm_360m": dict(temperature=0.6, top_p=0.92),
    "h2o_danube_1_8b": dict(temperature=0.7, top_p=0.95),
    "phi3_5_moe": dict(temperature=0.7, top_p=0.95),
    "qwen3_moe_30b": dict(temperature=0.6, top_p=0.95, top_k=20),
    "recurrentgemma_2b": dict(temperature=1.0, top_k=64, top_p=0.95),
    "deepseek_r1": dict(temperature=0.6, top_p=0.95),
}


def get_config(name: str):
    name = name.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def default_sampling(name: str, **overrides):
    """Recommended SamplingParams for an architecture (greedy when the
    model card publishes none).  ``overrides`` patch individual fields,
    e.g. ``default_sampling("llama3_2_1b", seed=7)``."""
    from repro_torch.sampling.params import SamplingParams
    name = name.replace("-", "_").replace(".", "_")
    kw = dict(SAMPLING_DEFAULTS.get(name, {}))
    kw.update(overrides)
    return SamplingParams(**kw)


def reduced_config(name: str):
    """Tiny same-family config exercising identical code paths on CPU."""
    cfg = get_config(name)
    updates = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=32,
    )
    if cfg.num_experts:
        updates.update(num_experts=4, experts_per_token=2, moe_d_ff=64,
                       capacity_factor=2.0)
    if cfg.num_shared_experts:
        updates.update(shared_d_ff=64)
    if cfg.use_mla:
        updates.update(q_lora_rank=64, kv_lora_rank=32, rope_head_dim=16,
                       head_dim=32)
    if cfg.family == "ssm":
        updates.update(ssm_state=16, ssm_head_dim=16)
    if cfg.family == "hybrid":
        updates.update(lru_width=128, local_window=64, num_layers=5,
                       num_heads=4, head_dim=32)
    if cfg.family == "audio":
        updates.update(encoder_layers=2, encoder_seq=32)
    if cfg.sliding_window:
        updates.update(sliding_window=64)
    if cfg.num_patches:
        updates.update(num_patches=8)
    return dataclasses.replace(cfg, **updates)
