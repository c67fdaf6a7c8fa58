"""Unified model API: configs, registry, and the functional model surface.

Every architecture in `repro_torch.configs` produces a `ModelConfig`; the
functions in `repro_torch.models.transformer` consume it.  Model code is
plain functions on tensors (a params dict in, tensors out), so the engine
and the tests can hold it to the JAX package function by function.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Tuple

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Static description of how mesh axes map to parallelism roles.

    batch: axes the global batch is sharded over (DP).
    model: axis used for TP/EP/sequence-split.
    """

    batch: Tuple[str, ...] = ("data",)
    model: Optional[str] = "model"

    @property
    def all(self) -> Tuple[str, ...]:
        return self.batch + ((self.model,) if self.model else ())


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention flavour ---
    attn_bias: bool = False            # qwen2-style QKV bias
    sliding_window: int = 0            # 0 = full attention
    rope_theta: float = 10000.0
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    act: Literal["silu", "gelu"] = "silu"
    logit_softcap: float = 0.0

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                  # per-expert hidden dim
    router_dtype: str = "float32"
    capacity_factor: float = 1.25
    num_shared_experts: int = 0
    shared_d_ff: int = 0

    # --- MLA (deepseek-style) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0

    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_groups: int = 1

    # --- hybrid (recurrentgemma): repeating unit of block kinds ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    local_window: int = 0

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0               # frontend frames (stub provides embeds)

    # --- vlm ---
    num_patches: int = 0               # vision stub patch count

    # --- numerics / misc ---
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    # ----- derived quantities -----
    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (total, all experts)."""
        from repro_torch.models import transformer

        return transformer.param_count(self)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        from repro_torch.models import transformer

        return transformer.param_count(self, active_only=True)


# ---------------------------------------------------------------------------
# Input shapes assigned to every LM-family architecture.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: Literal["train", "prefill", "decode"]
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether a (arch x shape) cell is exercised; see DESIGN.md §5."""
    if shape.name == "long_500k":
        sub_quadratic = (
            cfg.family in ("ssm", "hybrid")
            or cfg.sliding_window > 0
        )
        if not sub_quadratic:
            return False, "long_500k skipped: pure full-attention arch (quadratic)"
        if cfg.family == "audio":
            return False, "long_500k skipped: enc-dec audio backbone"
    return True, ""
