"""Qwen3-30B-A3B: 48L d_model=2048 32H (GQA kv=4) MoE 128 experts top-8,
expert d_ff=768, vocab=151936.  [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=0, vocab_size=151936, head_dim=128, rope_theta=1000000.0,
    num_experts=128, experts_per_token=8, moe_d_ff=768,
)
