"""DeepSeek-R1 (671B) — the paper's own flagship model (bonus config).
61L d_model=7168, MLA (kv_lora 512, q_lora 1536, rope dim 64), MoE 256
experts top-8 + 1 shared, expert d_ff=2048.  Structure approximated:
all layers MoE (real model: first 3 dense).
[arXiv deepseek-v3/r1; unverified]"""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-r1-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=0, vocab_size=129280, head_dim=128,
    num_experts=256, experts_per_token=8, moe_d_ff=2048,
    num_shared_experts=1, shared_d_ff=2048,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
)
