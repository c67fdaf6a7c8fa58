"""Mamba2-370M: 48L d_model=1024, attention-free SSD, ssm_state=128.
[arXiv:2405.21060; unverified]"""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_groups=1,
    head_dim=1,
)
