"""Pixtral-12B backbone: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072.  Pixtral-ViT frontend is a STUB (precomputed patch
embeddings, 1024 patches).  [hf:mistralai/Pixtral-12B-2409; unverified]"""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=131072, head_dim=128, rope_theta=1000000000.0,
    num_patches=1024,
)
