"""Whisper-base backbone: 6L enc + 6L dec, d_model=512 8H d_ff=2048
vocab=51865.  Enc-dec; conv audio frontend is a STUB (input_specs provides
precomputed frame embeddings).  encoder_seq rounded 1500->1536 for even
sharding (DESIGN.md §5).  [arXiv:2212.04356; unverified]"""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865, head_dim=64,
    norm="layernorm", act="gelu",
    encoder_layers=6, encoder_seq=1536,
)
