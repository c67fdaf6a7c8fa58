"""RecurrentGemma-2B: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000.  RG-LRU + local attention (window 2048), pattern 1:2 =
(rec, rec, attn) repeating; 26 = 8 units + 2 tail rec layers.
[arXiv:2402.19427; hf]"""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    act="gelu", logit_softcap=30.0,
    block_pattern=("rec", "rec", "attn"), lru_width=2560, local_window=2048,
)
