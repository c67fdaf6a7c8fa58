"""SmolLM-360M: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
llama-architecture small model.  [hf:HuggingFaceTB/SmolLM-360M; hf]"""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
    d_ff=2560, vocab_size=49152, head_dim=64,
)
