"""yi-9b [dense]: 48L d=4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-arch GQA [arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    source="arXiv:2403.04652 (hf)",
)
