"""internvl2-2b [vlm]: 24L d=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
InternViT frontend is a stub (precomputed patch embeddings) + projector
[arXiv:2404.16821]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    vision_tokens=256,            # 448x448 / 14 patch / pixel-shuffle 2x2
    vision_embed_dim=1024,        # InternViT-300M width
    source="arXiv:2404.16821 (hf)",
)
