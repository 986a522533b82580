"""whisper-base [audio]: 6L enc + 6L dec, d=512 8H d_ff=2048 vocab=51865,
enc-dec; conv frontend is a stub (precomputed frame embeddings)
[arXiv:2212.04356]. RoPE replaces whisper's sinusoidal/learned positions
(TPU-idiomatic; noted in DESIGN.md)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    encoder_layers=6,
    encoder_seq_len=1500,         # 30s of audio at 50 frames/s (stub)
    ffn_act="gelu",
    source="arXiv:2212.04356 (unverified)",
)
