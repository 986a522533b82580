"""mixtral-8x22b [moe]: 56L d=6144 48H (GQA kv=8) expert d_ff=16384
vocab=32768, 8 experts top-2, SWA [arXiv:2401.04088]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,                       # all FFNs are MoE
    vocab_size=32768,
    sliding_window=4096,
    rope_theta=1e6,
    moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=16384),
    source="arXiv:2401.04088 (hf)",
)
