"""hymba-1.5b [hybrid]: 32L d=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
parallel attn+mamba heads, SWA everywhere except 3 global layers
[arXiv:2411.13676]. Meta tokens are not modeled (noted in DESIGN.md)."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    sliding_window=1024,
    global_attn_layers=(0, 15, 31),
    parallel_ssm=True,
    ssm=SSMConfig(state_dim=16, conv_kernel=4, expand=2),
    source="arXiv:2411.13676 (hf)",
)
