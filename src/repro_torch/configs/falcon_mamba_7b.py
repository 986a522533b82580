"""falcon-mamba-7b [ssm]: 64L d_model=4096 attn-free vocab=65024 ssm_state=16.
Mamba-1 architecture [arXiv:2410.05355]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1,
    num_kv_heads=1,
    d_ff=0,                       # attn-free, no separate FFN (mamba block only)
    vocab_size=65024,
    attention="none",
    ssm=SSMConfig(state_dim=16, conv_kernel=4, expand=2),
    source="arXiv:2410.05355 (unverified)",
)
