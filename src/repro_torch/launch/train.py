"""Model presets for the port's launchers.

For now this module holds only ``PRESETS`` and ``scaled_config``, copied
from ``repro/launch/train.py`` (which imports JAX), so that the serving CLI
can size a model; the training CLI comes with the training slice.

Presets scale the *width/depth* of the chosen architecture family while
keeping its structure (GQA ratios, MoE top-k, SSM dims), so every assigned
arch has a runnable small variant: smoke (~1M), 20m, 100m, or the published
config (full).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, reduced

PRESETS = {
    "smoke": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                  d_ff=128, vocab_size=512, head_dim=16),
    "20m": dict(num_layers=4, d_model=384, num_heads=6, num_kv_heads=2,
                d_ff=1024, vocab_size=8192, head_dim=64),
    "100m": dict(num_layers=8, d_model=768, num_heads=12, num_kv_heads=4,
                 d_ff=2048, vocab_size=16384, head_dim=64),
    "full": {},
}


def scaled_config(arch: str, preset: str) -> ModelConfig:
    cfg = get_config(arch)
    if preset == "full":
        return cfg
    if preset == "smoke":
        return reduced(cfg)
    over = dict(PRESETS[preset])
    if cfg.is_moe:
        over["moe"] = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 8),
            expert_d_ff=over["d_ff"],
            first_k_dense=min(cfg.moe.first_k_dense, 1),
            first_dense_d_ff=over["d_ff"])
        over["d_ff"] = cfg.d_ff and over["d_ff"]
    if cfg.ssm is not None:
        over["ssm"] = cfg.ssm
        if cfg.d_ff == 0:
            over["d_ff"] = 0
    if cfg.vision_tokens:
        over["vision_tokens"] = min(cfg.vision_tokens, 16)
        over["vision_embed_dim"] = 128
    if cfg.encoder_layers:
        over["encoder_layers"] = min(cfg.encoder_layers, 4)
        over["encoder_seq_len"] = min(cfg.encoder_seq_len, 64)
    over["global_attn_layers"] = tuple(
        i for i in cfg.global_attn_layers if i < over["num_layers"])
    if cfg.sliding_window:
        over["sliding_window"] = min(cfg.sliding_window, 256)
    over["name"] = f"{cfg.name}-{preset}"
    return dataclasses.replace(cfg, **over)
