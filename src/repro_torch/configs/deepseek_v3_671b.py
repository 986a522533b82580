"""deepseek-v3-671b [moe]: 61L d=7168 128H MLA, MoE 256e top-8 + 1 shared,
expert d_ff=2048, vocab=129280, MTP, first 3 layers dense [arXiv:2412.19437]."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,             # MLA: latent-compressed, per-head on expand
    head_dim=192,                 # qk_nope(128) + qk_rope(64)
    d_ff=2048,                    # per-expert intermediate (assigned value)
    vocab_size=129280,
    attention="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, num_shared_experts=1, top_k=8,
                  expert_d_ff=2048, router_aux_free=True, router_scale=2.5,
                  first_k_dense=3, first_dense_d_ff=18432),
    mtp_depth=1,
    source="arXiv:2412.19437 (hf)",
)
