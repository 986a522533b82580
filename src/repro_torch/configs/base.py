"""Config system: architecture, shape, parallelism and run configs.

Every assigned architecture gets one module in ``repro_torch.configs``
exposing ``CONFIG: ModelConfig``. Shapes are global (same four cells for
every LM arch). All configs are plain frozen dataclasses so they hash,
print and diff cleanly. A copy of ``repro/configs/base.py``, except that
``decode_kernel`` defaults to True.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Model architecture
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # routed experts (0 = dense model)
    num_shared_experts: int = 0     # always-on experts (DeepSeek style)
    top_k: int = 2
    expert_d_ff: int = 0            # per-expert intermediate size
    capacity_factor: float = 1.25
    router_aux_free: bool = False   # DeepSeek-V3 bias-based balancing
    router_scale: float = 1.0       # routed_scaling_factor
    first_k_dense: int = 0          # leading dense layers (DeepSeek-V3: 3)
    first_dense_d_ff: int = 0       # ffn width of those dense layers


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 selective SSM."""
    state_dim: int = 16
    conv_kernel: int = 4
    expand: int = 2                 # d_inner = expand * d_model
    dt_rank: int = 0                # 0 -> ceil(d_model / 16)
    scan_dtype: str = "float32"     # chunk-scan operand dtype (see ssm.py)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or max(1, -(-d_model // 16))


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    # attention flavour
    attention: str = "gqa"          # gqa | mla | none (pure ssm)
    sliding_window: int = 0         # 0 = full attention; >0 = SWA width
    global_attn_layers: Tuple[int, ...] = ()   # hybrid: layers w/ full attn
    rope_theta: float = 10000.0
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (hymba): run attention and SSM heads in parallel per layer
    parallel_ssm: bool = False
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq_len: int = 0        # frames from the (stubbed) conv frontend
    # vlm (internvl): stubbed ViT patch embeddings + projector
    vision_tokens: int = 0
    vision_embed_dim: int = 0
    # misc
    tie_embeddings: bool = False
    ffn_act: str = "swiglu"      # swiglu (3-matrix) | gelu (2-matrix)
    norm_eps: float = 1e-5
    mtp_depth: int = 0              # DeepSeek-V3 multi-token prediction depth
    dtype: str = "bfloat16"
    # scan-over-layers for compact HLO; unrolled when layer stack heterogeneous
    scan_layers: bool = True
    # decode attention through decode_attention_op: the CUDA kernel on a
    # CUDA tensor, its plain version on a CPU tensor (the JAX package's
    # default is off, its plain jnp path); False keeps the inline plain path
    decode_kernel: bool = True
    remat: str = "full"             # full | dots | none
    # source note for provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.moe is not None and self.moe.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.attention == "none"

    @property
    def supports_long_decode(self) -> bool:
        """True iff the decode path is sub-quadratic / bounded-state."""
        if self.is_attention_free:
            return True
        if self.parallel_ssm:  # hybrid: SWA + few global layers
            return True
        # SWA-everywhere models keep a rolling cache
        return self.sliding_window > 0 and not self.global_attn_layers

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an AR decoder (whisper = enc-dec)

    def num_params(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        d, h = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        per_layer = 0
        if self.attention == "gqa":
            per_layer += d * (nq * h) + 2 * d * (nkv * h) + (nq * h) * d
        elif self.attention == "mla":
            m = self.mla
            qh = m.qk_nope_head_dim + m.qk_rope_head_dim
            per_layer += d * m.q_lora_rank + m.q_lora_rank * nq * qh
            per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            per_layer += m.kv_lora_rank * nq * (m.qk_nope_head_dim + m.v_head_dim)
            per_layer += nq * m.v_head_dim * d
        if self.ssm is not None:
            di = self.ssm.expand * d
            dt = self.ssm.resolved_dt_rank(d)
            s = self.ssm.state_dim
            per_layer += d * 2 * di                      # in_proj (x, z)
            per_layer += di * self.ssm.conv_kernel       # conv1d
            per_layer += di * (dt + 2 * s) + dt * di     # x_proj + dt_proj
            per_layer += di * s + di                     # A_log, D
            per_layer += di * d                          # out_proj
        ffn_mats = 3 if self.ffn_act == "swiglu" else 2
        if self.is_moe:
            e = self.moe
            moe_layer = (e.num_experts + e.num_shared_experts) * 3 * d * e.expert_d_ff
            moe_layer += d * e.num_experts               # router
            dense_layer = ffn_mats * d * self.d_ff if self.d_ff else 0
            n_moe = self.num_layers - e.first_k_dense
            per_layer_ffn = 0  # accounted per-kind below
            total_ffn = n_moe * moe_layer + e.first_k_dense * dense_layer
        else:
            total_ffn = self.num_layers * (ffn_mats * d * self.d_ff if self.d_ff else 0)
        per_layer += 2 * d                               # norms
        total = self.num_layers * per_layer + total_ffn
        total += self.vocab_size * d                     # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d                 # lm head
        if self.encoder_layers:
            enc = self.encoder_layers * (4 * d * d + ffn_mats * d * self.d_ff + 2 * d)
            total += enc + self.encoder_layers * (4 * d * d)  # cross-attn
        if self.vision_tokens:
            total += self.vision_embed_dim * d + d * d   # projector (2-layer)
        return int(total)

    def num_active_params(self) -> int:
        """Params touched per token (MoE: only top-k + shared experts)."""
        if not self.is_moe:
            return self.num_params()
        e = self.moe
        d = self.d_model
        all_experts = e.num_experts * 3 * d * e.expert_d_ff
        active_experts = (e.top_k + e.num_shared_experts) * 3 * d * e.expert_d_ff
        n_moe = self.num_layers - e.first_k_dense
        return int(self.num_params() - n_moe * (all_experts + e.num_shared_experts * 3 * d * e.expert_d_ff) + n_moe * active_experts)


# ---------------------------------------------------------------------------
# Input shapes (assigned cells)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Parallelism / run configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParallelConfig:
    """How logical axes map onto the mesh; the §Perf hillclimb edits this."""
    dp_axes: Tuple[str, ...] = ("pod", "data")   # batch axes
    tp_axis: str = "model"                       # tensor-parallel axis
    fsdp_axis: str = "data"                      # param/optimizer shard axis ("" = pure DP)
    ep_axis: str = "model"                       # expert-parallel axis
    sp_axis: str = "data"                        # sequence-parallel axis for prefill
    shard_params_over_fsdp: bool = True
    shard_opt_state: bool = True                 # ZeRO-1
    sequence_parallel: bool = True               # shard long-seq activations
    vocab_parallel: bool = True
    remat: str = "full"
    microbatches: int = 1
    opt_state_dtype: str = "float32"             # float32 | bfloat16 | int8
    extra_rules: Tuple[Tuple[str, Optional[str]], ...] = ()

    def replace(self, **kw) -> "ParallelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    z_loss: float = 1e-4
    seed: int = 0
    checkpoint_every: int = 100
    grad_compression: str = "none"   # none | int8_ef


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    changes: dict = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        head_dim=16,
        scan_layers=cfg.scan_layers,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
        global_attn_layers=tuple(i for i in cfg.global_attn_layers if i < 2),
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq_len=min(cfg.encoder_seq_len, 16) if cfg.encoder_seq_len else 0,
        vision_tokens=min(cfg.vision_tokens, 4) if cfg.vision_tokens else 0,
        vision_embed_dim=32 if cfg.vision_embed_dim else 0,
        mtp_depth=cfg.mtp_depth,
        name=cfg.name + "-smoke",
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            expert_d_ff=64,
            first_k_dense=min(cfg.moe.first_k_dense, 1),
        )
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                   qk_nope_head_dim=16, qk_rope_head_dim=8,
                                   v_head_dim=16)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(cfg.ssm, state_dim=4, dt_rank=8)
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
