"""Model architecture configs and the input-shape registry of the LM
serving slice.

A copy of the reference's ``configs/base.py`` (the port imports nothing
of the JAX package), with ``torch_dtype`` added. ``reduced()`` gives the
CPU-smoke variant (2 layers, d_model<=256, <=4 experts, float32) of the
same family, exactly as the reference's does.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    # shared (dense) expert d_ff; 0 disables the shared expert path
    d_ff_shared: int = 0
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2-style SSD / RWKV6 recurrence parameters."""
    state_dim: int = 64
    conv_width: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # one of ARCH_TYPES
    num_layers: int
    d_model: int
    num_heads: int                      # query heads (0 for attention-free)
    num_kv_heads: int                   # GQA KV heads
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # MoE / SSM / hybrid extras
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one shared attention block applied every k core blocks
    hybrid_attn_every: int = 0
    # sliding-window attention (0 = full attention); mixtral native,
    # dense archs use it only in the long-context serving mode
    sliding_window: int = 0
    # encoder-decoder (audio): number of encoder layers (decoder = num_layers)
    encoder_layers: int = 0
    # vlm: number of prefix image-patch embeddings supplied by the stub
    num_patches: int = 0
    # audio: number of input frames supplied by the stub frontend
    num_frames: int = 0
    dtype: str = "bfloat16"
    source: str = ""                    # citation from the assignment table

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def torch_dtype(self) -> torch.dtype:
        """The activation and weight dtype as a torch dtype."""
        return getattr(torch, self.dtype)

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if long_500k decode is runnable (sub-quadratic path exists)."""
        if self.arch_type in ("ssm", "hybrid"):
            return True
        if self.arch_type == "audio":
            return False  # enc-dec 500k target decode is not meaningful
        # dense / moe / vlm: runnable via sliding-window serving mode
        return True

    def reduced(self) -> "ModelConfig":
        """CPU smoke variant of the same family (2 layers, d<=512, <=4 experts)."""
        kw = dict(
            name=self.name + "-reduced",
            num_layers=2,
            d_model=min(self.d_model, 256),
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
        )
        nh = min(self.num_heads, 4) if self.num_heads else 0
        kw["num_heads"] = nh
        if self.num_kv_heads:
            kw["num_kv_heads"] = max(1, min(self.num_kv_heads, nh or 1))
        kw["head_dim"] = 64 if (nh or self.arch_type == "ssm") else 0
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 256),
                d_ff_shared=min(self.moe.d_ff_shared, 256),
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, state_dim=min(self.ssm.state_dim, 16),
                head_dim=32, chunk_size=32)
        if self.hybrid_attn_every:
            kw["hybrid_attn_every"] = 2
        if self.encoder_layers:
            kw["encoder_layers"] = 2
        if self.num_patches:
            kw["num_patches"] = 16
        if self.num_frames:
            kw["num_frames"] = 16
        if self.sliding_window:
            kw["sliding_window"] = 64
        kw["dtype"] = "float32"
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}


def param_count(cfg: ModelConfig) -> int:
    """Approximate parameter count (used for latency/cost models + roofline)."""
    d, L = cfg.d_model, cfg.num_layers
    hd = cfg.resolved_head_dim
    n = cfg.vocab_size * d  # embeddings
    if not cfg.tie_embeddings:
        n += cfg.vocab_size * d
    attn = d * (cfg.num_heads * hd) + 2 * d * (cfg.num_kv_heads * hd) \
        + (cfg.num_heads * hd) * d
    if cfg.moe is not None:
        ff = cfg.moe.num_experts * 3 * d * cfg.moe.d_ff_expert \
            + d * cfg.moe.num_experts \
            + (3 * d * cfg.moe.d_ff_shared)
    else:
        ff = 3 * d * cfg.d_ff
    if cfg.arch_type == "ssm":      # rwkv6: 5 dxd time-mix + channel-mix
        per_layer = 5 * d * d + 2 * d * cfg.d_ff + d * d
    elif cfg.arch_type == "hybrid":  # zamba2: mamba core only per layer...
        s = cfg.ssm
        dm = d * s.expand
        per_layer = d * (2 * dm + 2 * s.state_dim + dm // s.head_dim) + dm * d
    elif cfg.arch_type == "audio":   # enc-dec decoder adds cross-attention
        per_layer = 2 * attn + ff
    else:
        per_layer = attn + ff
    n += L * per_layer
    if cfg.arch_type == "hybrid":    # ...plus ONE shared attn+mlp block
        n += attn + ff
    if cfg.encoder_layers:
        n += cfg.encoder_layers * (attn + ff)
    return n


def active_param_count(cfg: ModelConfig) -> int:
    """Active params per token (MoE uses top-k experts only)."""
    if cfg.moe is None:
        return param_count(cfg)
    d, L = cfg.d_model, cfg.num_layers
    full = param_count(cfg)
    all_experts = L * cfg.moe.num_experts * 3 * d * cfg.moe.d_ff_expert
    active = L * cfg.moe.top_k * 3 * d * cfg.moe.d_ff_expert
    return full - all_experts + active
