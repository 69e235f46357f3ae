"""Zamba2-1.2B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64, expand=2, head_dim=64, chunk_size=128),
    hybrid_attn_every=6,   # one shared attention block every 6 mamba blocks
    source="arXiv:2411.15242",
)
