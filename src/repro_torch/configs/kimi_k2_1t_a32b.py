"""Kimi K2 — trillion-param MoE (paper-table) [arXiv:2501.kimi2]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    head_dim=128,
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048),
    source="arXiv:2501.kimi2",
)
