"""RWKV6 "Finch" 1.6B — attention-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    arch_type="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=0,          # attention-free
    num_kv_heads=0,
    d_ff=7168,
    vocab_size=65536,
    head_dim=64,          # rwkv6 time-mix head size
    ssm=SSMConfig(state_dim=64, head_dim=64, chunk_size=256),
    source="arXiv:2404.05892",
)
