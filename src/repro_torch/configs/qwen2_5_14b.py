"""Qwen2.5-14B — dense, GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    arch_type="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    source="hf:Qwen/Qwen2.5-0.5B",
)
