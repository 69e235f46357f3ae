"""PaliGemma-3B language backbone — SigLIP + Gemma [arXiv:2407.07726].

The SigLIP vision tower + projector is a STUB per the assignment carve-out:
``input_specs()`` supplies precomputed patch embeddings (batch, 256, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    arch_type="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,         # MQA
    d_ff=16384,
    vocab_size=257216,
    head_dim=256,
    num_patches=256,
    source="arXiv:2407.07726",
)
