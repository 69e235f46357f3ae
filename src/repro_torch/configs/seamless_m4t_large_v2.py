"""SeamlessM4T-large-v2 backbone — enc-dec, multimodal [arXiv:2308.11596].

The mel-spectrogram + conv feature extractor frontend is a STUB per the
assignment carve-out: ``input_specs()`` supplies precomputed frame embeddings
of shape (batch, num_frames, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    num_layers=24,          # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    num_frames=1024,        # stubbed conv-frontend output frames
    source="arXiv:2308.11596",
)
