"""Public wrapper of flash attention in the model's layout.

``flash_attention`` takes (B, S, H, D) queries and (B, S, KV, D) keys and
values, as the reference's ``ops.flash_attention`` does, and hands their
transposed (B, H, S, D) views to the kernel: on CUDA nothing is copied,
and the kernel writes the output in the (B, S, H, D) layout, so the
returned tensor is contiguous. A CPU tensor takes the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import on_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, S, KV, D) -> like q."""
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    if on_cuda(q, k, v):
        from repro_torch.kernels.flash_attention.kernel import \
            flash_attention_kernel
        out = flash_attention_kernel(qt, kt, vt, causal=causal,
                                     window=window)
    else:
        out = attention_ref(qt, kt, vt, causal=causal, window=window)
    return out.transpose(1, 2)
