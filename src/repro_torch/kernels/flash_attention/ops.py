"""Public wrapper of flash attention in the model's layout.

``flash_attention`` takes (B, S, H, D) queries and (B, S, KV, D) keys and
values, as the reference's ``ops.flash_attention`` does, and hands their
transposed (B, H, S, D) views to the kernel: on CUDA nothing is copied,
and the kernel writes the output in the (B, S, H, D) layout, so the
returned tensor is contiguous. A CPU tensor takes the plain version,
through which autograd differentiates.

On CUDA the kernel's output has no autograd history of its own, so the
call goes through ``FlashAttention``, an ``autograd.Function`` whose
backward is the hand-written backward kernel
(``csrc/flash_attention_bwd.cu``); where no input wants a gradient
(serving), it records nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import on_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref


class FlashAttention(torch.autograd.Function):
    """B4 forward and backward on CUDA tensors in the model's layout."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        from repro_torch.kernels.flash_attention.kernel import \
            flash_attention_kernel
        out = flash_attention_kernel(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), causal=causal,
                                     window=window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out.transpose(1, 2)

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels.flash_attention.kernel import \
            flash_attention_bwd_kernel
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_kernel(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), out,
            dout.contiguous().transpose(1, 2), causal=ctx.causal,
            window=ctx.window)
        return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
                None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, S, KV, D) -> like q."""
    if on_cuda(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    return attention_ref(qt, kt, vt, causal=causal,
                         window=window).transpose(1, 2)
