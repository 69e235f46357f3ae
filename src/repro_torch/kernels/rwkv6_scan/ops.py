"""Public wrapper of the RWKV6 WKV scan: a CUDA tensor launches the
kernel, a CPU tensor takes the plain per-step version (through which
autograd differentiates).

On CUDA the (B, H, T, dk) views are passed as they are (the model's
transposed (B, T, H, dk) tensors, no copy), and y comes back as the
(B, H, T, dv) view of a (B, T, H, dv) tensor. The kernel's outputs have
no autograd history, so the call goes through ``Rwkv6Scan``, an
``autograd.Function`` whose backward is the hand-written backward kernel
(``csrc/rwkv6_scan_bwd.cu``); where no input wants a gradient (serving),
it records nothing."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.common import on_cuda
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref


class Rwkv6Scan(torch.autograd.Function):
    """B5 forward and backward on CUDA tensors. A gradient that does not
    reach y or the final state comes in as None (not materialised)."""

    @staticmethod
    def forward(ctx, r, k, v, log_w, u):
        from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_kernel
        ctx.set_materialize_grads(False)
        y, fin = rwkv6_scan_kernel(r, k, v, log_w, u)
        ctx.save_for_backward(r, k, v, log_w, u)
        return y, fin

    @staticmethod
    def backward(ctx, dy, dfin):
        from repro_torch.kernels.rwkv6_scan.kernel import \
            rwkv6_scan_bwd_kernel
        r, k, v, log_w, u = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        elif dy.stride(-1) != 1:
            dy = dy.contiguous()
        if dfin is not None:
            dfin = dfin.contiguous()
        return rwkv6_scan_bwd_kernel(r, k, v, log_w, u, dy, dfin)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_w: torch.Tensor, u: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, log_w (B, H, T, dk); v (B, H, T, dv); u (H, dk) -> y
    (B, H, T, dv) and the final state (B, H, dk, dv), float32."""
    if not on_cuda(r, k, v, log_w, u):
        return rwkv6_scan_ref(r, k, v, log_w, u)
    return Rwkv6Scan.apply(r, k, v, log_w, u)
