"""Public wrapper of the RWKV6 WKV scan: a CUDA tensor launches the
kernel, a CPU tensor takes the plain per-step version.

On CUDA the (B, H, T, dk) views are passed as they are (the model's
transposed (B, T, H, dk) tensors, no copy), and y comes back as the
(B, H, T, dv) view of a (B, T, H, dv) tensor."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.common import on_cuda
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_w: torch.Tensor, u: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, log_w (B, H, T, dk); v (B, H, T, dv); u (H, dk) -> y
    (B, H, T, dv) and the final state (B, H, dk, dv), float32."""
    if not on_cuda(r, k, v, log_w, u):
        return rwkv6_scan_ref(r, k, v, log_w, u)
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_kernel
    return rwkv6_scan_kernel(r, k, v, log_w, u)
