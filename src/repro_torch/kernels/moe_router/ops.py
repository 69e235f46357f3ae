"""Public wrapper of the MoE router: a CUDA tensor launches the kernel,
a CPU tensor takes the plain version. Both paths refuse what the kernel
does not take (``check_router_args``), so the CPU path accepts no input
that CUDA would refuse."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.common import on_cuda
from repro_torch.kernels.moe_router.ref import moe_router_ref

MAX_EXPERTS = 384        # kimi-k2's expert count
MAX_TOP_K = 8
DTYPES = (torch.float32, torch.bfloat16)


def check_router_args(logits: torch.Tensor, top_k: int) -> None:
    if logits.dtype not in DTYPES:
        raise TypeError(f"logits: dtype {logits.dtype}, expected one of "
                        f"{list(DTYPES)}")
    if logits.dim() != 2:
        raise ValueError(f"logits: shape {tuple(logits.shape)}, expected "
                         f"(tokens, experts)")
    e = logits.shape[1]
    if not 1 <= e <= MAX_EXPERTS:
        raise ValueError(f"{e} experts; the kernel takes 1 to "
                         f"{MAX_EXPERTS}")
    if not 1 <= top_k <= min(MAX_TOP_K, e):
        raise ValueError(f"top_k {top_k}; the kernel takes 1 to "
                         f"min({MAX_TOP_K}, experts = {e})")


def moe_router(logits: torch.Tensor, top_k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (T, E) float32 or bfloat16 -> gates (T, k) float32 summing
    to 1, expert indices (T, k) int32."""
    if on_cuda(logits):
        from repro_torch.kernels.moe_router.kernel import moe_router_kernel
        return moe_router_kernel(logits if logits.is_contiguous()
                                 else logits.contiguous(), top_k)
    check_router_args(logits, top_k)
    return moe_router_ref(logits, top_k)
