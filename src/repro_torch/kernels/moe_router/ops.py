"""Public wrapper of the MoE router: a CUDA tensor launches the kernel,
a CPU tensor takes the plain version (through which autograd
differentiates). Both paths refuse what the kernel does not take
(``check_router_args``), so the CPU path accepts no input that CUDA would
refuse.

On CUDA the kernel's gates have no autograd history, so the call goes
through ``MoERouter``, an ``autograd.Function`` (recording nothing where
the logits want no gradient) whose backward is the gates' gradient in
torch ops: with the k picked logits l and gates g_j = exp(l_j) /
sum_i exp(l_i) (the softmax's normaliser over all E cancels),
dl_j = g_j (dg_j - sum_i g_i dg_i) on the picked experts and 0 on the
others. The indices take no gradient."""
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


def gate_grad(gates: torch.Tensor, idx: torch.Tensor,
              dgates: torch.Tensor, num_experts: int) -> torch.Tensor:
    """The logits' gradient (T, E) float32 from the gates' (T, k)."""
    g = gates.to(torch.float32)
    dg = dgates.to(torch.float32)
    local = g * (dg - torch.sum(g * dg, dim=-1, keepdim=True))
    return torch.zeros((g.shape[0], num_experts), dtype=torch.float32,
                       device=g.device).scatter_(1, idx.long(), local)


class MoERouter(torch.autograd.Function):
    """B6 on CUDA with the gates' gradient."""

    @staticmethod
    def forward(ctx, logits, top_k: int):
        from repro_torch.kernels.moe_router.kernel import moe_router_kernel
        gates, idx = moe_router_kernel(logits, top_k)
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(gates, idx)
        ctx.num_experts, ctx.dtype = logits.shape[1], logits.dtype
        return gates, idx

    @staticmethod
    def backward(ctx, dgates, didx):
        gates, idx = ctx.saved_tensors
        return (gate_grad(gates, idx, dgates, ctx.num_experts).to(ctx.dtype),
                None)


def moe_router(logits: torch.Tensor, top_k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (T, E) float32 or bfloat16 -> gates (T, k) float32 summing
    to 1, expert indices (T, k) int32."""
    if on_cuda(logits):
        if not logits.is_contiguous():
            logits = logits.contiguous()
        return MoERouter.apply(logits, top_k)
    check_router_args(logits, top_k)
    return moe_router_ref(logits, top_k)
