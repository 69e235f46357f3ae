"""Plain PyTorch version of the masked_aggregate kernel:

    out[r, d] = param[r, d] + (sum_s w[r, s] * delta[r, s, d])
                              / max(sum_s w[r, s], 1)

Slots are accumulated in order, one multiply and one add each, as the
CUDA kernel does, so the two agree bitwise.
"""
from __future__ import annotations

import torch


def masked_aggregate_ref(params: torch.Tensor, deltas: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """params (R, D), deltas (R, S, D), weights (R, S), float32 ->
    (R, D)."""
    w = weights.to(torch.float32)
    acc = torch.zeros_like(params, dtype=torch.float32)
    denom = torch.zeros_like(w[:, 0])
    for s in range(w.shape[1]):
        denom = denom + w[:, s]
        acc = acc + w[:, s, None] * deltas[:, s].to(torch.float32)
    denom = torch.clamp(denom, min=1.0)[:, None]
    return params.to(torch.float32) + acc / denom
