"""Public wrappers of the Eq. 3 masked aggregation.

``masked_aggregate_flat`` routes one ``(R, D)`` problem: the CUDA kernel
for CUDA tensors, the plain version on the CPU. ``masked_aggregate_rows``
is the training loop's entry: parameter dicts with ``(S, M, ...)``
leaves, the deltas already in one ``(S*M, slots, D)`` buffer and
weights ``(S, M, slots)``. The (seed, ES) pairs fold into rows and the
leaves lie side by side along the flattened parameter axis, so every ES
of every seed aggregates in one launch. ``masked_aggregate_stacked``
takes the deltas as a dict of leaves instead, as the reference does.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.common import on_cuda
from repro_torch.kernels.masked_aggregate.ref import masked_aggregate_ref


def masked_aggregate_flat(params: torch.Tensor, deltas: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """params (R, D), deltas (R, S, D), weights (R, S) -> (R, D)."""
    if not on_cuda(params, deltas, weights):
        return masked_aggregate_ref(params, deltas, weights)
    from repro_torch.kernels.masked_aggregate.kernel import \
        masked_aggregate_kernel
    f32 = torch.float32
    return masked_aggregate_kernel(params.to(f32).contiguous(),
                                   deltas.to(f32).contiguous(),
                                   weights.to(f32).contiguous())


def masked_aggregate_rows(edge_params: Dict[str, torch.Tensor],
                          deltas: torch.Tensor, weights: torch.Tensor
                          ) -> Dict[str, torch.Tensor]:
    """Eq. 3 for every (seed, ES) row under its own mask, with
    denominator max(sum_s w, 1). ``edge_params`` leaves (S, M, ...);
    ``deltas`` (S*M, slots, D), the leaves flattened and laid side by
    side in dict order (what ``fed.batched.slot_train`` writes);
    ``weights`` (S, M, slots). The result keeps the params' layout and
    dtypes."""
    if weights.dim() != 3:
        raise ValueError(f"weights must be (S, M, slots), got "
                         f"{tuple(weights.shape)}")
    slots = weights.shape[-1]
    rows = weights.reshape(-1, slots)
    r = rows.shape[0]
    names = list(edge_params)
    dims = [edge_params[k][0, 0].numel() for k in names]
    flat_p = torch.cat([edge_params[k].reshape(r, -1).to(torch.float32)
                        for k in names], dim=1)
    out = masked_aggregate_flat(flat_p, deltas, rows)
    pieces = torch.split(out, dims, dim=1)
    return {k: piece.reshape(edge_params[k].shape).to(edge_params[k].dtype)
            for k, piece in zip(names, pieces)}


def masked_aggregate_stacked(edge_params: Dict[str, torch.Tensor],
                             deltas: Dict[str, torch.Tensor],
                             weights: torch.Tensor
                             ) -> Dict[str, torch.Tensor]:
    """``masked_aggregate_rows`` for deltas given as a dict of
    (S, M, slots, ...) leaves, which are first concatenated."""
    r, slots = weights[..., 0].numel(), weights.shape[-1]
    flat_d = torch.cat([deltas[k].reshape(r, slots, -1).to(torch.float32)
                        for k in edge_params], dim=2)
    return masked_aggregate_rows(edge_params, flat_d, weights)
