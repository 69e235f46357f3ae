"""Robust Eq. 3 edge aggregation: trimmed mean, median and update
clipping, the reference's ``fed/robust.py`` on the port's row layout.

The paper's Eq. 3 is a participation-weighted mean over each edge
server's cohort, so one corrupted update (``FaultSpec.corrupt_rate``)
moves the edge model arbitrarily far. ``TrainSpec(aggregator=...)``
swaps the rule without touching the round:

  * ``"mean"``: the paper's rule, ``masked_aggregate_rows`` unchanged
    (the ``masked_aggregate`` kernel on CUDA);
  * ``"trimmed_mean"``: per coordinate, drop the ``k`` lowest and ``k``
    highest of the cohort's ``c`` values and average the rest, with
    ``k = min(max(1, floor(trim_frac * c)), (c - 1) // 2)`` for
    ``c >= 3`` (``trim_frac * c`` in float32) and ``k = 0`` below;
  * ``"median"``: the per-coordinate cohort median (the mean of the two
    middle order statistics for even ``c``);
  * ``"clipped"``: each update's L2 norm is clipped to the cohort's
    median norm, then Eq. 3's weighted mean.

The robust rules are plain PyTorch on the device (``torch.sort``,
``torch.linalg.vector_norm``), as the reference's are jnp and not
Pallas; they read no value back to the host. A slot counts where its
weight is > 0; an ES with no such slot keeps its params under every
rule.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.kernels.masked_aggregate.ops import masked_aggregate_rows

AGGREGATORS = ("mean", "trimmed_mean", "median", "clipped")


def _sorted_valid(flat_d: torch.Tensor, valid: torch.Tensor
                  ) -> torch.Tensor:
    """Per-coordinate ascending sort over the slots (axis 1) with the
    invalid slots keyed +inf, then every non-finite value (those slots,
    and a NaN or inf of a diverged update) as 0."""
    keyed = torch.where(valid[:, :, None], flat_d,
                        torch.full_like(flat_d, torch.inf))
    s = torch.sort(keyed, dim=1).values
    return torch.where(torch.isfinite(s), s, torch.zeros_like(s))


def _middle(s: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The mean of the two middle order statistics of the first ``c``
    sorted values along axis 1 (0 where ``c`` is 0)."""
    lo = torch.clamp((c - 1) // 2, min=0)
    hi = torch.clamp(c // 2, min=0)
    shape = (s.shape[0], 1) + s.shape[2:]
    v_lo = torch.gather(s, 1, lo.expand(shape)).squeeze(1)
    v_hi = torch.gather(s, 1, hi.expand(shape)).squeeze(1)
    return 0.5 * (v_lo + v_hi)


def _trimmed_mean(flat_d, valid, count, trim_frac: float):
    s = _sorted_valid(flat_d, valid)                     # (R, S, D)
    c = count.view(-1, 1, 1)
    frac = torch.tensor(np.float32(trim_frac), device=c.device)
    k = torch.minimum(torch.clamp(torch.floor(frac * c.to(torch.float32))
                                  .to(torch.int32), min=1),
                      (c - 1) // 2)
    k = torch.where(c >= 3, k, torch.zeros_like(k))
    ranks = torch.arange(s.shape[1], dtype=torch.int32,
                         device=s.device).view(1, -1, 1)
    keep = ((ranks >= k) & (ranks < c - k)).to(torch.float32)
    kept = torch.clamp(keep.sum(dim=1), min=1.0)         # (R, 1) = c - 2k
    return (s * keep).sum(dim=1) / kept


def _median(flat_d, valid, count):
    return _middle(_sorted_valid(flat_d, valid), count.view(-1, 1, 1))


def _clipped_mean(flat_d, w, valid, count):
    norms = torch.linalg.vector_norm(flat_d, dim=2)      # (R, S)
    s = _sorted_valid(norms[:, :, None], valid)[:, :, 0]
    med = _middle(s, count.view(-1, 1))[:, None]         # (R, 1)
    scale = torch.clamp(med / torch.clamp(norms, min=1e-12), max=1.0)
    clipped = flat_d * scale[:, :, None]
    denom = torch.clamp(w.sum(dim=1), min=1.0)
    return torch.einsum("rs,rsd->rd", w, clipped) / denom[:, None]


def robust_aggregate_rows(edge_params: Dict[str, torch.Tensor],
                          deltas: torch.Tensor, weights: torch.Tensor, *,
                          aggregator: str = "mean",
                          trim_frac: float = 0.1
                          ) -> Dict[str, torch.Tensor]:
    """Eq. 3 under ``aggregator`` for every (seed, ES) row, with
    ``masked_aggregate_rows``' contract: ``edge_params`` leaves
    (S, M, ...), ``deltas`` (S*M, slots, D) (the leaves side by side in
    dict order), ``weights`` (S, M, slots) (0 for padded or dropped
    slots). The result keeps the params' layout and dtypes."""
    if aggregator == "mean":
        return masked_aggregate_rows(edge_params, deltas, weights)
    if aggregator not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}; "
                         f"available: {AGGREGATORS}")
    if weights.dim() != 3:
        raise ValueError(f"weights must be (S, M, slots), got "
                         f"{tuple(weights.shape)}")
    slots = weights.shape[-1]
    w = weights.reshape(-1, slots).to(torch.float32)
    r = w.shape[0]
    names = list(edge_params)
    dims = [edge_params[k][0, 0].numel() for k in names]
    flat_p = torch.cat([edge_params[k].reshape(r, -1).to(torch.float32)
                        for k in names], dim=1)
    flat_d = deltas.to(torch.float32)
    valid = w > 0
    count = valid.to(torch.int32).sum(dim=1)            # (R,)
    if aggregator == "trimmed_mean":
        agg = _trimmed_mean(flat_d, valid, count, float(trim_frac))
    elif aggregator == "median":
        agg = _median(flat_d, valid, count)
    else:                                                # "clipped"
        agg = _clipped_mean(flat_d, w, valid, count)
    # an ES with no contributor keeps its params under every rule
    agg = torch.where(count[:, None] > 0, agg, torch.zeros_like(agg))
    out = flat_p + agg
    pieces = torch.split(out, dims, dim=1)
    return {k: piece.reshape(edge_params[k].shape).to(edge_params[k].dtype)
            for k, piece in zip(names, pieces)}


def robust_aggregate_stacked(edge_params: Dict[str, torch.Tensor],
                             deltas: Dict[str, torch.Tensor],
                             weights: torch.Tensor, *,
                             aggregator: str = "mean",
                             trim_frac: float = 0.1
                             ) -> Dict[str, torch.Tensor]:
    """``robust_aggregate_rows`` for deltas given as a dict of
    (S, M, slots, ...) leaves, which are first concatenated (the
    reference's ``robust_aggregate_stacked`` on its rank-3 layout)."""
    r, slots = weights[..., 0].numel(), weights.shape[-1]
    flat_d = torch.cat([deltas[k].reshape(r, slots, -1).to(torch.float32)
                        for k in edge_params], dim=2)
    return robust_aggregate_rows(edge_params, flat_d, weights,
                                 aggregator=aggregator, trim_frac=trim_frac)


__all__ = ["AGGREGATORS", "robust_aggregate_rows",
           "robust_aggregate_stacked"]
