"""The batched training round's building blocks: the static round
spec, on-device minibatch indices, and per-slot local SGD.

Minibatch indices come from the same counter-based keys as the
reference's (``fold_in(fold_in(base_key, t), uid)`` with a per-(ES,
slot) id), so both packages draw the same samples.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch import random as jr
from repro_torch.fed.client import sgd_trajectory
from repro_torch.models.logistic import Params


@dataclass(frozen=True)
class BatchedRoundSpec:
    """Static shape/hyperparameter bundle of one training round."""
    num_edge_servers: int
    steps: int            # E * batches_per_epoch local SGD steps (Eq. 2)
    lr: float
    z_min: int
    t_es: int
    model: str = "logreg"  # 'logreg' | 'cnn'


def device_batch_indices(base_keys: torch.Tensor, t: torch.Tensor,
                         client_idx: torch.Tensor,
                         stacked_sizes: torch.Tensor, steps: int,
                         batch: int) -> torch.Tensor:
    """Minibatch indices for every (seed, ES, slot) of one round.

    base_keys (S, 2), t (S,), client_idx (S, M, slots). The key of slot
    (m, s) is ``fold_in(fold_in(base_key, t), m * N + s)``: it depends
    only on the slot's position, never on the capacity. Returns
    (S, M, slots, steps, batch) int32 indices below each slot's client's
    shard size."""
    s, m, slots = client_idx.shape
    n = stacked_sizes.shape[0]
    rkey = jr.fold_in(base_keys, t)                         # (S, 2)
    uid = (torch.arange(m, device=t.device)[:, None] * n
           + torch.arange(slots, device=t.device)[None, :]).reshape(-1)
    keys = jr.fold_in(rkey[:, None, :], uid[None, :])       # (S, M*sl, 2)
    sizes = stacked_sizes[client_idx.long()].reshape(s, m * slots)
    idx = jr.randint(keys, (steps, batch), 0, sizes[..., None, None])
    return idx.reshape(s, m, slots, steps, batch)


def train_slots(slot_params: Params, batches: Dict[str, torch.Tensor],
                spec: BatchedRoundSpec, out: torch.Tensor,
                valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 2 local SGD for every flattened slot (leading axis = slots).

    Writes each slot's delta into ``out`` (slots, D): the leaves
    flattened and laid side by side in dict order, the layout the
    masked aggregation reads, so no copy is made between the two. A slot
    that holds no client (``valid`` (slots,) 0) gets a zero delta, as the
    reference's skipped slots: its weight is 0, and a model that diverged
    on its padding must not put 0 * NaN into the aggregate. Returns
    ``out`` and each slot's loss at each step (slots, steps)."""
    final, losses = sgd_trajectory(slot_params, batches, spec.lr,
                                   spec.model)
    off = 0
    for k, p0 in slot_params.items():
        size = p0[0].numel()
        d = out[:, off:off + size]
        torch.sub(final[k], p0, out=d.view(p0.shape))
        if valid is not None:
            d.masked_fill_((valid <= 0).view(-1, 1), 0.0)
        off += size
    if off != out.shape[1]:
        raise ValueError(f"out has {out.shape[1]} columns, the params "
                         f"{off}")
    return out, losses


def slot_train(slot_params: Params, batches: Dict[str, torch.Tensor],
               spec: BatchedRoundSpec, out: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``train_slots``' deltas alone."""
    return train_slots(slot_params, batches, spec, out, valid)[0]
