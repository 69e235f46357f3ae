"""The batched training round: the static round spec, on-device
minibatch indices, per-slot local SGD, and ``train_round``, the one
training body every tier runs (packing, Eq. 2 local SGD, update
corruption, Eq. 6 masks, Eq. 3 aggregation under the spec's rule, cloud
sync).

Minibatch indices come from the same counter-based keys as the
reference's (``fold_in(fold_in(base_key, t), uid)`` with a per-(ES,
slot) id), so both packages draw the same samples.

The host-loop tier (tier 2, ``experiment.sweep.run_host``) calls
``train_round`` one seed and one round at a time, with a host-state
policy's assignment as a (1, N) tensor. Slot capacity is decided per
round (the round's largest per-ES cohort, or a pinned
``slots_per_es``); the slot order is the reference's ``_pack`` order
(ascending client index per ES) and padded slots carry weight 0, so the
capacity changes no result.

Update corruption (``FaultSpec.corrupt_rate``) is drawn from the *env*
seeds' fault stream (``sim.draws.fault_draws``, tag 11), never the
policy seeds': a corrupted slot's delta is scaled by ``corrupt_scale``
before the aggregation, on the device, so selections never see it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch import random as jr
from repro_torch.experiment.packing import (es_counts, pack_assignment,
                                            pack_capacity)
from repro_torch.fed.client import sgd_trajectory
from repro_torch.fed.edge import broadcast_global, effective_mask_multi
from repro_torch.fed.robust import robust_aggregate_rows
from repro_torch.models.logistic import Params
from repro_torch.sim.draws import fault_draws
from repro_torch.sim.faults import corrupt_mask


@dataclass(frozen=True)
class BatchedRoundSpec:
    """Static shape/hyperparameter bundle of one training round."""
    num_edge_servers: int
    steps: int            # E * batches_per_epoch local SGD steps (Eq. 2)
    lr: float
    z_min: int
    t_es: int
    model: str = "logreg"  # 'logreg' | 'logreg-t' | 'cnn'
    # the Eq. 3 rule (fed.robust); "mean" is the masked_aggregate path
    aggregator: str = "mean"
    trim_frac: float = 0.1


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


def corrupt_slots(faults, env_seeds: torch.Tensor, t: torch.Tensor,
                  ci: torch.Tensor, valid: torch.Tensor,
                  num_clients: int) -> torch.Tensor:
    """(S, M, slots) bool: a filled slot whose client's update is
    corrupted this round. ``env_seeds`` and ``t`` are (S,): the events
    come from each element's env seed and round
    (``fault_draws(...).corr_u``), so every tier draws the same ones."""
    corr_u = fault_draws(env_seeds, t, num_clients, ci.shape[1], ci.device,
                         ("corr_u",)).corr_u                   # (S, N)
    hit = corrupt_mask(faults, corr_u)
    return torch.gather(hit, 1, ci.reshape(ci.shape[0], -1).long()
                        ).view(ci.shape) & (valid > 0)


def _scale(faults, slot_c: torch.Tensor, valid: torch.Tensor
           ) -> torch.Tensor:
    return torch.where(slot_c, torch.full_like(valid, faults.corrupt_scale),
                       torch.ones_like(valid))


def corrupt_scale(faults, env_seeds: torch.Tensor, t: torch.Tensor,
                  ci: torch.Tensor, valid: torch.Tensor,
                  num_clients: int) -> torch.Tensor:
    """(S, M, slots) delta scale: ``faults.corrupt_scale`` on the
    ``corrupt_slots``, 1 elsewhere."""
    return _scale(faults, corrupt_slots(faults, env_seeds, t, ci, valid,
                                        num_clients), valid)


def train_round(spec: BatchedRoundSpec, edge: Dict[str, torch.Tensor],
                assign: torch.Tensor, rd, stacked, base_keys: torch.Tensor,
                batch: int, slots: Optional[int] = None, faults=None,
                env_seeds: Optional[torch.Tensor] = None,
                taps: bool = False):
    """Train one round's assignment for every batch element:
    ``assign`` (S, N) int, ``rd`` a ``Round`` of (S, ...) tensors (its
    ``t``, ``outcomes`` and ``latency`` are read), ``edge`` (S, M, ...).
    ``faults`` (a ``FaultSpec``) with a corruption rate scales the
    corrupted slots' deltas; ``env_seeds`` (S,) then names each
    element's env seed. Returns ``(edge', participants (S,), train_loss
    (S, 2))``: local SGD's loss at its first and last step, the mean
    over each element's filled slots (0 where it filled none). With
    ``taps`` a fourth element holds what the telemetry taps read
    (``obs.telemetry.round_frame``), each (S, M, slots): ``arrived``,
    ``valid``, the Eq. 3 weights ``w``, the slot deltas' squared norms
    ``slot_sq`` (after corruption) and ``slot_c``, the corrupted slots
    (None without corruption). The packing and the slot batches are
    made here; the rest is ``train_packed``."""
    m, steps = spec.num_edge_servers, spec.steps
    with record_function("round.train"):
        cap = pack_capacity(es_counts(assign, m), slots)
        ci, valid, arrived, tau = pack_assignment(assign, rd.outcomes,
                                                  rd.latency, m, cap)
        idx = device_batch_indices(base_keys, rd.t, ci, stacked.sizes,
                                   steps, batch)      # (S, M, cap, st, B)
        cl, il = ci.long()[..., None, None], idx.long()
        xb, yb = stacked.x[cl, il], stacked.y[cl, il]  # (S, M, cap, st, B..)
    return train_packed(spec, edge, ci, valid, arrived, tau, xb, yb, rd.t,
                        faults, env_seeds, assign.shape[1], taps)


def train_packed(spec: BatchedRoundSpec, edge: Dict[str, torch.Tensor],
                 ci: torch.Tensor, valid: torch.Tensor,
                 arrived: torch.Tensor, tau: torch.Tensor,
                 xb: torch.Tensor, yb: torch.Tensor, t: torch.Tensor,
                 faults=None, env_seeds: Optional[torch.Tensor] = None,
                 num_clients: int = 0, taps: bool = False):
    """``train_round`` from its packed cohort on: ``ci``/``valid``/
    ``arrived``/``tau`` (S, M, slots) as ``pack_assignment`` gives them,
    the slot batches ``xb`` (S, M, slots, steps, B, ...features) and
    ``yb`` (S, M, slots, steps, B), ``t`` (S,) the round. Local SGD,
    update corruption (from ``env_seeds`` over ``num_clients``), the Eq. 6
    masks, the Eq. 3 rule and the cloud sync; returns as
    ``train_round``. The sharded cohort engine calls it on its exchanged
    cohort."""
    m, steps = spec.num_edge_servers, spec.steps
    s, _, cap = ci.shape
    batch = yb.shape[-1]
    with record_function("round.train"):
        flat = s * m * cap
        batches = {"x": xb.reshape((flat, steps, batch) + xb.shape[5:]),
                   "y": yb.reshape(flat, steps, batch)}
        slot_params = {k: a[:, :, None].expand((s, m, cap) + a.shape[2:])
                       .reshape((flat,) + a.shape[2:])
                       for k, a in edge.items()}
        d = sum(a[0, 0].numel() for a in edge.values())
        deltas, step_loss = train_slots(
            slot_params, batches, spec,
            torch.empty((flat, d), dtype=torch.float32, device=ci.device),
            valid.reshape(flat))
        filled = valid.reshape(s, m * cap, 1) > 0
        ends = step_loss[:, [0, -1]].reshape(s, m * cap, 2)
        train_loss = torch.where(filled, ends, torch.zeros_like(ends)).sum(
            dim=1) / torch.clamp(filled.sum(dim=1), min=1)
        slot_c = None
        if faults is not None and faults.corrupt_rate > 0.0:
            slot_c = corrupt_slots(faults, env_seeds, t, ci, valid,
                                   num_clients)
            deltas.mul_(_scale(faults, slot_c, valid).reshape(flat, 1))
        w = effective_mask_multi(arrived.reshape(s * m, cap),
                                 tau.reshape(s * m, cap),
                                 valid.reshape(s * m, cap),
                                 spec.z_min).reshape(s, m, cap)
        if taps:
            record = {"arrived": arrived, "valid": valid, "w": w,
                      "slot_sq": deltas.square().sum(dim=1).view(s, m, cap),
                      "slot_c": slot_c}
    with record_function("round.aggregate"):
        new_edge = robust_aggregate_rows(edge, deltas.view(s * m, cap, d),
                                         w, aggregator=spec.aggregator,
                                         trim_frac=spec.trim_frac)
        if (int(t[0]) + 1) % spec.t_es == 0:
            new_edge = broadcast_global(new_edge)
    parts = (arrived * valid).sum(dim=(1, 2))
    if taps:
        return new_edge, parts, train_loss, record
    return new_edge, parts, train_loss
