"""The HFL training block: environment, policy, training, evaluation.

One block covers one eval interval for all seeds at once, as a Python
loop over its rounds:

    Eq. 4-6 context generation (sim.core.round_batch)        [env]
    select (P2 / P3 greedy, or Random's scan)  ->  update     [policy]
    packing  ->  minibatch indices  ->  Eq. 2 local SGD
    Eq. 6 deadline masks  ->  Eq. 3 masked aggregation
    ->  cloud sync every t_es rounds                           [training]

then one test-set evaluation. The seed axis is a batch dimension in
every stage; each kernel on the round's path launches once per round for
all seeds: context_pairwise, the selection's (budgeted_topk for P2;
budgeted_topk's sort and flgreedy_walk for P3; random_assign for
Random), masked_aggregate.

Slot capacity is decided per round: the largest per-ES cohort of that
round's assignment, or the caller's pinned ``slots``. Padded slots carry weight 0, and minibatch keys depend
only on the slot's position, so the results do not depend on it.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch.profiler import record_function

from repro_torch.core.fmath import mul_rcp, sqrt_rn
from repro_torch.experiment.packing import es_counts, pack_assignment
from repro_torch.fed.batched import (BatchedRoundSpec, device_batch_indices,
                                     train_slots)
from repro_torch.fed.edge import broadcast_global, effective_mask_multi
from repro_torch.kernels.masked_aggregate.ops import masked_aggregate_rows
from repro_torch.models.logistic import accuracy, batched_logits, \
    softmax_xent
from repro_torch.policies.base import FunctionalPolicy, Round
from repro_torch.sim.core import SimStatics, round_batch
from repro_torch.sim.spec import SimSpec


class RoundOut(NamedTuple):
    assign: torch.Tensor        # (S, N) int32
    utility: torch.Tensor       # (S,)
    participants: torch.Tensor  # (S,)
    explored: torch.Tensor      # (S,) bool
    train_loss: torch.Tensor    # (S, 2) local SGD's first and last step


class BlockOut(NamedTuple):
    """Per-block outputs (leading axes: S seeds, T block rounds)."""
    policy_state: object
    edge_params: Dict[str, torch.Tensor]
    env_pos: torch.Tensor        # (S, N, 2)
    selections: torch.Tensor     # (S, T, N) int32
    utilities: torch.Tensor      # (S, T)
    participants: torch.Tensor   # (S, T)
    explored: torch.Tensor       # (S, T) bool
    train_loss: torch.Tensor     # (S, T, 2) local SGD, first / last step
    accuracy: torch.Tensor       # (S,) test accuracy at block end
    loss: torch.Tensor           # (S,) test loss at block end


def _capacity(assign: torch.Tensor, m: int, slots: Optional[int]) -> int:
    peak = max(int(es_counts(assign, m).max()), 1)
    if slots is None:
        return peak
    if peak > slots:
        raise ValueError(
            f"a round assigned {peak} clients to one ES but slots_per_es="
            f"{slots}; raise slots_per_es or leave it None")
    return slots


def train_round_step(policy: FunctionalPolicy, spec: BatchedRoundSpec,
                     pstate, edge: Dict[str, torch.Tensor], rd: Round,
                     stacked, base_keys: torch.Tensor, batch: int,
                     slots: Optional[int] = None):
    """One training round for all seeds:
    ``(pstate, edge, rd) -> (pstate', edge', RoundOut)``. The
    ``round.*`` profiler labels mark the stages (``chip_smoke.py
    --profile`` reads them)."""
    m, steps = spec.num_edge_servers, spec.steps
    s = rd.costs.shape[0]
    with record_function("round.select"):
        assign, aux = policy.select(pstate, rd)
        new_pstate = policy.update(pstate, rd, assign, aux)
    with record_function("round.train"):
        cap = _capacity(assign, m, slots)
        ci, valid, arrived, tau = pack_assignment(assign, rd.outcomes,
                                                  rd.latency, m, cap)
        idx = device_batch_indices(base_keys, rd.t, ci, stacked.sizes,
                                   steps, batch)      # (S, M, cap, st, B)
        cl, il = ci.long()[..., None, None], idx.long()
        flat = s * m * cap
        xb = stacked.x[cl, il]                        # (S, M, cap, st, B, F)
        batches = {"x": xb.reshape((flat, steps, batch) + xb.shape[5:]),
                   "y": stacked.y[cl, il].reshape(flat, steps, batch)}
        slot_params = {k: a[:, :, None].expand((s, m, cap) + a.shape[2:])
                       .reshape((flat,) + a.shape[2:])
                       for k, a in edge.items()}
        d = sum(a[0, 0].numel() for a in edge.values())
        deltas, step_loss = train_slots(
            slot_params, batches, spec,
            torch.empty((flat, d), dtype=torch.float32, device=ci.device),
            valid.reshape(flat))
        # the mean over a seed's filled slots of local SGD's loss at its
        # first and its last step (0 where a seed filled none)
        filled = valid.reshape(s, m * cap, 1) > 0
        ends = step_loss[:, [0, -1]].reshape(s, m * cap, 2)
        train_loss = torch.where(filled, ends, torch.zeros_like(ends)).sum(
            dim=1) / torch.clamp(filled.sum(dim=1), min=1)
        w = effective_mask_multi(arrived.reshape(s * m, cap),
                                 tau.reshape(s * m, cap),
                                 valid.reshape(s * m, cap),
                                 spec.z_min).reshape(s, m, cap)
    with record_function("round.aggregate"):
        new_edge = masked_aggregate_rows(edge, deltas.view(s * m, cap, d),
                                         w)
        if (int(rd.t[0]) + 1) % spec.t_es == 0:
            new_edge = broadcast_global(new_edge)
    parts = (arrived * valid).sum(dim=(1, 2))
    # Eq. 19's sqrt(parts / M), the division XLA's reciprocal multiply
    util = (sqrt_rn(mul_rcp(parts, m)) if policy.spec.sqrt_utility
            else parts)
    explored = aux.get("explored", torch.zeros(s, dtype=torch.bool,
                                               device=parts.device))
    return new_pstate, new_edge, RoundOut(assign, util, parts, explored,
                                          train_loss)


def block_eval(edge: Dict[str, torch.Tensor], test_x: torch.Tensor,
               test_y: torch.Tensor, model: str = "logreg"):
    """Per seed: the global model (mean over its M edge models) on the
    test set -> (accuracy (S,), loss (S,))."""
    glob = {k: a.mean(dim=1) for k, a in edge.items()}
    logits = batched_logits(model, glob, test_x)     # (S, T, C)
    y = test_y.expand(logits.shape[:-1])
    return accuracy(logits, y), softmax_xent(logits, y)


def block_device(policy: FunctionalPolicy, spec: BatchedRoundSpec,
                 sim_spec: SimSpec, pstate, edge: Dict[str, torch.Tensor],
                 env_pos: torch.Tensor, seeds: torch.Tensor,
                 statics: SimStatics, lo: int, hi: int, stacked,
                 base_keys: torch.Tensor, batch: int,
                 test_x: torch.Tensor, test_y: torch.Tensor,
                 slots: Optional[int] = None) -> BlockOut:
    """Rounds ``lo .. hi-1`` with the environment generated in the loop,
    then one evaluation."""
    outs = []
    pos = env_pos
    for t in range(lo, hi):
        with record_function("round.env"):
            pos, rd = round_batch(sim_spec, seeds, statics, pos, t)
        pstate, edge, out = train_round_step(policy, spec, pstate, edge,
                                             rd, stacked, base_keys, batch,
                                             slots)
        outs.append(out)
    with record_function("round.eval"):
        acc, loss = block_eval(edge, test_x, test_y, spec.model)
    col = lambda f: torch.stack([getattr(o, f) for o in outs], dim=1)
    return BlockOut(policy_state=pstate, edge_params=edge, env_pos=pos,
                    selections=col("assign"), utilities=col("utility"),
                    participants=col("participants"),
                    explored=col("explored"), train_loss=col("train_loss"),
                    accuracy=acc, loss=loss)
