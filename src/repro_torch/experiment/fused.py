"""The HFL training block: environment, policy, training, evaluation.

One block covers one eval interval for all seeds at once, as a Python
loop over its rounds:

    Eq. 4-6 context generation (sim.core.round_batch), or the
    host env's realized rounds (block_host)                   [env]
    select (P2 / P3 greedy, or Random's scan)  ->  update     [policy]
    packing  ->  minibatch indices  ->  Eq. 2 local SGD
    Eq. 6 deadline masks  ->  Eq. 3 masked aggregation
    ->  cloud sync every t_es rounds                           [training]

then one test-set evaluation. With ``telemetry`` each round also
records a ``obs.telemetry.TelemetryFrame`` from the policy state at
select time and the round's own intermediates, and the block its
running totals; nothing else changes. The seed axis is a batch dimension in
every stage (the grids flatten config cells into it); each kernel on the
round's path launches once per round for all seeds: context_pairwise
(device env only; the host env is numpy), the selection's (budgeted_topk
for P2; budgeted_topk's sort and flgreedy_walk for P3; random_assign for
Random), masked_aggregate. The training part, ``fed.batched.train_round``,
is the host-loop tier's (tier 2) too.

Faults: a device env injects dropout, stragglers and outages in its
rounds (``sim.core``); update corruption is the training round's, drawn
from each element's env seed (``seeds`` in ``block_device``,
``env_seeds`` in ``block_host``), and the spec's ``aggregator`` picks
the Eq. 3 rule (``fed.robust``: ``mean`` launches masked_aggregate, the
robust rules are plain PyTorch on the device).

Slot capacity is decided per round: the largest per-ES cohort of that
round's assignment, or the caller's pinned ``slots``. Padded slots
carry weight 0, and minibatch keys depend only on the slot's position,
so the results do not depend on it.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch.profiler import record_function

from repro_torch.core.fmath import mul_rcp, sqrt_rn
from repro_torch.fed.batched import BatchedRoundSpec, train_round
from repro_torch.models.logistic import accuracy, batched_logits, \
    softmax_xent
from repro_torch.obs.telemetry import (TelemetryFrame, acc_init,
                                       acc_update, round_frame)
from repro_torch.policies.base import FunctionalPolicy, Round
from repro_torch.sim.core import SimStatics, round_batch
from repro_torch.sim.spec import SimSpec


class RoundOut(NamedTuple):
    assign: torch.Tensor        # (S, N) int32
    utility: torch.Tensor       # (S,)
    participants: torch.Tensor  # (S,)
    explored: torch.Tensor      # (S,) bool
    train_loss: torch.Tensor    # (S, 2) local SGD's first and last step
    frame: Optional[TelemetryFrame] = None   # with telemetry only


class BlockOut(NamedTuple):
    """Per-block outputs (leading axes: S seeds, T block rounds)."""
    policy_state: object
    edge_params: Dict[str, torch.Tensor]
    env_pos: Optional[torch.Tensor]   # (S, N, 2); None on a host env
    selections: torch.Tensor     # (S, T, N) int32
    utilities: torch.Tensor      # (S, T)
    participants: torch.Tensor   # (S, T)
    explored: torch.Tensor       # (S, T) bool
    train_loss: torch.Tensor     # (S, T, 2) local SGD, first / last step
    accuracy: torch.Tensor       # (S,) test accuracy at block end
    loss: torch.Tensor           # (S,) test loss at block end
    # with telemetry only: (S, T) series a metric, (S,) block totals
    telemetry: Optional[TelemetryFrame] = None
    tele_acc: Optional[object] = None


def train_round_step(policy: FunctionalPolicy, spec: BatchedRoundSpec,
                     pstate, edge: Dict[str, torch.Tensor], rd: Round,
                     stacked, base_keys: torch.Tensor, batch: int,
                     slots: Optional[int] = None,
                     budgets: Optional[torch.Tensor] = None, faults=None,
                     env_seeds: Optional[torch.Tensor] = None,
                     telemetry: bool = False):
    """One training round for all batch elements:
    ``(pstate, edge, rd) -> (pstate', edge', RoundOut)``. ``budgets``
    (S, M) gives each element its per-ES budgets (the grids' budget
    axis, through ``select_with_budgets``); ``faults`` and ``env_seeds``
    (S,) go to ``train_round`` (update corruption); ``telemetry`` fills
    ``RoundOut.frame`` from ``pstate`` as the select saw it. The
    ``round.*`` profiler labels mark the stages (``chip_smoke.py
    --profile`` reads them)."""
    s = rd.costs.shape[0]
    with record_function("round.select"):
        if budgets is None:
            assign, aux = policy.select(pstate, rd)
        else:
            assign, aux = policy.select_with_budgets(pstate, rd, budgets)
        new_pstate = policy.update(pstate, rd, assign, aux)
    trained = train_round(spec, edge, assign, rd, stacked, base_keys,
                          batch, slots, faults, env_seeds, taps=telemetry)
    new_edge, parts, train_loss = trained[:3]
    # Eq. 19's sqrt(parts / M), the division XLA's reciprocal multiply
    util = (sqrt_rn(mul_rcp(parts, spec.num_edge_servers))
            if policy.spec.sqrt_utility else parts)
    explored = aux.get("explored", torch.zeros(s, dtype=torch.bool,
                                               device=parts.device))
    frame = (round_frame(policy, pstate, rd, assign, trained[3], budgets,
                         spec) if telemetry else None)
    return new_pstate, new_edge, RoundOut(assign, util, parts, explored,
                                          train_loss, frame)


def block_eval(edge: Dict[str, torch.Tensor], test_x: torch.Tensor,
               test_y: torch.Tensor, model: str = "logreg"):
    """Per seed: the global model (mean over its M edge models) on the
    test set -> (accuracy (S,), loss (S,))."""
    glob = {k: a.mean(dim=1) for k, a in edge.items()}
    logits = batched_logits(model, glob, test_x)     # (S, T, C)
    y = test_y.expand(logits.shape[:-1])
    return accuracy(logits, y), softmax_xent(logits, y)


def _block_out(pstate, edge, pos, outs, acc, loss, tacc=None) -> BlockOut:
    col = lambda f: torch.stack([getattr(o, f) for o in outs], dim=1)
    series = None
    if tacc is not None:
        series = TelemetryFrame(*(torch.stack(f, dim=1)
                                  for f in zip(*(o.frame for o in outs))))
    return BlockOut(policy_state=pstate, edge_params=edge, env_pos=pos,
                    selections=col("assign"), utilities=col("utility"),
                    participants=col("participants"),
                    explored=col("explored"), train_loss=col("train_loss"),
                    accuracy=acc, loss=loss, telemetry=series, tele_acc=tacc)


def block_device(policy: FunctionalPolicy, spec: BatchedRoundSpec,
                 sim_spec: SimSpec, pstate, edge: Dict[str, torch.Tensor],
                 env_pos: torch.Tensor, seeds: torch.Tensor,
                 statics: SimStatics, lo: int, hi: int, stacked,
                 base_keys: torch.Tensor, batch: int,
                 test_x: torch.Tensor, test_y: torch.Tensor,
                 slots: Optional[int] = None,
                 budgets: Optional[torch.Tensor] = None,
                 deadlines: Optional[torch.Tensor] = None,
                 telemetry: bool = False) -> BlockOut:
    """Rounds ``lo .. hi-1`` with the environment generated in the loop,
    then one evaluation. The grids' ``budgets`` (B, M) and ``deadlines``
    (B,) give each element its own cell: each round's Eq. 6 outcomes are
    re-thresholded against the element's deadline from the realized
    Eq. 5 latencies, the float32 comparison a ``SimSpec`` with that
    ``deadline_s`` makes. The env's faults (``sim_spec.faults``) act in
    its rounds, and their corruption in training, from ``seeds``.
    ``telemetry`` fills ``BlockOut.telemetry`` and ``tele_acc``."""
    outs = []
    pos = env_pos
    tacc = acc_init(seeds.shape[0], seeds.device) if telemetry else None
    for t in range(lo, hi):
        with record_function("round.env"):
            pos, rd = round_batch(sim_spec, seeds, statics, pos, t)
            if deadlines is not None:
                rd = rd._replace(outcomes=(
                    rd.latency <= deadlines.view(-1, 1, 1)).to(
                        torch.float32))
        pstate, edge, out = train_round_step(policy, spec, pstate, edge,
                                             rd, stacked, base_keys, batch,
                                             slots, budgets,
                                             sim_spec.faults, seeds,
                                             telemetry)
        if telemetry:
            tacc = acc_update(tacc, out.frame, out.explored)
        outs.append(out)
    with record_function("round.eval"):
        acc, loss = block_eval(edge, test_x, test_y, spec.model)
    return _block_out(pstate, edge, pos, outs, acc, loss, tacc)


def block_host(policy: FunctionalPolicy, spec: BatchedRoundSpec, pstate,
               edge: Dict[str, torch.Tensor], rounds: Round, stacked,
               base_keys: torch.Tensor, batch: int, test_x: torch.Tensor,
               test_y: torch.Tensor, slots: Optional[int] = None,
               budgets: Optional[torch.Tensor] = None, faults=None,
               env_seeds: Optional[torch.Tensor] = None,
               telemetry: bool = False) -> BlockOut:
    """A block over host-realized rounds (tier 3): ``rounds`` has
    (T, S, ...) leaves, one block of the host env's stacked rounds on
    the run's device, each round through the same ``train_round_step``
    as ``block_device``; then one evaluation. ``budgets`` (B, M) as
    there (a host grid's deadline cells are already in its rounds);
    ``faults`` is the host env's (its latency faults are already in the
    rounds; its corruption is drawn here from ``env_seeds`` (S,)).
    ``telemetry`` as in ``block_device``."""
    outs = []
    s = rounds.costs.shape[1]
    tacc = acc_init(s, rounds.costs.device) if telemetry else None
    for t in range(rounds.costs.shape[0]):
        rd = Round(*(f[t] for f in rounds))
        pstate, edge, out = train_round_step(policy, spec, pstate, edge,
                                             rd, stacked, base_keys, batch,
                                             slots, budgets, faults,
                                             env_seeds, telemetry)
        if telemetry:
            tacc = acc_update(tacc, out.frame, out.explored)
        outs.append(out)
    with record_function("round.eval"):
        acc, loss = block_eval(edge, test_x, test_y, spec.model)
    return _block_out(pstate, edge, None, outs, acc, loss, tacc)
