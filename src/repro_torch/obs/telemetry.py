"""On-device telemetry taps of the training tiers 3 and 4 (the
reference's ``obs/telemetry.py``).

A tap only observes: every number is derived from values the round
already computes (the policy state at select time, the assignment, the
Eq. 6 arrival masks, the slot deltas and the Eq. 3 weights). It draws
nothing and feeds nothing back, so with taps on the selections,
utilities and explored flags stay bitwise what they are with taps off.

* ``TelemetryFrame``: one (S,) float32 value a metric a round; a block
  stacks its rounds into (S, T) series.
* ``TelemetryAcc``: running (S,) totals, added to on the device each
  round and started at zero each block; ``collect`` sums the blocks'.

``collect``/``summarize`` build ``RunResult.telemetry``:
``{"series": {metric: (S, T)}, "totals": {metric: (S,)}, "summary":
{scalars}}``.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch


class TelemetryFrame(NamedTuple):
    """One round's observables, (S,) float32 each."""
    ucb_width: torch.Tensor      # mean CC-MAB confidence width, eligible pairs
    underexplored: torch.Tensor  # under-explored eligible pairs
    budget_util: torch.Tensor    # spent cost / the round's total budget
    selected: torch.Tensor       # clients selected this round
    arrived: torch.Tensor        # Eq. 6: selected clients within the deadline
    deadline_miss: torch.Tensor  # Eq. 6: selected clients that missed it
    delta_norm: torch.Tensor     # L2 norm over all weighted slot updates
    agg_adjusted: torch.Tensor   # slots the robust Eq. 3 rule trimmed/clipped
    corrupted: torch.Tensor      # corrupted filled slots


class TelemetryAcc(NamedTuple):
    """Running totals of a block, (S,) float32 each."""
    rounds: torch.Tensor
    explored: torch.Tensor       # rounds with an exploration step
    selected: torch.Tensor
    arrived: torch.Tensor
    deadline_miss: torch.Tensor
    corrupted: torch.Tensor


def acc_init(n: int, device=None) -> TelemetryAcc:
    z = torch.zeros((n,), dtype=torch.float32, device=device)
    return TelemetryAcc(*([z] * len(TelemetryAcc._fields)))


def acc_update(acc: TelemetryAcc, frame: TelemetryFrame,
               explored: torch.Tensor) -> TelemetryAcc:
    return TelemetryAcc(
        rounds=acc.rounds + 1.0,
        explored=acc.explored + explored.to(torch.float32),
        selected=acc.selected + frame.selected,
        arrived=acc.arrived + frame.arrived,
        deadline_miss=acc.deadline_miss + frame.deadline_miss,
        corrupted=acc.corrupted + frame.corrupted)


def aggregator_adjusted(aggregator: str, trim_frac: float, w: torch.Tensor,
                        slot_norms: torch.Tensor) -> torch.Tensor:
    """How many slot updates the Eq. 3 rule discounted this round, per
    batch element, by ``fed.robust``'s rank arithmetic over the same
    ``w > 0`` validity: the trimmed mean's ``2k`` a cohort, the order
    statistics the median drops, the updates whose norm exceeds the
    cohort's median norm under ``clipped``.

    w: (S, M, slots) Eq. 3 weights; slot_norms: (S, M, slots) L2 norms
    of the slot deltas (read by ``clipped`` only)."""
    valid = w > 0
    c = valid.to(torch.int32).sum(dim=2)                     # (S, M)
    if aggregator == "mean":
        return torch.zeros(w.shape[0], dtype=torch.float32, device=w.device)
    if aggregator == "trimmed_mean":
        frac = torch.tensor(np.float32(trim_frac), device=w.device)
        k = torch.minimum(torch.clamp(
            torch.floor(frac * c.to(torch.float32)).to(torch.int32), min=1),
            (c - 1) // 2)
        k = torch.where(c >= 3, k, torch.zeros_like(k))
        return (2 * k).sum(dim=1).to(torch.float32)
    if aggregator == "median":
        # an odd cohort keeps one order statistic, an even one two
        return torch.clamp(c - 2 + c % 2, min=0).sum(dim=1).to(torch.float32)
    if aggregator == "clipped":
        keyed = torch.where(valid, slot_norms,
                            torch.full_like(slot_norms, torch.inf))
        s = torch.sort(keyed, dim=2).values
        s = torch.where(torch.isfinite(s), s, torch.zeros_like(s))
        cc = c[:, :, None].long()
        lo = torch.clamp((cc - 1) // 2, min=0)
        hi = torch.clamp(cc // 2, min=0)
        med = 0.5 * (torch.gather(s, 2, lo) + torch.gather(s, 2, hi))
        return (valid & (slot_norms > med)).sum(dim=(1, 2)).to(torch.float32)
    raise ValueError(f"unknown aggregator {aggregator!r}")


def round_frame(policy, pstate, rd, assign: torch.Tensor, taps: dict,
                budgets: Optional[torch.Tensor], spec) -> TelemetryFrame:
    """One round's frame from the round's intermediates. ``pstate`` is
    the state at select time (before ``update``), so the policy's tap
    sees the counts the solver saw. ``taps`` is ``train_round``'s
    (``arrived``, ``valid``, ``w``, ``slot_sq`` (S, M, slots), ``slot_c``
    or None); ``budgets`` None (the policy spec's budget) or (S, M)."""
    s = assign.shape[0]
    m = taps["w"].shape[1]
    zeros = torch.zeros((s,), dtype=torch.float32, device=assign.device)
    tap = policy.telemetry_tap(pstate, rd)
    ucb_width = tap.get("ucb_width", zeros).to(torch.float32)
    under = tap.get("underexplored", zeros).to(torch.float32)

    sel_mask = assign >= 0
    selected = sel_mask.sum(dim=1).to(torch.float32)
    costs = rd.costs.to(torch.float32)
    spent = torch.where(sel_mask, costs, torch.zeros_like(costs)).sum(dim=1)
    if budgets is None:
        total = torch.full((s,), float(policy.spec.budget) * m,
                           dtype=torch.float32, device=assign.device)
    else:
        total = budgets.to(torch.float32).sum(dim=1)
    budget_util = spent / torch.clamp(total, min=1e-12)

    v = taps["valid"] > 0
    a = (taps["arrived"] > 0) & v
    arrived = a.sum(dim=(1, 2)).to(torch.float32)
    miss = (v & ~a).sum(dim=(1, 2)).to(torch.float32)

    w = taps["w"]
    slot_sq = taps["slot_sq"]
    delta_norm = torch.sqrt((slot_sq * (w > 0).to(torch.float32))
                            .sum(dim=(1, 2)))
    adjusted = aggregator_adjusted(spec.aggregator, float(spec.trim_frac),
                                   w, torch.sqrt(slot_sq))
    slot_c = taps.get("slot_c")
    corrupted = (zeros if slot_c is None
                 else (slot_c & v).sum(dim=(1, 2)).to(torch.float32))
    return TelemetryFrame(ucb_width=ucb_width, underexplored=under,
                          budget_util=budget_util, selected=selected,
                          arrived=arrived, deadline_miss=miss,
                          delta_norm=delta_norm, agg_adjusted=adjusted,
                          corrupted=corrupted)


# -- host-side collection -----------------------------------------------------


def _as_dict(t, fields) -> Dict[str, np.ndarray]:
    # a block's NamedTuple, or the plain dict a restored checkpoint holds
    if isinstance(t, dict):
        return {k: _np(t[k]) for k in fields}
    return {k: _np(getattr(t, k)) for k in fields}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def collect(frames: List[object], accs: List[object]) -> Optional[dict]:
    """``RunResult.telemetry`` from the blocks: the (S, T_b) frames
    concatenated into full-horizon series, the blocks' totals summed."""
    if not frames or any(f is None for f in frames):
        return None
    fd = [_as_dict(f, TelemetryFrame._fields) for f in frames]
    series = {k: np.concatenate([d[k] for d in fd], axis=1)
              for k in TelemetryFrame._fields}
    totals: Dict[str, np.ndarray] = {}
    if accs and all(a is not None for a in accs):
        ad = [_as_dict(a, TelemetryAcc._fields) for a in accs]
        totals = {k: np.sum([d[k] for d in ad], axis=0)
                  for k in TelemetryAcc._fields}
    return {"series": series, "totals": totals,
            "summary": summarize(series, totals)}


def summarize(series: Dict[str, np.ndarray],
              totals: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Seed-averaged scalars for the report."""
    out: Dict[str, float] = {}
    rounds = float(np.mean(totals["rounds"])) if totals else 0.0
    out["rounds"] = rounds
    if rounds > 0:
        out["explore_rate"] = float(np.mean(totals["explored"])) / rounds
        out["selected_per_round"] = (float(np.mean(totals["selected"]))
                                     / rounds)
        out["participants_per_round"] = (float(np.mean(totals["arrived"]))
                                         / rounds)
        sel = float(np.mean(totals["selected"]))
        out["deadline_miss_rate"] = (
            float(np.mean(totals["deadline_miss"])) / sel if sel > 0
            else 0.0)
        out["corrupted_total"] = float(np.mean(totals["corrupted"]))
    for f in ("ucb_width", "budget_util", "delta_norm", "agg_adjusted"):
        out[f"mean_{f}"] = float(np.mean(series[f]))
    return out


__all__ = ["TelemetryFrame", "TelemetryAcc", "acc_init", "acc_update",
           "aggregator_adjusted", "round_frame", "collect", "summarize"]
