"""Trial scoring: every suite cell becomes a typed :class:`TrialRecord`
scored against the same-draw-schedule Oracle cell (a copy of the
reference's ``trials/metrics.py``).

The paper's headline quantities are comparative (Figs. 3-7: COCS against
Oracle, CUCB, LinUCB and Random utility and regret across budgets,
deadlines, scenarios), so a cell's score is its distance to the oracle
run under the identical realized environment: regret is
``oracle_cum_utility - cum_utility`` per seed, on cells that share every
config coordinate and (asserted) the same draw-schedule id.

Records read the port's ``api.RunResult``: ``cumulative_utility()``,
``participants``, ``accuracy``, ``tier``, ``spec``, ``env_backend``,
``draw_schedule`` and the taps' ``telemetry["summary"]``. The entry a
record writes is the reference's key for key.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class TrialRecord:
    """One scored suite cell, ready for the ledger.

    Utilities/regret are draw-schedule-deterministic (participation
    counts under a pinned schedule), so a repeat run reproduces them
    exactly; ``final_acc`` is float-training output and gets a tolerance
    at gate time. ``us_per_call`` is the cell's wall-clock — amortized
    over its batched group when the fused grid path ran several config
    cells in one dispatch — or None for records scored without timing.
    """
    suite: str                               # suite label (incl. @smoke)
    policy: str                              # display name
    coord: Tuple[Tuple[str, Any], ...]       # config-axis coordinates
    cum_utility: float                       # final, mean over seeds
    cum_utility_seeds: Tuple[float, ...]
    participation: float                     # mean per-round arrivals
    regret: Optional[float] = None           # vs oracle, mean over seeds
    regret_seeds: Optional[Tuple[float, ...]] = None
    final_acc: Optional[float] = None        # mean over seeds
    acc_curve: Optional[Tuple[float, ...]] = None
    us_per_call: Optional[float] = None
    tier: int = 0
    batched_axes: Tuple[str, ...] = ()
    draw_schedule: str = ""
    provenance: Tuple[Tuple[str, Any], ...] = ()
    # scalar on-device telemetry summary (repro_torch.obs.telemetry) when the
    # cell ran with ObsSpec.telemetry on; rides in the ledger entry as a
    # top-level key, NOT under ``metrics`` — observability numbers are
    # never part of the committed quality gate
    telemetry: Optional[Dict[str, float]] = None

    @property
    def cell_id(self) -> str:
        parts = [self.policy] + [f"{a}_{v}" for a, v in self.coord]
        return "_".join(parts)

    @property
    def name(self) -> str:
        """Ledger entry name: ``trial_<suite>_<cell>``."""
        return f"trial_{self.suite}_{self.cell_id}"

    def to_entry(self) -> Dict[str, Any]:
        """BENCH_*.json-compatible ledger entry (extra typed fields ride
        along; timing consumers read name/us_per_call/derived only)."""
        derived = [f"cum_utility={self.cum_utility:.1f}"]
        metrics: Dict[str, Any] = {
            "cum_utility": round(self.cum_utility, 4),
            "cum_utility_seeds": [round(u, 4)
                                  for u in self.cum_utility_seeds],
            "participation": round(self.participation, 4),
        }
        if self.regret is not None:
            derived.append(f"regret={self.regret:.1f}")
            metrics["regret"] = round(self.regret, 4)
            metrics["regret_seeds"] = [round(r, 4)
                                       for r in self.regret_seeds]
        derived.append(f"participants={self.participation:.2f}")
        if self.final_acc is not None:
            derived.append(f"final_acc={self.final_acc:.3f}")
            metrics["final_acc"] = round(self.final_acc, 5)
            if self.acc_curve is not None:
                metrics["acc_curve"] = [round(a, 4) for a in self.acc_curve]
        entry = {
            "name": self.name,
            "us_per_call": (None if self.us_per_call is None
                            else float(self.us_per_call)),
            "derived": ";".join(derived),
            "suite": self.suite,
            "policy": self.policy,
            "coord": {a: v for a, v in self.coord},
            "metrics": metrics,
            "draw_schedule": self.draw_schedule,
            "provenance": dict(self.provenance),
        }
        if self.telemetry is not None:
            entry["telemetry"] = {k: (round(float(v), 6)
                                      if isinstance(v, float) else v)
                                  for k, v in self.telemetry.items()}
        return entry


def record_from_entry(entry: Mapping[str, Any]) -> TrialRecord:
    """Rebuild a :class:`TrialRecord` from its ledger entry — the inverse
    of ``to_entry`` up to JSON normalization (tuples come back from
    lists). The resume path uses this to carry already-recorded cells
    into a partially re-run suite's result."""
    m = entry.get("metrics") or {}

    def tup(key):
        v = m.get(key)
        return None if v is None else tuple(float(x) for x in v)

    return TrialRecord(
        suite=str(entry["suite"]), policy=str(entry["policy"]),
        coord=tuple((str(a), v) for a, v in
                    dict(entry.get("coord") or {}).items()),
        cum_utility=float(m["cum_utility"]),
        cum_utility_seeds=tup("cum_utility_seeds") or (),
        participation=float(m.get("participation", 0.0)),
        regret=(None if m.get("regret") is None
                else float(m["regret"])),
        regret_seeds=tup("regret_seeds"),
        final_acc=(None if m.get("final_acc") is None
                   else float(m["final_acc"])),
        acc_curve=tup("acc_curve"),
        us_per_call=(None if entry.get("us_per_call") is None
                     else float(entry["us_per_call"])),
        tier=int((entry.get("provenance") or {}).get("tier", 0)),
        draw_schedule=str(entry.get("draw_schedule", "")),
        provenance=tuple((entry.get("provenance") or {}).items()),
        telemetry=(dict(entry["telemetry"])
                   if entry.get("telemetry") else None))


@dataclass
class ScoredCell:
    """Runner-side raw material for scoring: one cell's RunResult plus
    how it executed."""
    result: Any                              # repro_torch.api.RunResult
    us: Optional[float] = None               # amortized wall-clock
    batched_axes: Tuple[str, ...] = field(default_factory=tuple)


def _cum_final(result) -> np.ndarray:
    return np.asarray(result.cumulative_utility()[:, -1], np.float64)


def score_cells(suite_label: str, oracle: str,
                cells: Mapping[Tuple[str, Tuple[Tuple[str, Any], ...]],
                               ScoredCell],
                provenance: Tuple[Tuple[str, Any], ...] = (),
                oracle_fallback: Optional[Mapping[
                    Tuple[Tuple[str, Any], ...],
                    Tuple[Tuple[float, ...], str]]] = None
                ) -> List[TrialRecord]:
    """Score every (policy, coord) cell against the oracle cell at the
    same config coordinate. Keyed like the runner produces them; cells
    whose coordinate has no oracle run score without regret. Raises if
    a cell and its oracle reference disagree on the draw-schedule id —
    regret across different randomness contracts is meaningless.

    ``oracle_fallback`` supplies ``coord -> (cum_utility_seeds,
    draw_schedule)`` references for coordinates whose oracle cell was
    not executed this run — the resume path's already-recorded oracle
    rows (utilities are draw-schedule-deterministic, so a recorded
    reference equals a re-run one exactly).
    """
    oracle_cum: Dict[Tuple[Tuple[str, Any], ...], np.ndarray] = {}
    oracle_sched: Dict[Tuple[Tuple[str, Any], ...], str] = {}
    for coord, (cum_seeds, sched) in (oracle_fallback or {}).items():
        oracle_cum[coord] = np.asarray(cum_seeds, np.float64)
        oracle_sched[coord] = sched
    for (policy, coord), sc in cells.items():
        if policy == oracle:
            oracle_cum[coord] = _cum_final(sc.result)
            oracle_sched[coord] = sc.result.draw_schedule

    records: List[TrialRecord] = []
    for (policy, coord), sc in cells.items():
        res = sc.result
        cum = _cum_final(res)
        regret = regret_seeds = None
        # the oracle is the reference, not a comparison — no regret row
        ref = None if policy == oracle else oracle_cum.get(coord)
        if ref is not None:
            # "" = legacy recorded reference without a schedule id:
            # nothing to compare against, accept it
            if oracle_sched[coord] and \
                    res.draw_schedule != oracle_sched[coord]:
                raise ValueError(
                    f"{suite_label}/{policy}: draw schedule "
                    f"{res.draw_schedule!r} != oracle's "
                    f"{oracle_sched[coord]!r} — regret would compare "
                    "different randomness contracts")
            diff = ref - cum
            regret = float(diff.mean())
            regret_seeds = tuple(float(r) for r in diff)
        final_acc = acc_curve = None
        if res.accuracy is not None:
            acc = np.asarray(res.accuracy, np.float64)
            final_acc = float(acc[:, -1].mean())
            acc_curve = tuple(float(a) for a in acc.mean(axis=0))
        records.append(TrialRecord(
            suite=suite_label, policy=policy, coord=coord,
            cum_utility=float(cum.mean()),
            cum_utility_seeds=tuple(float(u) for u in cum),
            participation=float(np.asarray(res.participants,
                                           np.float64).mean()),
            regret=regret, regret_seeds=regret_seeds,
            final_acc=final_acc, acc_curve=acc_curve,
            us_per_call=sc.us, tier=int(res.tier),
            batched_axes=tuple(sc.batched_axes),
            draw_schedule=res.draw_schedule,
            provenance=provenance + (
                ("spec", res.spec.to_dict()), ("tier", int(res.tier)),
                ("env_backend", res.env_backend)),
            telemetry=(res.telemetry["summary"]
                       if getattr(res, "telemetry", None) else None),
        ))
    return records


__all__ = ["ScoredCell", "TrialRecord", "record_from_entry",
           "score_cells"]
