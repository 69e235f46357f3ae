"""Suite execution: ``run_suite("paper-fig3")`` -> scored records (the
reference's ``trials/runner.py`` on ``repro_torch.run``).

The runner turns a :class:`~repro_torch.trials.suite.TrialSuite` into
``repro_torch.api.run`` calls with the batching contract of
``spec.grid``: for each policy (and each non-batchable coordinate), the
batchable config axes (budget, deadline, h_t, alpha) run as ONE grid
dispatch, the cells stacked next to the seed axis, and everything else
runs a cell at a time behind the same records. Per-cell wall-clock is
amortized over its dispatch group (``ScoredCell.us``), which keeps
timings comparable between batched and sequential rows; ``run`` returns
numpy arrays after the device has finished, so the wall time covers the
device work.

Every cell is scored against the oracle cell at the same coordinate
(``trials.metrics``), and the result optionally appends to a ledger file
with provenance: resolved suite, git rev, draw-schedule id, smoke flag.
The device is resolved once, at entry: ``None`` means CUDA, and raises
before any cell runs when there is none.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Set, Tuple, Union

from repro_torch.api.spec import GRID_AXES
from repro_torch.trials import ledger as ledger_mod
from repro_torch.trials.metrics import (ScoredCell, TrialRecord,
                                  record_from_entry, score_cells)
from repro_torch.trials.suite import TrialSuite, get_suite


@dataclass
class SuiteResult:
    """One suite run: the resolved suite, its scored records, and
    run-level provenance."""
    suite: TrialSuite
    label: str                               # name / name@smoke
    smoke: bool
    records: List[TrialRecord]
    total_us: float
    git_rev: str
    draw_schedule: str

    def record(self, policy: str,
               coord: Tuple[Tuple[str, Any], ...] = ()) -> TrialRecord:
        for rec in self.records:
            if rec.policy == policy and rec.coord == tuple(coord):
                return rec
        raise KeyError(f"no record for policy={policy!r} coord={coord!r}")

    def by_policy(self, policy: str) -> List[TrialRecord]:
        return [r for r in self.records if r.policy == policy]


def _json_norm(obj) -> str:
    """Canonical JSON text of a spec dict — the resolved-spec identity
    the resume skip test compares (tuples/lists and int/float unify the
    way the ledger stored them)."""
    return json.dumps(json.loads(json.dumps(obj)), sort_keys=True)


def _resumable_cells(suite: TrialSuite, smoke: bool, label: str,
                     entries) -> Dict[Tuple[str, Tuple[Tuple[str, Any],
                                                       ...]], TrialRecord]:
    """Cells of this suite variant whose TrialRecord already sits in the
    target ledger *with the identical resolved spec* (git-rev-agnostic:
    only the spec is compared, not run provenance) — safe to skip
    because every recorded quantity is deterministic given the spec."""
    done = {}
    for cell in suite.cells(smoke):
        rec_name = f"trial_{label}_{cell.policy}" + "".join(
            f"_{a}_{v}" for a, v in cell.coord)
        entry = entries.get(rec_name)
        if entry is None:
            continue
        spec_old = (entry.get("provenance") or {}).get("spec")
        if spec_old is None or \
                _json_norm(spec_old) != _json_norm(cell.spec.to_dict()):
            continue
        done[(cell.policy, cell.coord)] = record_from_entry(entry)
    return done


def _run_cells(suite: TrialSuite, smoke: bool, data, device,
               skip: Optional[Set[Tuple[str, Tuple[Tuple[str, Any], ...]]]]
               = None
               ) -> Dict[Tuple[str, Tuple[Tuple[str, Any], ...]],
                         ScoredCell]:
    """Execute every suite cell on ``device``, batching the batchable
    axes through the grid path. Returns (policy, coord) -> ScoredCell.

    ``skip`` names (policy, coord) cells to not run (the resume path's
    already-recorded ones). A batched group is skipped only when *all*
    its cells are — a partially-recorded group re-runs whole, which is
    harmless (re-scored values are deterministic) and keeps the one-
    dispatch-per-group contract."""
    import itertools

    from repro_torch import api
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.logging_setup import get_logger

    skip = skip or set()
    base = suite.resolved_base(smoke)
    batchable = [(a, v) for a, v in suite.axes if GRID_AXES[a][0]]
    sequential = [(a, v) for a, v in suite.axes if not GRID_AXES[a][0]]
    axis_order = [a for a, _ in suite.axes]

    def canonical(coord_pairs) -> Tuple[Tuple[str, Any], ...]:
        d = dict(coord_pairs)
        return tuple((a, d[a]) for a in axis_order)

    # live per-dispatch progress with ETA on stderr (repro_torch.progress):
    # one tick per dispatch group — batched groups count once, matching
    # the one-dispatch-per-group timing contract
    progress = get_logger("repro_torch.progress")
    n_seq = 1
    for _, v in sequential:
        n_seq *= max(1, len(v))
    total = max(1, len(suite.policies) * n_seq)
    done_n = 0
    t_start = time.perf_counter()

    def tick(label: str, note: str = "") -> None:
        nonlocal done_n
        done_n += 1
        elapsed = time.perf_counter() - t_start
        eta = elapsed / done_n * (total - done_n)
        progress.info(f"[{suite.label(smoke)}] {done_n}/{total} {label}"
                      f"{note} ({elapsed:.1f}s elapsed, eta {eta:.0f}s)")

    cells: Dict[Tuple[str, Tuple[Tuple[str, Any], ...]], ScoredCell] = {}
    for display, pspec in suite.policies:
        spec0 = replace(base, policy=pspec)
        for seq_combo in itertools.product(*(v for _, v in sequential)):
            seq_coord = tuple(zip((a for a, _ in sequential), seq_combo))
            spec1 = spec0
            for axis, value in seq_coord:
                spec1 = GRID_AXES[axis][1](spec1, value)
            label = display + "".join(f" {a}={v}" for a, v in seq_coord)
            if batchable:
                names = [a for a, _ in batchable]
                group_coords = [
                    canonical(seq_coord + tuple(zip(names, combo)))
                    for combo in itertools.product(
                        *(v for _, v in batchable))]
                if all((display, c) in skip for c in group_coords):
                    tick(label, " skipped (resume)")
                    continue
                grid = spec1.grid(**{a: list(v) for a, v in batchable})
                t0 = time.perf_counter()
                with obs_trace.span("trials.cell", policy=display,
                                    cells=len(group_coords),
                                    batched=names):
                    gres = api.run(grid, data=data, device=device)
                us = (time.perf_counter() - t0) * 1e6 / len(gres.results)
                names = [a for a, _ in batchable]
                for combo, res in zip(grid.coords(), gres.results):
                    coord = canonical(seq_coord + tuple(zip(names, combo)))
                    cells[(display, coord)] = ScoredCell(
                        result=res, us=us,
                        batched_axes=tuple(res.batched_axes))
                tick(label, f" [{len(group_coords)} cells batched]")
            else:
                if (display, canonical(seq_coord)) in skip:
                    tick(label, " skipped (resume)")
                    continue
                t0 = time.perf_counter()
                with obs_trace.span("trials.cell", policy=display,
                                    cells=1):
                    res = api.run(spec1, data=data, device=device)
                us = (time.perf_counter() - t0) * 1e6
                cells[(display, canonical(seq_coord))] = ScoredCell(
                    result=res, us=us)
                tick(label)
    return cells


def run_suite(suite: Union[str, TrialSuite], *, smoke: bool = False,
              ledger: Optional[str] = None, data=None,
              resume: bool = False, device=None) -> SuiteResult:
    """Run a trial suite (by registered name or as an object).

    ``smoke=True`` applies the suite's declared tiny-horizon overrides
    and records under the ``<name>@smoke`` label, so smoke runs gate
    against their own baselines, never the full ones. ``ledger``
    appends the scored records to that ``BENCH_*``-compatible JSON store
    (merge-by-name with trajectory annotations, ``trials.ledger``).
    ``data`` optionally shares one ``FederatedDataset`` across training
    cells. ``device`` is the torch device of every cell: ``None`` means
    CUDA, and raises here without one.

    ``resume=True`` (with ``ledger``) skips cells whose record already
    sits in the target ledger with the identical resolved spec
    (git-rev-agnostic) — a suite run killed between cells picks up where
    the last atomic ledger write left it. Skipped cells' records are
    carried into the result unchanged; executed cells score their regret
    against the recorded oracle rows when the oracle itself was skipped.
    """
    # resolve named suites late so trials.suites registration ran
    from repro_torch.kernels.common import resolve_device
    from repro_torch.trials import suites as _suites    # noqa: F401

    dev = resolve_device(device)
    suite = get_suite(suite)
    label = suite.label(smoke)
    done: Dict[Any, TrialRecord] = {}
    if resume and ledger:
        done = _resumable_cells(suite, smoke, label,
                                ledger_mod.load_entries(ledger))
    t0 = time.perf_counter()
    cells = _run_cells(suite, smoke, data, dev, skip=set(done))
    total_us = (time.perf_counter() - t0) * 1e6
    rev = ledger_mod.git_rev()
    schedules = {sc.result.draw_schedule for sc in cells.values()}
    schedules |= {r.draw_schedule for r in done.values()
                  if r.draw_schedule}
    provenance = (("suite", suite.to_dict()), ("smoke", smoke),
                  ("git_rev", rev))
    oracle_fallback = {
        coord: (rec.cum_utility_seeds, rec.draw_schedule)
        for (policy, coord), rec in done.items()
        if policy == suite.oracle and (policy, coord) not in cells}
    records = score_cells(label, suite.oracle, cells,
                          provenance=provenance,
                          oracle_fallback=oracle_fallback)
    scored = {(r.policy, r.coord) for r in records}
    records += [rec for key, rec in done.items() if key not in scored]
    result = SuiteResult(
        suite=suite, label=label, smoke=smoke, records=records,
        total_us=total_us, git_rev=rev,
        draw_schedule=schedules.pop() if len(schedules) == 1 else "mixed")
    if ledger:
        ledger_mod.append_suite(result, ledger)
    return result


__all__ = ["SuiteResult", "run_suite"]
