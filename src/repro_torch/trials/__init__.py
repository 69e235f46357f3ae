"""Trial bench: declarative eval suites with oracle-regret scoring and a
perf/quality ledger (the reference's ``repro.trials`` on
``repro_torch.run``).

    from repro_torch import trials

    result = trials.run_suite("paper-fig3")        # scored records, CUDA
    result.record("COCS").regret                   # vs same-draw Oracle
    trials.run_suite("paper-fig4-quick", smoke=True, device="cpu",
                     ledger="build/trials.json")   # append + trajectory
    print(trials.suite_report(result))             # markdown panel

A :class:`TrialSuite` is a named, JSON-round-trippable set of
(policy x config) cells over ``ExperimentSpec``; the runner batches the
batchable config axes through the grid path and scores every cell
against the same-draw-schedule Oracle cell into typed
:class:`TrialRecord`s. The ledger (``trials.ledger``) persists records
in the ``BENCH_*.json`` entry format with provenance (resolved suite,
tier, draw-schedule id, git rev), annotates quality and timing
trajectories across runs, resumes a killed suite and gates a run
against a baseline (``check_suite``). Suites, entries and ledgers are
the reference's, so either package reads the other's. CLI:
``python -m repro_torch.trials``.
"""
from __future__ import annotations

from repro_torch.trials import ledger
from repro_torch.trials.ledger import (append_suite, check_suite,
                                       load_entries, merge_entries)
from repro_torch.trials.metrics import ScoredCell, TrialRecord, score_cells
from repro_torch.trials.report import ledger_report, suite_report
from repro_torch.trials.runner import SuiteResult, run_suite
from repro_torch.trials.suite import (SUITES, TrialCell, TrialSuite,
                                      available, get_suite, register_suite)
from repro_torch.trials import suites as _named_suites  # noqa: F401

__all__ = [
    "SUITES", "ScoredCell", "SuiteResult", "TrialCell", "TrialRecord",
    "TrialSuite", "append_suite", "available", "check_suite", "get_suite",
    "ledger", "ledger_report", "load_entries", "merge_entries",
    "register_suite", "run_suite", "score_cells", "suite_report",
]
