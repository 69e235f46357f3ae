"""The port's trial bench (``repro_torch.trials``) without a run: suite
serialization (string for string the reference's), validation, cells
and smoke variants, oracle-regret scoring, the ledger's trajectory math
and atomic write, the suite-wide gate, the record round trip and the
CLI's ``list``/``check``/``report``. The cases of ``test_trials.py``
that need no run, on the port's classes; the runs against the reference
are in ``test_torch_trials_parity.py``."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

from repro_torch.api.spec import EnvSpec, ExperimentSpec, PolicySpec
from repro_torch.trials import ledger
from repro_torch.trials.cli import main as cli_main
from repro_torch.trials.metrics import (ScoredCell, TrialRecord,
                                        record_from_entry, score_cells)
from repro_torch.trials.suite import SUITES, TrialSuite, get_suite
from repro_torch.trials.suites import (PAPER_FIG3, PAPER_FIG4_QUICK,
                                       ROBUSTNESS_PANEL)

NAMED = (PAPER_FIG3, PAPER_FIG4_QUICK, ROBUSTNESS_PANEL)


# -- suite declaration / serialization ---------------------------------------


@pytest.mark.parametrize("suite", NAMED, ids=lambda s: s.name)
def test_suite_json_round_trip(suite):
    back = TrialSuite.from_json(suite.to_json())
    assert back == suite
    json.loads(suite.to_json())


@pytest.mark.parametrize("name", [s.name for s in NAMED])
def test_suite_json_is_the_references(name):
    """A suite file written by either package loads in the other."""
    from repro.trials import suites as ref_suites  # noqa: F401
    from repro.trials.suite import SUITES as REF_SUITES
    ref = REF_SUITES[name]
    ours = SUITES[name]
    assert ours.to_json() == ref.to_json()
    assert TrialSuite.from_json(ref.to_json()) == ours
    assert type(ref).from_json(ours.to_json()) == ref
    assert [c.cell_id for c in ours.cells(smoke=True)] == \
        [c.cell_id for c in ref.cells(smoke=True)]


def test_suite_validation():
    base = ExperimentSpec(env=EnvSpec(scenario="paper"), horizon=10)
    pols = (("Oracle", PolicySpec(name="oracle")),)
    with pytest.raises(ValueError):
        TrialSuite(name="x", base=base, policies=())
    with pytest.raises(ValueError):
        TrialSuite(name="x", base=base, policies=pols + pols)
    with pytest.raises(KeyError):
        TrialSuite(name="x", base=base, policies=pols,
                   axes=(("no_such_axis", (1, 2)),))
    with pytest.raises(ValueError):
        TrialSuite(name="x", base=base, policies=pols,
                   axes=(("policy", ("a",)),))
    with pytest.raises(ValueError):
        TrialSuite(name="x", base=base, policies=pols,
                   axes=(("budget", ()),))
    with pytest.raises(KeyError):
        TrialSuite(name="x", base=base, policies=pols,
                   smoke=(("no_such_field", 1),))


def test_suite_cells_and_smoke():
    suite = PAPER_FIG4_QUICK
    cells = suite.cells()
    # 5 policies x 2 budget values, budget applied onto each spec
    assert len(cells) == 5 * 2
    assert {c.spec.policy.budget for c in cells} == {3.5, 5.0}
    assert cells[0].cell_id == f"{cells[0].policy}_budget_3.5"
    assert suite.label() == "paper-fig4-quick"
    assert suite.label(smoke=True) == "paper-fig4-quick@smoke"
    smoke_base = suite.resolved_base(smoke=True)
    assert smoke_base.horizon == 12 and smoke_base.eval.eval_every == 6
    assert suite.resolved_base().horizon == 40
    no_smoke = TrialSuite(name="x", base=suite.base,
                          policies=suite.policies)
    with pytest.raises(ValueError):
        no_smoke.resolved_base(smoke=True)
    # two sequential axes in C order, the last fastest
    rob = ROBUSTNESS_PANEL.cells()
    assert len(rob) == 3 * 2 * 3
    assert rob[1].cell_id == "COCS_corrupt_rate_0.0_aggregator_trimmed_mean"
    assert rob[1].spec.env.faults.corrupt_rate == 0.0
    assert rob[1].spec.train.aggregator == "trimmed_mean"
    assert rob[1].spec.policy.budget == 8.0
    seeds = TrialSuite(name="x", base=suite.base, policies=suite.policies,
                       smoke=(("seeds", [3, 4]),))
    assert seeds.resolved_base(smoke=True).seeds == (3, 4)


def test_get_suite_by_name():
    assert get_suite("paper-fig3") is PAPER_FIG3
    assert get_suite(PAPER_FIG3) is PAPER_FIG3
    with pytest.raises(KeyError):
        get_suite("no-such-suite")
    assert {"paper-fig3", "paper-fig4-quick",
            "robustness-panel"} <= set(SUITES)


# -- oracle-regret scoring ---------------------------------------------------


class _FakeResult:
    """Minimal RunResult stand-in with hand-set utility curves."""

    def __init__(self, cum_by_seed, schedule="sched/v1", accuracy=None,
                 telemetry=None):
        self._cum = np.asarray(cum_by_seed, np.float64)   # (S, T)
        self.draw_schedule = schedule
        self.accuracy = accuracy
        self.participants = np.full(self._cum.shape, 2.0)
        self.spec = ExperimentSpec(env=EnvSpec(scenario="paper"), horizon=3)
        self.tier = 1
        self.env_backend = "host"
        self.telemetry = telemetry

    def cumulative_utility(self):
        return self._cum


def test_score_cells_hand_computed():
    oracle = _FakeResult([[1.0, 3.0, 6.0], [2.0, 4.0, 7.0]])
    cocs = _FakeResult([[1.0, 2.0, 4.0], [1.0, 3.0, 6.5]],
                       accuracy=[[0.5, 0.8], [0.7, 0.9]],
                       telemetry={"summary": {"arrived_mean": 1.5}})
    records = score_cells(
        "s", "Oracle",
        {("Oracle", ()): ScoredCell(oracle, us=10.0),
         ("COCS", ()): ScoredCell(cocs, us=None)})
    by = {r.policy: r for r in records}
    assert by["Oracle"].regret is None
    # regret per seed: 6-4=2, 7-6.5=0.5 -> mean 1.25
    assert by["COCS"].regret_seeds == (2.0, 0.5)
    assert by["COCS"].regret == pytest.approx(1.25)
    assert by["COCS"].cum_utility == pytest.approx((4.0 + 6.5) / 2)
    assert by["COCS"].final_acc == pytest.approx((0.8 + 0.9) / 2)
    assert by["COCS"].acc_curve == pytest.approx((0.6, 0.85))
    assert by["COCS"].participation == pytest.approx(2.0)
    entry = by["COCS"].to_entry()
    assert entry["name"] == "trial_s_COCS"
    assert entry["us_per_call"] is None
    assert "regret=1.2" in entry["derived"]
    assert entry["metrics"]["regret"] == pytest.approx(1.25)
    assert entry["telemetry"] == {"arrived_mean": 1.5}
    assert "telemetry" not in by["Oracle"].to_entry()
    assert by["Oracle"].to_entry()["us_per_call"] == 10.0
    prov = dict(by["COCS"].provenance)
    assert (prov["tier"], prov["env_backend"]) == (1, "host")
    assert prov["spec"]["horizon"] == 3


def test_score_cells_oracle_fallback():
    """A recorded oracle row scores a cell whose oracle did not run."""
    cocs = _FakeResult([[1.0, 2.0, 4.0]])
    records = score_cells("s", "Oracle", {("COCS", ()): ScoredCell(cocs)},
                          oracle_fallback={(): ((7.0,), "sched/v1")})
    assert records[0].regret_seeds == (3.0,)
    with pytest.raises(ValueError, match="draw schedule"):
        score_cells("s", "Oracle", {("COCS", ()): ScoredCell(cocs)},
                    oracle_fallback={(): ((7.0,), "other/v2")})


def test_score_cells_rejects_mixed_draw_schedules():
    oracle = _FakeResult([[1.0, 2.0]], schedule="a/v1")
    other = _FakeResult([[1.0, 2.0]], schedule="b/v2")
    with pytest.raises(ValueError, match="draw schedule"):
        score_cells("s", "Oracle",
                    {("Oracle", ()): ScoredCell(oracle),
                     ("COCS", ()): ScoredCell(other)})


# -- ledger: trajectory math + timing normalization --------------------------


def test_timing_normalization():
    assert ledger.timing(None) is None
    assert ledger.timing({"us_per_call": None}) is None
    assert ledger.timing({"us_per_call": 0.0}) is None
    assert ledger.timing({"us_per_call": "garbage"}) is None
    assert ledger.timing({"us_per_call": 2.5}) == 2.5
    entries = {"a": {"name": "a", "us_per_call": 10.0},
               "b": {"name": "b", "us_per_call": 4.0},
               "c": {"name": "c", "us_per_call": None}}
    assert ledger.entry_metric(entries, "a") == 10.0
    assert ledger.entry_metric(entries, "a", "b") == 2.5
    assert ledger.entry_metric(entries, "a", "c") is None
    assert ledger.entry_metric(entries, "c") is None
    assert ledger.entry_metric(entries, "missing") is None
    assert ledger.rows_to_entries([("r", None, "d")]) == [
        {"name": "r", "us_per_call": None, "derived": "d"}]


def test_merge_entries_trajectory(tmp_path):
    path = str(tmp_path / "BENCH.json")
    first = [{"name": "timed", "us_per_call": 10.0, "derived": "d"},
             {"name": "derived_only", "us_per_call": None, "derived": "x"},
             {"name": "quality", "us_per_call": 5.0, "derived": "q",
              "metrics": {"cum_utility": 100.0, "final_acc": 0.8}}]
    ledger.merge_entries(first, path)
    second = [{"name": "timed", "us_per_call": 5.0, "derived": "d"},
              {"name": "derived_only", "us_per_call": None, "derived": "y"},
              {"name": "quality", "us_per_call": 5.0, "derived": "q",
               "metrics": {"cum_utility": 90.0, "final_acc": 0.85}},
              {"name": "new_entry", "us_per_call": 1.0, "derived": "n"}]
    merged = {e["name"]: e for e in ledger.merge_entries(second, path)}
    assert merged["timed"]["speedup_vs"] == pytest.approx(2.0)
    assert "speedup_vs" not in merged["derived_only"]
    assert merged["derived_only"]["derived"] == "y"
    assert merged["quality"]["metric_deltas"] == {
        "cum_utility": -10.0, "final_acc": pytest.approx(0.05)}
    assert "speedup_vs" not in merged["new_entry"]
    assert [e["name"] for e in ledger.load_entries(path).values()] == \
        ["timed", "derived_only", "quality", "new_entry"]


def test_merge_entries_atomic_write(tmp_path, monkeypatch):
    """A write killed part way leaves the previous ledger intact and no
    temporary file behind; a corrupt ledger reads as empty."""
    path = str(tmp_path / "BENCH.json")
    ledger.merge_entries([{"name": "a", "us_per_call": 1.0,
                           "derived": "d"}], path)
    before = open(path).read()
    real_dump = json.dump

    def dump_then_die(obj, f, **kw):
        f.write("[{\"name\": ")
        raise KeyboardInterrupt("killed mid-write")

    monkeypatch.setattr(ledger.json, "dump", dump_then_die)
    with pytest.raises(KeyboardInterrupt):
        ledger.merge_entries([{"name": "b", "us_per_call": 2.0,
                               "derived": "d"}], path)
    monkeypatch.setattr(ledger.json, "dump", real_dump)
    assert open(path).read() == before
    assert os.listdir(tmp_path) == ["BENCH.json"]
    (tmp_path / "bad.json").write_text("[{\"name\": ")
    assert ledger.load_entries(str(tmp_path / "bad.json")) == {}
    assert ledger.load_entries(str(tmp_path / "missing.json")) == {}


def _record(suite, policy, cum, regret=None, acc=None):
    return TrialRecord(
        suite=suite, policy=policy, coord=(), cum_utility=cum,
        cum_utility_seeds=(cum,), participation=2.0, regret=regret,
        regret_seeds=None if regret is None else (regret,), final_acc=acc)


def test_check_suite_gate(tmp_path):
    base_path = str(tmp_path / "base.json")
    recs = [_record("s", "Oracle", 100.0),
            _record("s", "COCS", 90.0, regret=10.0, acc=0.80)]
    ledger.merge_entries([r.to_entry() for r in recs], base_path)
    baseline = ledger.load_entries(base_path)

    n, report = ledger.check_suite(baseline, baseline, "s")
    assert n == 0 and all("OK" in line for line in report)

    n, report = ledger.check_suite({}, baseline, "s")
    assert n == 0 and "skipping" in report[0]

    cur = [_record("s", "Oracle", 100.0),
           _record("s", "COCS", 90.0, regret=10.0, acc=0.81)]
    current = {e["name"]: e for e in (r.to_entry() for r in cur)}
    n, _ = ledger.check_suite(baseline, current, "s", acc_atol=0.02)
    assert n == 0
    n, _ = ledger.check_suite(baseline, current, "s", acc_atol=0.005)
    assert n == 1
    cur[1] = _record("s", "COCS", 89.0, regret=11.0, acc=0.80)
    current = {e["name"]: e for e in (r.to_entry() for r in cur)}
    n, report = ledger.check_suite(baseline, current, "s")
    assert n == 1 and any("cum_utility" in line and "FAIL" in line
                          for line in report)

    current = {k: v for k, v in baseline.items() if "COCS" not in k}
    n, report = ledger.check_suite(baseline, current, "s")
    assert n == 1 and any("missing from current" in line for line in report)

    # timings gate only when asked, as a ratio to a reference entry
    timed = {k: dict(v, us_per_call=10.0) for k, v in baseline.items()}
    slow = {k: dict(v, us_per_call=30.0 if "COCS" in k else 10.0)
            for k, v in baseline.items()}
    oracle = "trial_s_Oracle"
    assert ledger.check_suite(timed, slow, "s")[0] == 0
    n, report = ledger.check_suite(timed, slow, "s", max_time_ratio=2.0,
                                   time_reference=oracle)
    assert n == 1 and any("time" in line for line in report)


def test_record_from_entry_round_trip():
    rec = TrialRecord(
        suite="s", policy="COCS", coord=(("budget", 3.5),),
        cum_utility=90.0, cum_utility_seeds=(88.0, 92.0),
        participation=2.0, regret=10.0, regret_seeds=(11.0, 9.0),
        final_acc=0.8, acc_curve=(0.5, 0.8), us_per_call=123.0,
        tier=3, draw_schedule="sched/v1",
        provenance=(("spec", {"horizon": 10}), ("tier", 3)),
        telemetry={"arrived_mean": 2.5})
    back = record_from_entry(json.loads(json.dumps(rec.to_entry())))
    assert (back.suite, back.policy, back.coord) == ("s", "COCS",
                                                     (("budget", 3.5),))
    assert back.cum_utility_seeds == rec.cum_utility_seeds
    assert back.regret == rec.regret
    assert back.regret_seeds == rec.regret_seeds
    assert back.final_acc == rec.final_acc
    assert back.acc_curve == rec.acc_curve
    assert back.us_per_call == rec.us_per_call
    assert back.tier == 3
    assert back.draw_schedule == "sched/v1"
    assert back.telemetry == rec.telemetry
    assert back.name == rec.name
    assert back.to_entry() == rec.to_entry()


# -- the CLI without a run ---------------------------------------------------


def test_cli_list(capsys):
    assert cli_main(["list"]) == 0
    out = capsys.readouterr().out
    assert "paper-fig4-quick: 10 cells (5 policies x {'budget': (3.5, " \
           "5.0)}), oracle=Oracle" in out
    assert "robustness-panel: 18 cells" in out


def _write_ledger(path, cocs_cum):
    recs = [_record("s", "Oracle", 100.0),
            _record("s", "COCS", cocs_cum, regret=100.0 - cocs_cum,
                    acc=0.8)]
    ledger.merge_entries([r.to_entry() for r in recs], str(path))


def test_cli_check(tmp_path, capsys):
    base, same, worse = (tmp_path / f"{n}.json"
                         for n in ("base", "same", "worse"))
    _write_ledger(base, 90.0)
    _write_ledger(same, 90.0)
    _write_ledger(worse, 89.0)
    args = ["check", "--baseline", str(base), "--suite", "s"]
    assert cli_main(args + ["--current", str(same)]) == 0
    assert "trial_s_COCS: OK" in capsys.readouterr().out
    assert cli_main(args + ["--current", str(worse)]) == 1
    assert "cum_utility 90 -> 89" in capsys.readouterr().out
    # a label the baseline lacks skips cleanly
    assert cli_main(["check", "--baseline", str(base), "--current",
                     str(worse), "--suite", "other"]) == 0


def test_cli_report(tmp_path, capsys):
    path = tmp_path / "l.json"
    _write_ledger(path, 90.0)
    _write_ledger(path, 88.0)
    assert cli_main(["report", "--ledger", str(path), "--suite", "s",
                     "--suite", "none"]) == 0
    out = capsys.readouterr().out
    assert "# Ledger trajectory · `s`" in out
    assert "| COCS | regret 12 · u 88 · acc 0.800 | cum_utility -2, " \
           "regret +2 |" in out
    assert "_no ledger entries for this suite label_" in out


def test_reports_are_the_references(tmp_path):
    """The markdown of both reports is the reference's on the same
    records and ledger."""
    from repro.trials import report as ref_report
    from repro.trials.metrics import TrialRecord as RefRecord
    from repro.trials.runner import SuiteResult as RefResult
    from repro_torch.trials.report import ledger_report, suite_report
    from repro_torch.trials.runner import SuiteResult

    path = tmp_path / "l.json"
    _write_ledger(path, 90.0)
    _write_ledger(path, 88.0)
    entries = ledger.load_entries(str(path))
    assert ledger_report(entries, "s") == \
        ref_report.ledger_report(entries, "s")
    recs = [_record("s", "Oracle", 100.0),
            _record("s", "COCS", 90.0, regret=10.0, acc=0.8)]
    kw = dict(label="s", smoke=False, total_us=2.5e6, git_rev="abc",
              draw_schedule="sched/v1")
    ours = SuiteResult(suite=PAPER_FIG3, records=recs, **kw)
    ref = RefResult(suite=PAPER_FIG3,
                    records=[RefRecord(**r.__dict__) for r in recs], **kw)
    assert suite_report(ours) == ref_report.suite_report(ref)
    assert "| COCS | regret 10 · u 90 · acc 0.800 |" in suite_report(ours)
