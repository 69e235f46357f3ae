"""The port's trial bench against the reference's on the CPU: both
packages' ``run_suite`` on the same suites, live (no committed
``BENCH_*.json`` row is read).

* a bandit mini suite (Oracle, COCS, Random, horizon 20) over the
  non-batchable ``scenario`` axis (tier 1, a dispatch a cell);
* a training mini suite (Oracle, COCS, CUCB over ``budget`` 3.5 and 5.0,
  horizon 8): tier 3 batched in one grid dispatch a policy, CUCB tier 2
  a cell at a time;
* a one-cell suite with the taps on (COCS, tier 3, ``ObsSpec(telemetry=
  True)``; grids carry no taps in either package).

Every ``to_entry()`` key agrees: utilities, regret, participation and
their per-seed lists with ``==``, accuracy within ``ACC_TOL``, the taps'
summary within ``TAPS_RTOL`` relative, ``provenance`` equal as JSON.
Each package's ``check_suite`` passes on the other's ledger, a ledger
written by the reference resumes in the port, the port's resume cases
of ``test_trials.py`` hold, and ``python -m repro_torch.launch.train
--paper`` prints the reference's accuracies."""
from __future__ import annotations

import json
import re
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro.trials as RT  # noqa: E402
import repro_torch.trials as TT  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401
from repro_torch import api as TA  # noqa: E402
from repro_torch.core.utility import POLICY_TABLE  # noqa: E402
from repro_torch.obs import ObsSpec  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ACC_TOL = 1e-4        # final_acc, acc_curve (float32 training)
TAPS_RTOL = 1e-5      # the taps' float32 sums (test_torch_obs.py's)
EXACT = ("cum_utility", "cum_utility_seeds", "participation", "regret",
         "regret_seeds")


def _pols(names):
    return tuple((d, TA.PolicySpec(name=POLICY_TABLE[d][0],
                                   seed_offset=POLICY_TABLE[d][1]))
                 for d in names)


_TRAIN_BASE = TA.ExperimentSpec(
    env=TA.EnvSpec(scenario="paper", config="mnist-convex",
                   overrides=(("lr", 0.01),)),
    train=TA.TrainSpec(model="logreg"), eval=TA.EvalSpec(eval_every=4),
    horizon=8, seeds=(0,))
SUITES = {
    "bandit": TT.TrialSuite(
        name="mini-bandit",
        base=TA.ExperimentSpec(env=TA.EnvSpec(scenario="paper",
                                              config="mnist-convex"),
                               horizon=20, seeds=(0,)),
        policies=_pols(("Oracle", "COCS", "Random")),
        axes=(("scenario", ("paper", "high-mobility")),)),
    "train": TT.TrialSuite(
        name="mini-train", base=_TRAIN_BASE,
        policies=_pols(("Oracle", "COCS", "CUCB")),
        axes=(("budget", (3.5, 5.0)),)),
    "taps": TT.TrialSuite(
        name="mini-taps",
        base=TA.ExperimentSpec(**{**_TRAIN_BASE.__dict__,
                                  "obs": ObsSpec(telemetry=True)}),
        policies=_pols(("COCS",))),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """key -> (reference result, port result, reference ledger, port
    ledger), each suite run once a module by each package."""
    cache = {}

    def get(key):
        if key not in cache:
            suite = SUITES[key]
            d = tmp_path_factory.mktemp(key)
            ref_path, port_path = str(d / "ref.json"), str(d / "port.json")
            ref = RT.run_suite(RT.TrialSuite.from_json(suite.to_json()),
                               ledger=ref_path)
            port = TT.run_suite(suite, ledger=port_path, device="cpu")
            cache[key] = (ref, port, ref_path, port_path)
        return cache[key]
    return get


def _derived(entry):
    """``derived`` without its float-training part, and that part."""
    parts = entry["derived"].split(";")
    acc = [float(p.split("=")[1]) for p in parts
           if p.startswith("final_acc=")]
    return [p for p in parts if not p.startswith("final_acc=")], acc


def _entries_agree(want, got):
    assert set(got) == set(want)
    assert got["us_per_call"] > 0 and want["us_per_call"] > 0
    for key in set(want) - {"us_per_call", "derived", "metrics",
                            "telemetry", "provenance"}:
        assert got[key] == want[key], key
    (dw, aw), (dg, ag) = _derived(want), _derived(got)
    assert dg == dw
    # printed to 3 decimals: values within ACC_TOL may round apart
    assert np.allclose(ag, aw, rtol=0, atol=1e-3 + ACC_TOL)
    mw, mg = want["metrics"], got["metrics"]
    assert set(mg) == set(mw)
    for key in mw:
        if key in EXACT:
            assert mg[key] == mw[key], key
        else:
            assert np.allclose(mg[key], mw[key], rtol=0, atol=ACC_TOL), key
    assert json.dumps(got["provenance"], sort_keys=True) == \
        json.dumps(want["provenance"], sort_keys=True)
    if "telemetry" in want:
        tw, tg = want["telemetry"], got["telemetry"]
        assert set(tg) == set(tw)
        for key in tw:
            assert np.allclose(tg[key], tw[key], rtol=TAPS_RTOL,
                               atol=1e-12), key


@pytest.mark.parametrize("key", sorted(SUITES))
def test_records_equal_the_references(runs, key):
    ref, port, _, _ = runs(key)
    assert port.label == ref.label == SUITES[key].name
    assert port.draw_schedule == ref.draw_schedule
    assert port.git_rev == ref.git_rev
    assert [r.name for r in port.records] == [r.name for r in ref.records]
    for want, got in zip(ref.records, port.records):
        assert (got.tier, got.batched_axes) == (want.tier,
                                                want.batched_axes)
        _entries_agree(want.to_entry(), got.to_entry())
    tiers = {(r.policy, r.tier, r.batched_axes) for r in port.records}
    if key == "bandit":
        assert tiers == {(p, 1, ()) for p in ("Oracle", "COCS", "Random")}
    elif key == "train":
        assert tiers == {("Oracle", 3, ("budget",)),
                         ("COCS", 3, ("budget",)), ("CUCB", 2, ())}
    else:
        assert tiers == {("COCS", 3, ())}
        assert port.records[0].telemetry and port.records[0].regret is None
    if key != "taps":
        for rec in port.records:
            if rec.policy != "Oracle":
                assert rec.regret == pytest.approx(
                    port.record("Oracle", rec.coord).cum_utility
                    - rec.cum_utility)


@pytest.mark.parametrize("key", sorted(SUITES))
def test_each_package_gates_the_others_ledger(runs, key):
    _, port, ref_path, port_path = runs(key)
    ref_entries = RT.load_entries(ref_path)
    port_entries = TT.load_entries(port_path)
    assert list(port_entries) == list(ref_entries)
    n, report = RT.check_suite(ref_entries, port_entries, port.label)
    assert n == 0, report
    n, report = TT.check_suite(port_entries, ref_entries, port.label)
    assert n == 0, report
    assert all(line.endswith("OK") for line in report)


@pytest.fixture
def spy(monkeypatch):
    """Records every dispatch of the port's runner (``api.run``)."""
    calls = []
    real = TA.run

    def wrapped(spec, **kw):
        calls.append(spec)
        return real(spec, **kw)

    monkeypatch.setattr(TA, "run", wrapped)
    return calls


@pytest.mark.parametrize("key,drop", [("bandit", "COCS_scenario_paper"),
                                      ("train", "COCS_budget_5.0")])
def test_reference_ledger_resumes_in_the_port(runs, key, drop, tmp_path,
                                              spy, capsys):
    """Every cell recorded by the reference: nothing dispatches. One
    non-Oracle cell dropped: its dispatch group (a cell, or the budget
    grid) runs once and scores against the recorded Oracle row."""
    ref, _, ref_path, _ = runs(key)
    suite = SUITES[key]
    path = str(tmp_path / "ledger.json")
    shutil.copy(ref_path, path)
    again = TT.run_suite(suite, ledger=path, resume=True, device="cpu")
    assert spy == []
    assert "skipped (resume)" in capsys.readouterr().err
    for want in ref.records:
        got = again.record(want.policy, want.coord)
        assert got.to_entry()["metrics"] == want.to_entry()["metrics"]
    name = f"trial_{suite.name}_{drop}"
    with open(path) as f:
        on_disk = json.load(f)
    with open(path, "w") as f:
        json.dump([e for e in on_disk if e["name"] != name], f)
    resumed = TT.run_suite(suite, ledger=path, resume=True, device="cpu")
    assert len(spy) == 1
    rec = next(r for r in resumed.records if r.name == name)
    want = next(r for r in ref.records if r.name == name)
    assert rec.regret == want.regret
    assert rec.cum_utility_seeds == want.cum_utility_seeds
    assert name in TT.load_entries(path)


# -- the reference's resume cases (test_trials.py) on the port ---------------


def _mini_suite():
    return TT.TrialSuite(
        name="mini",
        base=TA.ExperimentSpec(env=TA.EnvSpec(scenario="paper",
                                              config="mnist-convex"),
                               horizon=20, seeds=(0,)),
        policies=_pols(("Oracle", "COCS", "Random")))


def test_run_suite_resume_skips_recorded_cells(tmp_path, spy):
    path = str(tmp_path / "BENCH_mini.json")
    suite = _mini_suite()
    first = TT.run_suite(suite, ledger=path, device="cpu")
    assert len(spy) == 3
    second = TT.run_suite(suite, ledger=path, resume=True, device="cpu")
    assert len(spy) == 3
    assert {(r.policy, r.coord) for r in second.records} == \
        {(r.policy, r.coord) for r in first.records}
    for rec in first.records:
        again = second.record(rec.policy, rec.coord)
        assert again.cum_utility == rec.cum_utility
        assert again.regret == rec.regret
    assert second.draw_schedule == first.draw_schedule


def test_run_suite_resume_reruns_on_spec_change(tmp_path, spy):
    from dataclasses import replace

    path = str(tmp_path / "BENCH_mini.json")
    suite = _mini_suite()
    TT.run_suite(suite, ledger=path, device="cpu")
    changed = TT.TrialSuite(name="mini",
                            base=replace(suite.base, horizon=24),
                            policies=suite.policies)
    del spy[:]
    TT.run_suite(changed, ledger=path, resume=True, device="cpu")
    assert len(spy) == len(changed.policies)


def test_run_suite_resume_partial_scores_against_recorded_oracle(
        tmp_path, spy):
    path = str(tmp_path / "BENCH_mini.json")
    suite = _mini_suite()
    first = TT.run_suite(suite, ledger=path, device="cpu")
    with open(path) as f:
        on_disk = json.load(f)
    with open(path, "w") as f:
        json.dump([e for e in on_disk if e["name"] != "trial_mini_COCS"],
                  f)
    del spy[:]
    second = TT.run_suite(suite, ledger=path, resume=True, device="cpu")
    assert len(spy) == 1
    assert second.record("COCS").regret == first.record("COCS").regret
    assert second.record("COCS").cum_utility_seeds == \
        first.record("COCS").cum_utility_seeds


def test_run_suite_without_cuda_raises_before_any_cell(monkeypatch, spy):
    """``device=None`` means CUDA: without one the runner raises before
    its first dispatch."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.run_suite(_mini_suite())
    assert spy == []


def test_each_dispatch_is_a_trials_cell_span(tmp_path):
    """A span a dispatch with the reference's attributes: a batched
    budget grid is one span of two cells."""
    from dataclasses import replace

    from repro_torch.obs import trace_to
    suite = replace(_mini_suite(), axes=(("budget", (3.5, 5.0)),))
    path = str(tmp_path / "run.jsonl")
    with trace_to(path):
        result = TT.run_suite(suite, device="cpu")
    with open(path) as f:
        spans = [json.loads(line) for line in f]
    cells = [(r["policy"], r["cells"], r["batched"]) for r in spans
             if r["ev"] == "span" and r["name"] == "trials.cell"]
    assert cells == [(d, 2, ["budget"]) for d in ("Oracle", "COCS",
                                                  "Random")]
    assert all(r.batched_axes == ("budget",) for r in result.records)


# -- the training launcher ---------------------------------------------------


def _accuracies(text):
    return [(int(m.group(1)), float(m.group(2))) for m in
            re.finditer(r"round +(\d+)  test_acc (\S+)", text)]


def test_launch_train_paper_matches_the_reference(capsys):
    from repro.launch.train import main as ref_main
    from repro_torch.launch.train import main as port_main

    args = ["--paper", "--rounds", "4", "--eval-every", "2"]
    assert ref_main(args) == 0
    want = capsys.readouterr().out
    assert port_main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    rw, rg = _accuracies(want), _accuracies(got)
    assert [r for r, _ in rg] == [r for r, _ in rw] == [2, 4]
    assert np.allclose([a for _, a in rg], [a for _, a in rw], rtol=0,
                       atol=ACC_TOL + 1e-9)
    final = float(got.split("final accuracy: ")[1])
    assert np.isfinite(final) and final == rg[-1][1]


def test_launch_train_arch_not_ported():
    """``--arch`` (LM-scale training) is ported; without ``--device`` it
    takes CUDA, and on a machine without a card it raises instead of
    falling back to the CPU."""
    import torch
    from repro_torch.launch.train import main as port_main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["--arch", "qwen2-1.5b", "--rounds", "2"])
