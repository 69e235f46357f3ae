"""The port's observability against the reference's
(``tests/test_obs.py`` at its sizes: ``paper``, horizon 16,
``eval_every`` 4, seeds (0, 1); lr 0.01, as in
``test_torch_resilient.py``).

The telemetry taps only observe: every tier decides bitwise the same
with them on, tiers 1 and 2 report ``telemetry=None``. On tiers 3 and 4
the counts (``selected``, ``arrived``, ``deadline_miss``,
``underexplored``, ``corrupted``, ``agg_adjusted``) equal the
reference's series exactly, under ``trimmed_mean``, ``median`` and
``clipped`` with all four fault processes on; ``ucb_width``,
``budget_util`` and ``delta_norm`` agree within ``FLOAT_RTOL``; the
counts equal the host oracle taken from the run's own outputs and the
totals the sums of the series. The tracer writes the run's spans, the
port's report and the reference's ``render_report`` render its trace,
health events reach it, ``REPRO_TORCH_TRACE`` captures without code,
and the logging stays print-compatible. Every test that opens a tracer
closes it (``closed_tracer``)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401
from repro import api as JA  # noqa: E402
from repro_torch import api as TA  # noqa: E402
from repro_torch.api.run import build_env, build_policy  # noqa: E402
from repro_torch.experiment.sweep import (SimulatedKill,  # noqa: E402
                                          sweep_experiments)
from repro_torch.obs import ObsSpec, logging_setup  # noqa: E402
from repro_torch.obs import trace as tr  # noqa: E402
from repro_torch.obs.__main__ import main as obs_main  # noqa: E402
from repro_torch.obs.report import render_report  # noqa: E402
from repro_torch.obs.trace import export_perfetto  # noqa: E402
from repro_torch.sim.faults import FaultSpec  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread", "closed_tracer")

HORIZON, EVERY = 16, 4
SEEDS = (0, 1)
COUNTS = ("selected", "arrived", "deadline_miss", "underexplored",
          "corrupted", "agg_adjusted")
# float32 sums over the eligible pairs (ucb_width), the selected costs
# (budget_util) and the slot deltas' squares (delta_norm) taken in
# another order than XLA's: a few ulp of float32 (measured 2.1e-7)
FLOAT_RTOL = 1e-5
# phase 17's rates of chip_smoke.py: the robustness-panel's corruption
# rate with the other three processes on
FAULTS = FaultSpec(dropout_rate=0.05, straggler_rate=0.2, outage_rate=0.05,
                   corrupt_rate=0.25)


@pytest.fixture
def closed_tracer():
    """No tracer survives a test: one a test opens is closed after it,
    and the environment capture is checked afresh by none."""
    yield
    tr.configure(None)
    assert tr.active() is None


def _spec(policy="COCS", backend="auto", train=True, telemetry=False,
          trace=None, perfetto=None, horizon=HORIZON, lr=0.01,
          health="off", checkpoint_dir=None, resume=False,
          aggregator="mean", faults=None, budget=None, profiler=None):
    return TA.ExperimentSpec(
        env=TA.EnvSpec(scenario="paper", backend=backend,
                       overrides=(("lr", lr),), faults=faults),
        policy=TA.PolicySpec(name=policy, budget=budget),
        train=(TA.TrainSpec(model="logreg", aggregator=aggregator)
               if train else None),
        eval=TA.EvalSpec(eval_every=EVERY, checkpoint_dir=checkpoint_dir,
                         resume=resume, health=health),
        obs=ObsSpec(telemetry=telemetry, trace=trace, perfetto=perfetto,
                    jax_profiler=profiler),
        horizon=horizon, seeds=SEEDS)


def _run(spec):
    return repro_torch.run(spec, device="cpu")


def _ref(spec):
    return repro.run(JA.ExperimentSpec.from_json(spec.to_json()))


def _assert_same_decisions(a, b):
    for f in ("selections", "utilities", "explored", "participants"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    if a.accuracy is not None or b.accuracy is not None:
        assert np.array_equal(a.accuracy, b.accuracy)
        assert np.array_equal(a.loss, b.loss)


@pytest.fixture(scope="module")
def fused_off():
    return _run(_spec())


@pytest.fixture(scope="module")
def fused_on():
    return _run(_spec(telemetry=True))


# -- bitwise neutrality, all four tiers ---------------------------------------


def test_tier1_bandit_neutral():
    off = _run(_spec(train=False))
    on = _run(_spec(train=False, telemetry=True))
    _assert_same_decisions(off, on)
    assert off.tier == on.tier == 1
    assert on.telemetry is None


def test_tier2_host_loop_neutral():
    off = _run(_spec(policy="CUCB"))
    on = _run(_spec(policy="CUCB", telemetry=True))
    _assert_same_decisions(off, on)
    assert off.tier == on.tier == 2
    assert on.telemetry is None


def test_tier3_fused_neutral(fused_off, fused_on):
    _assert_same_decisions(fused_off, fused_on)
    assert fused_off.tier == fused_on.tier == 3
    assert fused_off.telemetry is None and fused_on.telemetry is not None


@pytest.mark.parametrize("policy", ["COCS", "Random"])
def test_tier4_device_env_neutral(policy):
    off = _run(_spec(policy, backend="device"))
    on = _run(_spec(policy, backend="device", telemetry=True))
    _assert_same_decisions(off, on)
    assert off.tier == on.tier == 4
    assert on.telemetry is not None


# -- the taps against the reference and the host oracle -----------------------


def _taps_agree(want: dict, got: dict) -> None:
    assert set(got["series"]) == set(want["series"])
    for k, w in want["series"].items():
        w, g = np.asarray(w), got["series"][k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k in COUNTS:
            assert np.array_equal(w, g), k
        else:
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, atol=0,
                                       err_msg=k)
    for k, w in want["totals"].items():
        assert np.array_equal(np.asarray(w), got["totals"][k]), k


CASES = {
    # tier, aggregator, faults: each robust rule under corruption (the
    # COCS budget of the robustness-panel, 8.0, fills cohorts of >= 3);
    # ``mean`` adjusts no slot, and no other metric reads the rule
    "tier3-trimmed_mean-faults": ("auto", "trimmed_mean", FAULTS),
    "tier3-median-faults": ("auto", "median", FAULTS),
    "tier4-clipped-faults": ("device", "clipped", FAULTS),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_taps_equal_reference(case):
    backend, agg, faults = CASES[case]
    spec = _spec(telemetry=True, backend=backend, aggregator=agg,
                 faults=faults, budget=8.0)
    got = _run(spec)
    want = _ref(spec)
    assert np.array_equal(want.selections, got.selections)
    _taps_agree(want.telemetry, got.telemetry)
    series = got.telemetry["series"]
    assert series["agg_adjusted"].sum() > 0, agg
    assert series["corrupted"].sum() > 0
    assert (series["deadline_miss"] > 0).any()


def test_taps_match_host_oracle(fused_on):
    """The counts equal the oracle taken from the run's own outputs, and
    the totals carried through the blocks the sums of the series."""
    t = fused_on.telemetry
    series, totals = t["series"], t["totals"]
    sel = (fused_on.selections >= 0).sum(axis=2)
    assert np.array_equal(series["selected"], sel.astype(np.float32))
    assert np.array_equal(series["arrived"], fused_on.participants)
    assert np.array_equal(series["deadline_miss"],
                          series["selected"] - series["arrived"])
    for key in ("selected", "arrived", "deadline_miss", "corrupted"):
        assert np.array_equal(totals[key], series[key].sum(axis=1)), key
    assert np.array_equal(totals["explored"],
                          fused_on.explored.sum(axis=1).astype(np.float32))
    assert np.array_equal(totals["rounds"], np.full(2, HORIZON, np.float32))
    assert t["summary"]["rounds"] == HORIZON
    assert t["summary"]["participants_per_round"] == pytest.approx(
        fused_on.participants.mean())
    width = series["ucb_width"].mean(axis=0)
    assert np.all(width >= 0) and np.all(width <= 1)
    assert width[-1] < width[0]


def test_kill_resume_with_telemetry_bitwise(tmp_path, fused_on):
    """A killed telemetry run resumes bitwise, its series and totals
    too: the blocks' frames and totals ride in the checkpoint."""
    ck = str(tmp_path / "ck")
    spec = _spec(telemetry=True)
    env = build_env(spec.env)
    pol = build_policy(spec.policy, env.cfg, spec.horizon)
    with pytest.raises(SimulatedKill):
        sweep_experiments({"COCS": pol}, env, list(SEEDS), HORIZON,
                          eval_every=EVERY, checkpoint_dir=ck,
                          telemetry=True, stop_after_blocks=2,
                          device="cpu")
    resumed = _run(_spec(telemetry=True, checkpoint_dir=ck, resume=True))
    _assert_same_decisions(fused_on, resumed)
    for part in ("series", "totals"):
        for k, v in fused_on.telemetry[part].items():
            assert np.array_equal(v, resumed.telemetry[part][k]), (part, k)


# -- the tracer and the report ------------------------------------------------


def test_trace_and_report(tmp_path, fused_off):
    trace = str(tmp_path / "run.jsonl")
    pft = str(tmp_path / "run.trace.json")
    ck = str(tmp_path / "ck")
    res = _run(_spec(telemetry=True, trace=trace, perfetto=pft,
                     checkpoint_dir=ck))
    _assert_same_decisions(fused_off, res)      # tracing never perturbs
    assert tr.active() is None                  # closed with the run
    recs = [json.loads(ln) for ln in open(trace)]
    assert recs[0]["ev"] == "begin" and recs[0]["name"] == "repro-trace/v1"
    names = [r["name"] for r in recs]
    assert {"run.resolve", "run.dispatch", "env.realize", "train.prepare",
            "telemetry"} <= set(names)
    blocks = [r for r in recs if r["name"] == "fused_block"]
    assert len(blocks) == names.count("checkpoint.save") == HORIZON // EVERY
    for bi, b in enumerate(blocks):
        assert b["interval"] == bi and b["round_end"] == EVERY * (bi + 1)
        assert b["rounds"] == EVERY and b["policy"] == "COCS"
        assert {"dispatch_us", "execute_us", "slots"} <= set(b)
    report = render_report(trace)
    assert "## Phase times" in report and "## Fused blocks" in report
    assert "not applicable" in report and "0 jit compiles" not in report
    assert "## Telemetry — COCS" in report
    assert "participation / round" in report
    # the reference's report reads the port's trace
    from repro.obs.report import render_report as ref_report
    ref = ref_report(trace)
    assert "## Fused blocks" in ref and "## Telemetry — COCS" in ref
    with open(pft) as f:
        assert len(json.load(f)["traceEvents"]) == len(recs) - 1
    assert export_perfetto(trace, str(tmp_path / "again.json")) > 0


def test_tier4_trace_names_device_blocks(tmp_path):
    trace = str(tmp_path / "run.jsonl")
    _run(_spec(backend="device", trace=trace, horizon=8))
    names = [json.loads(ln)["name"] for ln in open(trace)]
    assert names.count("fused_block_device") == 2
    assert "env.realize" not in names          # generated inside blocks


def test_cli_report_and_export(tmp_path, capsys):
    trace = str(tmp_path / "run.jsonl")
    _run(_spec(trace=trace, horizon=8))
    assert obs_main(["report", trace]) == 0
    assert "## Fused blocks" in capsys.readouterr().out
    out = str(tmp_path / "run.trace.json")
    assert obs_main(["export", trace, "-o", out]) == 0
    assert json.load(open(out))["traceEvents"]
    bad = tmp_path / "ledger.json"
    bad.write_text('[{"name": "x"}]\n')
    assert obs_main(["report", str(bad)]) == 2
    assert "not a repro JSONL trace" in capsys.readouterr().out


def test_report_rejects_non_trace_input(tmp_path):
    p = tmp_path / "ledger.json"
    p.write_text('[{"name": "x"}]\n')
    with pytest.raises(ValueError, match="not a repro JSONL trace"):
        render_report(str(p))
    with pytest.raises(ValueError, match="not a repro JSONL trace"):
        export_perfetto(str(p), str(tmp_path / "out.json"))


def test_health_events_reach_the_trace(tmp_path):
    trace = str(tmp_path / "bad.jsonl")
    res = _run(_spec(horizon=8, lr=float("nan"), health="record",
                     trace=trace))
    assert len(res.health["events"]) == 2
    health = [r for r in map(json.loads, open(trace))
              if r["name"] == "health"]
    assert [h["bad"] for h in health] == [e["bad"]
                                          for e in res.health["events"]]
    assert health[0]["round_end"] == 4
    assert "carry['edge']['w']" in health[0]["bad"]
    assert "Health events" in render_report(trace)


def test_profiler_capture(tmp_path):
    """``ObsSpec.jax_profiler`` names a directory that receives a
    ``torch.profiler`` Chrome trace of the run."""
    d = tmp_path / "prof"
    _run(_spec(horizon=4, profiler=str(d)))
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".trace.json")
    events = json.load(open(d / files[0]))["traceEvents"]
    assert any("round.train" in str(e.get("name")) for e in events)


def test_env_var_zero_code_capture(tmp_path, monkeypatch):
    """``REPRO_TORCH_TRACE`` installs the tracer without a code change;
    the reference's ``REPRO_TRACE`` does not reach the port's."""
    trace = str(tmp_path / "env.jsonl")
    monkeypatch.setattr(tr, "_TRACER", None)
    monkeypatch.setattr(tr, "_ENV_CHECKED", False)
    monkeypatch.setenv("REPRO_TRACE", str(tmp_path / "reference.jsonl"))
    monkeypatch.setenv("REPRO_TORCH_TRACE", trace)
    try:
        assert tr.active() is not None
        with tr.span("unit", k=1):
            pass
        tr.event("mark", n=2)
        tr._close_global()
    finally:
        monkeypatch.setattr(tr, "_ENV_CHECKED", True)
    recs = [json.loads(ln) for ln in open(trace)]
    assert [r["name"] for r in recs] == ["repro-trace/v1", "unit", "mark"]
    assert recs[1]["k"] == 1 and recs[2]["n"] == 2
    assert not os.path.exists(tmp_path / "reference.jsonl")


def test_obs_eager_surface_is_light():
    """``import repro_torch.obs`` loads neither torch nor numpy; the
    taps and the report load on first use."""
    code = ("import sys, repro_torch.obs as o; "
            "assert 'torch' not in sys.modules and 'numpy' not in "
            "sys.modules; o.report; assert 'torch' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=60)


# -- logging ------------------------------------------------------------------


def test_logging_default_is_print_compatible(capfd):
    log = logging_setup.setup()
    log.info("name,123.4,derived=ok")
    out, err = capfd.readouterr()
    assert out == "name,123.4,derived=ok\n"
    assert err == ""


def test_progress_lines_go_to_stderr(capfd):
    logging_setup.setup()
    logging_setup.get_logger("repro_torch.progress").info("[suite] 1/4 COCS")
    out, err = capfd.readouterr()
    assert out == ""
    assert "[suite] 1/4 COCS" in err


def test_quiet_drops_info_keeps_warnings(capfd):
    try:
        log = logging_setup.setup(quiet=True)
        log.info("hidden")
        log.warning("shown")
        out, _ = capfd.readouterr()
        assert "hidden" not in out and "shown" in out
    finally:
        logging_setup.setup()


def test_obsspec_round_trip():
    spec = _spec(telemetry=True, trace="run.jsonl", profiler="prof")
    back = TA.ExperimentSpec.from_dict(spec.to_dict())
    assert back == spec and back.obs.jax_profiler == "prof"
    assert JA.ExperimentSpec.from_json(spec.to_json()).obs.trace == \
        "run.jsonl"
    with pytest.raises(ValueError, match="perfetto"):
        ObsSpec(perfetto="out.json")
