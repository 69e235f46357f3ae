"""The facade on the card: ``repro_torch.run`` tier 1 on CUDA launches
the path's kernels (no plain route), matches the CPU run of the same
spec, and refuses ``use_kernel=False``; tiers 2 and 3 and a grid on the
host env match the CPU and the sequential runs; faulty tiers 3 and 4
under each Eq. 3 rule (B3 under ``mean`` only) and ``logreg-t`` match
the CPU, and each rule on the card matches it on the CPU; a killed and
resumed tier-4 run equals the uninterrupted one bitwise, a CUDA
checkpoint is refused on the CPU, the taps leave decisions bitwise and
the tracer splits each block's time; the trial bench's training suite on
the card passes ``check_suite`` against the CPU, ``run_suite`` takes
CUDA by default and a resume on the card dispatches nothing. These need
an NVIDIA GPU; on a machine without one they skip. On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_api_cuda.py
"""
import dataclasses

import pytest
import torch

import repro_torch
from repro_torch import api
from repro_torch.kernels import common
from repro_torch.kernels.budgeted_topk import ops as topk_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _spec(**kw):
    base = api.ExperimentSpec(env=api.EnvSpec("paper", backend="device"),
                              horizon=8, seeds=(0, 1))
    return dataclasses.replace(base, **kw)


@pytest.mark.parametrize("reg,kernel", [("cocs", "budgeted_topk"),
                                        ("oracle", "budgeted_topk"),
                                        ("random", "random_assign")])
def test_tier1_launches_and_matches_cpu(dev, reg, kernel):
    spec = _spec(policy=api.PolicySpec(reg))
    common.reset_launches()
    for k in topk_ops.WALK_SYNCS:
        topk_ops.WALK_SYNCS[k] = 0
    got = repro_torch.run(spec, device=dev)
    assert common.LAUNCHES["context_pairwise"] == spec.horizon
    assert common.LAUNCHES[kernel] == spec.horizon
    assert not any(topk_ops.WALK_SYNCS.values())
    want = repro_torch.run(spec, device="cpu")
    rows = int((want.selections != got.selections).any(axis=-1).sum())
    # phase 5's rule: at most 1% of (seed, round) rows differ
    assert rows <= 0.01 * got.selections.shape[0] * got.selections.shape[1]


def test_plain_route_refused_on_cuda(dev):
    for spec in (_spec(env=api.EnvSpec("paper", backend="device",
                                       use_kernel=False)),
                 _spec(train=api.TrainSpec(use_kernel=False))):
        common.reset_launches()
        with pytest.raises(ValueError, match="use_kernel"):
            repro_torch.run(spec, device=dev)
        assert not any(common.LAUNCHES.values())


def _host_spec(reg, **kw):
    return api.ExperimentSpec(policy=api.PolicySpec(reg),
                              env=api.EnvSpec("paper"),
                              train=api.TrainSpec(),
                              eval=api.EvalSpec(eval_every=3), horizon=6,
                              seeds=(0, 1), **kw)


@pytest.mark.parametrize("reg,tier,kernel", [("cocs", 3, "budgeted_topk"),
                                             ("random", 3, "random_assign"),
                                             ("cucb", 2, None)])
def test_host_env_tiers_2_3_match_cpu(dev, reg, tier, kernel):
    """Tiers 2 and 3 on ``paper``'s host env: the rounds come from the
    CPU (no B1), B3 aggregates once a round a run (tier 2 runs a seed at
    a time), the selection kernel launches once a round in tier 3 and
    none for a host policy; selections and accuracy match the CPU run."""
    spec = _host_spec(reg)
    common.reset_launches()
    got = repro_torch.run(spec, device=dev)
    assert (got.tier, got.env_backend) == (tier, "host")
    runs = 1 if tier == 3 else len(spec.seeds)
    assert common.LAUNCHES["masked_aggregate"] == spec.horizon * runs
    assert common.LAUNCHES["context_pairwise"] == 0
    for k in ("budgeted_topk", "random_assign"):
        assert common.LAUNCHES[k] == (spec.horizon if k == kernel else 0)
    want = repro_torch.run(spec, device="cpu")
    assert (want.selections == got.selections).all()
    assert abs(want.accuracy - got.accuracy).max() <= 1e-3


def test_host_grid_matches_sequential_on_cuda(dev):
    grid = _host_spec("oracle").grid(budget=[3.5, 5.0])
    common.reset_launches()
    got = repro_torch.run(grid, device=dev)
    assert common.LAUNCHES["masked_aggregate"] == grid.base.horizon
    for cell, r in zip(got.cells, got.results):
        seq = repro_torch.run(cell, device=dev)
        assert (seq.selections == r.selections).all()


# -- faults and robust Eq. 3 on the card --------------------------------------


def _faulty_spec(aggregator="mean", env="device", **kw):
    from repro_torch.sim.faults import FaultSpec
    faults = FaultSpec(dropout_rate=0.2, straggler_rate=0.3,
                       outage_rate=0.15, corrupt_rate=0.25)
    return api.ExperimentSpec(
        policy=api.PolicySpec("cocs"),
        env=api.EnvSpec("paper", backend=env, faults=faults,
                        overrides=(("lr", 0.01),)),
        train=api.TrainSpec(aggregator=aggregator, **kw),
        eval=api.EvalSpec(eval_every=4), horizon=8, seeds=(0, 1))


@pytest.mark.parametrize("aggregator", ["mean", "trimmed_mean", "median",
                                        "clipped"])
def test_faulty_tier4_matches_cpu(dev, aggregator):
    """Tier 4 on ``device:paper`` with all four faults: B1 and B2 once a
    round, B3 once a round under ``mean`` and never under a robust rule,
    no walk host sync; the CPU run within phase 5's rule."""
    spec = _faulty_spec(aggregator)
    common.reset_launches()
    for k in topk_ops.WALK_SYNCS:
        topk_ops.WALK_SYNCS[k] = 0
    got = repro_torch.run(spec, device=dev)
    assert got.tier == 4
    h = spec.horizon
    assert common.LAUNCHES["context_pairwise"] == h
    assert common.LAUNCHES["budgeted_topk"] == h
    assert common.LAUNCHES["masked_aggregate"] == (
        h if aggregator == "mean" else 0)
    assert not any(topk_ops.WALK_SYNCS.values())
    want = repro_torch.run(spec, device="cpu")
    rows = int((want.selections != got.selections).any(axis=-1).sum())
    assert rows <= 0.01 * got.selections.shape[0] * got.selections.shape[1]
    if rows == 0:
        assert abs(want.accuracy - got.accuracy).max() <= 1e-3


def test_faulty_host_tier3_and_logreg_t_match_cpu(dev):
    """Tier 3 on the faulty host env, in the ``logreg-t`` layout."""
    spec = _faulty_spec(env="host", transposed_gemm=True)
    common.reset_launches()
    got = repro_torch.run(spec, device=dev)
    assert (got.tier, got.env_backend) == (3, "host")
    assert common.LAUNCHES["masked_aggregate"] == spec.horizon
    want = repro_torch.run(spec, device="cpu")
    assert (want.selections == got.selections).all()
    assert abs(want.accuracy - got.accuracy).max() <= 1e-3


def test_robust_rules_on_card_match_cpu(dev):
    """Each rule on the same inputs on the card and on the CPU."""
    from repro_torch.fed.robust import AGGREGATORS, robust_aggregate_rows
    g = torch.Generator().manual_seed(0)
    s, m, slots, d = 2, 3, 7, 7850
    edge = {"w": torch.randn(s, m, 784, 10, generator=g),
            "b": torch.randn(s, m, 10, generator=g)}
    deltas = torch.randn(s * m, slots, d, generator=g)
    w = (torch.rand(s, m, slots, generator=g) < 0.6).float()
    w[0, 1] = 0.0                       # an ES with no contributor
    for rule in AGGREGATORS:
        a = robust_aggregate_rows({k: v.to(dev) for k, v in edge.items()},
                                  deltas.to(dev), w.to(dev),
                                  aggregator=rule)
        b = robust_aggregate_rows(edge, deltas, w, aggregator=rule)
        for k in b:
            gap = (a[k].cpu() - b[k]).abs().max() / b[k].abs().max()
            assert gap <= 1e-5, (rule, k)


# -- checkpoints, the health guard and the taps on the card -------------------


def _resilient_spec(policy="cocs", **eval_kw):
    return api.ExperimentSpec(
        policy=api.PolicySpec(policy),
        env=api.EnvSpec("paper", backend="device",
                        overrides=(("lr", 0.01),)),
        train=api.TrainSpec(), eval=api.EvalSpec(eval_every=4, **eval_kw),
        horizon=16, seeds=(0, 1))


def _kill(spec, ckpt, blocks, dev):
    from repro_torch.api.run import build_env, build_policy
    from repro_torch.experiment.sweep import SimulatedKill, sweep_experiments
    env = build_env(spec.env)
    pol = build_policy(spec.policy, env.cfg, spec.horizon)
    with pytest.raises(SimulatedKill):
        sweep_experiments({spec.policy.name: pol}, env, list(spec.seeds),
                          spec.horizon, eval_every=4, checkpoint_dir=ckpt,
                          stop_after_blocks=blocks, device=dev)


@pytest.mark.parametrize("policy,kernel", [("cocs", "budgeted_topk"),
                                           ("random", "random_assign")])
def test_resume_bitwise_on_card(dev, tmp_path, policy, kernel):
    """Two uninterrupted runs are bitwise equal; a run killed after two
    intervals and resumed equals them, and its halves launch B1, the
    selection and B3 once a round between them."""
    spec = _resilient_spec(policy)
    a = repro_torch.run(spec, device=dev)
    b = repro_torch.run(spec, device=dev)
    ck = str(tmp_path / "ck")
    common.reset_launches()
    _kill(spec, ck, 2, dev)
    got = repro_torch.run(_resilient_spec(policy, checkpoint_dir=ck,
                                          resume=True), device=dev)
    for k in ("context_pairwise", kernel, "masked_aggregate"):
        assert common.LAUNCHES[k] == spec.horizon, k
    for f in ("selections", "utilities", "participants", "explored",
              "accuracy", "loss"):
        assert (getattr(a, f) == getattr(b, f)).all(), f
        assert (getattr(a, f) == getattr(got, f)).all(), f


def test_cuda_checkpoint_refused_on_cpu(dev, tmp_path):
    ck = str(tmp_path / "ck")
    _kill(_resilient_spec(), ck, 1, dev)
    with pytest.raises(ValueError, match="device type"):
        repro_torch.run(_resilient_spec(checkpoint_dir=ck, resume=True),
                        device="cpu")


def test_taps_health_and_tracer_on_card(dev, tmp_path):
    """Taps on leave every decision bitwise; a clean run records no
    health event; the trace splits each block into dispatch and
    execute."""
    from repro_torch.obs.spec import ObsSpec
    trace = str(tmp_path / "run.jsonl")
    off = repro_torch.run(_resilient_spec(), device=dev)
    spec = dataclasses.replace(
        _resilient_spec(health="record"),
        obs=ObsSpec(telemetry=True, trace=trace))
    on = repro_torch.run(spec, device=dev)
    for f in ("selections", "utilities", "participants", "explored",
              "accuracy"):
        assert (getattr(off, f) == getattr(on, f)).all(), f
    assert on.health == {"checked": 4, "events": []}
    sel = (on.selections >= 0).sum(axis=2)
    assert (on.telemetry["series"]["selected"] == sel).all()
    assert (on.telemetry["series"]["arrived"] == on.participants).all()
    import json
    blocks = [r for r in map(json.loads, open(trace))
              if r["name"] == "fused_block_device"]
    assert len(blocks) == 4
    assert all(b["execute_us"] >= 0 and b["dispatch_us"] > 0
               for b in blocks)


# -- the trial bench on the card ---------------------------------------------


def _trial_suite():
    from repro_torch.core.utility import POLICY_TABLE
    from repro_torch.trials import TrialSuite
    return TrialSuite(
        name="mini-train",
        base=api.ExperimentSpec(
            env=api.EnvSpec("paper", config="mnist-convex",
                            overrides=(("lr", 0.01),)),
            train=api.TrainSpec(model="logreg"),
            eval=api.EvalSpec(eval_every=4), horizon=8, seeds=(0,)),
        policies=tuple((d, api.PolicySpec(POLICY_TABLE[d][0],
                                          seed_offset=POLICY_TABLE[d][1]))
                       for d in ("Oracle", "COCS", "CUCB")),
        axes=(("budget", (3.5, 5.0)),))


def test_trial_suite_on_card_matches_cpu(dev, tmp_path):
    from repro_torch import trials
    suite = _trial_suite()
    cpu, gpu = str(tmp_path / "cpu.json"), str(tmp_path / "gpu.json")
    want = trials.run_suite(suite, ledger=cpu, device="cpu")
    got = trials.run_suite(suite, ledger=gpu, device=dev)
    n, report = trials.check_suite(trials.load_entries(cpu),
                                   trials.load_entries(gpu), suite.name)
    assert n == 0, report
    for w, g in zip(want.records, got.records):
        assert (g.policy, g.coord, g.tier) == (w.policy, w.coord, w.tier)
        assert g.cum_utility_seeds == w.cum_utility_seeds
        assert g.regret_seeds == w.regret_seeds
        assert g.participation == w.participation


def test_trial_suite_defaults_to_cuda_and_resumes_without_dispatch(
        dev, tmp_path, monkeypatch):
    from repro_torch import trials
    suite = _trial_suite()
    path = str(tmp_path / "l.json")
    common.reset_launches()
    first = trials.run_suite(suite, ledger=path)
    # two budget grids (Oracle, COCS) and two CUCB cells, 8 rounds each
    assert common.LAUNCHES["budgeted_topk"] == 2 * 8
    assert common.LAUNCHES["masked_aggregate"] == 4 * 8
    calls = []
    monkeypatch.setattr(api, "run", lambda *a, **k: calls.append(a))
    common.reset_launches()
    again = trials.run_suite(suite, ledger=path, resume=True)
    assert calls == [] and not any(common.LAUNCHES.values())
    for rec in first.records:
        assert again.record(rec.policy, rec.coord).to_entry()["metrics"] \
            == rec.to_entry()["metrics"]
