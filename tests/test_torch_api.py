"""The declarative facade, ``repro_torch.run(spec)``, against the
reference's ``repro.run`` on the CPU.

A spec writes the reference's JSON string and reads the reference's.
Tier 1 on a device env equals ``repro.run`` bitwise (selections,
utilities, participants, explored, and the provenance: tier, env
backend, draw schedule). Tier 4 on ``paper`` gives the reference's
selections bitwise and its accuracy within ``SWEEP_ACC_TOL``. The specs
that named ROADMAP queue A item 4 run, resolve, or raise the
reference's exception before any work starts (the env is never built),
and ``device=None`` raises without CUDA. The host env, tiers 2 and 3
and grids are held to the reference in ``test_torch_api_host.py`` and
``test_torch_grid.py``."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from _torch_parity import SWEEP_ACC_TOL, one_torch_thread  # noqa: E402,F401
from repro import api as JA  # noqa: E402
from repro.obs.spec import ObsSpec as JObs  # noqa: E402
from repro.sim.faults import FaultSpec as JFaults  # noqa: E402
from repro_torch import api as TA  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.obs.spec import ObsSpec  # noqa: E402
from repro_torch.sim.faults import FaultSpec  # noqa: E402
from repro_torch.sim import draws as tdraws  # noqa: E402
from repro_torch.sim import spec as tspec  # noqa: E402

FIELDS = ("selections", "utilities", "participants", "explored")

SPECS = {
    "default": JA.ExperimentSpec(),
    "fig3-random": JA.ExperimentSpec(
        policy=JA.PolicySpec("random", seed_offset=3),
        env=JA.EnvSpec(scenario="paper", config="mnist-convex"),
        horizon=400, seeds=(1,)),
    "options": JA.ExperimentSpec(
        policy=JA.PolicySpec("cocs", budget=5.0,
                             options=(("h_t", 3), ("alpha", 0.5))),
        env=JA.EnvSpec("metropolis-1k", true_p="analytic", deadline=2.5,
                       overrides=(("lr", 0.01),)),
        train=JA.TrainSpec(model="cnn", slots_per_es=8),
        eval=JA.EvalSpec(eval_every=3), horizon=12, seeds=(0, 1, 2)),
    "faults-obs-shard": JA.ExperimentSpec(
        env=JA.EnvSpec(faults=JFaults(dropout_rate=0.2)),
        shard=JA.ShardSpec(clients=2), shard_seeds=True,
        obs=JObs(telemetry=True, trace="t.jsonl")),
}

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_json_same_as_reference(name):
    want = SPECS[name]
    js = want.to_json()
    got = TA.ExperimentSpec.from_json(js)
    assert got.to_json() == js
    assert got.to_dict() == want.to_dict()
    back = JA.ExperimentSpec.from_json(got.to_json())
    assert back == want
    grid = want.grid(budget=[2.5, 3.5], h_t=[2, 5])
    tgrid = TA.ExperimentGrid.from_json(grid.to_json())
    assert tgrid.to_json() == grid.to_json()
    assert [c.to_json() for c in tgrid.expand()] == \
        [c.to_json() for c in grid.expand()]


def test_spec_validation_as_reference():
    with pytest.raises(ValueError, match="true_p"):
        TA.ExperimentSpec(env=TA.EnvSpec(true_p="exact"))
    with pytest.raises(ValueError, match="unknown field"):
        TA.ExperimentSpec.from_dict({"policy": {"nme": "cocs"}})
    with pytest.raises(KeyError, match="budget"):
        TA.ExperimentSpec().grid(budgets=[1.0])
    with pytest.raises(ValueError, match="aggregator"):
        TA.ExperimentSpec(train=TA.TrainSpec(aggregator="max"))


@pytest.mark.parametrize("reg,offset,scenario,true_p,horizon", [
    ("cocs", 0, "paper", "mc", 10), ("oracle", 0, "paper", "mc", 10),
    ("random", 3, "paper", "mc", 10),
    ("cocs", 0, "metropolis-1k", "analytic", 2)])
def test_run_tier1_device_env_bitwise(reg, offset, scenario, true_p,
                                      horizon):
    backend = "device" if scenario == "paper" else "auto"
    spec = JA.ExperimentSpec(
        policy=JA.PolicySpec(reg, seed_offset=offset),
        env=JA.EnvSpec(scenario, backend=backend, true_p=true_p),
        horizon=horizon, seeds=(0, 1))
    want = repro.run(spec)
    got = repro_torch.run(TA.ExperimentSpec.from_json(spec.to_json()),
                          device="cpu")
    assert (got.tier, got.env_backend) == (want.tier, want.env_backend) \
        == (1, "device")
    assert got.draw_schedule == want.draw_schedule == tdraws.SCHEDULE_ID
    assert got.spec.to_json() == spec.to_json()
    for f in FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert g.dtype == w.dtype and np.array_equal(w, g), f
    assert got.accuracy is None
    with pytest.raises(ValueError, match="bandit-only"):
        got.final_accuracy()
    assert np.array_equal(got.cumulative_utility(),
                          np.cumsum(got.utilities, axis=1))


def test_run_tier4_paper():
    spec = JA.ExperimentSpec(
        policy=JA.PolicySpec("cocs"), env=JA.EnvSpec("paper",
                                                     backend="device"),
        train=JA.TrainSpec(slots_per_es=11), eval=JA.EvalSpec(eval_every=2),
        horizon=4, seeds=(0, 1))
    want = repro.run(spec)
    got = repro_torch.run(TA.ExperimentSpec.from_json(spec.to_json()),
                          device="cpu")
    assert got.tier == want.tier == 4
    for f in FIELDS + ("eval_rounds",):
        assert np.array_equal(np.asarray(getattr(want, f)), getattr(got, f))
    for f in ("accuracy", "loss"):
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert np.isfinite(g).all()
        assert np.abs(w - g).max() <= SWEEP_ACC_TOL, f
    assert got.final_accuracy().shape == (2,)


def _spec(**kw):
    base = TA.ExperimentSpec(env=TA.EnvSpec("metropolis-1k"), horizon=2)
    return dataclasses.replace(base, **kw)


REFUSALS = {
    # what the reference runs, the port runs (tier 1 ignores
    # shard_seeds; a batched grid ignores its cells' ShardSpec), or, for
    # a mesh-scale cohort, resolves (its bandit run is too large for a
    # CPU test); what the reference refuses, the port refuses with the
    # reference's exception, before any work
    "host env": (_spec(env=TA.EnvSpec(
        "paper", faults=FaultSpec(dropout_rate=0.2)),
        obs=ObsSpec(telemetry=True), shard_seeds=True), ("runs", 1)),
    "host env, training": (_spec(env=TA.EnvSpec("paper", backend="host"),
                                 train=TA.TrainSpec(transposed_gemm=True),
                                 eval=TA.EvalSpec(checkpoint_dir="ckpt"),
                                 shard=TA.ShardSpec(clients=2)),
                           (ValueError, "resolved to tier 3")),
    "grid": (_spec(obs=ObsSpec(telemetry=True),
                   shard=TA.ShardSpec(clients=2)).grid(budget=[1.0, 2.0]),
             ("runs", 1)),
    "transposed logreg": (_spec(train=TA.TrainSpec(transposed_gemm=True),
                                shard=TA.ShardSpec(clients=2)),
                          ("ranks", 4)),
    "faults": (_spec(env=TA.EnvSpec(
        "metropolis-1k", faults=FaultSpec(outage_rate=0.1)),
        eval=TA.EvalSpec(health="halt"), shard_seeds=True), ("runs", 1)),
    "obs": (_spec(obs=ObsSpec(telemetry=True, trace="trace.jsonl"),
                  shard=TA.ShardSpec(clients=2)),
            (ValueError, "resolved to tier 1")),
    "checkpoint": (_spec(eval=TA.EvalSpec(checkpoint_dir="ckpt"),
                         env=TA.EnvSpec("metropolis-1m")),
                   ("resolves", (1_000_000, 64, 80))),
    "health": (_spec(eval=TA.EvalSpec(health="record"), shard_seeds=True),
               ("runs", 1)),
    "aggregator": (_spec(train=TA.TrainSpec(aggregator="median"),
                         eval=TA.EvalSpec(resume=True),
                         shard=TA.ShardSpec(clients=2)),
                   (NotImplementedError, "aggregator 'median'")),
    "shard": (_spec(shard=TA.ShardSpec(clients=2)),
              (ValueError, "resolved to tier 1")),
    "shard seeds": (_spec(shard_seeds=True), ("runs", 1)),
    "mesh cohort": (_spec(env=TA.EnvSpec("metropolis-100k")),
                    ("resolves", (100_000, 32, 50))),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_before_any_work(name, monkeypatch, tmp_path):
    """Each spec that named queue A item 4 before the sharded cohort was
    ported: run, resolved, or refused as the reference refuses it."""
    spec, (what, arg) = REFUSALS[name]
    if what == "runs":
        got = repro_torch.run(spec, device="cpu")
        for r in (got.results if hasattr(got, "results") else [got]):
            assert r.tier == arg and r.selections.shape[:2] == (1, 2)
        return
    if what == "resolves":
        env = TA.build_env(spec.env)
        policy = TA.build_policy(spec.policy, env.cfg, spec.horizon)
        assert (env.cfg.num_clients, env.cfg.num_edge_servers,
                env.spec.arrival_period) == arg
        assert TA.select_tier(spec, policy, env) == 1
        return
    if what == "ranks":
        # on a group of two ranks it runs, bitwise the dense run
        from repro_torch.data.federated import FederatedDataset
        from repro_torch.launch.mesh import run_specs, spawn_local
        data = dict(num_clients=1000, kind="tiny", samples_per_client=20,
                    seed=0)
        rows = spawn_local(run_specs, 2, backend="gloo", device="cpu",
                           init_file=str(tmp_path / "rdv"),
                           args=([spec.to_json()], data), timeout=240.0)
        dense = repro_torch.run(dataclasses.replace(spec, shard=None),
                                data=FederatedDataset.synthetic(**data),
                                device="cpu")
        assert dense.tier == 4
        for r in rows:
            assert r[0]["tier"] == arg
            for f in FIELDS + ("accuracy", "loss"):
                assert np.array_equal(np.asarray(getattr(dense, f)),
                                      r[0][f]), f
        return

    def no_env(*a, **k):
        raise AssertionError("the env was built before the refusal")

    monkeypatch.setattr(tspec, "make", no_env)
    common.reset_launches()
    with pytest.raises(what, match=arg):
        repro_torch.run(spec, device="cpu")
    assert not any(common.LAUNCHES.values())


def test_refusals_of_policies_and_types():
    # the registry names all six policies when it refuses an unknown one
    with pytest.raises(KeyError, match="cocs-phased.*linucb"):
        repro_torch.run(_spec(policy=TA.PolicySpec("ucb")),
                        device="cpu")
    with pytest.raises(TypeError, match="ExperimentSpec"):
        repro_torch.run({"policy": "cocs"}, device="cpu")


def test_device_none_asks_for_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(tspec, "make", lambda *a, **k: 1 / 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.run(_spec())
