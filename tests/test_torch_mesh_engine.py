"""The client-sharded cohort engine through ``repro_torch.run``, on gloo
CPU ranks started by ``launch.mesh.spawn_local``.

The reference's spec (``tests/test_mesh_engine.py::_spec``:
metropolis-1k cut to 64 clients and 4 ES, h_t 3, analytic ``true_p``,
batch 16, an eval every 2 rounds, 4 rounds, seeds 0 and 1, COCS) runs
on the shard layouts (clients, seeds) = (2, 1), (4, 1) and (2, 2), one
spawn a layout running every spec of that layout. Every rank's result
equals the port's dense ``run`` of the same spec in every field, bit for
bit, and the reference's dense ``repro.run`` (selections, utilities,
participants and explored bitwise, accuracy and loss within
``ACC_TOL``); telemetry within ``TELE_RTOL`` of the dense taps (sums
reassociate over shards). ``shard_seeds`` on 2 ranks equals the
unsharded run and warns on one process; faults, the Monte-Carlo
``true_p`` and the sqrt utility (P3's walk) shard alike. The capacity
contract: no op inside a sharded block outputs a client-pair table of
the global N (the dense block, the control, does). The reference's
sharded refusals are raised by type before any work.
"""
import os
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from _torch_mesh_ranks import pair_tables, run_grid, run_layout  # noqa
from _torch_parity import one_torch_thread  # noqa: E402,F401
from repro import api as JA  # noqa: E402
from repro.data.federated import FederatedDataset as JData  # noqa: E402
from repro_torch import api as TA  # noqa: E402
from repro_torch.data.federated import FederatedDataset  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.launch.mesh import spawn_local  # noqa: E402
from repro_torch.obs.spec import ObsSpec  # noqa: E402
from repro_torch.sim import spec as tspec  # noqa: E402
from repro_torch.sim.faults import FaultSpec  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OVR = (("num_clients", 64), ("num_edge_servers", 4), ("h_t", 3))
N, M = 64, 4
DATA = dict(num_clients=N, kind="tiny", samples_per_client=20, seed=0)
FIELDS = ("selections", "utilities", "participants", "explored",
          "accuracy", "loss")
# the reference's local SGD and Eq. 3 on XLA against PyTorch's CPU
# kernels: a few float32 ulp of the model, well under one test sample
ACC_TOL = 1e-4
TELE_RTOL = 1e-5
LAYOUTS = ((2, 1), (4, 1), (2, 2))
SPAWN_TIMEOUT = 240.0


def _spec(api, shard=None, telemetry=True, **kw):
    base = dict(policy=api.PolicySpec("cocs"),
                env=api.EnvSpec("metropolis-1k", config="mnist-metropolis-1k",
                                overrides=OVR, true_p="analytic"),
                train=api.TrainSpec(batch_size=16),
                eval=api.EvalSpec(eval_every=2), horizon=4, seeds=(0, 1),
                shard=shard)
    if api is TA:
        base["obs"] = ObsSpec(telemetry=telemetry)
    base.update(kw)
    return api.ExperimentSpec(**base)


FAULTY_ENV = dict(env=TA.EnvSpec(
    "metropolis-1k", config="mnist-metropolis-1k", overrides=OVR,
    true_p="mc", faults=FaultSpec(dropout_rate=0.1, straggler_rate=0.2,
                                  outage_rate=0.1)))


# the non-convex utility: COCS selects by P3's cost-benefit walk, merged
# over the shards with the picked (value, cost) streams
SQRT = dict(horizon=2)


def _sqrt_env(api):
    return api.EnvSpec("metropolis-1k", config="mnist-metropolis-1k",
                       overrides=OVR + (("utility", "sqrt"),),
                       true_p="analytic")


def _layout_specs(layout, tmp):
    shard = TA.ShardSpec(clients=layout[0], seeds=layout[1])
    specs = [_spec(TA, shard)]
    if layout == (4, 1):
        specs.append(_spec(TA, shard, telemetry=False, env=_sqrt_env(TA),
                           **SQRT))
    if layout == (2, 2):
        # the Monte-Carlo true_p and the latency and outage faults
        specs.append(_spec(TA, shard, telemetry=False, **FAULTY_ENV))
    if layout == (2, 1):
        # what the reference's sharded path ignores, ignored alike
        specs.append(_spec(TA, shard, telemetry=False, eval=TA.EvalSpec(
            eval_every=2, checkpoint_dir=str(tmp / "ckpt"), resume=True,
            health="halt")))
        # the dense engine with its seeds split over the 2 ranks
        specs.append(_spec(TA, None, telemetry=False, shard_seeds=True))
    return specs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each layout's ranks' rows, the port's dense runs on the CPU and
    the reference's dense run."""
    tmp = tmp_path_factory.mktemp("mesh")
    ds = FederatedDataset.synthetic(**DATA)
    dense = repro_torch.run(_spec(TA), data=ds, device="cpu")
    plain = repro_torch.run(_spec(TA, telemetry=False), data=ds,
                            device="cpu")
    faulty = repro_torch.run(_spec(TA, telemetry=False, **FAULTY_ENV),
                             data=ds, device="cpu")
    jdata = JData.synthetic(N, kind="tiny", samples_per_client=20, seed=0)
    ref = repro.run(_spec(JA), data=jdata)
    sqrt = repro_torch.run(_spec(TA, telemetry=False, env=_sqrt_env(TA),
                                 **SQRT), data=ds, device="cpu")
    ref_sqrt = repro.run(_spec(JA, env=_sqrt_env(JA), **SQRT), data=jdata)
    out = {}
    for layout in LAYOUTS:
        probe = (_spec(TA, telemetry=False, shard_seeds=False).to_json()
                 if layout == (4, 1) else None)
        out[layout] = spawn_local(
            run_layout, layout[0] * layout[1], backend="gloo", device="cpu",
            init_file=str(tmp / f"rdv{layout[0]}{layout[1]}"),
            args=([s.to_json() for s in _layout_specs(layout, tmp)], DATA,
                  probe), timeout=SPAWN_TIMEOUT)
    # a fused budget grid with its 2 x 2 elements split over 2 ranks
    grid = spawn_local(run_grid, 2, backend="gloo", device="cpu",
                       init_file=str(tmp / "rdvgrid"),
                       args=(_grid_spec().to_json(), GRID_BUDGETS, DATA),
                       timeout=SPAWN_TIMEOUT)
    return {"dense": dense, "plain": plain, "faulty": faulty, "ref": ref,
            "sqrt": sqrt, "ref_sqrt": ref_sqrt, "layouts": out,
            "grid": grid, "tmp": tmp}


GRID_BUDGETS = (6.0, 9.0)


def _grid_spec(**kw):
    return _spec(TA, telemetry=False, horizon=2, shard_seeds=True, **kw)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_run_is_the_dense_run_bitwise(runs, layout):
    dense = runs["dense"]
    assert dense.tier == 4
    for rank, rows in enumerate(runs["layouts"][layout]):
        got = rows[0]
        assert got["tier"] == 4
        for f in FIELDS:
            want = np.asarray(getattr(dense, f))
            assert want.dtype == got[f].dtype, f
            assert np.array_equal(want, got[f]), (layout, rank, f)
        assert got["walk_syncs"] > 0 and got["collectives"]["walk"] > 0
        assert (got["selections"] >= 0).sum() > 0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_run_against_the_reference(runs, layout):
    ref = runs["ref"]
    got = runs["layouts"][layout][0][0]
    for f in FIELDS[:4]:
        assert np.array_equal(np.asarray(getattr(ref, f)), got[f]), f
    for f in ("accuracy", "loss"):
        gap = np.abs(np.asarray(getattr(ref, f)) - got[f]).max()
        assert gap <= ACC_TOL, (f, gap)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_telemetry_within_tolerance(runs, layout):
    want = runs["dense"].telemetry
    got = runs["layouts"][layout][0][0]["telemetry"]
    for part in ("series", "totals"):
        assert set(want[part]) == set(got[part])
        for k in want[part]:
            np.testing.assert_allclose(got[part][k], want[part][k],
                                       rtol=TELE_RTOL, atol=1e-6,
                                       err_msg=f"{part}.{k}")
    for k, v in want["summary"].items():
        assert abs(got["summary"][k] - v) <= TELE_RTOL * max(1.0, abs(v)), k


def test_sharded_run_ignores_checkpoints_resume_and_health(runs):
    """As the reference's sharded path: no checkpoint is written, resume
    and the health guard are not applied, the run is the dense one."""
    rows = runs["layouts"][(2, 1)]
    for r in rows:
        for f in FIELDS:
            assert np.array_equal(np.asarray(getattr(runs["plain"], f)),
                                  r[1][f]), f
    assert not os.path.exists(runs["tmp"] / "ckpt")


def test_sharded_sqrt_utility_is_the_dense_run(runs):
    """P3 over 4 client shards (``shard_assign(sqrt_utility=True)``, one
    all_gather of the champions' density, flat index, value and cost a
    pick): every field bitwise the port's dense run, and the reference's
    dense run bitwise in selections through explored."""
    want, ref = runs["sqrt"], runs["ref_sqrt"]
    assert want.tier == 4 and (np.asarray(want.selections) >= 0).sum() > 0
    for f in FIELDS[:4]:
        assert np.array_equal(np.asarray(getattr(ref, f)),
                              np.asarray(getattr(want, f))), f
    for f in ("accuracy", "loss"):
        gap = np.abs(np.asarray(getattr(ref, f))
                     - np.asarray(getattr(want, f))).max()
        assert gap <= ACC_TOL, (f, gap)
    for r in runs["layouts"][(4, 1)]:
        got = r[1]
        assert got["walk_syncs"] > 0 and got["collectives"]["walk"] > 0
        for f in FIELDS:
            assert np.array_equal(np.asarray(getattr(want, f)), got[f]), f


def test_sharded_faults_and_mc_true_p_are_the_dense_run(runs):
    """Dropout, stragglers and ES outages from the shard fault draws, and
    the Monte-Carlo ``true_p`` from the shard's (K, n_local, M) fading
    pairs: every field bitwise the dense run's."""
    want = runs["faulty"]
    assert (np.asarray(want.selections) >= 0).sum() > 0
    for r in runs["layouts"][(2, 2)]:
        for f in FIELDS:
            assert np.array_equal(np.asarray(getattr(want, f)), r[1][f]), f


def test_shard_seeds_on_two_ranks_is_the_unsharded_run(runs):
    for r in runs["layouts"][(2, 1)]:
        row = r[2]
        for f in FIELDS:
            assert np.array_equal(np.asarray(getattr(runs["plain"], f)),
                                  row[f]), f
        assert row["collectives"].get("seeds") == 1
        assert row["walk_syncs"] == 0


def test_shard_seeds_splits_a_fused_grid(runs):
    """A budget grid's fused tier splits its cell x seed elements over
    the ranks (the reference's ``_fused_grid`` seed mesh): each cell is
    the unsplit grid's, on every rank."""
    ds = FederatedDataset.synthetic(**DATA)
    with pytest.warns(UserWarning, match="seed-axis sharding requested"):
        want = repro_torch.run(_grid_spec().grid(budget=list(GRID_BUDGETS)),
                               data=ds, device="cpu")
    for r in runs["grid"]:
        assert r["collectives"] == {"seeds": 1}
        for w, g in zip(want.results, r["cells"]):
            assert w.batched_axes == g["batched_axes"] == ("budget",)
            assert np.array_equal(w.selections, g["selections"])
            assert np.array_equal(w.accuracy, g["accuracy"])


def test_shard_seeds_on_one_process_warns():
    spec = _spec(TA, telemetry=False, horizon=2, shard_seeds=True)
    with pytest.warns(UserWarning, match="seed-axis sharding requested"):
        res = repro_torch.run(spec, data=FederatedDataset.synthetic(**DATA),
                              device="cpu")
    assert res.selections.shape == (2, 2, N)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        repro_torch.run(_spec(TA, telemetry=False, horizon=2,
                              shard_seeds=False),
                        data=FederatedDataset.synthetic(**DATA), device="cpu")


def test_capacity_contract(runs):
    """No op inside a sharded block (4 client shards) outputs a
    consecutive (N, M) client-pair table; its (N/4, M) tables are there.
    The dense block, the control, is full of (N, M) ones."""
    shapes = runs["layouts"][(4, 1)][0][-1]
    assert len(shapes["sharded"]) > 1000
    assert not pair_tables(shapes["sharded"], N, M)
    assert pair_tables(shapes["sharded"], N // 4, M)
    assert pair_tables(shapes["dense"], N, M)


def _refused(spec, error, says, monkeypatch):
    def no_env(*a, **k):
        raise AssertionError("the env was built before the refusal")
    monkeypatch.setattr(tspec, "make", no_env)
    common.reset_launches()
    with pytest.raises(error, match=says):
        repro_torch.run(spec, device="cpu")
    assert not any(common.LAUNCHES.values())


SHARD2 = TA.ShardSpec(clients=2)

REFUSED = {
    "corruption faults": (dict(env=TA.EnvSpec(
        "metropolis-1k", overrides=OVR, true_p="analytic",
        faults=FaultSpec(corrupt_rate=0.25))), NotImplementedError,
        "corruption"),
    "oracle": (dict(policy=TA.PolicySpec("oracle")), NotImplementedError,
               "pair_values"),
    "random": (dict(policy=TA.PolicySpec("random")), NotImplementedError,
               "pair_values"),
    "aggregator": (dict(train=TA.TrainSpec(batch_size=16,
                                           aggregator="median")),
                   NotImplementedError, "median"),
    "moe model": (dict(train=TA.TrainSpec(model="moe")),
                  NotImplementedError, "MoE"),
    "clients do not divide": (dict(shard=TA.ShardSpec(clients=3)),
                              ValueError, "must divide num_clients=64"),
    "host env": (dict(env=TA.EnvSpec("paper", backend="host")), ValueError,
                 "tier 3"),
    "no training": (dict(train=None), ValueError, "tier 1"),
    # everything else checks out: the ranks are what is missing
    "no process group": ({}, ValueError,
                         "2 ranks but the process group has 1.*torchrun "
                         "--nproc-per-node=2"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_sharded_refusals_before_any_work(name, monkeypatch):
    kw, error, says = REFUSED[name]
    spec = _spec(TA, SHARD2, telemetry=False)
    _refused(TA.ExperimentSpec(**{**spec.__dict__, **kw}), error, says,
             monkeypatch)


def test_seed_shards_that_do_not_divide_refuse():
    with pytest.raises(ValueError, match="must divide the 2"):
        _spec(TA, TA.ShardSpec(clients=2, seeds=4))
    from repro_torch.mesh.runner import check_sharded
    pol = repro_torch.api.build_policy(TA.PolicySpec("cocs"),
                                       tspec.make("metropolis-1k").cfg, 4)
    with pytest.raises(ValueError, match="must divide the 3"):
        check_sharded(pol, TA.ShardSpec(clients=2, seeds=2),
                      device_env=True, num_clients=N, n_seeds=3,
                      faults=None, model_kind="logreg", aggregator="mean")
