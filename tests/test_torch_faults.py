"""Fault injection in the port (``repro_torch.sim.faults``, the fault
draws of ``sim.draws``, the device env ``sim.core`` and the float64 host
env ``core.network``) against the reference's on the CPU.

The four uniform fault streams are bitwise the reference's and the
exponential straggler draw is within ``EXPONENTIAL_MAX_ULP``; the three
fault functions give bitwise event masks and latencies on the same
inputs, in the torch form and the numpy form. Over 2 seeds x 20 rounds
of ``paper`` and ``high-mobility`` with all four processes on, both envs
give the reference's eligibility bitwise, its latencies within the env
tolerances (the same +inf dropouts), and no Eq. 6 outcome flip (the
count is printed; run with ``-s``). A ``FaultSpec`` with every rate 0
draws nothing and leaves every output bitwise as ``faults=None``.
Through the facade (``runs_agree`` against ``repro.run``): tier 1 on
``device:paper`` and on the host ``paper`` env with dropout and outages,
and tier 2 (CUCB) with stragglers and corruption; a batched ``budget``
grid on the faulty device env, each cell also equal to its sequential
``run``."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from _torch_parity import (ENV_RTOL, EXPONENTIAL_MAX_ULP,  # noqa: E402
                           SWEEP_ACC_TOL,
                           bitwise, max_rel, np_, one_torch_thread,
                           runs_agree, t_, ulp_gap)  # noqa: F401
from repro import api as JA  # noqa: E402
from repro import envs as JE  # noqa: E402
from repro import sim as jsim  # noqa: E402
from repro.sim import draws as jdraws  # noqa: E402
from repro.sim import faults as jfaults  # noqa: E402
from repro_torch import api as TA  # noqa: E402
from repro_torch import envs as TE  # noqa: E402
from repro_torch.sim import draws as tdraws  # noqa: E402
from repro_torch.sim import faults as tfaults  # noqa: E402
from repro_torch.sim import spec as tspec  # noqa: E402
from repro_torch.sim.core import init_statics, sim_round  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

UNIFORM = ("drop_u", "strag_u", "out_u", "corr_u")
ALL_ON = dict(dropout_rate=0.2, straggler_rate=0.3, outage_rate=0.15,
              corrupt_rate=0.25)
SEEDS = (0, 1)
HORIZON = 20
# the float64 host env: a few-ulp gap of a float32 draw carried through
# (test_torch_envs.py's bound); the straggler factor adds one ulp of
# strag_e, 2.4e-7 relative at most (measured 1.2e-7)
HOST_RTOL = 1e-6


def _pair(**rates):
    return jfaults.FaultSpec(**rates), tfaults.FaultSpec(**rates)


# -- the draws ---------------------------------------------------------------


@pytest.mark.parametrize("seed,t,n,m", [(0, 0, 50, 3), (3, 7, 1000, 12),
                                        (11, 123, 257, 5)])
def test_fault_draws_match_reference(seed, t, n, m):
    want = jax.jit(jdraws.fault_draws, static_argnums=(2, 3))(
        jnp.uint32(seed), jnp.int32(t), n, m)
    got = tdraws.fault_draws(seed, t, n, m)
    for f in UNIFORM:
        assert bitwise(np.asarray(getattr(want, f)), getattr(got, f)), f
    assert ulp_gap(np.asarray(want.strag_e), got.strag_e) \
        <= EXPONENTIAL_MAX_ULP
    # a stream asked for alone is the same stream
    alone = tdraws.fault_draws(seed, t, n, m, fields=("corr_u",))
    assert alone.drop_u is None and torch.equal(alone.corr_u, got.corr_u)


@pytest.mark.parametrize("seed,t", [(0, 0), (5, 19)])
def test_host_fault_draws_are_the_float32_draws(seed, t):
    n, m = 50, 3
    host = tdraws.host_fault_draws(seed, t, n, m)
    dev = tdraws.fault_draws(seed, t, n, m)
    ref = jdraws.host_fault_draws(seed, t, n, m)
    for f in tdraws.FaultDraws._fields:
        a = getattr(host, f)
        assert a.dtype == np.float64
        assert np.array_equal(a, getattr(dev, f).double().numpy()), f
        if f in UNIFORM:
            assert np.array_equal(a, getattr(ref, f)), f


def test_fault_tags_do_not_renumber_the_schedule():
    tags = ("_FDROP", "_FSTRAG_U", "_FSTRAG_E", "_FOUT", "_FCORR")
    assert tuple(getattr(tdraws, k) for k in tags) == (7, 8, 9, 10, 11)
    for k in tags + ("_MOVE", "_BWJ", "_COMPJ", "_FDT", "_FUT", "_MCDT",
                     "_MCUT", "_INIT", "_ROUND"):
        assert getattr(tdraws, k) == getattr(jdraws, k), k
    assert tdraws.FaultDraws._fields == jdraws.FaultDraws._fields
    assert tdraws.SCHEDULE_ID == jdraws.SCHEDULE_ID


# -- the three functions -------------------------------------------------------

PROCESSES = {
    "dropout": dict(dropout_rate=0.3),
    "straggler": dict(straggler_rate=0.4, straggler_scale=2.7),
    "outage": dict(outage_rate=0.3),
    "corrupt": dict(corrupt_rate=0.4, corrupt_scale=-3.0),
    "all": dict(ALL_ON, straggler_scale=3.0),
}


@pytest.mark.parametrize("process", sorted(PROCESSES))
def test_fault_functions_match_reference(process):
    jspec, tspec_ = _pair(**PROCESSES[process])
    n, m = 300, 7
    rng = np.random.default_rng(len(process))
    tau32 = rng.uniform(0.05, 4.0, (n, m)).astype(np.float32)
    elig = rng.uniform(size=(n, m)) < 0.6
    fd = jdraws.fault_draws(4, 9, n, m)
    u = {f: np.asarray(getattr(fd, f)) for f in fd._fields}
    # the device form: jitted jnp against torch, float32
    jit_lat = jax.jit(lambda *a: jfaults.apply_latency_faults(
        jspec, *a, jnp))
    want = np.asarray(jit_lat(tau32, u["strag_u"], u["strag_e"],
                              u["drop_u"]))
    got = tfaults.apply_latency_faults(tspec_, t_(tau32), t_(u["strag_u"]),
                                       t_(u["strag_e"]), t_(u["drop_u"]))
    assert got.dtype == torch.float32 and bitwise(want, got)
    want_e = np.asarray(jax.jit(lambda e, o: jfaults.apply_outage(
        jspec, e, o, jnp))(elig, u["out_u"]))
    assert bitwise(want_e, tfaults.apply_outage(tspec_, t_(elig),
                                                t_(u["out_u"])))
    want_c = np.asarray(jfaults.corrupt_mask(jspec, u["corr_u"], jnp))
    assert bitwise(want_c, tfaults.corrupt_mask(tspec_, t_(u["corr_u"])))
    # the host form: numpy float64 on the float64 views
    h = {f: v.astype(np.float64) for f, v in u.items()}
    tau64 = tau32.astype(np.float64) * 1.0000001
    want64 = jfaults.apply_latency_faults(jspec, tau64, h["strag_u"],
                                          h["strag_e"], h["drop_u"], np)
    got64 = tfaults.apply_latency_faults(tspec_, tau64, h["strag_u"],
                                         h["strag_e"], h["drop_u"])
    assert got64.dtype == np.float64 and np.array_equal(want64, got64)
    assert np.array_equal(jfaults.apply_outage(jspec, elig, h["out_u"], np),
                          tfaults.apply_outage(tspec_, elig, h["out_u"]))
    assert np.array_equal(jfaults.corrupt_mask(jspec, h["corr_u"]),
                          tfaults.corrupt_mask(tspec_, h["corr_u"]))
    # latencies only grow; a dropout is +inf
    assert (np_(got) >= tau32).all()
    if tspec_.dropout_rate:
        assert np.isinf(np_(got)).any()


# -- the envs with faults ---------------------------------------------------


def _flips_and_checks(want_out, got_out, want_tau, got_tau, deadline,
                      rtol):
    """Latencies within ``rtol`` with the same infinities; returns the
    number of Eq. 6 outcome flips."""
    inf = np.isinf(want_tau)
    assert np.array_equal(inf, np.isinf(got_tau))
    rel = np.abs(want_tau[~inf] - got_tau[~inf]) / want_tau[~inf]
    assert rel.max() <= rtol
    flip = want_out != got_out
    # a flip may only sit at the deadline
    assert np.all(np.abs(got_tau[flip] - deadline) <= rtol * deadline)
    return int(flip.sum())


@pytest.mark.parametrize("preset", ["paper", "high-mobility"])
def test_device_env_with_faults_matches_reference(preset):
    jspec, tspec_ = _pair(**ALL_ON)
    jenv = jsim.make(preset, faults=jspec)
    tenv = tspec.make(preset, faults=tspec_)
    want = jenv.rollout_device(list(SEEDS), HORIZON).round
    seeds = torch.tensor(SEEDS)
    st = init_statics(tenv.spec, seeds)
    pos, flips, events = st.pos0, 0, 0
    for t in range(HORIZON):
        pos, sr = sim_round(tenv.spec, seeds, st, pos, t)
        rd = sr.round
        w = lambda f: np.asarray(getattr(want, f))[:, t]
        assert bitwise(w("eligible"), rd.eligible), t
        # costs read the bandwidth jitter, a normal draw (R4): few ulp
        assert max_rel(w("costs"), rd.costs) <= ENV_RTOL, t
        flips += _flips_and_checks(w("outcomes"), np_(rd.outcomes),
                                   w("latency"), np_(rd.latency),
                                   tenv.spec.deadline_s, ENV_RTOL)
        events += int(np.isinf(np_(rd.latency)).any(-1).sum())
    print(f"\n{preset}: device env with faults, {flips} outcome flips "
          f"over {len(SEEDS)} seeds x {HORIZON} rounds")
    assert flips == 0 and events > 0


def test_sim_round_on_the_references_draws():
    """``sim_round`` fed the reference's round and fault draws (``dr``,
    ``fd``): the fault events land where the reference's do."""
    from repro.sim import core as jcore
    jspec, tspec_ = _pair(**ALL_ON)
    js = jsim.make("paper", faults=jspec).spec
    ts = tspec.make("paper", faults=tspec_).spec
    n, m = js.num_clients, js.num_edge_servers
    init = jax.jit(jcore.init_statics, static_argnums=0)
    step = jax.jit(jcore.sim_round, static_argnums=0)
    jst = init(js, jnp.uint32(3))
    tst = init_statics(ts, torch.tensor([3]))
    jpos, tpos = jst.pos0, tst.pos0
    for t in range(3):
        dr = jdraws.round_draws(3, t, n, m, js.mc_true_p)
        fd = jdraws.fault_draws(3, t, n, m)
        jpos, want = step(js, jnp.uint32(3), jst, jpos, jnp.int32(t), dr, fd)
        tpos, got = sim_round(
            ts, torch.tensor([3]), tst, tpos, t,
            dr=tdraws.RoundDraws(*(t_(a)[None] for a in dr)),
            fd=tdraws.FaultDraws(*(t_(a)[None] for a in fd)))
        w = want.round
        assert bitwise(np.asarray(w.eligible)[None], got.round.eligible)
        _flips_and_checks(np.asarray(w.outcomes)[None],
                          np_(got.round.outcomes),
                          np.asarray(w.latency)[None],
                          np_(got.round.latency), js.deadline_s, ENV_RTOL)


@pytest.mark.parametrize("preset", ["paper", "high-mobility"])
def test_host_env_with_faults_matches_reference(preset):
    jspec, tspec_ = _pair(**ALL_ON)
    flips = cleared = 0
    deadline = TE.make(preset).cfg.deadline_s
    for seed in SEEDS:
        want = JE.make(preset, faults=jspec).rollout(seed, HORIZON)
        got = TE.make(preset, faults=tspec_).rollout(seed, HORIZON)
        for w, g in zip(want, got):
            assert np.array_equal(w.eligible, g.eligible), (seed, w.t)
            flips += _flips_and_checks(w.outcomes, g.outcomes, w.latency,
                                       g.latency, deadline, HOST_RTOL)
            cleared += int((~g.eligible.any(axis=0)).sum())
    print(f"\n{preset}: host env with faults, {flips} outcome flips, "
          f"{cleared} ES columns cleared")
    assert flips == 0 and cleared > 0


def test_host_and_device_envs_inject_the_same_events():
    _, f = _pair(**ALL_ON)
    host = TE.make("paper", faults=f).rollout(3, 6)
    dev = tspec.make("paper", faults=f).rollout(3, 6, device="cpu")
    for h, d in zip(host, dev):
        assert np.array_equal(h.eligible, d.eligible)
        assert np.array_equal(np.isinf(h.latency), np.isinf(d.latency))


# -- faults off ----------------------------------------------------------------


def test_zero_rates_draw_nothing_and_change_nothing(monkeypatch):
    off = tfaults.FaultSpec(straggler_scale=9.0)
    assert not off.enabled
    base_d = tspec.make("paper").rollout(2, 5, device="cpu")
    base_h = TE.make("paper").rollout(2, 5)

    def no_draw(*a, **k):
        raise AssertionError("a fault stream was drawn")

    monkeypatch.setattr(tdraws, "fault_draws", no_draw)
    for faults in (None, off):
        d = tspec.make("paper", faults=faults).rollout(2, 5, device="cpu")
        h = TE.make("paper", faults=faults).rollout(2, 5)
        for a, b in zip(base_d + base_h, d + h):
            for f in ("eligible", "outcomes", "latency", "costs",
                      "contexts", "true_p"):
                assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_sim_spec_carries_faults():
    _, f = _pair(outage_rate=0.2)
    env = tspec.make("metropolis-1k", faults=f)
    assert env.spec.faults == f
    assert dataclasses.replace(env.spec, faults=None) \
        == tspec.make("metropolis-1k").spec
    assert tspec.resolve("device:paper").spec.faults is None


# -- through the facade ------------------------------------------------------


def _port_spec(jspec):
    return TA.ExperimentSpec.from_json(jspec.to_json())


def test_device_env_faulty_tier1():
    jspec = JA.ExperimentSpec(env=JA.EnvSpec(
        "paper", backend="device",
        faults=jfaults.FaultSpec(dropout_rate=0.2, outage_rate=0.1)),
        horizon=20, seeds=(0, 1))
    got = repro_torch.run(_port_spec(jspec), device="cpu")
    assert (got.tier, got.env_backend) == (1, "device")
    runs_agree(repro.run(jspec), got)



def test_host_env_faulty_tiers_1_and_2():
    """Tier 1 on the host ``paper`` env with dropout and outages, and
    tier 2 (CUCB) with stragglers and corruption."""
    t1 = JA.ExperimentSpec(env=JA.EnvSpec(
        "paper", faults=jfaults.FaultSpec(dropout_rate=0.2, outage_rate=0.1)),
        horizon=20, seeds=(0, 1))
    runs_agree(repro.run(t1), repro_torch.run(_port_spec(t1), device="cpu"))
    t2 = JA.ExperimentSpec(
        policy=JA.PolicySpec("cucb", seed_offset=1),
        env=JA.EnvSpec("paper", faults=jfaults.FaultSpec(straggler_rate=0.3,
                                               corrupt_rate=0.2),
                       overrides=(("lr", 0.01),)),
        train=JA.TrainSpec(), eval=JA.EvalSpec(eval_every=6), horizon=12,
        seeds=(0, 1))
    got = repro_torch.run(_port_spec(t2), device="cpu")
    assert got.tier == 2
    runs_agree(repro.run(t2), got)


def test_faulty_budget_grid_batches_on_the_device_env():
    base = JA.ExperimentSpec(
        env=JA.EnvSpec("paper", backend="device", faults=jfaults.FaultSpec(**ALL_ON),
                       overrides=(("lr", 0.01),)),
        train=JA.TrainSpec(), eval=JA.EvalSpec(eval_every=8), horizon=8,
        seeds=(0, 1))
    want = repro.run(base.grid(budget=[3.5, 5.0]))
    got = repro_torch.run(_port_spec(base).grid(budget=[3.5, 5.0]),
                          device="cpu")
    for w, r, cell in zip(want.results, got.results, got.cells):
        assert r.batched_axes == ("budget",) and r.tier == 4
        runs_agree(w, r)
        seq = repro_torch.run(cell, device="cpu")
        for f in ("selections", "utilities", "participants", "explored"):
            assert np.array_equal(getattr(seq, f), getattr(r, f)), f
        assert np.abs(seq.accuracy - r.accuracy).max() <= SWEEP_ACC_TOL
