"""The host env (``repro_torch.envs``: the float64 ``HFLNetworkSim`` and
its scenarios) against the reference's ``repro.envs`` on the CPU.

Both packages draw from the same counter-based schedule; the port's
float32 draws are within a few ulp of the reference's (``repro_torch.
random``), and both simulators then compute in float64. Over 2 seeds x
20 rounds of every scenario in both ``true_p`` modes, eligibility and
outcomes are equal (0 flips), the float fields agree within
``HOST_ENV_RTOL`` / ``HOST_ENV_ATOL``, ``step`` is pure,
``rollout_multi`` equals the stacked rollouts, and a block of draws
equals the per-round draws exactly."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from _torch_parity import one_torch_thread  # noqa: E402,F401
from repro import envs as JE  # noqa: E402
from repro_torch import envs as TE  # noqa: E402
from repro_torch.policies.base import stack_rounds  # noqa: E402
from repro_torch.sim import draws as tdraws  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the float fields: a few-ulp gap of a float32 draw, carried through the
# float64 sim (measured: 3.7e-7 relative at most, high-mobility's costs).
# Contexts hold values near 0 (far clients' normalized rates), where the
# absolute bound binds; analytic true_p likewise (measured 1.0e-7).
# Monte-Carlo true_p is a mean of 0/1 values over 128 fading pairs: one
# flipped pair moves it by 1/128, and the atol holds it to none.
HOST_ENV_RTOL = 1e-6
HOST_ENV_ATOL = 1e-6
FLOAT_FIELDS = ("costs", "contexts", "latency", "true_p", "compute",
                "bandwidth")
SEEDS = (0, 1)
HORIZON = 20
# the five host scenarios and bursty arrival as an override of paper
SCENARIOS = ("paper", "static-clients", "high-mobility", "tiered-pricing",
             "flash-crowd", "bursty")


def _make(pkg, name, true_p):
    if name == "bursty":
        return pkg.make("paper", true_p=true_p, arrival_period=8,
                        arrival_duty=0.4)
    return pkg.make(name, true_p=true_p)


def test_scenarios_are_the_reference_s():
    assert TE.available() == JE.available()
    for name in TE.available():
        assert dataclasses.asdict(TE.SCENARIOS[name]) == \
            dataclasses.asdict(JE.SCENARIOS[name])


@pytest.mark.parametrize("true_p", ["mc", "analytic"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_rollout_matches_reference(name, true_p):
    tenv, jenv = _make(TE, name, true_p), _make(JE, name, true_p)
    for seed in SEEDS:
        got, want = tenv.rollout(seed, HORIZON), jenv.rollout(seed, HORIZON)
        for g, w in zip(got, want):
            assert g.t == w.t
            assert np.array_equal(g.eligible, w.eligible), (seed, g.t)
            assert np.array_equal(g.outcomes, w.outcomes), (seed, g.t)
            for f in FLOAT_FIELDS:
                a, b = getattr(g, f), getattr(w, f)
                assert a.dtype == b.dtype == np.float64, f
                assert np.allclose(a, b, rtol=HOST_ENV_RTOL,
                                   atol=HOST_ENV_ATOL), (f, seed, g.t)
    if name == "bursty":
        # the override reaches the sim: some client sits a round out
        assert any((~r.eligible.any(axis=1)).any() for r in got)


def test_step_is_pure_and_rollout_multi_stacks():
    env = TE.make("high-mobility")
    s0 = env.init(3)
    s1, rd_a = env.step(s0)
    _, rd_b = env.step(s0)           # the same state twice
    assert s1.t == 1 and s0.t == 0
    for f in FLOAT_FIELDS + ("eligible", "outcomes"):
        assert np.array_equal(getattr(rd_a, f), getattr(rd_b, f))
    _, rd_c = env.step(s1)
    want = env.rollout(3, 2)
    assert np.array_equal(rd_c.latency, want[1].latency)
    multi = env.rollout_multi(SEEDS, 6)
    for si, seed in enumerate(SEEDS):
        one = stack_rounds(env.rollout(seed, 6))
        for f, a, b in zip(one._fields, one, multi):
            assert np.array_equal(a, b[si]), f


@pytest.mark.parametrize("k_mc", [0, 128])
def test_block_draws_equal_per_round_draws(k_mc):
    n, m = 50, 3
    block = tdraws._block_size(n, m, k_mc)
    for t in (0, block - 1, block + 2):
        got = tdraws.host_round_draws(5, t, n, m, k_mc)
        one = tdraws.round_draws(5, t, n, m, k_mc)
        for f, a, b in zip(got._fields, got, one):
            assert torch.equal(torch.from_numpy(a),
                               b.to(torch.float64)), (t, f)
    init = tdraws.host_init_draws(5, n)
    for f, a, b in zip(init._fields, init, tdraws.init_draws(5, n)):
        b = b.double() if b.dtype == torch.float32 else b
        assert torch.equal(torch.from_numpy(a), b), f


def test_faults_refused():
    """Rates outside [0, 1] are refused when the spec is built; a valid
    ``FaultSpec`` now runs in the host env (its parity with the
    reference: ``test_torch_faults.py``)."""
    from repro_torch.sim.faults import FaultSpec
    with pytest.raises(ValueError, match="dropout_rate"):
        FaultSpec(dropout_rate=1.5)
    with pytest.raises(ValueError, match="unknown field"):
        FaultSpec.from_dict({"droput_rate": 0.1})
    rd = TE.make("paper", faults=FaultSpec(dropout_rate=1.0)).rollout(0, 1)
    assert np.isinf(rd[0].latency).all() and not rd[0].outcomes.any()
