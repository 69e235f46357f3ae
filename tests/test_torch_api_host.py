"""``repro_torch.run`` on the host env against the reference's
``repro.run`` on the CPU, with the repo's own paper panels as written
(``repro.trials.suites``) at their ``@smoke`` sizes.

``paper-fig3`` (horizon 60, the five policies of ``POLICY_TABLE`` with
their seed offsets) runs tier 1; ``paper-fig4-quick`` (horizon 12,
``eval_every`` 6) runs tier 3 for COCS, Oracle and Random and tier 2 for
CUCB and LinUCB. Selections, utilities, participants and explored are
bitwise the reference's, in its dtypes; accuracy and loss are within
``SWEEP_ACC_TOL``; ``tier`` and ``env_backend`` are the reference's.
The panels' budget axis runs as a grid in ``test_torch_grid.py``."""
from dataclasses import replace

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from _torch_parity import SWEEP_ACC_TOL, one_torch_thread  # noqa: E402,F401
from repro.trials.suites import PAPER_FIG3, PAPER_FIG4_QUICK  # noqa: E402
from repro_torch import api as TA  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIELDS = ("selections", "utilities", "participants", "explored")
TIERS = {"Oracle": 3, "COCS": 3, "Random": 3, "CUCB": 2, "LinUCB": 2}


def _agree(want, got, tier):
    assert (got.tier, got.env_backend) == (want.tier, want.env_backend) \
        == (tier, "host")
    assert got.draw_schedule == want.draw_schedule
    assert got.spec.to_json() == want.spec.to_json()
    for f in FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert g.dtype == w.dtype and np.array_equal(w, g), f
    if want.accuracy is None:
        assert got.accuracy is None
        return
    assert np.array_equal(np.asarray(want.eval_rounds), got.eval_rounds)
    for f in ("accuracy", "loss"):
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert g.shape == w.shape and np.isfinite(g).all()
        assert np.abs(w - g).max() <= SWEEP_ACC_TOL, f


def _spec(suite, display):
    base = suite.resolved_base(smoke=True)
    want = replace(base, policy=dict(suite.policies)[display])
    return want, TA.ExperimentSpec.from_json(want.to_json())


@pytest.mark.parametrize("display", [d for d, _ in PAPER_FIG3.policies])
def test_paper_fig3_smoke_tier1(display):
    jspec, tspec = _spec(PAPER_FIG3, display)
    assert tspec.horizon == 60 and tspec.env.scenario == "paper"
    got = repro_torch.run(tspec, device="cpu")
    _agree(repro.run(jspec), got, 1)
    assert got.utilities.sum() > 0


@pytest.mark.parametrize("display", [d for d, _ in
                                     PAPER_FIG4_QUICK.policies])
def test_paper_fig4_quick_smoke_tiers_2_3(display):
    jspec, tspec = _spec(PAPER_FIG4_QUICK, display)
    assert (tspec.horizon, tspec.eval.eval_every) == (12, 6)
    got = repro_torch.run(tspec, device="cpu")
    _agree(repro.run(jspec), got, TIERS[display])
    assert got.final_accuracy().shape == (1,)


def test_host_env_resolution():
    from repro_torch import envs
    from repro_torch.api import build_env
    from repro_torch.sim import spec as simspec
    assert isinstance(build_env(TA.EnvSpec("paper")), envs.HFLEnv)
    assert isinstance(build_env(TA.EnvSpec("paper", backend="device")),
                      simspec.DeviceEnv)
    assert isinstance(build_env(TA.EnvSpec("metropolis-1k")),
                      simspec.DeviceEnv)
    assert isinstance(simspec.resolve("flash-crowd"), envs.HFLEnv)
    assert isinstance(simspec.resolve("host:tiered-pricing"), envs.HFLEnv)
    assert simspec.resolve("bursty-arrival").spec.num_clients == 1024
    assert isinstance(simspec.resolve("device:paper"), simspec.DeviceEnv)


def test_host_policy_on_device_env():
    """A host-state policy on a device env takes the device simulator's
    rounds as ``RoundData`` (``DeviceEnv.rollout``), as the reference's."""
    spec = repro.api.ExperimentSpec(
        policy=repro.api.PolicySpec("cucb", seed_offset=1),
        env=repro.api.EnvSpec("paper", backend="device"), horizon=8,
        seeds=(0, 1))
    got = repro_torch.run(TA.ExperimentSpec.from_json(spec.to_json()),
                          device="cpu")
    want = repro.run(spec)
    assert (got.tier, got.env_backend) == (want.tier, want.env_backend) \
        == (1, "device")
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(want, f)),
                              getattr(got, f)), f
