"""``repro_torch.run(spec.grid(...))`` against the reference's
``repro.run`` of the same grid on the CPU, and against the port's own
sequential ``run`` of each cell.

Budget and deadline cells batch next to the seeds (element ``b = g * S +
s``) on the host env's tier 1 and tier 3 and the device env's tier 4;
the COCS ``h_t`` axis batches on the host tier 1; a host-state policy's
cells run one by one. Every cell's selections, utilities, participants
and explored equal both references bit for bit; accuracy and loss are
within ``SWEEP_ACC_TOL`` of the reference's."""
from dataclasses import replace

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from _torch_parity import SWEEP_ACC_TOL, one_torch_thread  # noqa: E402,F401
from repro import api as JA  # noqa: E402
from repro.trials.suites import PAPER_FIG4_QUICK  # noqa: E402
from repro_torch import api as TA  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIELDS = ("selections", "utilities", "participants", "explored")


def _check(jgrid, batched=True):
    """The port's grid against the reference's and against its own
    sequential runs; returns the port's ``GridResult``."""
    tgrid = TA.ExperimentGrid.from_json(jgrid.to_json())
    got = repro_torch.run(tgrid, device="cpu")
    want = repro.run(jgrid)
    assert got.shape == want.shape == tgrid.shape
    assert len(got.results) == len(want.results) == len(got.cells)
    for i, (w, g, cell) in enumerate(zip(want.results, got.results,
                                         got.cells)):
        assert (g.tier, g.env_backend, g.batched_axes) == \
            (w.tier, w.env_backend, w.batched_axes), i
        assert g.spec == cell
        seq = repro_torch.run(cell, device="cpu")
        for f in FIELDS:
            wv, gv = np.asarray(getattr(w, f)), getattr(g, f)
            assert gv.dtype == wv.dtype and np.array_equal(wv, gv), (i, f)
            assert np.array_equal(getattr(seq, f), gv), (i, f)
        if w.accuracy is not None:
            for f in ("accuracy", "loss"):
                wv, gv = np.asarray(getattr(w, f)), getattr(g, f)
                assert np.abs(wv - gv).max() <= SWEEP_ACC_TOL, (i, f)
                assert np.abs(getattr(seq, f) - gv).max() <= SWEEP_ACC_TOL
    assert bool(got.results[0].batched_axes) == batched
    return got


def test_host_tier1_budget_deadline_grid():
    spec = JA.ExperimentSpec(policy=JA.PolicySpec("cocs"),
                             env=JA.EnvSpec("paper"), horizon=20,
                             seeds=(0, 1))
    got = _check(spec.grid(budget=[2.5, 5.0], deadline=[2.0, 3.0]))
    assert got.results[0].batched_axes == ("budget", "deadline")
    # GridResult.at walks the axes in C order, the last fastest
    assert got.at(1, 0).spec.policy.budget == 5.0
    assert got.at(1, 0).spec.env.deadline == 2.0
    assert got[1].spec.env.deadline == 3.0
    assert got.cumulative_utility().shape == (2, 2, 2)
    # a larger budget never buys fewer participants here
    cum = got.cumulative_utility()
    assert (cum[1] >= cum[0]).all()


def test_host_tier1_h_t_axis():
    spec = JA.ExperimentSpec(policy=JA.PolicySpec("cocs"),
                             env=JA.EnvSpec("paper"), horizon=20,
                             seeds=(0, 1))
    got = _check(spec.grid(h_t=[2, 5], budget=[3.5, 5.0]))
    assert got.shape == (2, 2)
    assert got.at(0, 1).spec.policy.options == (("h_t", 2),)


@pytest.mark.parametrize("display", ["COCS", "Oracle", "Random"])
def test_host_tier3_fig4_quick_budget_grid(display):
    base = PAPER_FIG4_QUICK.resolved_base(smoke=True)
    spec = replace(base, policy=dict(PAPER_FIG4_QUICK.policies)[display])
    got = _check(spec.grid(**{a: list(v) for a, v in PAPER_FIG4_QUICK.axes}))
    assert got.results[0].tier == 3
    assert got.final_accuracy().shape == (2, 1)


def test_device_tier4_budget_deadline_grid():
    spec = JA.ExperimentSpec(policy=JA.PolicySpec("cocs"),
                             env=JA.EnvSpec("paper", backend="device"),
                             train=JA.TrainSpec(),
                             eval=JA.EvalSpec(eval_every=2), horizon=4,
                             seeds=(0, 1))
    got = _check(spec.grid(budget=[3.5, 5.0], deadline=[2.0, 3.0]))
    assert (got.results[0].tier, got.results[0].env_backend) == \
        (4, "device")


def test_host_policy_cells_run_in_turn():
    spec = JA.ExperimentSpec(policy=JA.PolicySpec("cucb", seed_offset=1),
                             env=JA.EnvSpec("paper"), horizon=20,
                             seeds=(0, 1))
    got = _check(spec.grid(budget=[2.5, 5.0]), batched=False)
    assert [r.tier for r in got.results] == [1, 1]
