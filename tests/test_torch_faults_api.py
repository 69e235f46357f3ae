"""Faults, the robust Eq. 3 rules and ``TrainSpec.transposed_gemm``
through the facade: ``repro_torch.run(spec, device="cpu")`` against the
reference's ``repro.run(spec)`` on the CPU.

The repo's ``robustness-panel`` suite (``repro.trials.suites``, budget
8.0) at its ``@smoke`` size (horizon 12, ``eval_every`` 6): COCS at
``corrupt_rate`` 0.25 under ``mean``, ``trimmed_mean`` and ``median``
and at 0.0 under ``mean``, and its ``corrupt_rate x aggregator`` grid
(Random's cells are in ``test_torch_robust.py``), and faults off. Selections,
utilities, participants and explored are bitwise the reference's, in
its dtypes; accuracy and loss are within ``SWEEP_ACC_TOL``; a grid cell
also equals its sequential ``run``. The faulty tiers 1 and 2 and a
batched ``budget`` grid on a faulty device env are in
``test_torch_faults.py``, tier 4 and ``transposed_gemm`` in
``test_torch_robust.py``: each file stays under a minute."""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from _torch_parity import (one_torch_thread,  # noqa: E402,F401
                           panel_cells, runs_agree)
from repro import api as JA  # noqa: E402
from repro.trials.suites import ROBUSTNESS_PANEL  # noqa: E402
from repro_torch import api as TA  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIELDS = ("selections", "utilities", "participants", "explored")
PANEL_POLICIES = dict(ROBUSTNESS_PANEL.policies)


@functools.lru_cache(maxsize=None)
def _ref(spec_json: str):
    """The reference's result of a spec (grids reuse the panel's)."""
    return repro.run(JA.ExperimentSpec.from_json(spec_json))


def _port_spec(jspec):
    return TA.ExperimentSpec.from_json(jspec.to_json())


@pytest.mark.parametrize("rate,agg", [(0.25, "mean"),
                                      (0.25, "trimmed_mean"),
                                      (0.25, "median"), (0.0, "mean")])
def test_robustness_panel_smoke(rate, agg):
    jspec = panel_cells(ROBUSTNESS_PANEL, "COCS")[(rate, agg)]
    assert (jspec.horizon, jspec.eval.eval_every) == (12, 6)
    got = repro_torch.run(_port_spec(jspec), device="cpu")
    runs_agree(_ref(jspec.to_json()), got)
    assert got.tier == 3 and np.isfinite(got.accuracy).all()


def test_corrupt_rate_by_aggregator_grid():
    """The panel's grid for COCS, 2 x 2: each cell runs in turn (the
    fault and rule axes change the computation) and equals the
    reference's run of that cell and the port's sequential run."""
    jgrid = dataclasses.replace(ROBUSTNESS_PANEL.resolved_base(smoke=True),
                                policy=PANEL_POLICIES["COCS"]).grid(
        corrupt_rate=[0.0, 0.25], aggregator=["mean", "median"])
    tgrid = _port_spec(jgrid.base).grid(corrupt_rate=[0.0, 0.25],
                                        aggregator=["mean", "median"])
    got = repro_torch.run(tgrid, device="cpu")
    assert got.shape == (2, 2)
    for jcell, cell, r in zip(jgrid.expand(), got.cells, got.results):
        assert cell.to_json() == jcell.to_json() and r.batched_axes == ()
        runs_agree(_ref(jcell.to_json()), r)
        seq = repro_torch.run(cell, device="cpu")
        for f in FIELDS + ("accuracy",):
            assert np.array_equal(getattr(seq, f), getattr(r, f)), f
    # under corruption the median keeps training where the mean collapses
    acc = got.final_accuracy()[..., 0]
    assert acc[1, 1] > acc[1, 0]


def test_faults_off_is_bitwise_the_clean_run():
    """``faults=None`` and ``FaultSpec()`` on tier 4 (and a FaultSpec
    that only sets a scale): every output bitwise."""
    from repro_torch.sim.faults import FaultSpec
    base = TA.ExperimentSpec(env=TA.EnvSpec("paper", backend="device"),
                             train=TA.TrainSpec(),
                             eval=TA.EvalSpec(eval_every=3), horizon=6)
    runs = [repro_torch.run(dataclasses.replace(
        base, env=dataclasses.replace(base.env, faults=f)), device="cpu")
        for f in (None, FaultSpec(), FaultSpec(corrupt_scale=5.0))]
    for r in runs[1:]:
        for f in FIELDS + ("accuracy", "loss"):
            assert np.array_equal(getattr(runs[0], f), getattr(r, f)), f
