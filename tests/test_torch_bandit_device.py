"""The device-env bandit engines against the reference on the CPU:
``run_bandit_device`` for ``paper-fig3``'s tensor policies (with
``POLICY_TABLE``'s seed offsets) on ``device:paper`` with Monte-Carlo
``true_p`` and on ``device:metropolis-1k`` with analytic ``true_p``, and
``run_bandit_device_grid`` over budget x deadline cells. Each round is
generated by the port's simulator and the reference's; selections,
utilities, participants and explored flags are compared bitwise, and the
Eq. 6 outcome flips between the two simulators are counted and printed
(a flip would show in the selections, which have no tolerance). Every
grid element also equals the port's sequential run of its cell."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from _torch_parity import one_torch_thread  # noqa: E402,F401

from repro import policies as JP  # noqa: E402
from repro import sim as jsim  # noqa: E402
from repro.configs.paper_hfl import MNIST_CONVEX as JCFG  # noqa: E402
from repro.sim.engine import run_bandit_device as jax_device  # noqa: E402
from repro.sim.engine import \
    run_bandit_device_grid as jax_device_grid  # noqa: E402
from repro_torch import policies as TP  # noqa: E402
from repro_torch.configs.paper_hfl import MNIST_CONVEX  # noqa: E402
from repro_torch.core.utility import POLICY_TABLE, _policy_kwargs  # noqa
from repro_torch.sim import spec as tspec  # noqa: E402
from repro_torch.sim.core import init_statics, round_batch  # noqa: E402
from repro_torch.sim.engine import (run_bandit_device,  # noqa: E402
                                    run_bandit_device_grid)

FIELDS = ("selections", "utilities", "participants", "explored")
FIG3 = ("COCS", "Oracle", "Random")
SEEDS = (0, 1)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _agree(want, got, what):
    for f in FIELDS:
        w, g = np.asarray(want[f]), got[f]
        assert g.shape == w.shape and g.dtype == w.dtype, (what, f)
        assert np.array_equal(w, g), (what, f)


def _pair(reg, horizon, jcfg=JCFG, tcfg=MNIST_CONVEX, budget=None):
    """The reference's and the port's policy, built alike."""
    kw = _policy_kwargs(tcfg, reg)
    jp = JP.make(reg, JP.PolicySpec.from_experiment(jcfg, horizon,
                                                    budget=budget), **kw)
    tp = TP.make(reg, TP.PolicySpec.from_experiment(tcfg, horizon,
                                                    budget=budget), **kw)
    return jp, tp


def _outcome_flips(preset, true_p, seeds, horizon):
    """Eq. 6 outcomes of the port's simulator against the reference's
    over the run's rounds: the number of (seed, round, client, ES)
    entries that differ."""
    jrd = jsim.rollout_device(jsim.make(preset, true_p=true_p).spec,
                              seeds, horizon).round
    spec = tspec.make(preset, true_p=true_p).spec
    s = torch.tensor(seeds)
    st = init_statics(spec, s)
    pos, flips = st.pos0, 0
    for t in range(horizon):
        pos, rd = round_batch(spec, s, st, pos, t)
        flips += int((rd.outcomes.numpy()
                      != np.asarray(jrd.outcomes[:, t])).sum())
    return flips


@pytest.mark.parametrize("preset,true_p,horizon",
                         [("paper", "mc", 20), ("metropolis-1k",
                                                "analytic", 2)])
def test_run_bandit_device(preset, true_p, horizon):
    jenv = jsim.make(preset, true_p=true_p)
    tenv = tspec.make(preset, true_p=true_p)
    flips = _outcome_flips(preset, true_p, SEEDS, horizon)
    print(f"{preset} ({true_p}): {flips} Eq. 6 outcome flips in "
          f"{len(SEEDS)} seeds x {horizon} rounds")
    for display in FIG3:
        reg, off = POLICY_TABLE[display]
        jp, tp = _pair(reg, horizon, jenv.cfg, tenv.cfg)
        pol_seeds = [s + off for s in SEEDS]
        want = jax_device(jp, jenv.spec, SEEDS, horizon,
                          policy_seeds=pol_seeds)
        got = run_bandit_device(tp, tenv.spec, SEEDS, horizon,
                                policy_seeds=pol_seeds, device="cpu")
        _agree(want, got, f"{preset}/{display}")


@pytest.mark.parametrize("reg", ["cocs", "oracle", "random"])
def test_run_bandit_device_grid(reg):
    horizon = 16
    budgets, deadlines = (2.5, 5.0), (2.0, 3.0)
    cells = [(b, d) for b in budgets for d in deadlines]
    s = len(SEEDS)
    seeds = [x for _ in cells for x in SEEDS]
    per_b = [b for b, _ in cells for _ in SEEDS]
    per_d = [d for _, d in cells for _ in SEEDS]
    jenv, tenv = jsim.make("paper"), tspec.make("paper")
    jp, tp = _pair(reg, horizon)
    want = jax_device_grid(jp, jenv.spec, seeds, per_b, per_d, horizon,
                           seeds)
    got = run_bandit_device_grid(tp, tenv.spec, seeds, per_b, per_d,
                                 horizon, seeds, device="cpu")
    _agree(want, got, reg)
    for i, (b, d) in enumerate(cells):
        env = tspec.make("paper", dataclasses.replace(MNIST_CONVEX,
                                                      deadline_s=d))
        _, tpc = _pair(reg, horizon, budget=b)
        seq = run_bandit_device(tpc, env.spec, SEEDS, horizon,
                                device="cpu")
        _agree(seq, {k: v[i * s:(i + 1) * s] for k, v in got.items()
                     if k in FIELDS}, f"{reg} budget {b} deadline {d}")
