"""The tier-[1] bandit engine against the reference on the CPU.

Fed the reference's realized rounds (``paper``, ``mnist-convex``, the
host env's float64 rollouts), the port's ``run_rounds``,
``run_rounds_multi_seed``, ``run_rounds_grid`` and
``run_rounds_grid_params`` give the reference's selections, utilities,
participants and explored flags bit for bit, for ``paper-fig3``'s
tensor policies with ``POLICY_TABLE``'s seed offsets. Every grid element
also equals the port's own sequential run of its cell. The device-env
engines: ``test_torch_bandit_device.py``."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from _torch_parity import one_torch_thread  # noqa: E402,F401

from repro import envs as jenvs  # noqa: E402
from repro import policies as JP  # noqa: E402
from repro.configs.paper_hfl import MNIST_CONVEX as JCFG  # noqa: E402
from repro_torch import policies as TP  # noqa: E402
from repro_torch.configs.paper_hfl import MNIST_CONVEX  # noqa: E402
from repro_torch.core.utility import POLICY_TABLE, _policy_kwargs  # noqa
from repro_torch.policies.cocs import theorem2_params  # noqa: E402
from repro_torch.sim import spec as tspec  # noqa: E402
from repro_torch.sim.engine import run_bandit_device  # noqa: E402

FIELDS = ("selections", "utilities", "participants", "explored")
# paper-fig3's tensor policies (trials/suites.py), display names
FIG3 = ("COCS", "Oracle", "Random")
HORIZON = 60
SEEDS = (0, 1)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _agree(want, got, what):
    for f in FIELDS:
        w, g = np.asarray(want[f]), got[f]
        assert g.shape == w.shape and g.dtype == w.dtype, (what, f)
        assert np.array_equal(w, g), (what, f)


def _pair(reg, horizon, jcfg=JCFG, tcfg=MNIST_CONVEX, budget=None, **kw):
    """The reference's and the port's policy, built alike."""
    kw = {**_policy_kwargs(tcfg, reg), **kw}
    jp = JP.make(reg, JP.PolicySpec.from_experiment(jcfg, horizon,
                                                    budget=budget), **kw)
    tp = TP.make(reg, TP.PolicySpec.from_experiment(tcfg, horizon,
                                                    budget=budget), **kw)
    return jp, tp


@pytest.fixture(scope="module")
def fig3_rollouts():
    """The reference's realized rounds of paper-fig3's env, a list of
    ``RoundData`` a seed."""
    env = jenvs.make("paper", JCFG)
    return [env.rollout(s, HORIZON) for s in SEEDS]


@pytest.fixture(scope="module")
def fig3_rounds(fig3_rollouts):
    """The same rounds stacked, (S, T, ...) numpy."""
    return JP.stack_rounds_multi(fig3_rollouts)


def _tile(batch, k):
    """k copies of a (S, T, ...) batch along the batch axis, cell-major."""
    return type(batch)(*(np.concatenate([np.asarray(f)] * k)
                         for f in batch))


@pytest.mark.parametrize("display", FIG3)
def test_run_rounds_fed_reference_rounds(fig3_rollouts, fig3_rounds,
                                         display):
    reg, off = POLICY_TABLE[display]
    jp, tp = _pair(reg, HORIZON)
    pol_seeds = [s + off for s in SEEDS]
    batch = TP.round_from_arrays(fig3_rounds)
    want = JP.run_rounds_multi_seed(jp, fig3_rounds, pol_seeds)
    got = TP.run_rounds_multi_seed(tp, batch, pol_seeds)
    _agree(want, got, display)
    want1 = JP.run_rounds(jp, fig3_rollouts[0], seed=pol_seeds[0])
    got1 = TP.run_rounds(tp, TP.round_from_arrays(
        JP.stack_rounds(fig3_rollouts[0])), seed=pol_seeds[0])
    _agree(want1, got1, f"{display}, one seed")
    _agree({k: v[0] for k, v in got.items() if k in FIELDS}, got1,
           f"{display}, one seed of the batch")
    assert (got["selections"] >= 0).any()


@pytest.mark.parametrize("reg", ["cocs", "oracle", "random"])
def test_run_rounds_grid_budgets(fig3_rounds, reg):
    budgets = (2.5, 3.5, 5.0)
    horizon = 40
    rounds = type(fig3_rounds)(*(np.asarray(f)[:, :horizon]
                                 for f in fig3_rounds))
    grid = _tile(rounds, len(budgets))
    per_elem = np.repeat(np.asarray(budgets), len(SEEDS))
    seeds = list(SEEDS) * len(budgets)
    jp, tp = _pair(reg, horizon)
    want = JP.run_rounds_grid(jp, grid, per_elem, seeds)
    got = TP.run_rounds_grid(tp, TP.round_from_arrays(grid), per_elem,
                             seeds)
    _agree(want, got, reg)
    s = len(SEEDS)
    for i, b in enumerate(budgets):
        _, tpb = _pair(reg, horizon, budget=b)
        seq = TP.run_rounds_multi_seed(tpb, TP.round_from_arrays(rounds),
                                       list(SEEDS))
        _agree(seq, {k: v[i * s:(i + 1) * s] for k, v in got.items()
                     if k in FIELDS}, f"{reg} budget {b}")
    # the budgets matter: the cells' selections differ
    assert len({got["selections"][i * s].tobytes()
                for i in range(len(budgets))}) == len(budgets)


def test_run_rounds_grid_params(fig3_rounds):
    horizon = 40
    rounds = type(fig3_rounds)(*(np.asarray(f)[:, :horizon]
                                 for f in fig3_rounds))
    cells = [(h, a) for h in (2, 3, 5) for a in (0.5, 1.0)]
    s = len(SEEDS)
    hs = np.repeat([h for h, _ in cells], s)
    zs = np.repeat([theorem2_params(horizon, a)[0] for _, a in cells], s)
    grid = _tile(rounds, len(cells))
    budgets = np.full(len(hs), JCFG.budget)
    seeds = list(SEEDS) * len(cells)
    jp, tp = _pair("cocs", horizon)
    want = JP.run_rounds_grid_params(jp, grid, budgets, hs, zs, seeds)
    got = TP.run_rounds_grid_params(tp, TP.round_from_arrays(grid), budgets,
                                    hs, zs, seeds)
    _agree(want, got, "h_t x alpha")
    assert got["final_state"].counters.shape[-1] == 5
    for i, (h, a) in enumerate(cells):
        _, tpc = _pair("cocs", horizon, h_t=h, alpha=a)
        seq = TP.run_rounds_multi_seed(tpc, TP.round_from_arrays(rounds),
                                       list(SEEDS))
        _agree(seq, {k: v[i * s:(i + 1) * s] for k, v in got.items()
                     if k in FIELDS}, f"h_t={h} alpha={a}")
        # the padded cells of the lattice stay untouched
        c = got["final_state"].counters[i * s:(i + 1) * s]
        assert int(c[..., h:, :].abs().sum() + c[..., :, h:].abs().sum()) \
            == 0


def test_engine_refusals():
    spec = TP.PolicySpec.from_experiment(MNIST_CONVEX, 4)
    for name in ("cucb", "linucb", "cocs-phased"):
        assert not TP.make(name, spec).tensor_capable
    with pytest.raises(KeyError, match="cocs"):
        TP.make("ucb", spec)
    assert TP.names() == ("cocs", "cocs-phased", "cucb", "linucb",
                          "oracle", "random")

    @dataclasses.dataclass(frozen=True)
    class HostPolicy(TP.FunctionalPolicy):
        name: str = "host"

    batch = TP.round_from_arrays(
        [np.zeros((2,), np.int32), np.zeros((2, 50, 3, 2)),
         np.ones((2, 50, 3), bool), np.ones((2, 50)), np.ones((2, 50, 3)),
         np.ones((2, 50, 3)), np.ones((2, 50, 3))])
    # the tensor engines refuse a host policy (run_rounds_host takes it)
    with pytest.raises(ValueError, match="run_rounds_host"):
        TP.run_rounds(HostPolicy(spec=spec), batch)
    with pytest.raises(ValueError, match="run_rounds_host"):
        run_bandit_device(HostPolicy(spec=spec), tspec.make("paper").spec,
                          (0,), 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_bandit_device(TP.make("oracle", spec),
                              tspec.make("paper").spec, (0,), 2)
