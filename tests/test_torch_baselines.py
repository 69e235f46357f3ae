"""The rest of the paper's experiment against the reference, on the CPU:
``permutation`` (bitwise) and ``gumbel`` (``GUMBEL_MAX_ULP1`` ulp of
max(1, |g|)); Random's scan and P3's FLGreedy (bitwise selections and
budgets, rows built to tie included); B2's keys-only sort; ``Oracle`` and
``Random`` fed the reference's realized rounds (bitwise); the new kernel
wrappers' refusals, which come before any build."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_parity import GUMBEL_MAX_ULP1, bitwise, t_  # noqa: E402
from repro import sim as jsim  # noqa: E402
from repro.configs.paper_hfl import CIFAR10_NONCONVEX as JNC  # noqa: E402
from repro.kernels.budgeted_topk.ops import \
    flgreedy_topk as jax_flgreedy_topk  # noqa: E402
from repro.kernels.budgeted_topk.ref import \
    sorted_candidates_ref as jax_sorted  # noqa: E402
from repro.policies.base import PolicySpec as JSpec  # noqa: E402
from repro.policies.base import Round as JRound  # noqa: E402
from repro.policies.baselines import Oracle as JOracle  # noqa: E402
from repro.policies.baselines import Random as JRandom  # noqa: E402
from repro.policies.engine import stack_states  # noqa: E402
from repro.policies.solvers import flgreedy_assign as jax_flgreedy  # noqa
from repro.policies.solvers import random_assign as jax_random  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.kernels.budgeted_topk.kernel import (  # noqa: E402
    budgeted_topk_keys_kernel, flgreedy_walk_kernel, key_capacity)
from repro_torch.kernels.budgeted_topk.ops import (  # noqa: E402
    WALK_SYNCS, candidate_keys_ref, flgreedy_topk_walk)
from repro_torch.kernels.random_assign.kernel import (  # noqa: E402
    MAX_ES, random_assign_kernel)
from repro_torch.kernels.random_assign.ops import (  # noqa: E402
    random_draws, random_scan)
from repro_torch.policies.base import PolicySpec, Round  # noqa: E402
from repro_torch.policies.baselines import Oracle, Random  # noqa: E402
from repro_torch.policies.solvers import (flgreedy_assign,  # noqa: E402
                                          random_assign)
from repro_torch.sim import spec as tspec  # noqa: E402


@pytest.mark.parametrize("n", [1, 50, 1000, 1625, 1626])
def test_permutation_bitwise(n):
    """One sort round up to n = 1625, two from 1626."""
    for seed in (0, 7):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 4)
        want = np.asarray(jax.random.permutation(key, n))
        got = jr.permutation(jr.fold_in(jr.PRNGKey(seed), 4), n)
        assert got.dtype == torch.int32
        assert bitwise(want.astype(np.int32), got)
    both = jr.permutation(jr.PRNGKey(torch.tensor([0, 7])), n)
    assert bitwise(np.asarray(jax.random.permutation(
        jax.random.PRNGKey(7), n)).astype(np.int32), both[1])


@pytest.mark.parametrize("seed", [0, 5])
def test_gumbel_within_stated_ulp(seed):
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed),
                                        (400, 250)), np.float64)
    got = jr.gumbel(jr.PRNGKey(seed), (400, 250)).numpy()
    err = np.abs(want - got) / np.maximum(1.0, np.abs(want))
    assert err.max() <= GUMBEL_MAX_ULP1 * 2.0 ** -23
    assert np.isfinite(got).all()


def _solver_inputs(s, n, m, seed, kind):
    rng = np.random.default_rng(seed)
    v = rng.random((s, n, m)).astype(np.float32)
    c = rng.uniform(0.3, 4.0, (s, n)).astype(np.float32)
    e = rng.random((s, n, m)) < 0.6
    b = np.full((s, m), 4.0, np.float32)
    if kind == "ties":             # equal rates everywhere: index order
        v[:], c[:], e[:] = 0.5, 1.0, True
    elif kind == "coarse":         # few distinct values and costs
        v = np.round(v * 3) / 3
        c = np.round(c)
    elif kind == "zero-cost":
        c[:, ::4] = 0.0
    elif kind == "ineligible":
        e[:] = False
    return v, c, e, b


SOLVER_CASES = [(2, 50, 3, "random"), (2, 50, 3, "ties"),
                (3, 37, 5, "coarse"), (2, 40, 4, "zero-cost"),
                (1, 20, 3, "ineligible"), (2, 120, 12, "random")]


@pytest.mark.parametrize("s,n,m,kind", SOLVER_CASES)
def test_flgreedy_bitwise(s, n, m, kind):
    """The port's P3 against both reference routes (the while-loop
    ``flgreedy_assign`` and the segment walk ``flgreedy_topk``)."""
    v, c, e, b = _solver_inputs(s, n, m, n + m, kind)
    got, rem = flgreedy_topk_walk(t_(v), t_(c), t_(b), t_(e))
    assert bitwise(got, flgreedy_assign(t_(v), t_(c), t_(b), t_(e)))
    for si in range(s):
        args = (v[si], c[si], b[si], e[si])
        want = np.asarray(jax_flgreedy(*args))
        assert bitwise(want, got[si])
        assert bitwise(np.asarray(jax_flgreedy_topk(*args)), got[si])
        sel = want >= 0
        assert np.all(rem[si].numpy() <= b[si])
        assert np.allclose(rem[si].numpy(), b[si] - np.bincount(
            want[sel], weights=c[si][sel], minlength=m), atol=1e-5)
    if kind == "ties":
        # every rate equal: the largest flat index wins each pick
        assert (got[0] >= 0).sum() > 0


@pytest.mark.parametrize("n,m", [(50, 3), (1000, 12)])
def test_flgreedy_syncs_once_a_pick_on_the_cpu(n, m):
    v, c, e, b = _solver_inputs(1, n, m, 3, "random")
    before = WALK_SYNCS["flgreedy_walk"]
    got = flgreedy_assign(t_(v), t_(c), t_(b), t_(e))
    picks = int((got >= 0).sum())
    assert WALK_SYNCS["flgreedy_walk"] - before == picks + 1


@pytest.mark.parametrize("s,n,m,kind", SOLVER_CASES[:4])
def test_candidate_keys_are_the_reference_order(s, n, m, kind):
    """B2's keys-only sort: the reference's single-segment order of the
    eligible pairs, density then flat index, descending."""
    v, c, e, _ = _solver_inputs(s, n, m, n, kind)
    keys, counts = candidate_keys_ref(t_(v), t_(c), t_(e),
                                      key_capacity(n, m))
    assert keys.shape == (s, key_capacity(n, m))
    for si in range(s):
        jd, ji = jax_sorted(jnp.asarray(v[si]), jnp.asarray(c[si]),
                            jnp.asarray(e[si]))
        jd, ji = np.asarray(jd).ravel(), np.asarray(ji).ravel()
        k = int(counts[si])
        assert k == int(e[si].sum())
        low = keys[si, :k].numpy() & 0xFFFFFFFF
        flat = (low >> 14) * m + (low & 0x3FFF)
        assert np.array_equal(flat, ji[:k])
        # the high word is the density's order image
        top = (keys[si, :k].numpy() >> 32) & 0xFFFFFFFF
        bits = np.where(top >= 0x80000000, top ^ 0x80000000,
                        top ^ 0xFFFFFFFF).astype(np.uint32)
        assert bitwise(jd[:k] + np.float32(0.0), bits.view(np.float32))
        assert (keys[si, k:] == 0).all()


def _gumbel_order_flips(key, n, m):
    """Rows where the port's Gumbels order some pair of ESs otherwise
    than the reference's, and pairs the reference ties from distinct u."""
    kc = jax.random.split(key)[1]
    want = np.asarray(jax.random.gumbel(kc, (n, m)))
    u = np.asarray(jax.random.uniform(kc, (n, m),
                                      minval=np.finfo(np.float32).tiny))
    got = jr.gumbel(jr.split(t_(np.asarray(key, np.uint32)
                                .astype(np.int64)))[1], (n, m)).numpy()
    flips = ties = 0
    for a in range(m):
        for b_ in range(a + 1, m):
            ties += int(((want[:, a] == want[:, b_])
                         & (u[:, a] != u[:, b_])).sum())
            flips += int((np.sign(want[:, a] - want[:, b_])
                          != np.sign(got[:, a] - got[:, b_])).sum())
    return flips, ties


@pytest.mark.parametrize("s,n,m,kind", SOLVER_CASES)
def test_random_assign_bitwise(s, n, m, kind):
    _, c, e, b = _solver_inputs(s, n, m, 2 * n + m, kind)
    seeds = [n + 10 * k for k in range(s)]
    keys = jr.fold_in(jr.PRNGKey(torch.tensor(seeds)), 3)
    got = random_assign(keys, t_(c), t_(b), t_(e))
    order, gum = random_draws(keys, n, m)
    again, rem = random_scan(order, gum, t_(c), t_(b), t_(e))
    assert bitwise(got, again)
    flips = ties = 0
    for si, sd in enumerate(seeds):
        key = jax.random.fold_in(jax.random.PRNGKey(sd), 3)
        want = np.asarray(jax_random(key, c[si], b[si], e[si]))
        assert bitwise(want, got[si])
        f, t = _gumbel_order_flips(key, n, m)
        flips, ties = flips + f, ties + t
        sel = want >= 0
        assert np.allclose(rem[si].numpy(), b[si] - np.bincount(
            want[sel], weights=c[si][sel], minlength=m), atol=1e-5)
    print(f"random_assign {(s, n, m, kind)}: {ties} reference Gumbel ties "
          f"from distinct u, {flips} ES pairs ordered otherwise by the "
          f"port's Gumbels")


def _realized_rounds(preset, cfg, seeds, horizon):
    env = jsim.make(preset, cfg) if cfg is not None else jsim.make(preset)
    return env, env.rollout_device(seeds, horizon).round


@pytest.mark.parametrize("preset,sqrt", [("paper", False),
                                         ("flash-crowd", False),
                                         ("paper", True)])
def test_oracle_and_random_fed_reference_rounds(preset, sqrt):
    """Both policies select bitwise what the reference selects on its own
    realized rounds (P2 or, under the sqrt utility, P3)."""
    seeds, horizon = (0, 1), 6
    env, rounds = _realized_rounds(preset, JNC if sqrt else None, seeds,
                                   horizon)
    cfg = env.cfg
    jspec = JSpec.from_experiment(cfg, horizon)
    tspec_ = PolicySpec.from_experiment(cfg, horizon)
    assert tspec_.sqrt_utility == sqrt == jspec.sqrt_utility
    for jcls, tcls in ((JOracle, Oracle), (JRandom, Random)):
        jpol, tpol = jcls(spec=jspec), tcls(spec=tspec_)
        select = jax.jit(jax.vmap(jpol.select))
        state = stack_states(jpol, seeds)
        tstate = tpol.init(len(seeds), "cpu", seeds)
        picked = 0
        for t in range(horizon):
            rd = JRound(*(getattr(rounds, f)[:, t]
                          for f in JRound._fields))
            want, _ = select(state, rd)
            trd = Round(*(t_(np.asarray(getattr(rd, f)))
                          for f in Round._fields))
            got, _ = tpol.select(tstate, trd)
            assert bitwise(want, got), f"{tpol.name} round {t}"
            picked += int((np.asarray(want) >= 0).sum())
        assert picked > 0


def test_flash_crowd_builds():
    env = tspec.make("flash-crowd")
    assert env.spec.surge_count == 15 and env.spec.surge_period == 50
    assert env.spec.min_cost() == pytest.approx(
        2.0 * 0.5 * 0.3e6 / 1e6 * 0.3)


def test_new_kernel_wrappers_refuse_before_building():
    """Each check comes before the build and the launch, so it runs on a
    machine without nvcc."""
    v, c, e, b = (t_(a) for a in _solver_inputs(1, 10, 3, 0, "random"))
    with pytest.raises(ValueError, match="CUDA"):
        budgeted_topk_keys_kernel(v, c, e)
    keys = torch.zeros((1, key_capacity(10, 3)), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        flgreedy_walk_kernel(keys, torch.zeros(1, dtype=torch.int32), v,
                             c, b)
    with pytest.raises(ValueError, match="16384"):
        budgeted_topk_keys_kernel(torch.zeros(1, 16385, 1), c.new_zeros(
            1, 16385), torch.zeros(1, 16385, 1, dtype=torch.bool))
    order, gum = random_draws(jr.PRNGKey(torch.tensor([0])), 10, 3)
    with pytest.raises(ValueError, match="expected CUDA"):
        random_assign_kernel(order, gum, c, b, e)
    with pytest.raises(ValueError, match=str(MAX_ES)):
        random_assign_kernel(order, torch.zeros(1, 10, MAX_ES + 1), c,
                             torch.zeros(1, MAX_ES + 1),
                             torch.zeros(1, 10, MAX_ES + 1,
                                         dtype=torch.bool))
