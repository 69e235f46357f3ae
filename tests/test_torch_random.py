"""``repro_torch.random`` and ``repro_torch.sim.draws`` against
``jax.random`` and ``repro.sim.draws`` (live, on the CPU)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_parity import (EXPONENTIAL_MAX_ULP, NORMAL_MAX_ULP,  # noqa: E402
                           bitwise, np_, t_, ulp_gap)
from repro.sim import draws as jdraws  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.sim import draws as tdraws  # noqa: E402

SEEDS = [0, 1, 11, 123456, 2 ** 31 - 1]
SHAPES = [(1,), (7,), (5, 3), (4, 2, 6)]


def _key_np(k):
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys(seed):
    kj, kt = jax.random.PRNGKey(seed), jr.PRNGKey(seed)
    assert np.array_equal(_key_np(kj), np_(kt))
    for d in (0, 1, 6, 99999):
        assert np.array_equal(_key_np(jax.random.fold_in(kj, d)),
                              np_(jr.fold_in(kt, d)))
    for num in (2, 3):
        assert np.array_equal(_key_np(jax.random.split(kj, num)),
                              np_(jr.split(kt, num)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_bits_uniform_randint_bitwise(seed, shape):
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    kt = jr.fold_in(jr.PRNGKey(seed), 3)
    assert np.array_equal(np.asarray(jax.random.bits(kj, shape))
                          .astype(np.int64), np_(jr.bits(kt, shape)))
    assert bitwise(jax.random.uniform(kj, shape), jr.uniform(kt, shape))
    for hi in (1, 8, 37, 200):
        assert bitwise(jax.random.randint(kj, shape, 0, hi),
                       jr.randint(kt, shape, 0, hi))


def test_batched_keys_and_per_key_maxval():
    """A leading key axis (the seed batch) with one maxval per key, as
    the training sampler calls randint."""
    seeds = np.array([0, 5, 9], np.int64)
    sizes = np.array([3, 200, 17], np.int32)
    kj = [jax.random.fold_in(jax.random.PRNGKey(int(s)), 4) for s in seeds]
    kt = jr.fold_in(jr.PRNGKey(t_(seeds)), 4)
    want = np.stack([np.asarray(jax.random.randint(k, (4, 8), 0, int(m)))
                     for k, m in zip(kj, sizes)])
    got = jr.randint(kt, (4, 8), 0, t_(sizes)[:, None, None])
    assert bitwise(want, got)
    want_u = np.stack([np.asarray(jax.random.uniform(k, (6,))) for k in kj])
    assert bitwise(want_u, jr.uniform(kt, (6,)))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_normal_within_stated_ulp(seed):
    kj, kt = jax.random.PRNGKey(seed), jr.PRNGKey(seed)
    want = jax.random.normal(kj, (100_000,))
    got = jr.normal(kt, (100_000,))
    assert ulp_gap(want, got) <= NORMAL_MAX_ULP
    # most draws are bitwise (torch.erfinv alone differs on ~2/3)
    assert np.mean(np_(want) != np_(got)) < 0.1


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_exponential_within_one_ulp(seed):
    kj, kt = jax.random.PRNGKey(seed), jr.PRNGKey(seed)
    want = jax.random.exponential(kj, (100_000,))
    got = jr.exponential(kt, (100_000,))
    assert ulp_gap(want, got) <= EXPONENTIAL_MAX_ULP


def test_erf_inv_edges():
    x = np.array([-1.0, -0.999999, -0.5, 0.0, 1e-8, 0.5, 0.9999999, 1.0],
                 np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = np_(jr.erf_inv(t_(x)))
    fin = np.isfinite(want)
    assert np.array_equal(np.isinf(want), np.isinf(got))
    assert ulp_gap(want[fin], got[fin]) <= NORMAL_MAX_ULP


@pytest.mark.parametrize("seed", [0, 3])
def test_init_draws(seed):
    n = 57
    want = jdraws.init_draws(seed, n)
    got = tdraws.init_draws(seed, n)
    for f in ("pos_u", "price_u", "bw_u", "comp_u", "perm", "phase_u"):
        assert bitwise(getattr(want, f), getattr(got, f)), f
    # a seed batch gives each seed's own stream
    both = tdraws.init_draws(torch.tensor([seed, seed + 1]), n)
    assert bitwise(want.pos_u, both.pos_u[0])
    assert bitwise(jdraws.init_draws(seed + 1, n).bw_u, both.bw_u[1])


@pytest.mark.parametrize("seed,t", [(0, 0), (1, 7), (5, 123)])
def test_round_draws(seed, t):
    n, m, k = 23, 4, 6
    want = jdraws.round_draws(seed, t, n, m, k)
    got = tdraws.round_draws(seed, t, n, m, k)
    for f in ("move", "bw_n", "comp_n"):
        assert ulp_gap(getattr(want, f), getattr(got, f)) <= \
            NORMAL_MAX_ULP, f
    for f in ("fad_dt", "fad_ut", "mc_dt", "mc_ut"):
        assert ulp_gap(getattr(want, f), getattr(got, f)) <= \
            EXPONENTIAL_MAX_ULP, f
    assert got.mc_dt.shape == (k, n, m)
