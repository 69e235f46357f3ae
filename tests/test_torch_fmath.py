"""``repro_torch.core.fmath.fma`` is correctly rounded: bitwise equal to
the exact ``a * b + c`` rounded once to float32 (ties to even), also
where a float64 sum lands on a float32 tie that the exact sum is not
on, and equal to what XLA's contracted ``a * b + c`` gives under jit."""
from fractions import Fraction

import numpy as np
import pytest
import torch

from repro_torch.core.fmath import fma

F32 = np.float32


def _exact_rn(a, b, c) -> np.float32:
    """The exact a * b + c, rounded to nearest float32, ties to even."""
    e = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = F32(float(e))
    cands = (np.nextafter(r, F32(-np.inf)), r, np.nextafter(r, F32(np.inf)))
    return min(cands, key=lambda x: (abs(Fraction(float(x)) - e),
                                     int(np.array(x).view(np.int32)) & 1))


# (a, b, c) whose float64 sum is a float32 tie the exact sum lies off:
# (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 exactly, and a c far below float64's
# half ulp pushes the exact value to one side of that tie
HARD = [(1 + 2 ** -12, 1 + 2 ** -12, 2 ** -60),
        (1 + 2 ** -12, 1 + 2 ** -12, -2 ** -60),
        (-(1 + 2 ** -12), 1 + 2 ** -12, 2 ** -60),
        (1 + 2 ** -12, 1 + 2 ** -12, 2 ** -100),
        (3 * (1 + 2 ** -12), 1 + 2 ** -12, 2 ** -55),
        (1.0, 1.0, 2 ** -24)]          # an exact tie: ties to even


@pytest.mark.parametrize("a,b,c", HARD)
def test_fma_double_rounding_cases(a, b, c):
    a, b, c = F32(a), F32(b), F32(c)
    got = fma(torch.tensor([a]), torch.tensor([b]), torch.tensor([c]))
    want = _exact_rn(a, b, c)
    assert got.numpy().view(np.int32)[0] == np.array(want).view(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fma_random_against_exact(seed):
    rng = np.random.default_rng(seed)
    n = 3000
    a = rng.standard_normal(n).astype(F32)
    b = (rng.standard_normal(n) * np.exp2(rng.integers(-20, 20, n))
         ).astype(F32)
    c = (rng.standard_normal(n) * np.exp2(rng.integers(-60, 20, n))
         ).astype(F32)
    got = fma(torch.from_numpy(a), torch.from_numpy(b),
              torch.from_numpy(c)).numpy()
    want = np.array([_exact_rn(*t) for t in zip(a, b, c)], dtype=F32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_fma_scalar_operands_and_specials():
    x = torch.tensor([0.1, -2.5, 3e38, np.nan], dtype=torch.float32)
    got = fma(2.0 * 3.5, x, -1.25)          # Python floats as float32
    want = [_exact_rn(F32(7.0), v, F32(-1.25)) for v in x.numpy()[:2]]
    assert np.array_equal(got[:2].numpy(), np.array(want, dtype=F32))
    assert got[2] == torch.inf and torch.isnan(got[3])
    assert fma(torch.tensor([torch.inf]), 0.5, -torch.inf).isnan().all()


@pytest.mark.parametrize("a,b,c", HARD)
def test_fma_matches_xla_contraction(a, b, c):
    jax = pytest.importorskip("jax")
    args = [np.asarray([v], dtype=F32) for v in (a, b, c)]
    want = np.asarray(jax.jit(lambda x, y, z: x * y + z)(*args))
    got = fma(*(torch.from_numpy(v) for v in args)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
