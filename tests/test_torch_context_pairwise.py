"""The port's context_pairwise plain version against the reference's
oracle and its Pallas kernel (interpret mode), on the CPU.

The reference runs the oracle under ``jit`` inside its simulator, where
XLA contracts and folds its arithmetic (``repro_torch.core.fmath``); the
port follows that execution, so the oracle is held here under ``jit``
too. The distance is then bitwise; the transcendental stages (PyTorch's
``log``/``log1p``/``pow`` against XLA's) agree to ``ENV_RTOL``."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_parity import ENV_RTOL, bitwise, max_rel, t_  # noqa: E402
from repro.core.network import _dbm_to_watt, es_positions  # noqa: E402
from repro.kernels.context_pairwise.kernel import \
    context_pairwise_kernel as jax_kernel  # noqa: E402
from repro.kernels.context_pairwise.ref import \
    pairwise_context_ref as jax_ref  # noqa: E402
from repro_torch.kernels.context_pairwise.ops import \
    pairwise_context  # noqa: E402
from repro_torch.kernels.context_pairwise.ref import \
    pairwise_context_ref  # noqa: E402

KW = dict(tx_w=_dbm_to_watt(23.0), noise_psd_w=_dbm_to_watt(-174.0),
          update_bits=0.18e6, workload=2.41e6)


def _inputs(n, m, seed, kind="random"):
    rng = np.random.default_rng(seed)
    es = es_positions(m).astype(np.float32)
    pos = rng.uniform(-3.5, 3.5, (n, 2)).astype(np.float32)
    bw = rng.uniform(0.3e6, 1e6, n).astype(np.float32)
    comp = rng.uniform(2e6, 4e6, n).astype(np.float32)
    fdt = rng.exponential(size=(n, m)).astype(np.float32)
    fut = rng.exponential(size=(n, m)).astype(np.float32)
    if kind == "near":           # below the 0.01 km path-loss floor
        pos = (es[rng.integers(0, m, n)]
               + rng.uniform(-0.006, 0.006, (n, 2))).astype(np.float32)
    elif kind == "weak":         # deep fades: snr far below 1
        fdt = (fdt * 1e-6).astype(np.float32)
        fut = (fut * 1e-7).astype(np.float32)
    return pos, es, bw, comp, fdt, fut


def _check(want, got):
    assert bitwise(want.dist, got.dist)
    for f in ("gain", "rate", "tau"):
        assert max_rel(getattr(want, f), getattr(got, f)) <= ENV_RTOL, f


@pytest.mark.parametrize("kind", ["random", "near", "weak"])
@pytest.mark.parametrize("n,m,seed", [(300, 12, 0), (50, 3, 1), (7, 1, 2)])
def test_ref_matches_reference_oracle(n, m, seed, kind):
    args = _inputs(n, m, seed, kind)
    want = jax.jit(lambda *a: jax_ref(*a, **KW))(*map(jnp.asarray, args))
    got = pairwise_context_ref(*map(t_, args), **KW)
    _check(want, got)


def test_ref_matches_reference_pallas_kernel_interpret():
    args = _inputs(37, 3, 5)
    want = jax_kernel(*map(jnp.asarray, args), **KW, tile=16,
                      interpret=True)
    got = pairwise_context_ref(*map(t_, args), **KW)
    _check(want, got)


def test_cpu_wrapper_takes_plain_version_with_seed_axis():
    per_seed = [_inputs(20, 4, s) for s in (0, 1)]
    stacked = [np.stack([a[i] for a in per_seed]) if i != 1 else
               per_seed[0][1] for i in range(6)]
    got = pairwise_context(*map(t_, stacked), **KW)
    assert got.tau.shape == (2, 20, 4)
    for s in range(2):
        one = pairwise_context_ref(*map(t_, per_seed[s]), **KW)
        for f in one._fields:
            assert torch.equal(getattr(one, f), getattr(got, f)[s])


# -- the CUDA kernel's 10^x, mirrored in numpy --------------------------------

MIDPOINT_MARGIN = 64    # csrc/context_pairwise.cu, kMidpointMargin


def _exp10_faithful(x32):
    """10^x in float64 within about half an ulp (the product x ln 10 and
    the exponential in numpy's extended precision), standing in for the
    card's double exp10, which is within one."""
    assert np.finfo(np.longdouble).nmant >= 63
    x = x32.astype(np.longdouble)
    return np.exp(x * np.log(np.longdouble(10))).astype(np.float64)


def _midpoint_offset(y):
    """Signed distance, in ulps of the float64 ``y``, from the float32
    rounding midpoint of its binade nearest to it (the 29 bits below
    float32's significand against 2^28)."""
    return (y.view(np.int64) & ((1 << 29) - 1)) - (1 << 28)


def _takes_exp10(y):
    return (y >= 2.0 ** -126) & (np.abs(_midpoint_offset(y)) > MIDPOINT_MARGIN)


def _pow10_mirror(x32):
    """The kernel's rule: exp10's value rounded to float32 where no float
    rounding midpoint lies within the margin of it, else pow10_rn. Also
    returns which elements took exp10."""
    from repro_torch.core.fmath import pow10_rn
    y = _exp10_faithful(x32)
    fast = _takes_exp10(y)
    slow = pow10_rn(torch.from_numpy(x32)).numpy()
    return np.where(fast, y.astype(np.float32), slow), fast


def _pow10_rn_np(x32):
    from repro_torch.core.fmath import pow10_rn
    return pow10_rn(torch.from_numpy(x32)).numpy()


def test_pow10_rule_is_pow10_rn_on_every_float_of_the_path():
    """Every float32 x in [-18, -5], which holds pl * -0.1 for every
    distance the path loss takes (pl in [52.9, 171.3] dB): the rule
    rounds as pow10_rn does, bit for bit."""
    lo = int(np.float32(-5.0).view(np.int32))
    hi = int(np.float32(-18.0).view(np.int32))
    fast_total = 0
    for start in range(lo, hi + 1, 1 << 22):
        bits = np.arange(start, min(start + (1 << 22), hi + 1),
                         dtype=np.int32)
        x = bits.view(np.float32)
        got, fast = _pow10_mirror(x)
        want = _pow10_rn_np(x)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        fast_total += int(fast.sum())
    n = hi - lo + 1
    assert n > 15_000_000
    assert n - fast_total == 3          # the three below, and no other


# float32 x in [-18, -5] whose 10^x lies within the margin of a float
# rounding midpoint (all three there are, by an exhaustive search)
NEAR_MIDPOINT_X = (0xC126F431, 0xC0ADA2D8, 0xC17D4E91)


def test_pow10_rule_takes_pow_near_a_midpoint():
    x = np.array(NEAR_MIDPOINT_X, np.uint32).view(np.float32)
    y = _exp10_faithful(x)
    assert (np.abs(_midpoint_offset(y)) <= MIDPOINT_MARGIN).all()
    got, fast = _pow10_mirror(x)
    assert not fast.any()
    np.testing.assert_array_equal(got.view(np.int32),
                                  _pow10_rn_np(x).view(np.int32))


def test_midpoint_test_on_doubles_built_at_midpoints():
    """Doubles k ulps from a float32 rounding midpoint: within the margin
    (and at it) they take pow, beyond it exp10; float32 subnormals take
    pow; powers of two lie far from every midpoint."""
    rng = np.random.default_rng(0)
    f = rng.uniform(1e-18, 1e-5, 1000).astype(np.float32)
    up = np.nextafter(f, np.float32(np.inf))
    mid = (f.astype(np.float64) + up.astype(np.float64)) / 2   # exact
    assert (_midpoint_offset(mid) == 0).all()
    for k in (-MIDPOINT_MARGIN - 1, -MIDPOINT_MARGIN, -1, 0, 1,
              MIDPOINT_MARGIN, MIDPOINT_MARGIN + 1):
        y = (mid.view(np.int64) + k).view(np.float64)
        assert (_midpoint_offset(y) == k).all()
        assert (_takes_exp10(y) == (abs(k) > MIDPOINT_MARGIN)).all(), k
        if abs(k) > MIDPOINT_MARGIN:        # rounds away from the midpoint
            want = up if k > 0 else f
            np.testing.assert_array_equal(y.astype(np.float32), want)
    two = np.ldexp(1.0, np.arange(-125, 128))
    for k in (-3, 0, 3):
        assert _takes_exp10((two.view(np.int64) + k).view(np.float64)).all()
    sub = np.array([2.0 ** -127, 2.0 ** -140, 0.0])
    assert not _takes_exp10(sub).any()


# -- the CUDA wrapper, without a card ----------------------------------------

def test_index_width_choice():
    from repro_torch.kernels.context_pairwise.kernel import index_bits
    assert index_bits(2, 1000, 12) == 32
    assert index_bits(1, 2 ** 31 - 1, 1) == 32
    assert index_bits(3, 2 ** 29, 1) == 32
    assert index_bits(1, 2 ** 31, 1) == 64
    assert index_bits(4, 2 ** 29, 1) == 64
    assert index_bits(2, 2 ** 20, 2 ** 10) == 64


def _cpu_args(s=2, n=5, m=3):
    args = _inputs(n, m, 0)
    stacked = [np.stack([a] * s) if i != 1 else a
               for i, a in enumerate(args)]
    return [t_(a) for a in stacked]


@pytest.mark.parametrize("bad,error,match", [
    ("dtype", TypeError, "pos: dtype"),
    ("shape", ValueError, "pos: shape"),
    ("strided", ValueError, "pos: not contiguous"),
    ("cpu", ValueError, "pos: on cpu, expected CUDA")])
def test_wrapper_checks_raise_before_any_build(monkeypatch, bad, error,
                                               match):
    from repro_torch.kernels import _build
    from repro_torch.kernels.context_pairwise.kernel import \
        context_pairwise_kernel

    def no_build(name):
        raise AssertionError("built")
    monkeypatch.setattr(_build, "load", no_build)
    args = _cpu_args()
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "shape":
        args[0] = args[0][:, :-1]
    elif bad == "strided":
        args[0] = args[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(error, match=match):
        context_pairwise_kernel(*args, **KW)


def test_constants_are_float32_and_made_once_per_spec():
    from repro_torch.kernels.context_pairwise.kernel import _consts
    from repro_torch.kernels.context_pairwise.ref import (NEG_TENTH, PL_ICPT,
                                                          PL_SLOPE, RCP_LN2)
    vals = (KW["tx_w"], KW["noise_psd_w"], KW["update_bits"],
            KW["workload"])
    arr, addr = _consts(*vals)
    assert _consts(*vals)[1] == addr
    want = np.float32(list(vals) + [PL_SLOPE, PL_ICPT, NEG_TENTH, RCP_LN2])
    np.testing.assert_array_equal(np.array(arr[:], np.float32), want)
