"""The port's MoE router (B6) on the CPU, where it takes its plain
version, against the reference's jnp oracle ``moe_router_ref`` (the
routing of ``moe.route``: ``lax.top_k`` over the float32 softmax) and
its Pallas kernel in interpret mode, on the same numpy logits.

Tolerances: expert indices equal; gates within 1e-6 absolute (float32
softmaxes whose sums run in another order, values in [0, 1]); each row's
gates sum to 1 within 1e-5, as ``tests/test_serving_router.py`` holds
the Pallas kernel.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_parity import np_, t_  # noqa: E402
from repro.kernels.moe_router.kernel import moe_router_kernel  # noqa: E402
from repro.kernels.moe_router.ref import \
    moe_router_ref as jax_ref  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.moe_router.ops import moe_router  # noqa: E402

GATE_TOL = 1e-6
SUM_TOL = 1e-5
# the shapes of tests/test_serving_router.py, and kimi-k2's 384 experts
SHAPES = [(64, 8, 2), (100, 16, 4), (256, 64, 8), (7, 4, 1), (64, 384, 8)]


def _logits(t, e, seed, dtype):
    x = np.random.default_rng(seed).standard_normal((t, e)).astype(
        np.float32)
    # bf16 logits: both packages read the same bf16 values
    return np.asarray(jnp.asarray(x, dtype).astype(jnp.float32)) \
        if dtype == jnp.bfloat16 else x


def _both(x, k, dtype):
    """(port gates, port idx, reference gates, reference idx)."""
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else \
        (jnp.float32, torch.float32)
    before = dict(common.LAUNCHES)
    g, i = moe_router(t_(x).to(td), k)
    assert common.LAUNCHES == before        # the CPU takes the plain version
    wg, wi = jax_ref(jnp.asarray(x, jd), k)
    return g, i, wg, wi


def _assert_route(g, i, wg, wi):
    assert g.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(np_(i), np.asarray(wi))
    np.testing.assert_allclose(np_(g), np.asarray(wg), atol=GATE_TOL,
                               rtol=0)
    np.testing.assert_allclose(np_(g).sum(-1), 1.0, atol=SUM_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("t,e,k", SHAPES)
def test_plain_matches_reference_oracle(t, e, k, dtype):
    x = _logits(t, e, t + e, jnp.bfloat16 if dtype == "bf16" else None)
    _assert_route(*_both(x, k, dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("t,e,k", SHAPES)
def test_plain_matches_pallas_kernel(t, e, k, dtype):
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    x = _logits(t, e, 7 * t + e, jd if dtype == "bf16" else None)
    wg, wi = moe_router_kernel(jnp.asarray(x, jd), k, tile=64)
    g, i = moe_router(t_(x).to(torch.bfloat16 if dtype == "bf16"
                                else torch.float32), k)
    _assert_route(g, i, wg, wi)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("e,k", [(8, 2), (16, 4), (384, 8)])
def test_exact_ties_follow_lax_top_k(e, k, dtype):
    """Integer logits from {0, 1, 2}: most rows hold equal probabilities
    at the k-th place; ties go to the lower expert index."""
    x = np.random.default_rng(e).integers(0, 3, (96, e)).astype(np.float32)
    x[0] = 0.0                                   # one row all equal
    g, i, wg, wi = _both(x, k, dtype)
    _assert_route(g, i, wg, wi)
    np.testing.assert_array_equal(np_(i)[0], np.arange(k))
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x), axis=-1))
    _, want = jax.lax.top_k(jnp.asarray(probs), k)
    np.testing.assert_array_equal(np_(i), np.asarray(want))


def test_underflowing_row_picks_distinct_experts():
    """ROADMAP R7: with logits [0, -200 x 7] every probability but the
    first underflows to 0. ``lax.top_k`` (``route``) and the port pick
    experts 0 then 1, gates [1, 0]; the reference's Pallas kernel zeroes
    its pick and takes expert 0 twice."""
    x = np.array([[0.0] + [-200.0] * 7, [-200.0] * 7 + [0.0]], np.float32)
    g, i, wg, wi = _both(x, 2, "f32")
    _assert_route(g, i, wg, wi)
    np.testing.assert_array_equal(np_(i), [[0, 1], [7, 0]])
    np.testing.assert_array_equal(np_(g), [[1.0, 0.0], [1.0, 0.0]])
    _, pi = moe_router_kernel(jnp.asarray(x), 2, tile=2)
    np.testing.assert_array_equal(np.asarray(pi)[0], [0, 0])


@pytest.mark.parametrize("shape,k,dtype,err", [
    ((4, 385), 2, torch.float32, ValueError),      # E above 384
    ((4, 8), 9, torch.float32, ValueError),        # k above 8
    ((4, 4), 5, torch.float32, ValueError),        # k above E
    ((4, 8), 0, torch.float32, ValueError),
    ((8,), 2, torch.float32, ValueError),          # not (T, E)
    ((4, 8), 2, torch.float16, TypeError),
    ((4, 8), 2, torch.float64, TypeError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(shape, k, dtype,
                                                       err):
    with pytest.raises(err):
        moe_router(torch.zeros(shape, dtype=dtype), k)


# -- rows whose softmax sum is not finite --------------------------------

def _nonfinite(t, e, pattern, seed):
    """(T, E) standard normal logits whose even rows hold ``pattern``:
    one NaN, one +inf, all -inf or all NaN. Every probability of such a
    row is NaN."""
    x = np.random.default_rng(seed).standard_normal((t, e)).astype(
        np.float32)
    rows = np.arange(0, t, 2)
    if pattern == "nan":
        x[rows, rows % e] = np.nan
    elif pattern == "inf":
        x[rows, (rows + 5) % e] = np.inf
    elif pattern == "neginf":
        x[rows] = -np.inf
    else:
        x[rows] = np.nan
    return x


def _assert_nonfinite_route(g, i, wg, wi, bad):
    """Indices equal everywhere; gates NaN exactly where the
    reference's are (the rows in ``bad``), and on the other rows as
    ``_assert_route`` holds them."""
    g, i, wg, wi = np_(g), np_(i), np.asarray(wg), np.asarray(wi)
    np.testing.assert_array_equal(i, wi)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(wg))
    assert np.isnan(wg[bad]).all() and not np.isnan(wg[~bad]).any()
    np.testing.assert_array_equal(i[bad], np.broadcast_to(
        np.arange(i.shape[1]), i[bad].shape))
    np.testing.assert_allclose(g[~bad], wg[~bad], atol=GATE_TOL, rtol=0)
    np.testing.assert_allclose(g[~bad].sum(-1), 1.0, atol=SUM_TOL)


@pytest.mark.parametrize("e,k", [(8, 2), (384, 8)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pattern", ["nan", "inf", "neginf", "allnan"])
def test_nonfinite_rows_follow_the_reference(pattern, dtype, e, k):
    """A row with a NaN or +inf logit, or all -inf: the reference's
    ``moe_router_ref`` and ``route``'s ``lax.top_k`` rank NaN above
    every number and give indices 0..k-1 with NaN gates; so does the
    port's plain version."""
    x = _nonfinite(16, e, pattern, e + len(pattern))
    bad = np.arange(16) % 2 == 0
    g, i, wg, wi = _both(x, k, dtype)
    _assert_nonfinite_route(g, i, wg, wi, bad)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    probs = jax.nn.softmax(jnp.asarray(x, jd).astype(jnp.float32), axis=-1)
    _, want = jax.lax.top_k(probs, k)
    np.testing.assert_array_equal(np_(i), np.asarray(want))


# -- the CUDA kernel's thread-a-row path, mirrored in numpy --------------

def _row_mirror(x, k):
    """float32 mirror of the kernel's thread-a-row path (E <= 32): per
    row, the max (``fmaxf``: a NaN operand gives the other) and the sum
    in index order, each probability by one division; a row whose sum
    is NaN takes experts 0..k-1 with NaN gates, any other row k rounds
    over the untaken experts by "strictly greater" in index order, the
    gates divided by the sum of the picks in round order."""
    t, e = x.shape
    gates = np.empty((t, k), np.float32)
    idx = np.empty((t, k), np.int32)
    with np.errstate(all="ignore"):
        for r in range(t):
            m = np.float32(-np.inf)
            for j in range(e):
                m = np.fmax(m, x[r, j])
            p = np.empty(e, np.float32)
            s = np.float32(0.0)
            for j in range(e):
                p[j] = np.exp(x[r, j] - m)
                s = np.float32(s + p[j])
            p = p / s
            if np.isnan(s):
                gates[r], idx[r] = p[:k], np.arange(k)
                continue
            taken, total = 0, np.float32(0.0)
            for rnd in range(k):
                bv, bi = np.float32(-1.0), 0
                for j in range(e):
                    if not (taken >> j) & 1 and p[j] > bv:
                        bv, bi = p[j], j
                taken |= 1 << bi
                gates[r, rnd], idx[r, rnd] = bv, bi
                total = np.float32(total + bv)
            gates[r] = gates[r] / total
    return gates, idx


def _mirror_inputs(t, e, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return rng.integers(0, 3, (t, e)).astype(np.float32)
    if kind == "underflow":                    # R7: one 0, the rest -200
        x = np.full((t, e), -200.0, np.float32)
        x[np.arange(t), np.arange(t) % e] = 0.0
        return x
    x = rng.standard_normal((t, e)).astype(np.float32)
    if kind == "tiny":     # probabilities in (0, 2^-117): subnormal ones
        x[:, e // 2:] = -85.0 - 20.0 * rng.random((t, e - e // 2))
    if kind == "nonfinite":                    # rows of each pattern
        rows = np.arange(t)
        x[rows[0::5], rows[0::5] % e] = np.nan
        x[rows[1::5], rows[1::5] % e] = np.inf
        x[2::5] = -np.inf
        x[3::5] = np.nan
    return x


@pytest.mark.parametrize("e,k", [(1, 1), (8, 2), (32, 8)])
@pytest.mark.parametrize("kind", ["normal", "ties", "underflow", "tiny",
                                  "nonfinite"])
def test_thread_a_row_mirror_matches_reference(kind, e, k):
    """The kernel's pick for E <= 32 (index-order max and sum, a taken
    mask, a NaN row's experts 0..k-1) against the reference's ``moe_router_ref``:
    indices equal on every row whose reference probabilities, sorted down
    to the (k+1)-th, are apart by more than 1e-6 or exactly equal (as
    the CUDA tests hold the kernel), gates within GATE_TOL; on
    non-finite rows indices 0..k-1 and NaN gates."""
    x = _mirror_inputs(64, e, kind, 3 * e + len(kind))
    g, i = _row_mirror(x, k)
    wg, wi = (np.asarray(a) for a in jax_ref(jnp.asarray(x), k))
    bad = ~np.isfinite(x).all(-1)
    assert bad.any() == (kind == "nonfinite")
    np.testing.assert_array_equal(i[bad], wi[bad])
    np.testing.assert_array_equal(i[bad], np.broadcast_to(np.arange(k),
                                                          i[bad].shape))
    assert np.isnan(g[bad]).all() and np.isnan(wg[bad]).all()
    probs = np.sort(np.asarray(jax.nn.softmax(jnp.asarray(x[~bad]))),
                    -1)[:, ::-1]
    probs = np.concatenate([probs, np.zeros((len(probs), 1), np.float32)],
                           -1)                  # a k+1-th where k = E
    gaps = probs[:, :k] - probs[:, 1:k + 1]
    decided = ((gaps > 1e-6) | (gaps == 0)).all(-1)
    assert decided.mean() > 0.95
    np.testing.assert_array_equal(i[~bad][decided], wi[~bad][decided])
    np.testing.assert_allclose(g[~bad], wg[~bad], atol=GATE_TOL, rtol=0)
    np.testing.assert_allclose(g[~bad].sum(-1), 1.0, atol=SUM_TOL)
    if kind == "underflow":
        np.testing.assert_array_equal(i[:, 0], np.arange(64) % e)


# -- the CUDA wrapper's refusals, before anything is built ---------------

@pytest.mark.parametrize("what,error,says", [
    ("E above 384", ValueError, "experts"),
    ("k above E", ValueError, "top_k"),
    ("float16", TypeError, "dtype"),
    ("1-d", ValueError, "shape"),
    ("not contiguous", ValueError, "contiguous"),
    ("on the cpu", ValueError, "expected CUDA"),
])
def test_kernel_wrapper_refuses_before_building(monkeypatch, what, error,
                                                says):
    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_router import kernel

    def no_build(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(_build, "load", no_build)
    x = torch.zeros((4, 8))
    if what == "E above 384":
        x = torch.zeros((4, 385))
    elif what == "float16":
        x = x.half()
    elif what == "1-d":
        x = x[0]
    elif what == "not contiguous":
        x = torch.zeros((8, 4)).t()
    with pytest.raises(error, match=says):
        kernel.moe_router_kernel(x, 9 if what == "k above E" else 2)
