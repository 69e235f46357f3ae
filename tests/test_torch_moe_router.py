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
