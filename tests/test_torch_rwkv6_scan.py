"""The port's RWKV6 WKV scan (B5) on the CPU, where it takes its plain
per-step version, against the reference's Pallas kernel (interpret mode)
and its per-step oracle, and the port's ``chunked_linear_recurrence``
and ``linear_recurrence_step`` against the reference's, on the same
numpy inputs.

Tolerances, float32: against the per-step oracle the arithmetic is the
same recurrence in the same order, 1e-5 absolute and relative (einsum
sums in another order). Against the chunked forms (the Pallas kernel and
``chunked_linear_recurrence``) the reference multiplies by exp(+-cumsum
log_w) within a chunk, which loses digits where the decay is strong:
the reference's own kernel test allows 2e-4 absolute and 1e-3 relative
between its two forms, and so does this file.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_parity import np_, t_  # noqa: E402
from repro.kernels.rwkv6_scan.kernel import \
    rwkv6_scan_kernel as jax_kernel  # noqa: E402
from repro.kernels.rwkv6_scan.ref import \
    rwkv6_scan_ref as jax_ref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.rwkv6_scan.kernel import \
    rwkv6_scan_kernel  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

ORACLE_TOL = 1e-5
CHUNKED_ATOL, CHUNKED_RTOL = 2e-4, 1e-3
SHAPES = [(2, 2, 128, 32, 32, 32), (1, 3, 256, 64, 64, 64),
          (2, 1, 64, 16, 48, 16), (1, 1, 32, 8, 8, 32)]


def _inputs(b, h, t, dk, dv, seed):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((b, h, t, dk)).astype(np.float32)
    k = rng.standard_normal((b, h, t, dk)).astype(np.float32)
    v = rng.standard_normal((b, h, t, dv)).astype(np.float32)
    lw = -np.exp(rng.standard_normal((b, h, t, dk)) * 0.5 - 2.0
                 ).astype(np.float32)
    u = (rng.standard_normal((h, dk)) * 0.2).astype(np.float32)
    return r, k, v, lw, u


@pytest.mark.parametrize("b,h,t,dk,dv,chunk", SHAPES)
def test_plain_matches_pallas_kernel(b, h, t, dk, dv, chunk):
    args = _inputs(b, h, t, dk, dv, seed=t + dk)
    wy, wf = jax_kernel(*map(jnp.asarray, args), chunk=chunk,
                        interpret=True)
    before = dict(common.LAUNCHES)
    gy, gf = rwkv6_scan(*map(t_, args))
    assert common.LAUNCHES == before
    assert gy.dtype == gf.dtype == torch.float32
    assert gy.shape == (b, h, t, dv) and gf.shape == (b, h, dk, dv)
    np.testing.assert_allclose(np_(gy), np.asarray(wy), atol=CHUNKED_ATOL,
                               rtol=CHUNKED_RTOL)
    np.testing.assert_allclose(np_(gf), np.asarray(wf), atol=CHUNKED_ATOL,
                               rtol=CHUNKED_RTOL)


@pytest.mark.parametrize("b,h,t,dk,dv,chunk", SHAPES)
def test_plain_matches_reference_oracle(b, h, t, dk, dv, chunk):
    args = _inputs(b, h, t, dk, dv, seed=t * 3 + dv)
    wy, wf = jax_ref(*map(jnp.asarray, args))
    gy, gf = rwkv6_scan(*map(t_, args))
    np.testing.assert_allclose(np_(gy), np.asarray(wy), atol=ORACLE_TOL,
                               rtol=ORACLE_TOL)
    np.testing.assert_allclose(np_(gf), np.asarray(wf), atol=ORACLE_TOL,
                               rtol=ORACLE_TOL)


def test_exclusive_convention_first_steps():
    """y_0 is the u bonus alone (C_0 = 0); y_1 reads C_0 updated once."""
    r, k, v, lw, u = _inputs(1, 1, 4, 8, 8, seed=11)
    y, _ = rwkv6_scan(*map(t_, (r, k, v, lw, u)))
    r0, k0, v0 = r[0, 0, 0], k[0, 0, 0], v[0, 0, 0]
    np.testing.assert_allclose(np_(y)[0, 0, 0], (r0 * u[0] * k0).sum() * v0,
                               rtol=1e-6, atol=1e-6)
    c1 = np.outer(k0, v0)
    r1, k1, v1 = r[0, 0, 1], k[0, 0, 1], v[0, 0, 1]
    want = r1 @ c1 + (r1 * u[0] * k1).sum() * v1
    np.testing.assert_allclose(np_(y)[0, 0, 1], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("t,chunk", [(64, 64), (128, 32)])
def test_chunked_linear_recurrence_matches_reference(t, chunk):
    r, k, v, lw, u = _inputs(2, 4, t, 64, 64, seed=t + chunk)
    wy, wf = JL.chunked_linear_recurrence(*map(jnp.asarray, (r, k, v, lw)),
                                          chunk=chunk, u=jnp.asarray(u))
    gy, gf = L.chunked_linear_recurrence(*map(t_, (r, k, v, lw)),
                                         chunk=chunk, u=t_(u))
    np.testing.assert_allclose(np_(gy), np.asarray(wy), atol=CHUNKED_ATOL,
                               rtol=CHUNKED_RTOL)
    np.testing.assert_allclose(np_(gf), np.asarray(wf), atol=CHUNKED_ATOL,
                               rtol=CHUNKED_RTOL)


def test_chunked_linear_recurrence_contract():
    r, k, v, lw, u = map(t_, _inputs(1, 2, 48, 8, 8, seed=1))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        L.chunked_linear_recurrence(r, k, v, lw, chunk=32, u=u)
    with pytest.raises(NotImplementedError, match="inclusive"):
        L.chunked_linear_recurrence(r, k, v, lw, chunk=16)
    with pytest.raises(NotImplementedError, match="inclusive"):
        L.linear_recurrence_step(r[:, :, 0], k[:, :, 0], v[:, :, 0],
                                 lw[:, :, 0], torch.zeros(1, 2, 8, 8))


@pytest.mark.parametrize("seed", [5, 6])
def test_linear_recurrence_step_matches_reference(seed):
    rng = np.random.default_rng(seed)
    r, k, lw = (rng.standard_normal((3, 2, 16)).astype(np.float32)
                for _ in range(3))
    lw = -np.exp(lw)
    v = rng.standard_normal((3, 2, 24)).astype(np.float32)
    st = rng.standard_normal((3, 2, 16, 24)).astype(np.float32)
    u = rng.standard_normal((2, 16)).astype(np.float32)
    wy, ws = JL.linear_recurrence_step(*map(jnp.asarray, (r, k, v, lw, st)),
                                       u=jnp.asarray(u))
    gy, gs = L.linear_recurrence_step(*map(t_, (r, k, v, lw, st)), u=t_(u))
    np.testing.assert_allclose(np_(gy), np.asarray(wy), atol=ORACLE_TOL,
                               rtol=ORACLE_TOL)
    np.testing.assert_allclose(np_(gs), np.asarray(ws), atol=ORACLE_TOL,
                               rtol=ORACLE_TOL)


def test_kernel_wrapper_refuses_cpu_tensors():
    args = list(map(t_, _inputs(1, 2, 32, 64, 64, seed=2)))
    before = common.LAUNCHES["rwkv6_scan"]
    with pytest.raises(ValueError, match="expected CUDA"):
        rwkv6_scan_kernel(*args)
    small = list(map(t_, _inputs(1, 2, 32, 32, 32, seed=2)))
    with pytest.raises(ValueError, match="head dims"):
        rwkv6_scan_kernel(*small)
    assert common.LAUNCHES["rwkv6_scan"] == before
