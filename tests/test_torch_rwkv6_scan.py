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

The CUDA kernel's chunked form cannot run here, so ``_chunked_mirror``
repeats its algorithm in float64 (chunks of 64, sub-chunks of 16 and
their halves, every decay factor referenced so that none exceeds 1, the
pairs inside a half with the exact pairwise decay, the ragged last chunk
zero-padded): it must equal the per-step recurrence to 1e-5 at decays
where the reference's chunked forms overflow (R8).
"""
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

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
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

ORACLE_TOL = 1e-5
CHUNKED_ATOL, CHUNKED_RTOL = 2e-4, 1e-3
# float64 mirror against the float32 per-step recurrence, relative to
# max(1, |value|); and the port's plain version against a float64 one
MIRROR_TOL = 1e-5
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
    # u=None is the inclusive (Mamba2) form: y_t = r_t . C_t, any T
    y, fin = L.chunked_linear_recurrence(r, k, v, lw, chunk=32)
    st = torch.zeros(1, 2, 8, 8)
    for i in range(48):
        y_i, st = L.linear_recurrence_step(r[:, :, i], k[:, :, i],
                                           v[:, :, i], lw[:, :, i], st)
        np.testing.assert_allclose(np_(y[:, :, i]), np_(y_i), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_allclose(np_(fin), np_(st), atol=1e-5, rtol=1e-5)


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


def _decay_inputs(b, h, t, w0, seed):
    """log_w = -exp(0.5 N(0, 1) + w0): the model's decay with its w0 bias
    moved from the init's -2 towards trained values."""
    r, k, v, _, u = _inputs(b, h, t, 64, 64, seed)
    rng = np.random.default_rng(seed + 1)
    lw = -np.exp(rng.standard_normal((b, h, t, 64)) * 0.5 + w0
                 ).astype(np.float32)
    return r, k, v, lw, u


def _factor(x):
    """2^x for a decay factor of the chunked form, which references every
    factor so that none exceeds 1: x <= 0 (up to float64 rounding of the
    cumulative sums)."""
    assert x.max().item() <= 1e-9, x.max().item()
    return torch.exp2(x)


def _chunked_mirror(r, k, v, lw, u, chunk=64, sub=16):
    """The CUDA kernel's chunked algorithm in float64, log2 units: per
    sub-chunk I of 16 rows and channel c the inclusive prefix incl_i, the
    exclusive one e_i = incl_{i-1} and the total T_I; q~ = r 2^e,
    k~ = k 2^(T_I - incl); the state part reads q~ 2^(T_0 + .. + T_{I-1}),
    the state update k~ 2^(T_{J+1} + .. + T_3); the score of i in I and j
    in an earlier J is sum_c q~_ic k~_jc 2^(T_{J+1} + .. + T_{I-1}). Inside
    a sub-chunk, i in its second half against j in its first is
    sum_c (r_ic 2^(e_ic - incl_7c)) (k_jc 2^(incl_7c - incl_jc)); a pair in
    one half takes the pairwise 2^(e_i - incl_j), the diagonal the u
    bonus. No factor exceeds 1. Rows past T are zero, log_w 0."""
    f64 = torch.float64
    b, h, t, d = r.shape
    r, k, v = (torch.as_tensor(x, dtype=f64) for x in (r, k, v))
    lw2 = torch.as_tensor(lw, dtype=f64) * math.log2(math.e)
    u = torch.as_tensor(u, dtype=f64)
    n = -(-t // chunk)
    pad = (0, 0, 0, n * chunk - t)
    r, k, v, lw2 = (F.pad(x, pad) for x in (r, k, v, lw2))
    ns, half = chunk // sub, sub // 2
    i_ = torch.arange(sub)
    same_half = (i_[:, None] // half == i_[None, :] // half)
    below = ((i_[:, None] > i_[None, :]) & same_half)[..., None]
    diag = (i_[:, None] == i_[None, :])[..., None]
    state = torch.zeros((b, h, d, d), dtype=f64)
    ys = []
    for c in range(n):
        rows = slice(c * chunk, (c + 1) * chunk)
        rc, kc, vc = r[:, :, rows], k[:, :, rows], v[:, :, rows]
        w = lw2[:, :, rows].reshape(b, h, ns, sub, d)
        incl = torch.cumsum(w, 3)
        e = incl - w
        tot = incl[:, :, :, -1]                          # (b, h, ns, d)
        qt = rc.reshape(b, h, ns, sub, d) * _factor(e)
        kt = kc.reshape(b, h, ns, sub, d) \
            * _factor(tot[:, :, :, None] - incl)
        a = torch.zeros((b, h, chunk, chunk), dtype=f64)
        y = torch.zeros((b, h, chunk, d), dtype=f64)
        for si in range(ns):
            ri = slice(si * sub, (si + 1) * sub)
            before = _factor(tot[:, :, :si].sum(2))[:, :, None]
            y[:, :, ri] = (qt[:, :, si] * before) @ state
            for sj in range(si):
                mid = _factor(tot[:, :, sj + 1:si].sum(2))[:, :, None]
                a[:, :, ri, sj * sub:(sj + 1) * sub] = \
                    qt[:, :, si] @ (kt[:, :, sj] * mid).transpose(-1, -2)
            ra, ka = rc[:, :, ri], kc[:, :, ri]
            pair = e[:, :, si, :, None] - incl[:, :, si, None]
            fac = torch.where(below, _factor(torch.where(below, pair,
                                                              0.0)), 0.0)
            fac = fac + torch.where(diag, u[None, :, None, None], 0.0)
            blk = torch.einsum("bhic,bhjc,bhijc->bhij", ra, ka, fac)
            ref = incl[:, :, si, half - 1:half]          # incl_7
            pq = ra[:, :, half:] * _factor(e[:, :, si, half:] - ref)
            pk = ka[:, :, :half] * _factor(ref - incl[:, :, si, :half])
            blk[:, :, half:, :half] = pq @ pk.transpose(-1, -2)
            a[:, :, ri, ri] = blk
        ys.append(y + a @ vc)
        after = torch.flip(torch.cumsum(torch.flip(tot, (2,)), 2), (2,)) \
            - tot                                        # T_{J+1} + ..
        kh = (kt * _factor(after)[:, :, :, None]).reshape(b, h, chunk, d)
        state = state * _factor(tot.sum(2))[..., None] \
            + kh.transpose(-1, -2) @ vc
    return torch.cat(ys, 2)[:, :, :t], state


def _per_step_f64(r, k, v, lw, u):
    """numpy float64 per-step recurrence."""
    r, k, v, lw, u = (np.asarray(x, np.float64) for x in (r, k, v, lw, u))
    b, h, t, dk = r.shape
    state = np.zeros((b, h, dk, v.shape[-1]))
    y = np.zeros(v.shape)
    for i in range(t):
        rt, kt, vt = r[:, :, i], k[:, :, i], v[:, :, i]
        y[:, :, i] = np.einsum("bhd,bhdv->bhv", rt, state) \
            + np.einsum("bhd,hd,bhd->bh", rt, u, kt)[..., None] * vt
        state = state * np.exp(lw[:, :, i])[..., None] \
            + kt[..., None] * vt[..., None, :]
    return y, state


def _rel_err(got, want) -> float:
    got, want = np_(got).astype(np.float64), np_(want).astype(np.float64)
    return float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())


@pytest.mark.parametrize("t", [1, 63, 64, 100, 512])
@pytest.mark.parametrize("w0", [-2.0, 0.0, 0.5, 1.0, 3.0])
def test_chunked_mirror_matches_per_step(w0, t):
    """The kernel's chunked algorithm equals the per-step recurrence at
    every decay strength, a ragged last chunk included, and stays
    finite where exp(-cumsum log_w) overflows."""
    args = _decay_inputs(1, 2, t, w0, seed=int(t + 10 * (w0 + 2)))
    gy, gf = _chunked_mirror(*args)
    assert torch.isfinite(gy).all() and torch.isfinite(gf).all()
    wy, wf = rwkv6_scan_ref(*map(t_, args))
    assert _rel_err(gy, wy) < MIRROR_TOL
    assert _rel_err(gf, wf) < MIRROR_TOL


@pytest.mark.parametrize("w0", [0.5, 1.0])
def test_r8_reference_chunked_form_overflows(w0):
    """R8: the reference's Pallas kernel scales k by exp(-cumsum log_w)
    over a 64-step chunk, which overflows float32 once a chunk's decays
    sum below about -88; the per-step recurrence, the port's plain
    version, stays finite and exact."""
    args = _decay_inputs(1, 2, 128, w0, seed=3)
    assert np.cumsum(args[3], axis=2).min() < -88.0
    jy, jf = jax_kernel(*map(jnp.asarray, args), chunk=64, interpret=True)
    assert not (np.isfinite(np.asarray(jy)).all()
                and np.isfinite(np.asarray(jf)).all())
    gy, gf = rwkv6_scan(*map(t_, args))
    assert torch.isfinite(gy).all() and torch.isfinite(gf).all()
    wy, wf = _per_step_f64(*args)
    assert _rel_err(gy, wy) < MIRROR_TOL
    assert _rel_err(gf, wf) < MIRROR_TOL
