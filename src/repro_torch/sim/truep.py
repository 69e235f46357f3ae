"""Analytic Eq. 6 success probability under exponential (Rayleigh-power)
fading: the ``true_p="analytic"`` replacement for the Monte-Carlo
estimate over ``mc_true_p`` fading pairs.

The round latency (Eq. 5) is ``tau = a/r(F_dt) + q/y + a/r(F_ut)`` with
``r(F) = b log2(1 + c F)``, ``c = P g0 / (N0 b)`` and iid ``F ~ Exp(1)``.
Conditioning on the downlink draw,

    P[tau <= d] = E_F1[ S(T - u(F1)) ],   u(F) = a / r(F),  T = d - q/y,
    S(t) = P[u(F) <= t] = exp(-(2^(a/(b t)) - 1) / c)   (t > 0, else 0),

and ``s = exp(-F1)`` turns the expectation into an integral over (0, 1],
taken here with a fixed 64-node Gauss-Legendre rule. No random draw is
made, so the ``(K, N, M)`` fading tensors of the Monte-Carlo mode go.

The node table is built in float64 numpy, as the reference's
(``sim/truep.py``); the integrand is evaluated in float32 on the round's
tensors, written as XLA executes the jitted reference (``core.fmath``):
the divisions by ``ln 2`` are multiplications by its float32 reciprocal.
``host_analytic_true_p`` is the host env's float64 numpy form (a copy of
the reference's numpy path).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fmath import f32, mul_rcp, rdiv

QUAD_NODES = 64

# Gauss-Legendre nodes and weights mapped from [-1, 1] onto (0, 1)
_X, _W = np.polynomial.legendre.leggauss(QUAD_NODES)
GL_POINTS = 0.5 * (_X + 1.0)
GL_WEIGHTS = 0.5 * _W
# F1 = -ln(s) at each node
GL_FADING = -np.log(GL_POINTS)

LN2 = f32(np.log(2.0))
# the exponent's clamp, 80 / ln 2 folded in float32
SPECTRAL_MAX = f32(np.float32(80.0) / np.float32(LN2))


# pairs a pass of the integral takes: its (64, pairs) float32 temporaries
# stay near 1 GB, where a metropolis-1m round's 64M pairs would need 16 GB
# each; every pair's value is its own, so the passes change no result
CHUNK_PAIRS = 1 << 22


def analytic_true_p(bandwidth: torch.Tensor, compute: torch.Tensor,
                    g0: torch.Tensor, *, tx_w: float, noise_psd_w: float,
                    update_bits: float, workload: float,
                    deadline_s: float) -> torch.Tensor:
    """P[tau <= deadline] per (seed, client, ES) pair.

    ``bandwidth`` and ``compute`` broadcast against ``g0`` (S, N, M) as in
    the latency computation (pass ``bandwidth[..., None]``). The guards
    ``max(r, 1e-9)`` and ``max(compute, 1e-9)`` are the latency's. Past
    ``CHUNK_PAIRS`` pairs the clients go in blocks."""
    kw = dict(tx_w=tx_w, noise_psd_w=noise_psd_w, update_bits=update_bits,
              workload=workload, deadline_s=deadline_s)
    n = g0.shape[-2]
    step = max(1, CHUNK_PAIRS // max(1, g0.numel() // max(n, 1)))
    if n <= step:
        return _true_p(bandwidth, compute, g0, **kw)
    rows = lambda a, i: a.narrow(-2, i, min(step, n - i)) \
        if a.shape[-2] == n else a
    return torch.cat([_true_p(rows(bandwidth, i), rows(compute, i),
                              rows(g0, i), **kw)
                      for i in range(0, n, step)], dim=-2)


def _true_p(bandwidth, compute, g0, *, tx_w, noise_psd_w, update_bits,
            workload, deadline_s):
    dev = g0.device
    b = bandwidth
    c = (g0 * f32(tx_w)) / (b * f32(noise_psd_w))
    slack = deadline_s - rdiv(workload, torch.clamp(compute, min=1e-9))
    f1 = torch.as_tensor(GL_FADING, dtype=torch.float32, device=dev)
    f1 = f1.view((QUAD_NODES,) + (1,) * g0.dim())
    rate1 = b * mul_rcp(torch.log1p(c * f1), LN2)             # (K, S, N, M)
    t = slack - rdiv(update_bits, torch.clamp(rate1, min=1e-9))
    spectral = torch.clamp(
        rdiv(update_bits, b * torch.clamp(t, min=1e-30)), max=SPECTRAL_MAX)
    needed = (torch.exp(spectral * LN2) - 1.0) / c
    surv = torch.where(t > 0, torch.exp(-needed), torch.zeros_like(needed))
    w = torch.as_tensor(GL_WEIGHTS, dtype=torch.float32, device=dev)
    total = (w.view_as(f1) * surv).sum(dim=0)
    return torch.clamp(total, 0.0, 1.0)


def host_analytic_true_p(bandwidth, compute, g0, *, tx_w: float,
                         noise_psd_w: float, update_bits: float,
                         workload: float, deadline_s: float) -> np.ndarray:
    """The same integral in float64 numpy, per (client, ES) pair of the
    host env: ``g0`` (N, M), ``bandwidth``/``compute`` broadcasting
    against it (``bandwidth[:, None]``)."""
    b = bandwidth * 1.0
    c = tx_w * g0 / (noise_psd_w * b)
    slack = deadline_s - workload / np.maximum(compute * 1.0, 1e-9)
    ln2 = np.log(2.0)
    rate1 = b * (np.log1p(c * GL_FADING[:, None, None]) / ln2)  # (K, N, M)
    t = slack - update_bits / np.maximum(rate1, 1e-9)
    # S(t) = exp(-(2^(a/(b t)) - 1)/c), 0 for t <= 0; the exponent is
    # clamped so the t -> 0+ tail saturates without an overflow warning
    spectral = np.minimum(update_bits / (b * np.maximum(t, 1e-30)),
                          80.0 / ln2)
    needed = (np.exp(spectral * ln2) - 1.0) / c
    surv = np.where(t > 0, np.exp(-needed), 0.0)
    total = np.sum(GL_WEIGHTS[:, None, None] * surv, axis=0)
    return np.clip(total, 0.0, 1.0)
