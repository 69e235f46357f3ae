"""Plain PyTorch version of the context_pairwise kernel (Eq. 4/5).

The Shannon-rate and latency formulas live here once: the simulator's
Monte-Carlo ``true_p`` stage calls them, the CPU path of
``ops.pairwise_context`` composes them at full shape, and the CUDA
kernel (``csrc/context_pairwise.cu``) repeats the same float32 sequence,
operation for operation. The sequence is the reference's oracle as XLA
executes it under ``jit`` (``core.fmath``): the squared distance
``fma(dy, dy, dx * dx)``; the path loss ``fma(log(d), 37.6 / ln 10,
128.1)`` with the constants folded; ``10 ** (pl * -0.1)``; the rate
``B * (log1p(snr) * (1 / ln 2))``; IEEE divisions elsewhere.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.fmath import fma, fold, pow10_rn, rcp, rdiv, sqrt_rn

# 37.6 * log10(x) = log(x) * float32(37.6 * float32(1 / ln 10))
PL_SLOPE = fold(37.6, 0.4342944819032518)
PL_ICPT = float(np.float32(128.1))
NEG_TENTH = -rcp(10.0)
RCP_LN2 = rcp(float(np.log(np.float32(2.0))))


class PairwiseContext(NamedTuple):
    """The per-(client, ES) tensors ``sim_round`` consumes downstream."""
    dist: torch.Tensor     # (..., N, M) client-ES distance, km
    gain: torch.Tensor     # (..., N, M) path-loss channel gain g0
    rate: torch.Tensor     # (..., N, M) Eq. 4 rate at the fading mean
    tau: torch.Tensor      # (..., N, M) realized Eq. 5 latency, s


def path_loss_gain(d: torch.Tensor) -> torch.Tensor:
    """128.1 + 37.6 log10(max(d, 0.01)) dB as a linear gain (float32)."""
    pl_db = fma(torch.log(torch.clamp(d, min=0.01)), PL_SLOPE, PL_ICPT)
    return pow10_rn(pl_db * NEG_TENTH)


def shannon_rate(bandwidth, fading, g0, *, tx_w, noise_psd_w):
    """Eq. 4: B * log2(1 + P g / (N0 B)) with g = fading * g0."""
    g = fading * g0
    snr = (tx_w * g) / (noise_psd_w * bandwidth)
    return bandwidth * (torch.log1p(snr) * RCP_LN2)


def latency(bandwidth, compute, fad_dt, fad_ut, g0, *, tx_w, noise_psd_w,
            update_bits, workload):
    """Eq. 5: download + compute + upload time for one round."""
    r_dt = shannon_rate(bandwidth, fad_dt, g0, tx_w=tx_w,
                        noise_psd_w=noise_psd_w)
    r_ut = shannon_rate(bandwidth, fad_ut, g0, tx_w=tx_w,
                        noise_psd_w=noise_psd_w)
    return (rdiv(update_bits, torch.clamp(r_dt, min=1e-9))
            + rdiv(workload, torch.clamp(compute, min=1e-9))
            + rdiv(update_bits, torch.clamp(r_ut, min=1e-9)))


def pairwise_context_ref(pos, es, bandwidth, compute, fad_dt, fad_ut, *,
                         tx_w, noise_psd_w, update_bits, workload
                         ) -> PairwiseContext:
    """pos (..., N, 2), es (M, 2), bandwidth/compute (..., N),
    fad_dt/fad_ut (..., N, M) -> four (..., N, M) float32 tensors."""
    diff = pos[..., :, None, :] - es
    dx, dy = diff[..., 0], diff[..., 1]
    d = sqrt_rn(fma(dy, dy, dx * dx))
    g0 = path_loss_gain(d)
    bw = bandwidth[..., None]
    tau = latency(bw, compute[..., None], fad_dt, fad_ut, g0, tx_w=tx_w,
                  noise_psd_w=noise_psd_w, update_bits=update_bits,
                  workload=workload)
    rate = shannon_rate(bw, 1.0, g0, tx_w=tx_w, noise_psd_w=noise_psd_w)
    return PairwiseContext(dist=d, gain=g0, rate=rate, tau=tau)
