"""Channel constants of the HFL network (Section III, VI-A), float64 on
the host: the device simulator starts from these exact values."""
from __future__ import annotations

import numpy as np

from repro_torch.configs.paper_hfl import HFLExperimentConfig


def _dbm_to_watt(dbm: float) -> float:
    return 10 ** (dbm / 10.0) / 1000.0


def es_positions(num_es: int) -> np.ndarray:
    """ES positions on a circle of radius 1.5 km (float64)."""
    ang = np.linspace(0, 2 * np.pi, num_es, endpoint=False)
    return np.stack([1.5 * np.cos(ang), 1.5 * np.sin(ang)], -1)


def path_loss_gain(d_km, floor_km: float = 0.01):
    """Linear distance-only channel gain: 128.1 + 37.6 log10(d) dB
    (float64 numpy)."""
    pl_db = 128.1 + 37.6 * np.log10(np.maximum(d_km, floor_km))
    return 10.0 ** (-pl_db / 10.0)


def context_rate_hi(cfg: HFLExperimentConfig) -> float:
    """Context-normalization constant (min-max scaling, Sec. IV): the
    Eq. 4 rate at bandwidth_high, d = 0.05 km, |h|^2 = 4, in float64."""
    g = 4.0 * path_loss_gain(0.05)
    snr = (_dbm_to_watt(cfg.tx_power_dbm) * g
           / (_dbm_to_watt(cfg.noise_dbm_per_hz) * cfg.bandwidth_high))
    return float(cfg.bandwidth_high * np.log2(1.0 + snr))
