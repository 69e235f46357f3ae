"""Mamba2 SSD block (a scalar decay per head, the chunked state-space dual
form), mirroring the reference's ``models/mamba2.py``. Used inside the
Zamba2 hybrid.

A prompt runs the inclusive recurrence in chunks
(``layers.chunked_linear_recurrence`` with ``u=None``), written so that
every decay factor is <= 1 (the reference's form overflows at zamba2's
own chunk of 128, R12); a decode step runs ``layers.linear_recurrence_step``
(the reference runs its chunked form at T = 1, the same function). The
decay is passed as (B, H, T, 1), one per head, not broadcast over the
state dimension.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.models import layers as L


def _dims(cfg: ModelConfig):
    s = cfg.ssm or SSMConfig()
    d_in = cfg.d_model * s.expand
    heads = d_in // s.head_dim
    return s, d_in, heads


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype,
               device=None) -> dict:
    s, d_in, heads = _dims(cfg)
    d = cfg.d_model
    conv_ch = d_in + 2 * s.state_dim
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # fused in_proj: [z, x, B, C, dt]
        "in_proj": L.dense_init(gen, (d, 2 * d_in + 2 * s.state_dim + heads),
                                **kw),
        "conv_w": L.dense_init(gen, (s.conv_width, conv_ch), scale=0.1,
                               **kw),
        "conv_b": torch.zeros((conv_ch,), **kw),
        "a_log": torch.zeros((heads,), **f32),
        "dt_bias": torch.zeros((heads,), **f32),
        "d_skip": torch.ones((heads,), **f32),
        "norm_w": torch.zeros((d_in,), **kw),
        "out_proj": L.dense_init(gen, (d_in, d), **kw),
    }


def _split(cfg: ModelConfig, proj: torch.Tensor):
    """in_proj's output -> (z, xBC, dt)."""
    s, d_in, heads = _dims(cfg)
    return torch.split(proj, [d_in, d_in + 2 * s.state_dim, heads], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 carry: Optional[torch.Tensor] = None):
    """xbc (B, T, C); w (W, C) depthwise. Returns (silu(conv + b), the new
    carry (B, W-1, C): the last W-1 inputs). Summed tap by tap in the
    model dtype, in the reference's order."""
    width = w.shape[0]
    if carry is None:
        carry = torch.zeros((xbc.shape[0], width - 1, xbc.shape[2]),
                            dtype=xbc.dtype, device=xbc.device)
    padded = torch.cat([carry.to(xbc.dtype), xbc], dim=1)
    t = xbc.shape[1]
    out = sum(padded[:, i:i + t] * w[i] for i in range(width))
    return F.silu(out + b), padded[:, -(width - 1):]


def _ssm_inputs(p: dict, cfg: ModelConfig, x: torch.Tensor, conv_state):
    """The shared front of the prompt and the step forms: (z, xs (B, T,
    H, P), B (B, T, N), C (B, T, N), dt (B, T, H) float32, log_w (B, T, H)
    float32, the new conv carry)."""
    s, d_in, heads = _dims(cfg)
    b, t, _ = x.shape
    z, xbc, dt = _split(cfg, x @ p["in_proj"])
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                   conv_state)
    xs, bmat, cmat = torch.split(xbc, [d_in, s.state_dim, s.state_dim],
                                 dim=-1)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    log_w = -dt * torch.exp(p["a_log"])
    return (z, xs.reshape(b, t, heads, s.head_dim), bmat, cmat, dt, log_w,
            conv_state)


def _out(p: dict, cfg: ModelConfig, x, z, y, xs):
    """y (B, T, H, P) float32 -> the block's output (B, T, d)."""
    s, d_in, heads = _dims(cfg)
    b, t, _ = x.shape
    y = y + xs * p["d_skip"][None, None, :, None]
    y = y.reshape(b, t, d_in).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"]


def mamba_mix(p: dict, x: torch.Tensor, cfg: ModelConfig,
              ssm_state: Optional[torch.Tensor] = None,
              conv_state: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, T, d) -> (out (B, T, d), ssm state (B, H, N, P) float32,
    conv carry). Chunks of min(chunk_size, T), as the reference's."""
    s, d_in, heads = _dims(cfg)
    b, t, _ = x.shape
    z, xs, bmat, cmat, dt, log_w, conv_state = _ssm_inputs(p, cfg, x,
                                                           conv_state)
    # per head: v = x (P wide), k = B dt, r = C (N wide), one decay
    v = xs.transpose(1, 2)                                  # (B, H, T, P)
    k = (bmat[:, None] * dt.transpose(1, 2)[..., None])     # (B, H, T, N)
    r = cmat[:, None].expand(b, heads, t, s.state_dim)
    lw = log_w.transpose(1, 2)[..., None]                   # (B, H, T, 1)
    y, fin = L.chunked_linear_recurrence(
        r, k, v, lw, chunk=min(s.chunk_size, t), init_state=ssm_state)
    return _out(p, cfg, x, z, y.transpose(1, 2), xs), fin, conv_state


def mamba_mix_step(p: dict, x: torch.Tensor, cfg: ModelConfig,
                   ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """One token (decode): x (B, d) -> (out (B, d), ssm state, conv
    carry), through the step form of the recurrence."""
    s, d_in, heads = _dims(cfg)
    b = x.shape[0]
    x3 = x[:, None]
    z, xs, bmat, cmat, dt, log_w, conv_state = _ssm_inputs(p, cfg, x3,
                                                           conv_state)
    k = bmat[:, 0, None] * dt[:, 0, :, None]                # (B, H, N)
    r = cmat[:, 0, None].expand(b, heads, s.state_dim)
    y, fin = L.linear_recurrence_step(r, k, xs[:, 0], log_w[:, 0, :, None],
                                      ssm_state)
    return _out(p, cfg, x3, z, y[:, None], xs)[:, 0], fin, conv_state


def ssm_state_shapes(cfg: ModelConfig, batch: int):
    s, d_in, heads = _dims(cfg)
    return ((batch, heads, s.state_dim, s.head_dim),            # ssm state
            (batch, s.conv_width - 1, d_in + 2 * s.state_dim))  # conv carry
