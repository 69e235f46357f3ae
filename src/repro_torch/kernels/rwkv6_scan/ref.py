"""Plain PyTorch version of the RWKV6 WKV scan kernel: the per-step
recurrence, mirroring the reference's ``kernels/rwkv6_scan/ref.py``
(``models/layers.py::linear_recurrence_ref`` with ``u``):

    y_t = r_t . C_{t-1} + (r_t . (u o k_t)) v_t
    C_t = diag(exp(log_w_t)) C_{t-1} + k_t v_t^T,   C_0 = 0
"""
from __future__ import annotations

from typing import Tuple

import torch


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_w: torch.Tensor, u: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, log_w (B, H, T, dk); v (B, H, T, dv); u (H, dk) -> y
    (B, H, T, dv) float32 and the final state (B, H, dk, dv) float32."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    f32 = torch.float32
    r_, k_, v_, lw = (a.to(f32) for a in (r, k, v, log_w))
    uf = u.to(f32)
    state = torch.zeros((b, h, dk, dv), dtype=f32, device=r.device)
    ys = []
    for i in range(t):
        rt, kt, vt = r_[:, :, i], k_[:, :, i], v_[:, :, i]
        y = torch.einsum("bhd,bhdv->bhv", rt, state)
        y = y + torch.einsum("bhd,hd,bhd->bh", rt, uf, kt)[..., None] * vt
        state = state * torch.exp(lw[:, :, i])[..., None] \
            + kt[..., None] * vt[..., None, :]
        ys.append(y)
    y = torch.stack(ys, dim=2) if ys else torch.zeros((b, h, 0, dv),
                                                      dtype=f32,
                                                      device=r.device)
    return y, state
