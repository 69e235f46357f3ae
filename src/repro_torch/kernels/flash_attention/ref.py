"""Plain PyTorch version of the flash attention kernel, mirroring the
reference's ``kernels/flash_attention/ref.py::attention_ref``: float32
einsums, masked scores set to -1e30, softmax, in the kernel's layout."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  sm_scale: float = 0.0) -> torch.Tensor:
    """q (B, H, S, D); k, v (B, KV, S, D) with H % KV == 0 -> like q.
    Query head h reads KV head h // (H / KV)."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    if h % kv:
        raise ValueError(f"{h} query heads do not split over {kv} KV heads")
    groups = h // kv
    if sm_scale == 0.0:
        sm_scale = 1.0 / math.sqrt(d)
    f32 = torch.float32
    qf = q.to(f32).reshape(b, kv, groups, s, d)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qf, k.to(f32)) * sm_scale
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    scores = torch.where(ok, scores, torch.tensor(NEG_INF, dtype=f32,
                                                  device=q.device))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", w, v.to(f32))
    return out.reshape(b, h, s, d).to(q.dtype)
