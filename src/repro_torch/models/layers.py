"""Shared building blocks of the LM models, mirroring the reference's
``models/layers.py``.

Conventions, as in the reference:
  * parameters are nested dicts of tensors, weights in (d_in, d_out)
    layout (``x @ W``);
  * per-layer parameters are stacked on a leading ``num_layers`` axis
    (the models loop over layers in Python);
  * norms and softmax run in float32, matmuls in the config dtype.

Prompt attention goes through the flash attention kernel and the RWKV6
recurrence through the WKV scan kernel (``repro_torch/kernels``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan

# ---------------------------------------------------------------------------
# init helpers (the reference's scales; torch's numbers, not JAX's)


def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=gen, device=device)
    return x.mul_(scale).to(dtype)      # in place: one float32 temporary


def embed_init(gen: torch.Generator, shape, dtype=torch.float32,
               device=None) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=device)
    return x.mul_(0.02).to(dtype)


def stack_layers(make_layer, n: int) -> dict:
    """``n`` per-layer parameter dicts from ``make_layer()``, drawn in
    order, as one dict with a leading layer axis. Each stacked leaf is
    allocated once and filled layer by layer, so beside the stack only
    one layer's tensors are alive (stacking a list of layers would hold
    every tensor twice: 2 x 40 GB for 8 mixtral-8x22b layers)."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return t.new_empty((n, *t.shape))

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i].copy_(v)

    out = None
    for i in range(n):
        layer = make_layer()
        if out is None:
            out = alloc(layer)
        fill(out, layer, i)
        del layer
    return out


def layer_params(params: dict, i: int) -> dict:
    """Layer i's parameters: views into the stacked ``params["layers"]``."""
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return pick(params["layers"])


# ---------------------------------------------------------------------------
# norms


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + weight), in float32."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + weight.to(torch.float32))).to(x.dtype)


def group_norm_heads(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, num_heads: int,
                     eps: float = 64e-5) -> torch.Tensor:
    """GroupNorm over per-head channels; x (..., H*hd)."""
    *lead, d = x.shape
    xf = x.to(torch.float32).reshape(*lead, num_heads, d // num_heads)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (y * weight.to(torch.float32) + bias.to(torch.float32)
            ).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # a Python base: no host-to-device copy (and no stream sync) a call
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, S, H, hd); positions (B, S) integer. Angles in float32,
    split halves."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, sliding window, KV cache)


def attention_scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                          k_valid: Optional[torch.Tensor] = None,
                          sliding_window: int = 0,
                          prefix_len: int = 0) -> torch.Tensor:
    """Additive float32 mask from position vectors: 1-D positions give a
    batch-free (Sq, Sk) mask, (B, S) positions a (B, Sq, Sk) one. Causal,
    optionally windowed, with an optional fully visible prefix."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    ok = k <= q
    if sliding_window:
        ok &= k > (q - sliding_window)
    if prefix_len:
        ok |= k < prefix_len
    if k_valid is not None:
        ok &= k_valid[..., None, :]
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, zero - 1e30)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Sk, KV, hd); mask additive float32 of
    shape (Sq, Sk) or (B, Sq, Sk), or None. The decode path over the
    cache. Products take the operands' values with float32 accumulation
    and a float32 result, as the reference's ``preferred_element_type``
    does; the softmax weights are rounded to v's dtype before the PV
    product, as the reference rounds them."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    groups = h // kv
    f32 = torch.float32
    qg = q.reshape(b, sq, kv, groups, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(f32), k.to(f32)) \
        / math.sqrt(hd)
    if mask is not None:
        if mask.dim() == 2:
            scores = scores + mask[None, None, None]
        else:
            scores = scores + mask[:, None, None]
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype).to(f32),
                       v.to(f32))
    return out.reshape(b, sq, h, hd).to(q.dtype)


def init_attention(gen, d_model: int, num_heads: int, num_kv_heads: int,
                   head_dim: int, qkv_bias: bool, dtype,
                   device=None) -> dict:
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": dense_init(gen, (d_model, num_heads * head_dim), **kw),
        "wk": dense_init(gen, (d_model, num_kv_heads * head_dim), **kw),
        "wv": dense_init(gen, (d_model, num_kv_heads * head_dim), **kw),
        "wo": dense_init(gen, (num_heads * head_dim, d_model), **kw),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((num_heads * head_dim,), **kw)
        p["bk"] = torch.zeros((num_kv_heads * head_dim,), **kw)
        p["bv"] = torch.zeros((num_kv_heads * head_dim,), **kw)
    return p


def attention_block(p: dict, x: torch.Tensor, *, num_heads: int,
                    num_kv_heads: int, head_dim: int, rope_theta: float,
                    positions: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, window: int = 0,
                    kv_cache: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None,
                    cache_positions: Optional[torch.Tensor] = None,
                    ) -> torch.Tensor:
    """Self-attention.

    With ``kv_cache=(ck, cv)`` the new K/V are written into the cache at
    ``cache_positions`` (B, S), in place (the reference returns a new
    cache; writing in place saves a copy of the whole cache a step).

    With ``mask=None`` the sequence attends causally to its own S
    positions, limited to ``window`` when it is > 0, through the flash
    attention kernel: the prompt of a prefill (whose cache slots past S
    are unwritten and masked, so they add exactly 0) or a training
    forward. With a mask, attention runs in plain torch over the whole
    cache (decode) or the sequence.
    """
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = apply_rope(q.reshape(b, s, num_heads, head_dim), positions,
                   rope_theta)
    k = apply_rope(k.reshape(b, s, num_kv_heads, head_dim), positions,
                   rope_theta)
    v = v.reshape(b, s, num_kv_heads, head_dim)
    if kv_cache is not None:
        ck, cv = kv_cache
        bidx = torch.arange(b, device=x.device)[:, None]
        cpos = cache_positions.long()
        ck[bidx, cpos] = k.to(ck.dtype)
        cv[bidx, cpos] = v.to(cv.dtype)
        if mask is None:
            k, v = k.to(ck.dtype), v.to(cv.dtype)
        else:
            k, v = ck, cv
    if mask is None:
        out = flash_attention(q, k, v, causal=True, window=window)
    else:
        out = gqa_attention(q, k, v, mask)
    return out.reshape(b, s, num_heads * head_dim) @ p["wo"]


# ---------------------------------------------------------------------------
# MLP (SwiGLU)


def init_mlp(gen, d_model: int, d_ff: int, dtype, device=None) -> dict:
    kw = dict(dtype=dtype, device=device)
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), **kw),
        "w_up": dense_init(gen, (d_model, d_ff), **kw),
        "w_down": dense_init(gen, (d_ff, d_model), **kw),
    }


def mlp_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


# ---------------------------------------------------------------------------
# linear recurrence (the RWKV6 WKV; the Mamba2 SSD form waits for its model)
#
# State C in R^{dk x dv}: C_t = diag(w_t) C_{t-1} + k_t v_t^T. Exclusive
# (RWKV6) query: y_t = r_t . C_{t-1} + (r_t . (u o k_t)) v_t. The
# reference's inclusive (Mamba2) query, y_t = r_t . C_t, selected by
# u=None, raises until zamba2 is ported.


def _exclusive_only(u) -> None:
    if u is None:
        raise NotImplementedError("the inclusive (Mamba2) recurrence is "
                                  "not ported yet")


def chunked_linear_recurrence(r, k, v, log_w, chunk: int,
                              u: Optional[torch.Tensor] = None):
    """r, k, log_w (B, H, T, dk); v (B, H, T, dv); log_w <= 0; u (H, dk).

    The exclusive form with ``u`` from a zero state (the reference's
    ``init_state=None``), which is what the WKV scan kernel computes, in
    its own chunks of 64 (bf16) or sequentially (float32); ``chunk`` is
    only the reference's contract: T a multiple of ``chunk``. On CUDA the
    (B, H, T, d) views of the model's (B, T, H, d) tensors go in without
    a copy and y comes back as the (B, H, T, dv) view of a (B, T, H, dv)
    tensor. Returns y and the final state (B, H, dk, dv), float32.
    """
    _exclusive_only(u)
    t = r.shape[2]
    if t % chunk:
        raise ValueError(f"sequence length {t} is not a multiple of the "
                         f"chunk {chunk}")
    return rwkv6_scan(r, k, v, log_w, u)


def linear_recurrence_step(r, k, v, log_w, state,
                           u: Optional[torch.Tensor] = None):
    """One token (decode), exclusive: the old state is queried, plus the
    u bonus. r, k, log_w (B, H, dk); v (B, H, dv); state (B, H, dk, dv).
    Returns y (B, H, dv) and the new state, float32."""
    _exclusive_only(u)
    f32 = torch.float32
    r_, k_, v_, lw = (a.to(f32) for a in (r, k, v, log_w))
    st = state.to(f32)
    new_state = st * torch.exp(lw)[..., None] \
        + k_[..., None] * v_[..., None, :]
    y = torch.einsum("bhd,bhdv->bhv", r_, st)
    y = y + torch.einsum("bhd,hd,bhd->bh", r_, u.to(f32),
                         k_)[..., None] * v_
    return y, new_state
