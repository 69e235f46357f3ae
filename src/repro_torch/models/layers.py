"""Shared building blocks of the LM models, mirroring the reference's
``models/layers.py``.

Conventions, as in the reference:
  * parameters are nested dicts of tensors, weights in (d_in, d_out)
    layout (``x @ W``);
  * per-layer parameters are stacked on a leading ``num_layers`` axis
    (the models loop over layers in Python);
  * norms and softmax run in float32, matmuls in the config dtype.

Prompt attention goes through the flash attention kernel and the RWKV6
recurrence through the WKV scan kernel (``repro_torch/kernels``); the
Mamba2 (inclusive) recurrence is torch ops.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan

# ---------------------------------------------------------------------------
# init helpers (the reference's scales; torch's numbers, not JAX's)


# a float32 draw above this many elements is made in slices along the
# leading axis (kimi-k2's (384, 7168, 2048) expert stacks would need a
# 22.5 GB float32 temporary beside their 11.3 GB of bf16); smaller draws,
# every other config's, are made whole, as before
SLICE_ELEMS = 1 << 30


def _normal(gen: torch.Generator, shape, scale: float, dtype,
            device) -> torch.Tensor:
    """N(0, scale^2) in ``dtype``, drawn in float32 and rounded once."""
    n = math.prod(shape)
    if n <= SLICE_ELEMS or len(shape) < 2:
        x = torch.randn(shape, generator=gen, device=device)
        return x.mul_(scale).to(dtype)      # in place: one float32 temporary
    out = torch.empty(shape, dtype=dtype, device=device)
    step = max(1, (SLICE_ELEMS // 4) // (n // shape[0]))
    for i in range(0, shape[0], step):
        part = out[i:i + step]
        x = torch.randn(part.shape, generator=gen, device=device)
        part.copy_(x.mul_(scale))
        del x
    return out


def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = 1.0 / math.sqrt(fan_in)
    return _normal(gen, shape, scale, dtype, device)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32,
               device=None) -> torch.Tensor:
    return _normal(gen, shape, 0.02, dtype, device)


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

    if n == 1:          # a view of the one layer, no second copy
        return _tree_map(lambda t: t.unsqueeze(0), make_layer())
    out = None
    for i in range(n):
        layer = make_layer()
        if out is None:
            out = alloc(layer)
        fill(out, layer, i)
        del layer
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer_params(params: dict, i: int, key: str = "layers") -> dict:
    """Layer i's parameters: views into the stacked ``params[key]``."""
    return _tree_map(lambda t: t[i], params[key])


def remat_call(remat: bool, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``; with ``remat`` under activation
    checkpointing (``torch.utils.checkpoint``, non-reentrant): only the
    inputs are kept and the body runs again in the backward pass, the
    counterpart of the reference's ``jax.checkpoint`` of a layer body.
    The rerun launches the body's kernels a second time."""
    if not remat:
        return fn(*args, **kwargs)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             **kwargs)


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
                    mask: Optional[torch.Tensor] = None, causal: bool = True,
                    window: int = 0,
                    kv_cache: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None,
                    cache_positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Self-attention.

    With ``kv_cache=(ck, cv)`` the new K/V are written into the cache at
    ``cache_positions`` (B, S), in place (the reference returns a new
    cache; writing in place saves a copy of the whole cache a step).

    With ``mask=None`` the sequence attends to its own S positions
    through the flash attention kernel: causally, limited to ``window``
    when it is > 0, or with ``causal=False`` to every position (the
    encoder's bidirectional attention, which the reference asks for with
    ``mask=None``; here ``mask=None`` alone means causal). That covers
    the prompt of a prefill (whose cache slots past S are unwritten and
    masked, so they add exactly 0) and a training forward. With a mask,
    attention runs in plain torch over the whole cache (decode, the VLM
    prefill) or, with no cache, over the sequence's own positions.
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
        if mask is not None:
            k, v = ck, cv
        else:
            k, v = k.to(ck.dtype), v.to(cv.dtype)
    if mask is None:
        out = flash_attention(q, k, v, causal=causal, window=window)
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
# linear recurrence (the RWKV6 WKV and the Mamba2 SSD form)
#
# State C in R^{dk x dv}: C_t = diag(w_t) C_{t-1} + k_t v_t^T, w_t in (0, 1].
# Two query conventions, as in the reference:
#   * exclusive (RWKV6), u given: y_t = r_t . C_{t-1} + (r_t . (u o k_t)) v_t,
#     through the WKV scan kernel;
#   * inclusive (Mamba2), u=None: y_t = r_t . C_t, in torch ops (the
#     reference computes it outside any Pallas kernel).


def chunked_linear_recurrence(r, k, v, log_w, chunk: int,
                              u: Optional[torch.Tensor] = None,
                              init_state: Optional[torch.Tensor] = None):
    """r, k (B, H, T, dk); v (B, H, T, dv); log_w <= 0, (B, H, T, dk) or
    (B, H, T, 1) for a decay shared by the state's rows (Mamba2's scalar
    per head); u (H, dk); init_state (B, H, dk, dv). Returns y (B, H, T,
    dv) and the final state (B, H, dk, dv), float32.

    With ``u`` (exclusive) T must be a multiple of ``chunk``, the
    reference's contract; the WKV scan kernel runs it from a zero state,
    in its own chunks of 64 (bf16) or sequentially (float32). On CUDA the
    (B, H, T, d) views of the model's (B, T, H, d) tensors go in without a
    copy and y comes back as the (B, H, T, dv) view of a (B, T, H, dv)
    tensor.

    With ``u=None`` (inclusive) see ``_inclusive_chunked``: any T, from
    ``init_state`` or zero.
    """
    if u is None:
        return _inclusive_chunked(r, k, v, log_w, chunk, init_state)
    if init_state is not None:
        raise ValueError("the exclusive form runs from a zero state")
    t = r.shape[2]
    if t % chunk:
        raise ValueError(f"sequence length {t} is not a multiple of the "
                         f"chunk {chunk}")
    return rwkv6_scan(r, k, v, log_w, u)


def _inclusive_chunked(r, k, v, log_w, chunk: int, init_state=None):
    """The inclusive form in chunks of ``chunk`` steps, written so that no
    factor exceeds 1. The reference (``layers.py:245``) scales k by
    exp(-cumsum log_w) within a chunk, which is inf in float32 once the
    decays of a chunk sum below -88.7: zamba2's chunk of 128 at its
    initial dt = softplus(0) already reaches it (R12). Here, with
    lcum the inclusive cumulative log decay within a chunk and ltot its
    last value:
      * within a chunk, source s reaches query t >= s with exp(lcum_t -
        lcum_s), a difference of two cumulative sums (a segment sum);
      * the chunk's summary is sum_s exp(ltot - lcum_s) k_s v_s^T;
      * the incoming state reaches query t with exp(lcum_t) and the next
        chunk with exp(ltot).
    A ragged tail is padded with k = 0, log_w = 0 steps, which leave the
    state as it is. Float32 throughout."""
    f32 = torch.float32
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    nc = -(-t // chunk)
    pad = nc * chunk - t
    r_, k_, v_, lw = (a.to(f32) for a in (r, k, v, log_w))
    if pad:
        r_, k_, v_, lw = (F.pad(a, (0, 0, 0, pad)) for a in (r_, k_, v_, lw))
    r_, k_, v_, lw = (a.reshape(b, h, nc, chunk, a.shape[-1])
                      for a in (r_, k_, v_, lw))
    lcum = torch.cumsum(lw, dim=3)                     # (b, h, nc, C, dw)
    ltot = lcum[:, :, :, -1:]                          # (b, h, nc, 1, dw)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=r.device).tril()
    # exp(lcum_t - lcum_s) for s <= t, else 0: (b, h, nc, C, C, dw)
    seg = lcum[:, :, :, :, None] - lcum[:, :, :, None]
    decay = torch.exp(seg.masked_fill(~tri[:, :, None], -math.inf))
    if lw.shape[-1] == 1:
        scores = (r_ @ k_.transpose(-1, -2)) * decay[..., 0]
    else:
        scores = torch.einsum("bhntd,bhntsd,bhnsd->bhnts", r_, decay, k_)
    y = scores @ v_                                    # (b, h, nc, C, dv)
    summ = (k_ * torch.exp(ltot - lcum)).transpose(-1, -2) @ v_
    carry = torch.exp(ltot[:, :, :, 0])                # (b, h, nc, dw)
    q_in = r_ * torch.exp(lcum)                        # (b, h, nc, C, dk)
    state = (torch.zeros((b, h, dk, dv), dtype=f32, device=r.device)
             if init_state is None else init_state.to(f32))
    ys = []
    for n in range(nc):
        ys.append(y[:, :, n] + q_in[:, :, n] @ state)
        state = carry[:, :, n, :, None] * state + summ[:, :, n]
    y = torch.stack(ys, dim=2).reshape(b, h, nc * chunk, dv)
    return y[:, :, :t], state


def linear_recurrence_step(r, k, v, log_w, state,
                           u: Optional[torch.Tensor] = None):
    """One token (decode). r, k (B, H, dk); log_w (B, H, dk) or (B, H,
    1); v (B, H, dv); state (B, H, dk, dv). Exclusive with ``u`` (the old
    state is queried, plus the u bonus), inclusive without (the new state
    is queried). Returns y (B, H, dv) and the new state, float32."""
    f32 = torch.float32
    r_, k_, v_, lw = (a.to(f32) for a in (r, k, v, log_w))
    st = state.to(f32)
    new_state = st * torch.exp(lw)[..., None] \
        + k_[..., None] * v_[..., None, :]
    if u is None:
        return torch.einsum("bhd,bhdv->bhv", r_, new_state), new_state
    y = torch.einsum("bhd,bhdv->bhv", r_, st)
    y = y + torch.einsum("bhd,hd,bhd->bh", r_, u.to(f32),
                         k_)[..., None] * v_
    return y, new_state
