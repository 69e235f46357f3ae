"""RWKV6 "Finch": attention-free LM with data-dependent decay
[arXiv:2404.05892], mirroring the reference's ``models/rwkv6.py``.

Time-mix runs the WKV recurrence (exclusive convention, u bonus) through
``layers.chunked_linear_recurrence``, that is the WKV scan kernel, over
a whole prompt, and through ``layers.linear_recurrence_step`` one token
at a time in decode. Data dependence: token-shift DDLerp with a low-rank
adapter, and the per-channel decay w_t = exp(-exp(w0 + lora_w(x_mix))).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

LORA_RANK = 32
MIX_NAMES = ("r", "k", "v", "w", "g")


def _heads(cfg: ModelConfig) -> Tuple[int, int]:
    hd = cfg.resolved_head_dim if cfg.head_dim else 64
    return cfg.d_model // hd, hd


def init_time_mix(gen: torch.Generator, cfg: ModelConfig,
                  device=None) -> dict:
    d = cfg.d_model
    h, hd = _heads(cfg)
    dt = cfg.torch_dtype
    f32 = torch.float32
    kw = dict(dtype=dt, device=device)
    n = len(MIX_NAMES)
    return {
        # token-shift DDLerp
        "mu_x": torch.zeros((d,), **kw),
        "mu": torch.zeros((n, d), **kw),
        "lora_a": L.dense_init(gen, (d, LORA_RANK * n), **kw),
        "lora_b": L.dense_init(gen, (n, LORA_RANK, d), **kw),
        # projections
        "wr": L.dense_init(gen, (d, d), **kw),
        "wk": L.dense_init(gen, (d, d), **kw),
        "wv": L.dense_init(gen, (d, d), **kw),
        "wg": L.dense_init(gen, (d, d), **kw),
        "wo": L.dense_init(gen, (d, d), **kw),
        # decay
        "w0": torch.full((d,), -2.0, dtype=f32, device=device),
        "w_lora_a": L.dense_init(gen, (d, 64), **kw),
        "w_lora_b": L.dense_init(gen, (64, d), **kw),
        # per-head current-token bonus
        "u": torch.randn((h, hd), generator=gen, device=device) * 0.1,
        # output group-norm
        "gn_w": torch.ones((d,), dtype=f32, device=device),
        "gn_b": torch.zeros((d,), dtype=f32, device=device),
    }


def init_channel_mix(gen: torch.Generator, cfg: ModelConfig,
                     device=None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(dtype=cfg.torch_dtype, device=device)
    return {
        "mu_k": torch.zeros((d,), **kw),
        "mu_r": torch.zeros((d,), **kw),
        "wk": L.dense_init(gen, (d, f), **kw),
        "wv": L.dense_init(gen, (f, d), **kw),
        "wr": L.dense_init(gen, (d, d), **kw),
    }


def init_layer(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    kw = dict(dtype=cfg.torch_dtype, device=device)
    return {
        "ln1": torch.zeros((cfg.d_model,), **kw),
        "ln2": torch.zeros((cfg.d_model,), **kw),
        "tm": init_time_mix(gen, cfg, device),
        "cm": init_channel_mix(gen, cfg, device),
    }


def init_lm(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    dt = cfg.torch_dtype
    return {
        "embed": L.embed_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                              device=device),
        "layers": L.stack_layers(lambda: init_layer(gen, cfg, device),
                                 cfg.num_layers),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=device),
        "lm_head": L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                dtype=dt, device=device),
    }


def _ddlerp(p: dict, x: torch.Tensor, x_prev: torch.Tensor):
    """Data-dependent token-shift interpolation -> 5 mixed streams."""
    dx = x_prev - x
    xx = x + dx * p["mu_x"]
    lo = torch.tanh(xx @ p["lora_a"])                  # (..., 5*R)
    lo = lo.reshape(*lo.shape[:-1], len(MIX_NAMES), LORA_RANK)
    adj = torch.einsum("...nr,nrd->...nd", lo, p["lora_b"])
    mixed = x[..., None, :] + dx[..., None, :] * (p["mu"] + adj)
    return tuple(mixed[..., i, :] for i in range(len(MIX_NAMES)))


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """log w = -exp(w0 + lora_w(xw)), float32, <= 0."""
    w_raw = p["w0"] + (torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
                       ).to(torch.float32)
    return -torch.exp(w_raw)


def time_mix(p: dict, x: torch.Tensor, x_prev: torch.Tensor,
             cfg: ModelConfig, chunk: int = 64):
    """x (B, T, d); x_prev: x shifted right by one. T must be a multiple
    of min(chunk, T), the reference's contract. Returns (out, final WKV
    state)."""
    b, t, d = x.shape
    h, hd = _heads(cfg)
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev)

    def heads(a):
        return a.reshape(b, t, h, hd).transpose(1, 2)

    r = heads(xr @ p["wr"])
    k = heads(xk @ p["wk"])
    v = heads(xv @ p["wv"])
    g = F.silu(xg @ p["wg"])
    log_w = heads(_decay(p, xw))
    y, fin = L.chunked_linear_recurrence(r, k, v, log_w, chunk=min(chunk, t),
                                         u=p["u"])
    y = y.transpose(1, 2).reshape(b, t, d)   # on CUDA already this layout
    y = L.group_norm_heads(y.to(x.dtype), p["gn_w"], p["gn_b"], h)
    return (y * g) @ p["wo"], fin


def time_mix_step(p: dict, x: torch.Tensor, x_prev: torch.Tensor,
                  cfg: ModelConfig, state: torch.Tensor):
    """Single-token decode. x, x_prev (B, d); state (B, H, hd, hd)."""
    b, d = x.shape
    h, hd = _heads(cfg)
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev)
    r = (xr @ p["wr"]).reshape(b, h, hd)
    k = (xk @ p["wk"]).reshape(b, h, hd)
    v = (xv @ p["wv"]).reshape(b, h, hd)
    g = F.silu(xg @ p["wg"])
    log_w = _decay(p, xw).reshape(b, h, hd)
    y, new_state = L.linear_recurrence_step(r, k, v, log_w, state, u=p["u"])
    y = L.group_norm_heads(y.reshape(b, d).to(x.dtype), p["gn_w"],
                           p["gn_b"], h)
    return (y * g) @ p["wo"], new_state


def channel_mix(p: dict, x: torch.Tensor, x_prev: torch.Tensor):
    dx = x_prev - x
    xk = x + dx * p["mu_k"]
    xr = x + dx * p["mu_r"]
    k = torch.square(torch.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])


def _shift(x: torch.Tensor) -> torch.Tensor:
    """(B, T, d) -> x shifted right one step, zero-padded."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _layer(lp: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    z = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    tm_out, _ = time_mix(lp["tm"], z, _shift(z), cfg)
    x = x + tm_out
    z = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + channel_mix(lp["cm"], z, _shift(z))


def forward_lm(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
               remat: bool = False, unroll: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits (B, T, V), aux loss 0). One WKV scan launch a layer.
    ``remat`` checkpoints each layer; ``unroll`` changes nothing (the
    reference's scan option)."""
    del unroll
    x = params["embed"][tokens.long()]
    for i in range(cfg.num_layers):
        x = L.remat_call(remat, _layer, L.layer_params(params, i), cfg, x)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"], torch.zeros((), dtype=torch.float32,
                                              device=x.device)


# ---------------------------------------------------------------------------
# decode (recurrent O(1) state)


def init_state(cfg: ModelConfig, batch: int, device=None) -> Dict[str, Any]:
    d = cfg.d_model
    h, hd = _heads(cfg)
    dt = cfg.torch_dtype
    return {
        "tm_x": torch.zeros((cfg.num_layers, batch, d), dtype=dt,
                            device=device),
        "cm_x": torch.zeros((cfg.num_layers, batch, d), dtype=dt,
                            device=device),
        "wkv": torch.zeros((cfg.num_layers, batch, h, hd, hd),
                           dtype=torch.float32, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


# the batch axis of every state field (the serving engine resets a slot
# along it)
STATE_BATCH_AXIS = {"tm_x": 1, "cm_x": 1, "wkv": 1, "pos": 0}


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                state: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens (B, 1) -> (logits (B, 1, V), state). The state's tensors are
    updated in place (the reference returns new ones)."""
    x = params["embed"][tokens[:, 0].long()]
    for i in range(cfg.num_layers):
        lp = L.layer_params(params, i)
        z = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        tm_out, wkv = time_mix_step(lp["tm"], z, state["tm_x"][i], cfg,
                                    state["wkv"][i])
        state["tm_x"][i] = z
        state["wkv"][i] = wkv
        x = x + tm_out
        z = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + channel_mix(lp["cm"], z, state["cm_x"][i])
        state["cm_x"][i] = z
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    new_state = dict(state)
    new_state["pos"] = state["pos"] + 1
    return (x @ params["lm_head"])[:, None], new_state
