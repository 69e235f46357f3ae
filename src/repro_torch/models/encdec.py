"""Encoder-decoder transformer (the SeamlessM4T backbone
[arXiv:2308.11596]), mirroring the reference's ``models/encdec.py``.

The audio frontend (mel spectrogram and conv feature extractor) is a
stub, as in the reference: the encoder takes precomputed frame
embeddings (B, F, d_model). The encoder's self-attention is
bidirectional, through the flash attention kernel with ``causal=False``;
the decoder's is causal, through the kernel over a prompt and over the
KV cache in plain torch in decode. Cross-attention (queries from the
decoder, keys and values from the encoder's output, Sq != Sk, no mask)
is the reference's plain ``gqa_attention``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def _attn(gen, cfg: ModelConfig, device) -> dict:
    return L.init_attention(gen, cfg.d_model, cfg.num_heads,
                            cfg.num_kv_heads, cfg.resolved_head_dim,
                            cfg.qkv_bias, cfg.torch_dtype, device=device)


def init_enc_layer(gen: torch.Generator, cfg: ModelConfig,
                   device=None) -> dict:
    kw = dict(dtype=cfg.torch_dtype, device=device)
    return {
        "ln1": torch.zeros((cfg.d_model,), **kw),
        "ln2": torch.zeros((cfg.d_model,), **kw),
        "attn": _attn(gen, cfg, device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.torch_dtype,
                          device=device),
    }


def init_dec_layer(gen: torch.Generator, cfg: ModelConfig,
                   device=None) -> dict:
    kw = dict(dtype=cfg.torch_dtype, device=device)
    return {
        "ln1": torch.zeros((cfg.d_model,), **kw),
        "ln_x": torch.zeros((cfg.d_model,), **kw),
        "ln2": torch.zeros((cfg.d_model,), **kw),
        "attn": _attn(gen, cfg, device),
        "xattn": _attn(gen, cfg, device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.torch_dtype,
                          device=device),
    }


def init_model(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    dt = cfg.torch_dtype
    kw = dict(dtype=dt, device=device)
    return {
        "frame_proj": L.dense_init(gen, (cfg.d_model, cfg.d_model), **kw),
        "embed": L.embed_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                              device=device),
        "encoder": L.stack_layers(lambda: init_enc_layer(gen, cfg, device),
                                  cfg.encoder_layers),
        "decoder": L.stack_layers(lambda: init_dec_layer(gen, cfg, device),
                                  cfg.num_layers),
        "enc_norm": torch.zeros((cfg.d_model,), **kw),
        "final_norm": torch.zeros((cfg.d_model,), **kw),
        "lm_head": L.dense_init(gen, (cfg.d_model, cfg.vocab_size), **kw),
    }


def _self_attn(lp: dict, cfg: ModelConfig, h, positions, **kw):
    return L.attention_block(
        lp["attn"], L.rms_norm(h, lp["ln1"], cfg.norm_eps),
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        positions=positions, **kw)


def encode(params: dict, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames (B, F, d_model), the stub frontend's embeddings -> the
    encoder's output (B, F, d_model). Bidirectional: one non-causal
    flash attention launch a layer."""
    x = frames.to(cfg.torch_dtype) @ params["frame_proj"]
    b, f, _ = x.shape
    positions = torch.arange(f, dtype=torch.int32,
                             device=x.device).expand(b, f)
    for i in range(cfg.encoder_layers):
        lp = L.layer_params(params, i, "encoder")
        x = x + _self_attn(lp, cfg, x, positions, causal=False)
        x = x + L.mlp_block(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps))
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_attend(lp: dict, cfg: ModelConfig, x: torch.Tensor,
                  enc_out: torch.Tensor) -> torch.Tensor:
    """Cross-attention: queries from x, keys and values from the encoder's
    output, no mask, no rotary embedding, no bias (as the reference)."""
    b, s, _ = x.shape
    f = enc_out.shape[1]
    hd = cfg.resolved_head_dim
    y = L.rms_norm(x, lp["ln_x"], cfg.norm_eps)
    p = lp["xattn"]
    q = (y @ p["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = (enc_out @ p["wk"]).reshape(b, f, cfg.num_kv_heads, hd)
    v = (enc_out @ p["wv"]).reshape(b, f, cfg.num_kv_heads, hd)
    out = L.gqa_attention(q, k, v, None)
    return x + out.reshape(b, s, cfg.num_heads * hd) @ p["wo"]


def forward(params: dict, cfg: ModelConfig, frames: torch.Tensor,
            tokens: torch.Tensor, enc_out: Optional[torch.Tensor] = None,
            unroll: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward: (logits over the target tokens (B, S, V), aux
    loss 0). ``enc_out``, when given, is ``encode(frames)`` already made
    (the frames are then not encoded again). ``unroll`` changes nothing
    (the reference's scan option); like the reference's, this forward
    takes no ``remat``."""
    del unroll
    if enc_out is None:
        enc_out = encode(params, cfg, frames)
    x = params["embed"][tokens.long()]
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    for i in range(cfg.num_layers):
        lp = L.layer_params(params, i, "decoder")
        x = x + _self_attn(lp, cfg, x, positions)
        x = _cross_attend(lp, cfg, x, enc_out)
        x = x + L.mlp_block(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps))
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"], torch.zeros((), dtype=torch.float32,
                                              device=x.device)


# ---------------------------------------------------------------------------
# serving


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Dict[str, Any]:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dt = cfg.torch_dtype
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "kpos": torch.full((batch, max_len), -1, dtype=torch.int32,
                           device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        # the encoder's output, kept for cross-attention
        "enc_out": torch.zeros((batch, cfg.num_frames, cfg.d_model),
                               dtype=dt, device=device),
    }


# the batch axis of every cache field (the serving engine resets a slot
# along it)
CACHE_BATCH_AXIS = {"k": 1, "v": 1, "kpos": 0, "pos": 0, "enc_out": 0}


def start_serving(params: dict, cfg: ModelConfig, frames: torch.Tensor,
                  cache: Dict[str, Any],
                  enc_out: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """The cache with the encoder's output of ``frames`` (or ``enc_out``
    when it is already made)."""
    cache = dict(cache)
    cache["enc_out"] = encode(params, cfg, frames) if enc_out is None \
        else enc_out
    return cache


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens (B, 1): one target-side decode step with cross-attention.
    The cache's tensors are updated in place."""
    b = tokens.shape[0]
    x = params["embed"][tokens.long()]
    positions = cache["pos"][:, None]
    size = cache["k"].shape[2]
    cache_positions = positions % size
    kpos = cache["kpos"]
    bidx = torch.arange(b, device=x.device)[:, None]
    kpos[bidx, cache_positions.long()] = positions         # slot being written
    mask = L.attention_scores_mask(positions, kpos, k_valid=kpos >= 0)
    enc_out = cache["enc_out"]
    for i in range(cfg.num_layers):
        lp = L.layer_params(params, i, "decoder")
        x = x + _self_attn(lp, cfg, x, positions, mask=mask,
                           kv_cache=(cache["k"][i], cache["v"][i]),
                           cache_positions=cache_positions)
        x = _cross_attend(lp, cfg, x, enc_out)
        x = x + L.mlp_block(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps))
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    cache = dict(cache)
    cache["pos"] = cache["pos"] + 1
    return x @ params["lm_head"], cache
