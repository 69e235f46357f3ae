"""Decoder-only transformer LM (dense and MoE), mirroring the
reference's ``models/transformer.py``: training forward, prefill (builds
the KV cache) and single-token decode over a full-length cache or a
sliding-window ring buffer.

Layer parameters keep the reference's leading ``num_layers`` axis; the
forward loops over layers in Python. The prompt's attention (prefill and
the training forward) runs through the flash attention kernel; decode
attends over the cache in plain torch. An MoE config's layers take the
MoE block (``models/moe.py``, its router through the router kernel) in
place of the MLP. A VLM config (``num_patches``) takes image-patch
embeddings, projected by ``patch_proj`` and prepended to the tokens, with
a prefix-LM mask (the patches see each other both ways); that mask is not
the flash kernel's function, so its prompt attends in plain torch.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import init_moe, moe_block


def init_layer(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    dt = cfg.torch_dtype
    hd = cfg.resolved_head_dim
    p = {
        "ln1": torch.zeros((cfg.d_model,), dtype=dt, device=device),
        "ln2": torch.zeros((cfg.d_model,), dtype=dt, device=device),
        "attn": L.init_attention(gen, cfg.d_model, cfg.num_heads,
                                 cfg.num_kv_heads, hd, cfg.qkv_bias, dt,
                                 device=device),
    }
    if cfg.moe is not None:
        p["moe"] = init_moe(gen, cfg.d_model, cfg.moe, dt, device=device)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dt, device=device)
    return p


def init_lm(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    dt = cfg.torch_dtype
    p = {
        "embed": L.embed_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                              device=device),
        "layers": L.stack_layers(lambda: init_layer(gen, cfg, device),
                                 cfg.num_layers),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                    dtype=dt, device=device)
    if cfg.num_patches:   # VLM patch projector (the frontend supplies embeds)
        p["patch_proj"] = L.dense_init(gen, (cfg.d_model, cfg.d_model),
                                       dtype=dt, device=device)
    return p


def _layer_apply(cfg: ModelConfig, lp: dict, x, positions, mask=None,
                 window: int = 0, kv_cache=None, cache_positions=None,
                 aux: bool = False):
    """One layer: (x, the MoE aux loss when ``aux`` asks and the layer
    has one, else None)."""
    h = L.attention_block(
        lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps),
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        positions=positions, mask=mask, window=window, kv_cache=kv_cache,
        cache_positions=cache_positions)
    x = x + h
    y = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.moe is None:
        return x + L.mlp_block(lp["mlp"], y), None
    b, s, d = y.shape
    out, loss = moe_block(lp["moe"], y.reshape(b * s, d), cfg.moe, aux=aux)
    return x + out.reshape(b, s, d), loss


def embed_inputs(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 patch_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Token embeddings (B, S, d), after the projected patches (B, P, d)
    when ``patch_embeds`` is given."""
    x = params["embed"][tokens.long()]
    if cfg.tie_embeddings:
        # the scale is rounded to the activation dtype first, as in JAX,
        # on the host: a device tensor made from a Python number would
        # copy and synchronise the stream every call
        scale = torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
        x = x * scale
    if patch_embeds is not None:
        proj = patch_embeds.to(x.dtype) @ params["patch_proj"]
        x = torch.cat([proj, x], dim=1)
    return x


def _prefix_mask(s: int, prefix: int, window: int, device,
                 slots: int = 0):
    """The prefix-LM mask of S positions over ``slots`` key slots (S when
    0; slot j holds position j, slots past S are unwritten), batch-free
    (S, slots), or None when there is no prefix (the flash kernel's
    causal function)."""
    if not prefix:
        return None
    pos = torch.arange(s, dtype=torch.int32, device=device)
    slot = torch.arange(slots or s, dtype=torch.int32, device=device)
    return L.attention_scores_mask(pos, slot, k_valid=slot < s,
                                   sliding_window=window, prefix_len=prefix)


def unembed(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def forward_lm(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
               patch_embeds: Optional[torch.Tensor] = None,
               remat: bool = False, unroll: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/prefill forward: (logits (B, S, V), the sum of the MoE
    layers' load-balance losses; 0 for a dense model). With
    ``patch_embeds`` (B, P, d) the logits cover the P + S positions.
    ``remat`` checkpoints each layer (``layers.remat_call``); ``unroll``
    is the reference's scan option and changes nothing here (the layers
    are a Python loop)."""
    del unroll
    x = embed_inputs(params, cfg, tokens, patch_embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    prefix = 0 if patch_embeds is None else patch_embeds.shape[1]
    mask = _prefix_mask(s, prefix, cfg.sliding_window, x.device)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        x, loss = L.remat_call(remat, _layer_apply, cfg,
                               L.layer_params(params, i), x, positions,
                               mask=mask, window=cfg.sliding_window,
                               aux=True)
        if loss is not None:
            total = total + loss
    return unembed(params, cfg, x), total


# ---------------------------------------------------------------------------
# KV-cache serving


def init_cache(cfg: ModelConfig, batch: int, max_len: int, window: int = 0,
               device=None) -> Dict[str, Any]:
    """window > 0 -> a ring buffer of that size (sliding-window serving)."""
    size = min(max_len, window) if window else max_len
    shape = (cfg.num_layers, batch, size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dt = cfg.torch_dtype
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        # the sequence position held in each slot (-1 = empty)
        "kpos": torch.full((batch, size), -1, dtype=torch.int32,
                           device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


# the batch axis of every cache field (the serving engine resets a slot
# along it)
CACHE_BATCH_AXIS = {"k": 1, "v": 1, "kpos": 0, "pos": 0}


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Dict[str, Any], window: Optional[int] = None,
            patch_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt (B, S) through the model, writing the KV cache (in
    place). Returns the last position's logits (B, 1, V) and the cache.

    The reference attends over the whole cache with unwritten slots
    masked to -1e30; those slots add exactly 0 after the float32 exp, so
    attending to the prompt's own S positions through the flash kernel,
    causally, is the same function. With ``patch_embeds`` (the VLM
    prefix, S = P + tokens) attention runs as the reference's does, over
    the whole cache with the prefix-LM mask, in plain torch: the flash
    kernel takes neither that mask nor paligemma's head dim of 256. The
    prompt must fit the cache.
    """
    x = embed_inputs(params, cfg, tokens, patch_embeds)
    b, s, _ = x.shape
    size = cache["k"].shape[2]
    if s > size:
        raise ValueError(f"prefill of {s} tokens is longer than the cache "
                         f"({size}); decode incrementally instead")
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    cache_positions = positions % size
    window = cfg.sliding_window if window is None else window
    prefix = 0 if patch_embeds is None else patch_embeds.shape[1]
    mask = _prefix_mask(s, prefix, window, x.device, size)
    for i in range(cfg.num_layers):
        x, _ = _layer_apply(cfg, L.layer_params(params, i), x, positions,
                            mask=mask, window=window,
                            kv_cache=(cache["k"][i], cache["v"][i]),
                            cache_positions=cache_positions)
    cache = dict(cache)
    bidx = torch.arange(b, device=x.device)[:, None]
    cache["kpos"][bidx, cache_positions.long()] = positions
    cache["pos"] = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return unembed(params, cfg, x[:, -1:]), cache


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict[str, Any], window: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens (B, 1): one autoregressive step over the cache (updated in
    place). Returns logits (B, 1, V) and the cache."""
    b = tokens.shape[0]
    x = embed_inputs(params, cfg, tokens)
    positions = cache["pos"][:, None]                       # (B, 1)
    size = cache["k"].shape[2]
    cache_positions = positions % size
    eff_window = cfg.sliding_window if window is None else window
    kpos = cache["kpos"]
    bidx = torch.arange(b, device=x.device)[:, None]
    kpos[bidx, cache_positions.long()] = positions        # slot being written
    mask = L.attention_scores_mask(positions, kpos, k_valid=kpos >= 0,
                                   sliding_window=eff_window)
    for i in range(cfg.num_layers):
        x, _ = _layer_apply(cfg, L.layer_params(params, i), x, positions,
                            mask=mask,
                            kv_cache=(cache["k"][i], cache["v"][i]),
                            cache_positions=cache_positions)
    cache = dict(cache)
    cache["pos"] = cache["pos"] + 1
    return unembed(params, cfg, x), cache
