"""Zamba2 hybrid: a Mamba2 backbone and one *shared* attention block
applied after every ``hybrid_attn_every`` Mamba2 blocks
[arXiv:2411.15242], mirroring the reference's ``models/zamba2.py``.

The shared block (attention and MLP, one set of weights) is reused at
each site. Over a prompt its attention is causal through the flash
attention kernel, one launch a site; decode attends over a KV cache per
site in plain torch.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.mamba2 import (init_mamba, mamba_mix, mamba_mix_step,
                                       ssm_state_shapes)


def _group_sizes(cfg: ModelConfig) -> List[int]:
    """num_layers Mamba2 blocks in groups of hybrid_attn_every (the last
    one shorter when it does not divide); a shared-attention site follows
    each group: 38 layers in groups of 6 give 7 sites."""
    k = max(cfg.hybrid_attn_every, 1)
    n = cfg.num_layers
    sizes = [k] * (n // k)
    if n % k:
        sizes.append(n % k)
    return sizes


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig,
                     device=None) -> dict:
    dt = cfg.torch_dtype
    return {"ln": torch.zeros((cfg.d_model,), dtype=dt, device=device),
            "mamba": init_mamba(gen, cfg, dt, device)}


def init_lm(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    dt = cfg.torch_dtype
    kw = dict(dtype=dt, device=device)
    shared = {
        "ln1": torch.zeros((cfg.d_model,), **kw),
        "ln2": torch.zeros((cfg.d_model,), **kw),
        "attn": L.init_attention(gen, cfg.d_model, cfg.num_heads,
                                 cfg.num_kv_heads, cfg.resolved_head_dim,
                                 cfg.qkv_bias, dt, device=device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, dt, device=device),
    }
    return {
        "embed": L.embed_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                              device=device),
        "mamba_layers": L.stack_layers(
            lambda: init_mamba_block(gen, cfg, device), cfg.num_layers),
        "shared": shared,
        "final_norm": torch.zeros((cfg.d_model,), **kw),
        "lm_head": L.dense_init(gen, (cfg.d_model, cfg.vocab_size), **kw),
    }


def _shared_attn(params: dict, cfg: ModelConfig, x, positions, mask=None,
                 kv_cache=None, cache_positions=None):
    sp = params["shared"]
    x = x + L.attention_block(
        sp["attn"], L.rms_norm(x, sp["ln1"], cfg.norm_eps),
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        positions=positions, mask=mask, kv_cache=kv_cache,
        cache_positions=cache_positions)
    return x + L.mlp_block(sp["mlp"], L.rms_norm(x, sp["ln2"], cfg.norm_eps))


def _mamba_layer(lp: dict, cfg: ModelConfig, x: torch.Tensor
                 ) -> torch.Tensor:
    out, _, _ = mamba_mix(lp["mamba"], L.rms_norm(x, lp["ln"], cfg.norm_eps),
                          cfg)
    return x + out


def forward_lm(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
               remat: bool = False, unroll: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/prefill forward: (logits (B, S, V), aux loss 0). The
    shared attention is causal over the S positions (B4, one launch a
    site). ``remat`` checkpoints each Mamba2 block, as the reference's
    checkpoints its Mamba2 scan body; ``unroll`` changes nothing."""
    del unroll
    x = params["embed"][tokens.long()]
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    layer = 0
    for gsize in _group_sizes(cfg):
        for _ in range(gsize):
            x = L.remat_call(remat, _mamba_layer,
                             L.layer_params(params, layer, "mamba_layers"),
                             cfg, x)
            layer += 1
        x = _shared_attn(params, cfg, x, positions)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"], torch.zeros((), dtype=torch.float32,
                                              device=x.device)


# ---------------------------------------------------------------------------
# decode: Mamba2 states per layer and a KV cache per shared-attention site


def init_state(cfg: ModelConfig, batch: int, max_len: int, window: int = 0,
               device=None) -> Dict[str, Any]:
    ssm_shape, conv_shape = ssm_state_shapes(cfg, batch)
    n_sites = len(_group_sizes(cfg))
    size = min(max_len, window) if window else max_len
    kv_shape = (n_sites, batch, size, cfg.num_kv_heads,
                cfg.resolved_head_dim)
    dt = cfg.torch_dtype
    return {
        "ssm": torch.zeros((cfg.num_layers,) + ssm_shape,
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.num_layers,) + conv_shape, dtype=dt,
                            device=device),
        "k": torch.zeros(kv_shape, dtype=dt, device=device),
        "v": torch.zeros(kv_shape, dtype=dt, device=device),
        "kpos": torch.full((batch, size), -1, dtype=torch.int32,
                           device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


# the batch axis of every state field (the serving engine resets a slot
# along it)
STATE_BATCH_AXIS = {"ssm": 1, "conv": 1, "k": 1, "v": 1, "kpos": 0,
                    "pos": 0}


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                state: Dict[str, Any], window: int = 0
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens (B, 1) -> (logits (B, 1, V), state). The state's tensors are
    updated in place (the reference returns new ones)."""
    b = tokens.shape[0]
    x = params["embed"][tokens[:, 0].long()]
    positions = state["pos"][:, None]
    size = state["k"].shape[2]
    cache_positions = positions % size
    kpos = state["kpos"]
    bidx = torch.arange(b, device=x.device)[:, None]
    kpos[bidx, cache_positions.long()] = positions         # slot being written
    mask = L.attention_scores_mask(positions, kpos, k_valid=kpos >= 0,
                                   sliding_window=window)
    layer = 0
    for site, gsize in enumerate(_group_sizes(cfg)):
        for _ in range(gsize):
            lp = L.layer_params(params, layer, "mamba_layers")
            out, ssm, conv = mamba_mix_step(
                lp["mamba"], L.rms_norm(x, lp["ln"], cfg.norm_eps), cfg,
                state["ssm"][layer], state["conv"][layer])
            state["ssm"][layer] = ssm
            state["conv"][layer] = conv
            x = x + out
            layer += 1
        x = _shared_attn(params, cfg, x[:, None], positions, mask,
                         kv_cache=(state["k"][site], state["v"][site]),
                         cache_positions=cache_positions)[:, 0]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    new_state = dict(state)
    new_state["pos"] = state["pos"] + 1
    return (x @ params["lm_head"])[:, None], new_state
