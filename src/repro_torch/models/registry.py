"""Uniform per-architecture API of the serving slice, mirroring the
reference's ``models/registry.py`` for the ``dense``, ``moe`` and
``ssm`` arch types (``moe`` goes through the transformer, as ``dense``
does): ``init_params``, ``init_serve_state``, ``serve_step``,
``prefill`` and ``serve_cache_len``. Other arch types raise until they
are ported.

Entry points take ``device``: ``None`` means CUDA and raises without a
CUDA device. The serve state's tensors are updated in place by
``serve_step`` and ``prefill``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import rwkv6, transformer

PORTED_ARCH_TYPES = ("dense", "moe", "ssm")


def _check(cfg: ModelConfig) -> None:
    if cfg.arch_type not in PORTED_ARCH_TYPES:
        raise NotImplementedError(f"{cfg.name}: arch type {cfg.arch_type!r} "
                                  f"is not ported; ported: "
                                  f"{PORTED_ARCH_TYPES}")


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters with the reference's scales, drawn on ``device``
    by a ``torch.Generator`` seeded with ``seed`` (the numbers differ from
    JAX's; tests convert JAX's parameters instead)."""
    _check(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.arch_type == "ssm":
        return rwkv6.init_lm(cfg, gen, device=dev)
    return transformer.init_lm(cfg, gen, device=dev)


def serve_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Context capacity: VLM caches also hold the image-patch prefix."""
    return seq_len + (cfg.num_patches if cfg.arch_type == "vlm" else 0)


def init_serve_state(cfg: ModelConfig, batch: int, seq_len: int,
                     window: int = 0, device=None) -> Dict[str, Any]:
    _check(cfg)
    dev = resolve_device(device)
    seq_len = serve_cache_len(cfg, seq_len)
    if cfg.arch_type == "ssm":
        return rwkv6.init_state(cfg, batch, device=dev)
    return transformer.init_cache(cfg, batch, seq_len, window=window,
                                  device=dev)


def state_batch_axes(cfg: ModelConfig) -> Dict[str, int]:
    """The batch axis of every field of the serve state."""
    _check(cfg)
    if cfg.arch_type == "ssm":
        return dict(rwkv6.STATE_BATCH_AXIS)
    return dict(transformer.CACHE_BATCH_AXIS)


def serve_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
               state: Dict[str, Any], window: int = 0):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), state)."""
    _check(cfg)
    if cfg.arch_type == "ssm":
        return rwkv6.decode_step(params, cfg, tokens, state)
    return transformer.decode_step(params, cfg, tokens, state,
                                   window=window or None)


def prefill(params: dict, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            state: Dict[str, Any], window: int = 0,
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Prompt processing: (last position's logits (B, 1, V), state).

    For ``ssm`` the prefill is the training-mode forward (the WKV scan
    over the prompt) and the state comes back unchanged, as in the
    reference; its serve launcher rebuilds the state token by token."""
    _check(cfg)
    if cfg.arch_type == "ssm":
        logits, _ = rwkv6.forward_lm(params, cfg, batch["tokens"])
        return logits[:, -1:], state
    return transformer.prefill(params, cfg, batch["tokens"], state,
                               window=window or None)
