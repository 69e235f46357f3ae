"""Uniform per-architecture API, mirroring the reference's
``models/registry.py`` for its six arch types: ``init_params``,
``train_loss`` (next-token cross-entropy, per-example weights, the MoE
aux loss), ``supports_shape``, ``make_concrete_batch``,
``init_serve_state``, ``state_batch_axes``, ``serve_step``, ``prefill``,
``serve_cache_len``, and ``input_specs``/``serve_specs`` (shapes and
dtypes as tensors on the ``meta`` device, nothing allocated). ``dense``,
``moe`` and ``vlm`` go through the transformer, ``ssm`` through RWKV6,
``hybrid`` through Zamba2 and ``audio`` through the encoder-decoder.

Entry points take ``device``: ``None`` means CUDA and raises without a
CUDA device. The serve state's tensors are updated in place by
``serve_step`` and ``prefill``.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ARCH_TYPES, InputShape, ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import encdec, rwkv6, transformer, zamba2

# sliding window used by the long-context serving mode of full-attention
# archs
LONG_CONTEXT_WINDOW = 8192

log = logging.getLogger(__name__)


def _check(cfg: ModelConfig) -> None:
    if cfg.arch_type not in ARCH_TYPES:
        raise ValueError(f"{cfg.name}: unknown arch type "
                         f"{cfg.arch_type!r}; known: {ARCH_TYPES}")


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters with the reference's scales, drawn on ``device``
    by a ``torch.Generator`` seeded with ``seed`` (the numbers differ from
    JAX's; tests convert JAX's parameters instead)."""
    _check(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.arch_type == "ssm":
        return rwkv6.init_lm(cfg, gen, device=dev)
    if cfg.arch_type == "hybrid":
        return zamba2.init_lm(cfg, gen, device=dev)
    if cfg.arch_type == "audio":
        return encdec.init_model(cfg, gen, device=dev)
    return transformer.init_lm(cfg, gen, device=dev)  # dense / moe / vlm


def supports_shape(cfg: ModelConfig, shape: InputShape) -> bool:
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True


# ---------------------------------------------------------------------------
# training


def _xent(logits: torch.Tensor, labels: torch.Tensor,
          weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy in float32; ``weights`` (B,)
    reweight the examples (HFL participation masking: dropped cohorts
    contribute zero)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    per_ex = torch.mean(logz - gold, dim=-1)            # (B,)
    if weights is None:
        return torch.mean(per_ex)
    w = weights.to(torch.float32)
    return torch.sum(per_ex * w) / torch.clamp(torch.sum(w), min=1.0)


def train_loss(params: dict, cfg: ModelConfig,
               batch: Dict[str, torch.Tensor], remat: bool = False,
               weights: Optional[torch.Tensor] = None,
               unroll: bool = False) -> torch.Tensor:
    """The training loss, a float32 scalar: batch holds ``tokens`` and
    ``labels`` (B, S), with ``frames`` for ``audio`` and ``patches`` for
    ``vlm`` (whose loss covers the text positions only); the MoE layers'
    load-balance loss enters with weight 0.01. ``remat`` checkpoints each
    layer; ``unroll`` changes nothing (the reference's scan option)."""
    _check(cfg)
    kw = dict(remat=remat, unroll=unroll)
    if cfg.arch_type == "ssm":
        logits, aux = rwkv6.forward_lm(params, cfg, batch["tokens"], **kw)
    elif cfg.arch_type == "hybrid":
        logits, aux = zamba2.forward_lm(params, cfg, batch["tokens"], **kw)
    elif cfg.arch_type == "audio":
        logits, aux = encdec.forward(params, cfg, batch["frames"],
                                     batch["tokens"], unroll=unroll)
    elif cfg.arch_type == "vlm":
        logits, aux = transformer.forward_lm(
            params, cfg, batch["tokens"], patch_embeds=batch["patches"], **kw)
        logits = logits[:, cfg.num_patches:]   # loss on text positions only
    else:
        logits, aux = transformer.forward_lm(params, cfg, batch["tokens"],
                                             **kw)
    return _xent(logits, batch["labels"], weights) + 0.01 * aux


def serve_window(cfg: ModelConfig, shape: InputShape) -> int:
    """Ring-buffer window for attention KV caches under this input shape."""
    if shape.name != "long_500k":
        return 0
    return cfg.sliding_window or LONG_CONTEXT_WINDOW


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
    if cfg.arch_type == "hybrid":
        return zamba2.init_state(cfg, batch, seq_len, window=window,
                                 device=dev)
    if cfg.arch_type == "audio":
        return encdec.init_cache(cfg, batch, seq_len, device=dev)
    return transformer.init_cache(cfg, batch, seq_len, window=window,
                                  device=dev)


def state_batch_axes(cfg: ModelConfig) -> Dict[str, int]:
    """The batch axis of every field of the serve state."""
    _check(cfg)
    if cfg.arch_type == "ssm":
        return dict(rwkv6.STATE_BATCH_AXIS)
    if cfg.arch_type == "hybrid":
        return dict(zamba2.STATE_BATCH_AXIS)
    if cfg.arch_type == "audio":
        return dict(encdec.CACHE_BATCH_AXIS)
    return dict(transformer.CACHE_BATCH_AXIS)


def serve_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
               state: Dict[str, Any], window: int = 0):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), state)."""
    _check(cfg)
    if cfg.arch_type == "ssm":
        return rwkv6.decode_step(params, cfg, tokens, state)
    if cfg.arch_type == "hybrid":
        return zamba2.decode_step(params, cfg, tokens, state, window=window)
    if cfg.arch_type == "audio":
        return encdec.decode_step(params, cfg, tokens, state)
    return transformer.decode_step(params, cfg, tokens, state,
                                   window=window or None)


def prefill(params: dict, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            state: Dict[str, Any], window: int = 0,
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Prompt processing: (last position's logits (B, 1, V), state).
    ``batch`` holds ``tokens`` (B, S), with ``frames`` (B, F, d) for
    ``audio`` and ``patches`` (B, P, d) for ``vlm``.

    For ``ssm`` and ``hybrid`` the prefill is the training-mode forward
    (the WKV scan, or the Mamba2 chunked form and the shared attention,
    over the prompt) and the state comes back unchanged, as in the
    reference; its serve launcher rebuilds the state token by token.

    For ``audio`` the frames are encoded once: the output goes into the
    state's ``enc_out`` and feeds the decoder's forward over the prompt
    (the reference encodes them twice, the same function). As in the
    reference (R13), the decoder's self-attention cache is left empty and
    ``pos`` at 0, so decoding starts at position 0 and never attends to
    the prompt; this is logged, not fixed."""
    _check(cfg)
    if cfg.arch_type in ("ssm", "hybrid"):
        mod = rwkv6 if cfg.arch_type == "ssm" else zamba2
        logits, _ = mod.forward_lm(params, cfg, batch["tokens"])
        return logits[:, -1:], state
    if cfg.arch_type == "audio":
        enc_out = encdec.encode(params, cfg, batch["frames"])
        state = encdec.start_serving(params, cfg, batch["frames"], state,
                                     enc_out=enc_out)
        logits, _ = encdec.forward(params, cfg, batch["frames"],
                                   batch["tokens"], enc_out=enc_out)
        log.warning("%s prefill: the decoder's self-attention cache is left "
                    "empty and pos at 0, as in the reference (R13); decoding "
                    "starts at position 0 without the prompt", cfg.name)
        return logits[:, -1:], state
    return transformer.prefill(params, cfg, batch["tokens"], state,
                               window=window or None,
                               patch_embeds=batch.get("patches"))


# ---------------------------------------------------------------------------
# input specs: shapes and dtypes as ``meta`` tensors (nothing allocated)


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Training / prefill batch specs."""
    b, s = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    specs = {"tokens": torch.empty((b, s), dtype=torch.int32, device=meta)}
    if shape.kind == "train":
        specs["labels"] = torch.empty((b, s), dtype=torch.int32, device=meta)
    if cfg.arch_type == "audio":
        specs["frames"] = torch.empty((b, cfg.num_frames, cfg.d_model),
                                      dtype=cfg.torch_dtype, device=meta)
    if cfg.arch_type == "vlm":
        specs["patches"] = torch.empty((b, cfg.num_patches, cfg.d_model),
                                       dtype=cfg.torch_dtype, device=meta)
    return specs


def serve_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Decode-step specs: one token and a seq_len cache or state."""
    b = shape.global_batch
    state = init_serve_state(cfg, b, shape.seq_len,
                             window=serve_window(cfg, shape), device="meta")
    return {"tokens": torch.empty((b, 1), dtype=torch.int32, device="meta"),
            "state": state}


def make_concrete_batch(cfg: ModelConfig, shape: InputShape, seed: int = 0,
                        device=None) -> Dict[str, torch.Tensor]:
    """A real batch of ``input_specs``' shapes on ``device``: token ids
    uniform in [0, vocab), embeddings N(0, 1) in the config
    dtype, drawn in spec order by a ``torch.Generator`` seeded with
    ``seed`` (the numbers differ from the reference's JAX draws)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, spec in input_specs(cfg, shape).items():
        if spec.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, tuple(spec.shape), generator=gen,
                                      device=dev, dtype=torch.int32)
        else:
            out[name] = torch.randn(tuple(spec.shape), generator=gen,
                                    device=dev).to(spec.dtype)
    return out
