"""Launch wrappers of the CUDA flash attention, forward
(``csrc/flash_attention.cu``) and backward (``csrc/flash_attention_bwd.cu``):
checks, allocates, launches, counts.

q, k and v come in as strided views, so the model's (B, S, H, D) tensors
are passed transposed without a copy; the outputs are allocated in the
model's layout and returned as their (B, H, S, D) views."""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (count_launch, raise_on_error,
                                        raw_stream, view_strides)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
HEAD_DIMS = (64, 128)        # the reduced configs and qwen2-1.5b
STRIDE_ALIGN = 8             # elements: TMA takes 16-byte strides
_ENTRY = {torch.float32: "flash_attention_f32_launch",
          torch.bfloat16: "flash_attention_bf16_launch"}
_Strides = ctypes.c_longlong * 9
_BWD_ENTRY = {torch.float32: "flash_attention_bwd_f32_launch",
              torch.bfloat16: "flash_attention_bwd_bf16_launch"}
_BwdStrides = ctypes.c_longlong * 15


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    fn = getattr(_build.load("flash_attention"), _ENTRY[dtype])
    fn.argtypes = [_P] * 5 + [_I] * 7 + [_F, _P]
    fn.restype = _I
    return fn


def wgmma_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one block of the bf16 kernel at head dim
    ``d``, as it launches (q tile, two stages of K and V, barriers,
    alignment)."""
    fn = _build.load("flash_attention").flash_attention_bf16_smem
    fn.argtypes = [_I]
    fn.restype = _I
    return fn(d)


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = True,
                           window: int = 0, sm_scale: float = 0.0
                           ) -> torch.Tensor:
    """q (B, H, S, D); k, v (B, KV, S, D) views, float32 or bfloat16 (one
    dtype), on one CUDA device, 16-byte aligned, with strides as
    ``common.view_strides`` takes them at ``STRIDE_ALIGN``; H % KV == 0,
    D in ``HEAD_DIMS`` -> out (B, H, S, D), the transposed view of a
    contiguous (B, S, H, D) tensor. One launch for all (batch, head,
    query tile). bfloat16 runs the tensor-core kernel, float32 the scalar
    kernel."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    if q.dtype not in _ENTRY:
        raise TypeError(f"q: dtype {q.dtype}, expected one of "
                        f"{list(_ENTRY)}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {q.dtype}")
    if tuple(k.shape) != (b, kv, s, d) or tuple(v.shape) != (b, kv, s, d):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if h % kv:
        raise ValueError(f"{h} query heads do not split over {kv} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the grid's 65535")
    named = (("q", q), ("k", k), ("v", v))
    strides = [st for name, t in named for st in view_strides(t, name, STRIDE_ALIGN)]
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data pointer not 16-byte aligned")
        if not t.is_cuda:
            raise ValueError(f"{name}: on {t.device}, expected CUDA")
    if sm_scale == 0.0:
        sm_scale = 1.0 / math.sqrt(d)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    code = _fn(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), _Strides(*strides), b, h, kv, s, d,
                        int(causal), int(window), sm_scale,
                        torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error(code, "flash_attention")
    count_launch("flash_attention")
    return out.transpose(1, 2)


@functools.lru_cache(maxsize=None)
def _bwd_fn(dtype: torch.dtype):
    fn = getattr(_build.load("flash_attention_bwd"), _BWD_ENTRY[dtype])
    fn.argtypes = [_P] * 13 + [_I] * 7 + [_F, _P]
    fn.restype = _I
    return fn


def flash_attention_bwd_kernel(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, o: torch.Tensor,
                               do: torch.Tensor, causal: bool = True,
                               window: int = 0, sm_scale: float = 0.0
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """The gradients of ``flash_attention_kernel``: q, o (its output) and
    do (the output's gradient) (B, H, S, D), k, v (B, KV, S, D) views in
    one dtype, float32 or bfloat16, on one CUDA device, each with a
    unit-stride last dim; H % KV == 0, D in ``HEAD_DIMS`` -> dq (B, H, S,
    D), dk and dv (B, KV, S, D), the transposed views of contiguous
    (B, S, H, D) and (B, S, KV, D) tensors in the inputs' dtype. One call,
    three launches: dQ with each row's logsumexp and rowsum(dO o O), each
    query head's share of dK and dV, their sum over each group."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    if q.dtype not in _BWD_ENTRY:
        raise TypeError(f"q: dtype {q.dtype}, expected one of "
                        f"{list(_BWD_ENTRY)}")
    named = (("q", q, (b, h, s, d)), ("k", k, (b, kv, s, d)),
             ("v", v, (b, kv, s, d)), ("o", o, (b, h, s, d)),
             ("do", do, (b, h, s, d)))
    for name, t, shape in named:
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {q.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, expected {q.device} "
                             f"(CUDA)")
    if h % kv:
        raise ValueError(f"{h} query heads do not split over {kv} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} exceed the grid's 65535")
    strides = [st for name, t, _ in named
               for st in view_strides(t, name, 1)]
    if sm_scale == 0.0:
        sm_scale = 1.0 / math.sqrt(d)
    f32 = torch.float32
    lse = torch.empty((b, h, s), dtype=f32, device=q.device)
    delta = torch.empty((b, h, s), dtype=f32, device=q.device)
    shares = torch.empty((2, b, s, h, d), dtype=f32, device=q.device)
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, kv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, s, kv, d), dtype=q.dtype, device=q.device)
    code = _bwd_fn(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), do.data_ptr(), dq.data_ptr(),
                            dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
                            delta.data_ptr(), shares[0].data_ptr(),
                            shares[1].data_ptr(), _BwdStrides(*strides), b,
                            h, kv, s, d, int(causal), int(window), sm_scale,
                            raw_stream(q))
    raise_on_error(code, "flash_attention_bwd")
    count_launch("flash_attention_bwd")
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)
