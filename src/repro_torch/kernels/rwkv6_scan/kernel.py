"""Launch wrappers of the CUDA RWKV6 WKV scan, forward
(``csrc/rwkv6_scan.cu``) and backward (``csrc/rwkv6_scan_bwd.cu``):
checks, allocates, launches, counts.

r, k, v and log_w come in as strided views, so the model's (B, T, H, 64)
tensors are passed transposed without a copy; y is allocated in the
model's layout and returned as its (B, H, T, 64) view. bfloat16 r/k/v run
the chunked tensor-core kernel, float32 the sequential kernel."""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (check, count_launch,
                                        raise_on_error, raw_stream,
                                        view_strides)

_P, _I = ctypes.c_void_p, ctypes.c_int
HEAD_DIM = 64
TMA_ALIGN = 16               # bytes: TMA's base pointers and strides
_ENTRY = {torch.float32: "rwkv6_scan_f32_launch",
          torch.bfloat16: "rwkv6_scan_bf16_launch"}
_Strides = ctypes.c_longlong * 12
_BWD_ENTRY = {torch.float32: "rwkv6_scan_bwd_f32_launch",
              torch.bfloat16: "rwkv6_scan_bwd_bf16_launch"}
_BwdStrides = ctypes.c_longlong * 15
CHECKPOINT = 64              # the backward's checkpoint interval (steps)


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    fn = getattr(_build.load("rwkv6_scan"), _ENTRY[dtype])
    fn.argtypes = [_P] * 8 + [_I] * 5 + [_P]
    fn.restype = _I
    return fn


def chunked_smem_bytes() -> int:
    """Dynamic shared memory of one block of the bf16 kernel, as it
    launches (two stages of r, k, v and log_w, the decays, the scores and
    two state buffers)."""
    fn = _build.load("rwkv6_scan").rwkv6_scan_bf16_smem
    fn.argtypes = []
    fn.restype = _I
    return fn()


def rwkv6_scan_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_w: torch.Tensor, u: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v (B, H, T, 64) views in float32 or bfloat16 (one dtype),
    log_w (B, H, T, 64) view and u (H, 64) contiguous, float32, on one
    CUDA device; the views' last dim unit-stride, and in bfloat16 (read
    through TMA) their other strides and base pointers 16-byte aligned ->
    y (B, H, T, 64), the transposed view of a contiguous (B, T, H, 64)
    tensor, and the final state (B, H, 64, 64), float32. One launch, one
    block per (batch, head)."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    if r.dtype not in _ENTRY:
        raise TypeError(f"r: dtype {r.dtype}, expected one of "
                        f"{list(_ENTRY)}")
    if dk != HEAD_DIM or dv != HEAD_DIM:
        raise ValueError(f"head dims ({dk}, {dv}); the kernel takes "
                         f"({HEAD_DIM}, {HEAD_DIM})")
    named = (("r", r, r.dtype), ("k", k, r.dtype), ("v", v, r.dtype),
             ("log_w", log_w, torch.float32))
    tma = r.dtype == torch.bfloat16
    strides = []
    for name, x, dtype in named:
        if not x.is_cuda:
            raise ValueError(f"{name}: on {x.device}, expected CUDA")
        if x.dtype != dtype:
            raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
        if tuple(x.shape) != (b, h, t, HEAD_DIM):
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                             f"{(b, h, t, HEAD_DIM)}")
        if tma and x.data_ptr() % TMA_ALIGN:
            raise ValueError(f"{name}: data pointer not {TMA_ALIGN}-byte "
                             f"aligned")
        strides += view_strides(
            x, name, TMA_ALIGN // x.element_size() if tma else 1)
    check(u, "u", torch.float32, (h, dk))
    y = torch.empty((b, t, h, dv), dtype=torch.float32, device=r.device)
    fin = torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)
    code = _fn(r.dtype)(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        log_w.data_ptr(), u.data_ptr(), y.data_ptr(),
                        fin.data_ptr(), _Strides(*strides), b, h, t, dk, dv,
                        torch.cuda.current_stream(r.device).cuda_stream)
    raise_on_error(code, "rwkv6_scan")
    count_launch("rwkv6_scan")
    return y.transpose(1, 2), fin


@functools.lru_cache(maxsize=None)
def _bwd_fn(dtype: torch.dtype):
    fn = getattr(_build.load("rwkv6_scan_bwd"), _BWD_ENTRY[dtype])
    fn.argtypes = [_P] * 16 + [_I] * 3 + [_P]
    fn.restype = _I
    return fn


def rwkv6_scan_bwd_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          log_w: torch.Tensor, u: torch.Tensor,
                          dy: torch.Tensor,
                          dfin: Optional[torch.Tensor] = None):
    """The gradients of ``rwkv6_scan_kernel``: r, k, v (B, H, T, 64) views
    in float32 or bfloat16 (one dtype), log_w and dy (y's gradient) (B, H,
    T, 64) float32 views, each with a unit-stride last dim; u (H, 64) and
    dfin (the final state's gradient, or None for zero) (B, H, 64, 64)
    contiguous float32; all on one CUDA device, T >= 1 -> dr, dk, dv (the
    inputs' dtype) and dlog_w (float32), the (B, H, T, 64) views of
    contiguous (B, T, H, 64) tensors, and du (H, 64) float32. One call,
    two launches: a block per (batch, head) over the steps backwards, its
    states recomputed from checkpoints every ``CHECKPOINT`` steps, then
    du's sum over the batch."""
    b, h, t, dk_ = r.shape
    if r.dtype not in _BWD_ENTRY:
        raise TypeError(f"r: dtype {r.dtype}, expected one of "
                        f"{list(_BWD_ENTRY)}")
    if dk_ != HEAD_DIM:
        raise ValueError(f"head dim {dk_}; the kernel takes {HEAD_DIM}")
    if t < 1:
        raise ValueError("the backward takes T >= 1 steps")
    named = (("r", r, r.dtype), ("k", k, r.dtype), ("v", v, r.dtype),
             ("log_w", log_w, torch.float32), ("dy", dy, torch.float32))
    strides = []
    for name, x, dtype in named:
        if not x.is_cuda or x.device != r.device:
            raise ValueError(f"{name}: on {x.device}, expected {r.device} "
                             f"(CUDA)")
        if x.dtype != dtype:
            raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
        if tuple(x.shape) != (b, h, t, HEAD_DIM):
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                             f"{(b, h, t, HEAD_DIM)}")
        strides += view_strides(x, name, 1)
    check(u, "u", torch.float32, (h, HEAD_DIM))
    if u.device != r.device:
        raise ValueError(f"u: on {u.device}, expected {r.device}")
    if dfin is not None:
        check(dfin, "dfin", torch.float32, (b, h, HEAD_DIM, HEAD_DIM))
        if dfin.device != r.device:
            raise ValueError(f"dfin: on {dfin.device}, expected {r.device}")
    f32, dev = torch.float32, r.device
    state = HEAD_DIM * HEAD_DIM
    nc = -(-t // CHECKPOINT)
    ckpt = torch.empty((b * h * nc * state,), dtype=f32, device=dev)
    buf = torch.empty((b * h * CHECKPOINT * state,), dtype=f32, device=dev)
    du_part = torch.empty((b, h, HEAD_DIM), dtype=f32, device=dev)
    grads = [torch.empty((b, t, h, HEAD_DIM), dtype=dtype, device=dev)
             for dtype in (r.dtype, r.dtype, r.dtype, f32)]
    du = torch.empty((h, HEAD_DIM), dtype=f32, device=dev)
    code = _bwd_fn(r.dtype)(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
        u.data_ptr(), dy.data_ptr(),
        None if dfin is None else dfin.data_ptr(),
        *(g.data_ptr() for g in grads), du.data_ptr(), du_part.data_ptr(),
        ckpt.data_ptr(), buf.data_ptr(), _BwdStrides(*strides), b, h, t,
        raw_stream(r))
    raise_on_error(code, "rwkv6_scan_bwd")
    count_launch("rwkv6_scan_bwd")
    dr, dk, dv, dlw = (g.transpose(1, 2) for g in grads)
    return dr, dk, dv, dlw, du
