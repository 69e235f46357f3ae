"""Device and kernel routing for the port, and the kernels' launch counts.

The rule, one for every kernel wrapper:

  * a tensor on the CPU takes the kernel's plain PyTorch version (its
    ``ref.py``);
  * a tensor on a CUDA device launches the hand-written kernel, or the
    wrapper raises. Nothing falls back from CUDA to the plain version.

Each wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel
and nowhere else, so a run can show that its main path went through the
kernels (``chip_smoke.py`` resets the counts, drives the path, reads
them).

Entry points take an explicit ``device``: ``None`` means CUDA, and raises
when there is no CUDA device instead of falling back to the CPU.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

LAUNCHES: Dict[str, int] = {"context_pairwise": 0, "budgeted_topk": 0,
                            "masked_aggregate": 0, "flash_attention": 0,
                            "rwkv6_scan": 0, "moe_router": 0,
                            "random_assign": 0, "flgreedy_walk": 0,
                            "density_sort_tiles": 0, "segment_walk": 0,
                            "flash_attention_bwd": 0, "rwkv6_scan_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def resolve_device(device: Optional[Union[str, torch.device]]
                   ) -> torch.device:
    """``None`` -> the current CUDA device; raises without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def on_cuda(first: torch.Tensor, *rest: torch.Tensor) -> bool:
    """True when the kernel must launch. All tensors share one device."""
    for t in rest:
        if t.device != first.device:
            raise ValueError(f"tensors on {first.device} and {t.device}")
    return first.is_cuda


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
          cuda: bool = True) -> None:
    """Wrapper-side contract of a kernel argument; ``cuda=False`` leaves
    the device to a later check."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if cuda and not t.is_cuda:
        raise ValueError(f"{name}: on {t.device}, expected CUDA")


def view_strides(t: torch.Tensor, name: str, align: int
                 ) -> Tuple[int, int, int]:
    """Element strides over the three leading dims of a 4-d view a kernel
    can read: unit-stride last dim, the other strides positive multiples
    of ``align``. A dim of size 1 is never stepped, so its stride is
    reported as ``align`` whatever the view says."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: last dim has stride {t.stride(-1)}, "
                         f"expected 1")
    out = []
    for dim in range(3):
        st = t.stride(dim) if t.shape[dim] > 1 else align
        if st % align or st <= 0:
            raise ValueError(f"{name}: stride {st} of dim {dim} is not a "
                             f"positive multiple of {align}")
        out.append(st)
    return tuple(out)


def raw_stream(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream of ``t``'s device, as a C
    launcher takes it: ``torch.cuda.current_stream(dev).cuda_stream``
    without building a ``Stream`` object on every call."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def raise_on_error(code: int, name: str) -> None:
    """The C entry points return ``cudaGetLastError()`` after launch."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {code}")
