"""Float32 primitives that reproduce how the reference's arithmetic is
actually executed.

The reference runs its simulator, policy and training step under
``jax.jit`` on the CPU, and XLA rewrites the float32 arithmetic it was
given. Measured against jax 0.9.0 (``tests/test_torch_sim.py``,
``tests/test_torch_context_pairwise.py`` pin the results):

  * a multiply feeding an add is contracted into one fused
    multiply-add (``fma``): ``1 + jitter * n``, ``pos + mobility * move``,
    ``dx * dx + dy * dy``, ``est + 0.35 * sqrt(...)``;
  * a division by a constant becomes a multiplication by the float32
    reciprocal (``mul_rcp``): ``x / 1e6``, ``rate / rate_hi``,
    ``log1p(snr) / log(2)``;
  * constant factors are folded: ``37.6 * (log(d) * (1/ln 10))`` is
    ``log(d) * float32(37.6 * (1/ln 10))``.

Context binning (``floor(ctx * h)``), the Eq. 6 deadline test and the
density greedy turn one ulp into a different decision, so the port
writes these forms out. Two more PyTorch habits are pinned here:

  * CPU ``torch.sqrt`` is not correctly rounded on every input; XLA's
    is. ``sqrt_rn`` takes the root in float64 and rounds once.
  * ``10 ** x``: ``pow10_rn`` rounds the float64 power (XLA's float32
    power agrees on all but ~0.06% of inputs, by one ulp).

``fma`` is correctly rounded, as ``__fmaf_rn`` (which the CUDA kernel
uses at the same places) and XLA's contraction are: the product of two
float32 numbers is exact in float64, the float64 sum is rounded to odd
(its exact residual decides), and rounding that to float32 is then the
one rounding of the exact ``a * b + c``. Division is always a tensor division:
``tensor / python_float`` on CUDA is a reciprocal multiply of PyTorch's
own, and ``python_float / tensor`` is ``tensor.reciprocal() * float``.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

Num = Union[float, torch.Tensor]


def f32(c: float) -> float:
    """A Python float rounded to float32 (as XLA's weak-typed constants)."""
    return float(np.float32(c))


def rcp(c: float) -> float:
    """The float32 reciprocal of a float32 constant."""
    return float(np.float32(1.0 / np.float64(np.float32(c))))


def fold(c1: float, c2: float) -> float:
    """Two float32 constants multiplied in float32."""
    return float(np.float32(np.float64(np.float32(c1))
                            * np.float64(np.float32(c2))))


def _d(x: Num, like: torch.Tensor) -> Num:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return f32(x)


def fma(a: Num, b: Num, c: Num) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding."""
    like = next(t for t in (a, b, c) if isinstance(t, torch.Tensor))
    as64 = lambda x: torch.as_tensor(_d(x, like), dtype=torch.float64,
                                     device=like.device)
    p, c = as64(a) * as64(b), as64(c)     # p is exact
    s = p + c
    # TwoSum: the exact residual of the float64 sum. Where it is not 0
    # and s is even, step s toward the exact sum (round to odd), so that
    # s never sits on a float32 tie the exact sum is not on.
    v = s - p
    err = (p - (s - v)) + (c - v)
    even = (s.view(torch.int64) & 1) == 0
    step = torch.isfinite(err) & (err != 0) & even
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s)
    return torch.where(step, torch.nextafter(s, toward), s).to(
        torch.float32)


def mul_rcp(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant ``c``, as XLA computes it."""
    return x * rcp(c)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).to(x.dtype)


def pow10_rn(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, x.double()).to(x.dtype)


def rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """IEEE ``c / x`` for a constant numerator."""
    return torch.tensor(c, dtype=x.dtype, device=x.device) / x
