"""Counter-based random numbers, bit-compatible with ``jax.random``.

The simulator is defined by its draw schedule (``repro_torch.sim.draws``):
every random quantity is addressed by ``(seed, t, tag)`` through
threefry2x32 keys, never by a sequential generator. This module is that
generator in PyTorch, matching jax 0.9.0 with
``jax_threefry_partitionable`` on (its default):

  * a key is an int64 tensor ``(..., 2)`` holding two uint32 words;
  * ``fold_in(key, d)`` and the ``i``-th key of ``split`` are
    ``threefry2x32(key, (0, d))`` and ``threefry2x32(key, (0, i))``;
  * the 32 random bits at flat index ``i`` of ``bits(key, shape)`` are
    ``o1 ^ o2`` with ``(o1, o2) = threefry2x32(key, (0, i))``.

Words are kept in int64 tensors masked to 32 bits, so the integer
arithmetic is exact and identical on CPU and CUDA. Keys may carry leading
batch dimensions (the seed axis): every draw then has shape
``key.shape[:-1] + shape``.

``normal`` ports XLA's float32 ``erf_inv`` polynomial literally;
``exponential`` is ``-log1p(-u)``. Both use PyTorch's ``log1p``, which is
not XLA's: the remaining gap is a few ulp (tests state the bound).
``gumbel`` is ``-log(-log(u))`` with PyTorch's ``log``, within a few ulp
of ``max(1, |g|)`` likewise. ``permutation`` is exact: it sorts by random
32-bit keys with a stable sort, as jax's ``_shuffle``.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.core.fmath import sqrt_rn

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds on int64 tensors holding uint32 words
    (all four arguments broadcast). Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + k1) & MASK
    b = (x2 + k2) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def _words(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK


def PRNGKey(seed, device=None) -> torch.Tensor:
    """Key ``(0, seed)`` for a non-negative int or an int tensor of seeds
    (the result then has the seeds' shape plus a trailing 2)."""
    s = _words(seed, device)
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def _hash(key: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    k1, k2 = key[..., 0], key[..., 1]
    o1, o2 = threefry2x32(k1, k2, torch.zeros_like(counter), counter)
    return torch.stack([o1, o2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``data`` is an int or an int tensor that
    broadcasts against the key's batch shape."""
    return _hash(key, _words(data, key.device))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., num, 2)`` keys."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    return _hash(key[..., None, :], i)


def _shape(shape: Union[int, Sequence[int]]) -> tuple:
    return (int(shape),) if isinstance(shape, (int, np.integer)) \
        else tuple(int(s) for s in shape)


def bits(key: torch.Tensor, shape, at: torch.Tensor = None
         ) -> torch.Tensor:
    """``jax.random.bits`` (uint32 words in int64):
    ``key.shape[:-1] + shape``. ``at`` (int64 flat indices into
    ``shape``) evaluates only those words of the stream, in ``at``'s
    shape: counter i is the flat index, so a slice of the draw costs
    only its own words (the sharded engine's rows)."""
    if at is None:
        shape = _shape(shape)
        i = torch.arange(math.prod(shape), dtype=torch.int64,
                         device=key.device)
    else:
        shape, i = tuple(at.shape), at.reshape(-1)
    batch = key.shape[:-1]
    k1 = key[..., 0].reshape(batch + (1,))
    k2 = key[..., 1].reshape(batch + (1,))
    o1, o2 = threefry2x32(k1, k2, torch.zeros_like(i), i)
    return (o1 ^ o2).reshape(batch + shape)


def _unit(key: torch.Tensor, shape, at=None) -> torch.Tensor:
    """Floats in [0, 1) from the top 23 bits, as jax's ``_uniform``."""
    b = (bits(key, shape, at) >> 9) | 0x3F800000
    return b.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0, at: torch.Tensor = None) -> torch.Tensor:
    """``jax.random.uniform`` (float32); ``at`` as in ``bits``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    f = _unit(key, shape, at)
    f = f * float(np.float32(hi - lo)) + float(lo)
    return torch.clamp(f, min=float(lo))


# XLA's ErfInv32 (Giles, "Approximating the erfinv function"): two
# degree-8 polynomials in w = -log1p(-x^2), split at w = 5.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, XLA's polynomial op for op."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt_rn(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], dtype=x.dtype,
                                            device=x.device),
                           torch.tensor(_ERFINV_GE5[i], dtype=x.dtype,
                                        device=x.device))
    p = coef(0)
    for i in range(1, 9):
        p = coef(i) + p * w
    out = p * x
    return torch.where(x.abs() == 1.0, x * torch.inf, out)


def normal(key: torch.Tensor, shape, at: torch.Tensor = None
           ) -> torch.Tensor:
    """``jax.random.normal`` (float32): ``sqrt(2) * erf_inv(u)`` with ``u``
    uniform on ``[nextafter(-1, 0), 1)``; ``at`` as in ``bits``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(key, shape, float(lo), 1.0, at)
    return float(np.float32(np.sqrt(2))) * erf_inv(u)


def exponential(key: torch.Tensor, shape, at: torch.Tensor = None
                ) -> torch.Tensor:
    """``jax.random.exponential`` (float32): ``-log1p(-u)``; ``at`` as
    in ``bits``."""
    return -torch.log1p(-uniform(key, shape, at=at))


def randint(key: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint`` (int32) on 32-bit words. ``minval``/
    ``maxval`` are ints or int tensors broadcasting against
    ``key.shape[:-1] + (1,) * len(shape)``."""
    shape = _shape(shape)
    dev = key.device
    ks = split(key)
    hi_bits = bits(ks[..., 0, :], shape)
    lo_bits = bits(ks[..., 1, :], shape)
    lo = torch.as_tensor(minval, dtype=torch.int64, device=dev)
    hi = torch.as_tensor(maxval, dtype=torch.int64, device=dev)
    span = (hi - lo) & MASK
    span = torch.where(hi <= lo, torch.ones_like(span), span)
    mult = (2 ** 16) % span
    mult = (mult * mult) % span
    off = (((hi_bits % span) * mult) & MASK) + (lo_bits % span)
    off = (off & MASK) % span
    return (lo + off).to(torch.int32)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` (float32, ``mode="low"``):
    ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)``."""
    tiny = float(np.finfo(np.float32).tiny)
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0)))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (int32, ``key.shape[:-1] +
    (n,)``): ``ceil(3 ln n / ln(2^32 - 1))`` rounds, each a fresh
    ``split`` and a stable ascending sort of ``arange(n)`` by 32 random
    bits a position."""
    n = int(n)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int32, device=key.device).expand(
        key.shape[:-1] + (n,))
    for _ in range(rounds):
        ks = split(key)
        key, sub = ks[..., 0, :], ks[..., 1, :]
        order = torch.sort(bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x.contiguous()
