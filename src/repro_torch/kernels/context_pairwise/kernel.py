"""Launch wrapper of the CUDA context_pairwise kernel
(``csrc/context_pairwise.cu``): checks, allocates, launches, counts.

The main path calls it once a round and the host sets that path's pace,
so the call is kept light: one allocation for the four outputs, the
spec's float32 constants made once per distinct spec, the stream's raw
handle, and a short argument list."""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (check, count_launch,
                                        raise_on_error, raw_stream)
from repro_torch.kernels.context_pairwise.ref import (NEG_TENTH, PL_ICPT,
                                                      PL_SLOPE, RCP_LN2,
                                                      PairwiseContext)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("context_pairwise").context_pairwise_launch
    fn.argtypes = [_P] * 7 + [_I] * 3 + [_P, _I, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=64)
def _consts(tx_w, noise_psd_w, update_bits, workload):
    """The kernel's eight float32 constants in host memory, and their
    address; the physics scalars rounded to float32, as the reference's
    weak-typed Python floats are. Cached, so the array outlives every
    launch that reads it."""
    arr = (ctypes.c_float * 8)(*np.float32(
        [tx_w, noise_psd_w, update_bits, workload, PL_SLOPE, PL_ICPT,
         NEG_TENTH, RCP_LN2]).tolist())
    return arr, ctypes.addressof(arr)


def index_bits(s: int, n: int, m: int) -> int:
    """32 where every flat (seed, client, ES) index fits a signed 32-bit
    int, else 64: the kernel instantiation the wrapper launches."""
    return 32 if s * n * m < 2 ** 31 else 64


def context_pairwise_kernel(pos, es, bandwidth, compute, fad_dt, fad_ut, *,
                            tx_w, noise_psd_w, update_bits, workload
                            ) -> PairwiseContext:
    """Seed-batched launch: pos (S, N, 2), es (M, 2), bandwidth/compute
    (S, N), fad_dt/fad_ut (S, N, M), all float32 on one CUDA device.
    The four outputs are contiguous planes of one (4, S, N, M) buffer."""
    s, n, m = fad_dt.shape
    f32 = torch.float32
    check(pos, "pos", f32, (s, n, 2))
    check(es, "es", f32, (m, 2))
    check(bandwidth, "bandwidth", f32, (s, n))
    check(compute, "compute", f32, (s, n))
    check(fad_dt, "fad_dt", f32, (s, n, m))
    check(fad_ut, "fad_ut", f32, (s, n, m))
    out = pos.new_empty((4, s, n, m))
    code = _fn()(pos.data_ptr(), es.data_ptr(), bandwidth.data_ptr(),
                 compute.data_ptr(), fad_dt.data_ptr(), fad_ut.data_ptr(),
                 out.data_ptr(), s, n, m,
                 _consts(tx_w, noise_psd_w, update_bits, workload)[1],
                 index_bits(s, n, m) == 64, raw_stream(pos))
    raise_on_error(code, "context_pairwise")
    count_launch("context_pairwise")
    return PairwiseContext(*out.unbind(0))
