"""Launch wrapper of the CUDA context_pairwise kernel
(``csrc/context_pairwise.cu``): checks, allocates, launches, counts."""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (check, count_launch,
                                        raise_on_error)
from repro_torch.kernels.context_pairwise.ref import (NEG_TENTH, PL_ICPT,
                                                      PL_SLOPE, RCP_LN2,
                                                      PairwiseContext)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _fn():
    lib = _build.load("context_pairwise")
    fn = lib.context_pairwise_launch
    fn.argtypes = [_P] * 10 + [_I] * 3 + [_F] * 8 + [_P]
    fn.restype = _I
    return fn


def context_pairwise_kernel(pos, es, bandwidth, compute, fad_dt, fad_ut, *,
                            tx_w, noise_psd_w, update_bits, workload
                            ) -> PairwiseContext:
    """Seed-batched launch: pos (S, N, 2), es (M, 2), bandwidth/compute
    (S, N), fad_dt/fad_ut (S, N, M), all float32 on one CUDA device.
    The physics scalars are rounded to float32, as the reference's
    weak-typed Python floats are."""
    s, n, m = fad_dt.shape
    f32 = torch.float32
    check(pos, "pos", f32, (s, n, 2))
    check(es, "es", f32, (m, 2))
    check(bandwidth, "bandwidth", f32, (s, n))
    check(compute, "compute", f32, (s, n))
    check(fad_dt, "fad_dt", f32, (s, n, m))
    check(fad_ut, "fad_ut", f32, (s, n, m))
    if m > 4096:
        raise ValueError(f"{m} edge servers exceed the kernel's ES table")
    outs = [torch.empty((s, n, m), dtype=f32, device=pos.device)
            for _ in range(4)]
    f = lambda v: float(np.float32(v))
    code = _fn()(pos.data_ptr(), es.data_ptr(), bandwidth.data_ptr(),
                 compute.data_ptr(), fad_dt.data_ptr(), fad_ut.data_ptr(),
                 *(o.data_ptr() for o in outs), s, n, m, f(tx_w),
                 f(noise_psd_w), f(update_bits), f(workload), PL_SLOPE,
                 PL_ICPT, NEG_TENTH, RCP_LN2,
                 torch.cuda.current_stream(pos.device).cuda_stream)
    raise_on_error(code, "context_pairwise")
    count_launch("context_pairwise")
    return PairwiseContext(*outs)
