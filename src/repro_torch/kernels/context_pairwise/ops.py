"""Public wrapper of the fused Eq. 4/5 pairwise context stage.

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
hand-written kernel (``kernel.py``), one launch for all seeds, or raise.
"""
from __future__ import annotations

from repro_torch.kernels.common import on_cuda
from repro_torch.kernels.context_pairwise.ref import (PairwiseContext,
                                                      pairwise_context_ref)


def pairwise_context(pos, es, bandwidth, compute, fad_dt, fad_ut, *,
                     tx_w, noise_psd_w, update_bits, workload
                     ) -> PairwiseContext:
    """pos (S, N, 2), es (M, 2), bandwidth/compute (S, N), fad_dt/fad_ut
    (S, N, M) -> ``PairwiseContext`` of four (S, N, M) float32 tensors."""
    kw = dict(tx_w=tx_w, noise_psd_w=noise_psd_w, update_bits=update_bits,
              workload=workload)
    if not on_cuda(pos, es, bandwidth, compute, fad_dt, fad_ut):
        return pairwise_context_ref(pos, es, bandwidth, compute, fad_dt,
                                    fad_ut, **kw)
    from repro_torch.kernels.context_pairwise.kernel import \
        context_pairwise_kernel
    return context_pairwise_kernel(
        pos.contiguous(), es.contiguous(), bandwidth.contiguous(),
        compute.contiguous(), fad_dt.contiguous(), fad_ut.contiguous(),
        **kw)
