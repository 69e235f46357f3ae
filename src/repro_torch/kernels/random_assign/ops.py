"""Random's feasible random assignment: the draws, then the scan, routed
by device.

The draws are the reference's (``policies/solvers.py::random_assign``):
``split(key)`` into an order key and a choice key, ``permutation`` of the
clients and ``gumbel`` (N, M) scores, from ``repro_torch.random``. The
scan then runs as the hand-written kernel on a CUDA tensor
(``kernel.py``, ``csrc/random_assign.cu``: one warp a seed, no host
sync) or as the plain version on a CPU tensor (``ref.py``)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import random as jr
from repro_torch.kernels.common import on_cuda
from repro_torch.kernels.random_assign.ref import random_assign_ref


def random_draws(key: torch.Tensor, n: int, m: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """key (S, 2) -> (order (S, N) int32, gumbel (S, N, M) float32)."""
    ks = jr.split(key)
    return (jr.permutation(ks[..., 0, :], n),
            jr.gumbel(ks[..., 1, :], (n, m)))


def random_scan(order: torch.Tensor, gumbel: torch.Tensor,
                costs: torch.Tensor, budgets: torch.Tensor,
                eligible: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan over given draws: (assign (S, N) int32, remaining
    (S, M) float32). budgets (S, M) or (M,)."""
    s, n, m = gumbel.shape
    budgets = torch.as_tensor(budgets, dtype=torch.float32,
                              device=gumbel.device).expand(s, m)
    if not on_cuda(gumbel, order, costs, eligible):
        return random_assign_ref(order, gumbel, costs, budgets, eligible)
    from repro_torch.kernels.random_assign.kernel import random_assign_kernel
    return random_assign_kernel(order.contiguous(), gumbel.contiguous(),
                                costs.contiguous(), budgets.contiguous(),
                                eligible.contiguous())


def random_assign(key: torch.Tensor, costs: torch.Tensor,
                  budgets: torch.Tensor, eligible: torch.Tensor
                  ) -> torch.Tensor:
    """key (S, 2), costs (S, N), budgets (S, M) or (M,), eligible
    (S, N, M) bool -> assign (S, N) int32 (-1 = unselected)."""
    s, n, m = eligible.shape
    order, gumbel = random_draws(key, n, m)
    return random_scan(order, gumbel, costs.to(torch.float32), budgets,
                       eligible)[0]
