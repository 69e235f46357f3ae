"""Edge aggregation masks (Eq. 6) and cloud synchronization.

The masked mean itself is ``kernels.masked_aggregate``; this module owns
the Eq. 6 effective-mask semantics and the global average.
"""
from __future__ import annotations

from typing import Dict

import torch


def effective_mask_multi(arrived: torch.Tensor, tau: torch.Tensor,
                         valid: torch.Tensor, z_min: int) -> torch.Tensor:
    """Eq. 6 for every row (edge server) over fixed-capacity slots.

    arrived/tau/valid: (R, slots). Clients that arrived before the
    deadline count; where fewer than Z arrived, the Z fastest count
    instead. Padded slots are forced to arrived=0 / tau=+inf and
    re-zeroed at the end. "Fastest" ranks by tau with ties toward the
    lower slot (a stable sort, as the reference's ``top_k``)."""
    valid = valid.to(torch.float32)
    arrived = arrived.to(torch.float32) * valid
    tau = torch.where(valid > 0, tau, torch.full_like(tau, torch.inf))
    z = min(int(z_min), arrived.shape[-1])
    count = arrived.sum(dim=-1, keepdim=True)
    order = torch.sort(tau, dim=-1, stable=True).indices[..., :z]
    fallback = torch.zeros_like(arrived).scatter(-1, order, 1.0)
    return torch.where(count >= z, arrived, fallback) * valid


def broadcast_global(edge: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Every T_ES rounds each ES resets to the global mean over the ES
    axis (axis 1 of the (S, M, ...) leaves)."""
    return {k: a.to(torch.float32).mean(dim=1, keepdim=True)
            .to(a.dtype).expand_as(a).clone() for k, a in edge.items()}
