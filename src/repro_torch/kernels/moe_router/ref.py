"""Plain PyTorch version of the MoE router kernel, mirroring the
reference's ``kernels/moe_router/ref.py::moe_router_ref`` (and the
routing of ``models/moe.py::route``): a float32 softmax over the
experts, the top k by (probability desc, expert index asc), as
``lax.top_k`` orders them, and the k gates divided by their sum."""
from __future__ import annotations

from typing import Tuple

import torch


def moe_router_ref(logits: torch.Tensor, top_k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (T, E) -> gates (T, k) float32, expert indices (T, k)
    int32. A stable descending sort keeps equal probabilities in index
    order (``torch.topk`` leaves the order of ties unspecified)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :top_k], idx[:, :top_k]
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    return gates, idx.to(torch.int32)
