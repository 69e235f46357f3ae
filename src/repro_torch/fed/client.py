"""Client-side local training (Eq. 2): E epochs of SGD from the edge
model, for every slot at once (the slot axis is a batch dimension)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.logistic import Params, loss_and_grad


def sgd_trajectory(params: Params, batches: Dict[str, torch.Tensor],
                   lr: float, kind: str = "logreg"
                   ) -> Tuple[Params, torch.Tensor]:
    """One SGD step per stacked batch for every client slot.

    params leaves (K, ...) (each slot starts from its own copy);
    batches ``x`` (K, steps, B, ...features), ``y`` (K, steps, B);
    ``kind`` the model ('logreg' or 'cnn'). Returns the final per-slot
    params and each step's loss before its update (K, steps)."""
    grad = loss_and_grad(kind)
    p = dict(params)
    losses = []
    for step in range(batches["x"].shape[1]):
        loss, g = grad(p, batches["x"][:, step], batches["y"][:, step])
        p = {k: p[k] - lr * g[k] for k in p}
        losses.append(loss)
    return p, torch.stack(losses, dim=-1)


def sgd_steps(params: Params, batches: Dict[str, torch.Tensor],
              lr: float, kind: str = "logreg"
              ) -> Tuple[Params, torch.Tensor]:
    """``sgd_trajectory`` with the mean loss over the steps (K,), as the
    reference's ``local_sgd``."""
    p, losses = sgd_trajectory(params, batches, lr, kind)
    return p, losses.mean(dim=-1)


def local_sgd_multi(params: Params, batches: Dict[str, torch.Tensor],
                    lr: float) -> Tuple[Params, torch.Tensor]:
    """``sgd_steps`` returning per-slot deltas ``w_final - w_init`` and
    mean losses (K,)."""
    p, loss = sgd_steps(params, batches, lr)
    return {k: p[k] - params[k] for k in p}, loss
