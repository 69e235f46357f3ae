"""The paper's convex training model: multinomial logistic regression
(the "MNIST" setting of Figs. 3/4).

Parameters are a plain dict ``{"w": (F, C), "b": (C,)}``; every function
takes optional leading batch axes on the parameters (one model per
(seed, ES) or per slot). The CNN of the non-convex setting is not ported
yet (ROADMAP, queue A).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


def init_logreg(num_features: int = 784, num_classes: int = 10,
                device=None) -> Params:
    """Zeros, as the reference's init (the key is unused there)."""
    return {"w": torch.zeros((num_features, num_classes),
                             dtype=torch.float32, device=device),
            "b": torch.zeros((num_classes,), dtype=torch.float32,
                             device=device)}


def logreg_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x (..., B, F) @ w (..., F, C) + b (..., C) -> (..., B, C)."""
    return torch.matmul(x, params["w"]) + params["b"][..., None, :]


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
    """Mean cross-entropy over the batch axis (-2)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    picked = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -picked.mean(dim=-1)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(logits, dim=-1) == labels).to(
        torch.float32).mean(dim=-1)


def logreg_loss_and_grad(params: Params, x: torch.Tensor,
                         y: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """Loss and its gradient for batched models: params leaves
    (K, ...), x (K, B, F), y (K, B) -> loss (K,), grads like params.
    The gradient of mean softmax cross-entropy is (softmax - onehot) / B
    through the logits; the products are batched matmuls."""
    logits = logreg_logits(params, x)
    b = x.shape[-2]
    p = torch.softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(y.long(), p.shape[-1]).to(p.dtype)
    g = (p - onehot) / b
    gw = torch.matmul(x.transpose(-1, -2), g)
    gb = g.sum(dim=-2)
    return softmax_xent(logits, y), {"w": gw, "b": gb}


def make_loss_fn(kind: str) -> Callable:
    """kind: 'logreg'. Returns ``loss(params, batch)`` -> scalar(s)."""
    if kind != "logreg":
        raise NotImplementedError(
            f"model {kind!r} is not ported yet; the slice runs 'logreg' "
            "(ROADMAP, queue A)")

    def loss(params: Params, batch: Dict[str, torch.Tensor]):
        return softmax_xent(logreg_logits(params, batch["x"]), batch["y"])

    return loss
