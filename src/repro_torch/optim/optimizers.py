"""Optimizers over nested dicts of tensors, mirroring the reference's
``optim/optimizers.py``.

Each optimizer is a pair of functions:
    init(params) -> state
    update(grads, state, params, lr) -> (updates, state)
Apply with ``apply_updates`` (params + updates, in each param's dtype).
The state is float32 (AdamW's ``count`` an int32 tensor); nothing is
updated in place. HFL local training uses plain SGD (Eq. 2); momentum
and AdamW serve the centralized training paths.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

OptState = Any


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _f32_zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def sgd() -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr):
        return tree_map(lambda g: -lr * g, grads), state

    return Optimizer(init, update)


def momentum(beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return tree_map(_f32_zeros, params)

    def update(grads, state, params, lr):
        new_m = tree_map(lambda m, g: beta * m + g, state, grads)
        if nesterov:
            upd = tree_map(lambda m, g: -lr * (beta * m + g), new_m, grads)
        else:
            upd = tree_map(lambda m: -lr * m, new_m)
        return upd, new_m

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"mu": tree_map(_f32_zeros, params),
                "nu": tree_map(_f32_zeros, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=_first(params).device)}

    def update(grads, state, params, lr):
        count = state["count"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                      state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v
                      + (1 - b2) * torch.square(g.to(torch.float32)),
                      state["nu"], grads)
        c1 = 1 - b1 ** count.to(torch.float32)
        c2 = 1 - b2 ** count.to(torch.float32)

        def u(m, v, p):
            step = (m / c1) / (torch.sqrt(v / c2) + eps)
            return -lr * (step + weight_decay * p.to(torch.float32))

        upd = tree_map(u, mu, nu, params)
        return upd, {"mu": mu, "nu": nu, "count": count}

    return Optimizer(init, update)


def _first(tree) -> torch.Tensor:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree
