"""LM-scale HFL building blocks, mirroring the reference's
``fed/distributed.py`` on one device.

* ``make_train_step`` -- one deadline-masked training step: client
  cohorts are the rows of a batch, COCS's selection enters as per-example
  participation weights (dropped cohorts contribute zero to the
  aggregate, the Eq. (6) masked mean when local_steps = 1).

* ``make_hfl_round`` -- the paper's hierarchy with an edge model per
  edge server, stacked on a leading ``n_edge`` axis: a round takes a
  masked local step on each edge and, every ``t_es`` rounds, the global
  aggregation, the mean over the edges in the parameter dtype. The
  reference ``vmap``s the edges and all-reduces over its ``pod`` mesh
  axis; here a Python loop walks the edges on the one device.

Parameters are nested dicts of tensors; a step returns new tensors and
leaves its inputs as they are. The reference's ``abstract_edge_params``
needs ``registry.abstract_params``, which comes with the pod tools
(ROADMAP queue A item 6).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry as R
from repro_torch.optim.optimizers import tree_map


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _unflatten(tree, leaves) -> Any:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def value_and_grad(cfg: ModelConfig, params: dict,
                   batch: Dict[str, torch.Tensor], weights: torch.Tensor,
                   remat: bool = False, unroll: bool = False
                   ) -> Tuple[torch.Tensor, dict]:
    """(``registry.train_loss``, its gradient with respect to every
    parameter, a tree like ``params``). The parameters are not
    modified."""
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
        loss = R.train_loss(_unflatten(params, leaves), cfg, batch,
                            remat=remat, weights=weights, unroll=unroll)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), _unflatten(params, grads)


def make_train_step(cfg: ModelConfig, lr: float = 1e-3, remat: bool = False,
                    unroll: bool = False, microbatch: int = 1
                    ) -> Callable[..., Tuple[dict, torch.Tensor]]:
    """(params, batch, weights) -> (params, loss). weights: (B,) cohort
    participation (1 = arrived before the deadline, 0 = dropped).

    microbatch > 1 takes the batch in that many sequential slices along
    its leading axis, accumulates the gradients in float32 and divides by
    the count: the same update at 1 / microbatch the live activations.
    The update is p - lr * g in float32, cast back to p's dtype."""

    def step(params, batch, weights):
        if microbatch > 1:
            n = weights.shape[0] // microbatch
            gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            losses = []
            for i in range(microbatch):
                sl = slice(i * n, (i + 1) * n)
                loss, g = value_and_grad(
                    cfg, params, {k: a[sl] for k, a in batch.items()},
                    weights[sl], remat, unroll)
                gacc = tree_map(lambda a, gg: a + gg.to(torch.float32), gacc,
                                g)
                losses.append(loss)
            grads = tree_map(lambda g: g / microbatch, gacc)
            loss = torch.mean(torch.stack(losses))
        else:
            loss, grads = value_and_grad(cfg, params, batch, weights, remat,
                                         unroll)
        lr32 = torch.tensor(lr, dtype=torch.float32).item()
        new = tree_map(lambda p, g: (p.to(torch.float32)
                                     - lr32 * g.to(torch.float32)
                                     ).to(p.dtype), params, grads)
        return new, loss

    return step


def make_serve_step(cfg: ModelConfig, window: int = 0, unroll: bool = False):
    """(params, tokens (B, 1), state) -> (logits (B, 1, V), state): one
    decode step (``unroll`` changes nothing)."""
    del unroll

    def step(params, tokens, state):
        return R.serve_step(params, cfg, tokens, state, window=window)

    return step


def stack_edge_params(params: dict, n_edge: int) -> dict:
    """The initial params copied onto a leading ``n_edge`` axis."""
    return tree_map(lambda p: p[None].expand((n_edge,) + tuple(p.shape))
                    .contiguous(), params)


def make_hfl_round(cfg: ModelConfig, n_edge: int, t_es: int,
                   lr: float = 1e-3, remat: bool = False,
                   unroll: bool = False, microbatch: int = 1):
    """(edge_params (E, ...), batch (E, B_e, ...), weights (E, B_e), step)
    -> (edge_params, the mean of the edges' losses).

    Edge aggregation: the weighted loss mean over an edge's cohorts makes
    one backward pass equal to the deadline-masked mean of per-cohort
    deltas. Global aggregation: the mean over the edge axis in the
    parameter dtype, broadcast back to every edge, when (step + 1) % t_es
    == 0."""
    edge_step = make_train_step(cfg, lr=lr, remat=remat, unroll=unroll,
                                microbatch=microbatch)

    def round_fn(edge_params, batch, weights, step):
        new, losses = [], []
        for e in range(n_edge):
            p, loss = edge_step(tree_map(lambda a: a[e], edge_params),
                                {k: a[e] for k, a in batch.items()},
                                weights[e])
            new.append(p)
            losses.append(loss)
        edge_params = tree_map(lambda *ps: torch.stack(ps), *new)
        if (int(step) + 1) % t_es == 0:
            edge_params = tree_map(
                lambda a: torch.mean(a, dim=0, dtype=a.dtype)[None]
                .expand(a.shape).contiguous(), edge_params)
        return edge_params, torch.mean(torch.stack(losses))

    return round_fn
