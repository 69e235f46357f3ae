"""Mixture-of-Experts block with capacity-based dispatch, mirroring the
reference's ``models/moe.py``.

The router's top-k goes through the MoE router kernel. Dispatch sorts
the (token, choice) assignments stably by expert id, takes each one's
position within its expert from exclusive per-expert offsets, and
scatters the tokens into an (E, C, d) buffer; assignments past an
expert's capacity C go to a drop row that is thrown away. The expert
FFNs are batched products over the expert axis; the combine adds each
token's k gate-weighted outputs in the model dtype, in ascending expert
order, from zero (the order of the reference's stable argsort followed by
``.at[].add``), so that the result is pinned for any k and run-to-run
bitwise on the card.

Nothing here reads a device value back to the host: the per-expert
counts come from ``scatter_add_`` (``torch.bincount`` reads its input's
max first on CUDA), and no boolean mask indexes a tensor.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels.moe_router.ops import moe_router
from repro_torch.models.layers import dense_init


def init_moe(gen: torch.Generator, d_model: int, mcfg: MoEConfig, dtype,
             device=None) -> dict:
    e, fe = mcfg.num_experts, mcfg.d_ff_expert
    kw = dict(dtype=dtype, device=device)
    p = {
        "router": dense_init(gen, (d_model, e), dtype=torch.float32,
                             device=device),
        "w_gate": dense_init(gen, (e, d_model, fe), **kw),
        "w_up": dense_init(gen, (e, d_model, fe), **kw),
        "w_down": dense_init(gen, (e, fe, d_model), **kw),
    }
    if mcfg.d_ff_shared:
        p["shared"] = {
            "w_gate": dense_init(gen, (d_model, mcfg.d_ff_shared), **kw),
            "w_up": dense_init(gen, (d_model, mcfg.d_ff_shared), **kw),
            "w_down": dense_init(gen, (mcfg.d_ff_shared, d_model), **kw),
        }
    return p


def _capacity(num_tokens: int, mcfg: MoEConfig) -> int:
    c = int(num_tokens * mcfg.top_k * mcfg.capacity_factor
            / mcfg.num_experts) + 1
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def route(p: dict, x2d: torch.Tensor, mcfg: MoEConfig, aux: bool = False
          ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(gates (T, k) float32, expert indices (T, k) int32, the Switch
    load-balance loss or None). The loss is computed only when ``aux``
    asks for it (the training forward does; prefill and decode do not,
    as XLA drops the reference's unused one under jit)."""
    logits = x2d.to(torch.float32) @ p["router"]              # (T, E)
    gates, idx = moe_router(logits, mcfg.top_k)
    if not aux:
        return gates, idx, None
    e = mcfg.num_experts
    me = torch.mean(torch.softmax(logits, dim=-1), dim=0)      # (E,)
    ce = torch.mean(F.one_hot(idx[:, 0].long(), e).to(torch.float32),
                    dim=0)
    return gates, idx, e * torch.sum(me * ce)


def combine_ascending(contrib: torch.Tensor, order: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    """contrib (T*k, d), each assignment's weighted output in the stable
    sort's order ``order`` of the flat (token, choice) assignments; idx
    (T, k) the experts -> y (T, d): each token's k contributions summed
    left to right in ascending expert index, starting from zero, rounded
    to contrib's dtype after each add. Elementwise adds only, so the same
    inputs give the same bits on every run. With top-2 the sum is 0 + a
    + b, which two adds onto zero give in either order, so one
    ``index_add_`` computes it."""
    t, k = idx.shape
    if k == 2:
        return torch.zeros((t, contrib.shape[1]), dtype=contrib.dtype,
                           device=contrib.device).index_add_(
                               0, order // k, contrib)
    return _ascending_sum(contrib, order, idx)


def _ascending_sum(contrib: torch.Tensor, order: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """``combine_ascending``'s sum for any k: a (T, k, d) gather in
    ascending expert order, then k adds."""
    t, k = idx.shape
    flat = torch.empty_like(contrib)
    flat[order] = contrib                       # back to (token, choice)
    asc = torch.argsort(idx, dim=1)             # a token's experts differ
    per_tok = flat.view(t, k, -1).gather(
        1, asc[..., None].expand(t, k, contrib.shape[1]))
    y = torch.zeros((t, contrib.shape[1]), dtype=contrib.dtype,
                    device=contrib.device)
    for j in range(k):
        y = y + per_tok[:, j]
    return y


def moe_block(p: dict, x2d: torch.Tensor, mcfg: MoEConfig,
              aux: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x2d (T, d) -> (out (T, d), aux loss or None)."""
    t, d = x2d.shape
    k, e = mcfg.top_k, mcfg.num_experts
    cap = _capacity(t, mcfg)
    dev = x2d.device
    gates, idx, loss = route(p, x2d, mcfg, aux)

    flat_e = idx.reshape(-1).long()                            # (T*k,)
    flat_g = gates.reshape(-1)
    flat_tok = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    # stable, as the reference's argsort: the assignments past capacity
    # are the same ones
    order = torch.argsort(flat_e, stable=True)
    se, sg, stok = flat_e[order], flat_g[order], flat_tok[order]
    counts = torch.zeros((e,), dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=0) - counts              # exclusive
    pos = torch.arange(t * k, device=dev) - starts[se]
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, e * cap)          # overflow row
    # dispatch into (E*C + 1, d); only the drop row, thrown away, is
    # written more than once
    buf = torch.zeros((e * cap + 1, d), dtype=x2d.dtype, device=dev)
    buf[slot] = x2d[stok]
    h = buf[: e * cap].view(e, cap, d)
    act = F.silu(torch.bmm(h, p["w_gate"])) * torch.bmm(h, p["w_up"])
    out_e = torch.bmm(act, p["w_down"])
    out_flat = torch.cat([out_e.reshape(e * cap, d),
                          torch.zeros((1, d), dtype=out_e.dtype,
                                      device=dev)])
    # the combine stays in the model dtype, as the reference's does, and
    # adds each token's contributions one at a time in ascending expert
    # index from zero: the reference's scatter-add meets them in the
    # stable sort's order
    gate_scale = torch.where(keep, sg, 0.0).to(x2d.dtype)
    contrib = out_flat[slot].to(x2d.dtype) * gate_scale[:, None]
    y = combine_ascending(contrib, order, idx)
    if "shared" in p:
        sh = p["shared"]
        y = y + (F.silu(x2d @ sh["w_gate"]) * (x2d @ sh["w_up"])
                 ) @ sh["w_down"]
    return y, loss
