"""The tier-[1] bandit engine: a policy driven over realized rounds with
no training in the loop.

The reference scans rounds with ``lax.scan`` and ``vmap``s seeds; the
port's policies already carry a leading seed axis, so here a run is a
Python loop over T rounds on (S, ...) tensors. Each round is one
``policy_scan_step``: select, update and the utility accounting, on the
device of the round's tensors with no host sync (the outputs stay on the
device until the run ends).

The batch axis S may enumerate seeds or flattened (config cell, seed)
pairs: ``run_rounds_grid`` gives each element its own budget, and
``run_rounds_grid_params`` its own COCS hypercube resolution ``h`` and
exponent ``z`` too, over a state padded to the largest ``h``. Every
element equals the sequential run with its parameters, bit for bit.

Outputs match the reference's: host numpy ``selections`` (S, T, N)
int32, ``utilities`` and ``participants`` (S, T) float32, ``explored``
(S, T) bool, and ``final_state`` as tensors. Host-state policies (CUCB,
LinUCB, phased COCS) take ``run_rounds_host``: one seed, one round at a
time on ``RoundData``, as the reference's sequential driver.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fmath import mul_rcp, sqrt_rn
from repro_torch.core.utility import realized_utility
from repro_torch.policies.base import FunctionalPolicy, PolicyAdapter, Round

StepOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def traced_utility(assign: torch.Tensor, outcomes: torch.Tensor,
                   num_es: int, sqrt_utility: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 7-8 / Eq. 19 realized utility for every batch element:
    ``(utility (S,), participants (S,))``. ``participants`` sums 0/1
    outcomes, exactly in any order; Eq. 19's ``sqrt(parts / M)`` is
    written as XLA computes it (a reciprocal multiply, then a correctly
    rounded root)."""
    sel = assign >= 0
    j = torch.clamp(assign.long(), 0, num_es - 1)
    hit = torch.gather(outcomes.to(torch.float32), 2, j[..., None])[..., 0]
    part = torch.where(sel, hit, torch.zeros_like(hit)).sum(dim=1)
    if sqrt_utility:
        return sqrt_rn(mul_rcp(part, num_es)), part
    return part, part


def require_tensor_policy(policy: FunctionalPolicy, what: str) -> None:
    if not getattr(policy, "tensor_capable", False):
        raise ValueError(
            f"{policy.name} is a host policy; {what} drives tensor "
            "policies only (run_rounds_host drives host policies)")


def stack_states(policy: FunctionalPolicy, seeds: Sequence[int],
                 device=None):
    """The initial state of every batch element (leading axis S), each
    from its own policy seed."""
    seeds = [int(s) for s in seeds]
    return policy.init(len(seeds), device, seeds)


def policy_scan_step(policy: FunctionalPolicy,
                     budgets: Optional[torch.Tensor] = None
                     ) -> Callable[[object, Round], Tuple[object, StepOut]]:
    """The one-round body of every engine:
    ``(state, rd) -> (state', (assign, utility, participants, explored))``.
    ``budgets`` (S, M) gives each batch element its per-ES budgets
    (``select_with_budgets``) in place of the spec's."""
    m = policy.spec.num_edge_servers

    def step(state, rd: Round):
        if budgets is None:
            assign, aux = policy.select(state, rd)
        else:
            assign, aux = policy.select_with_budgets(state, rd, budgets)
        new_state = policy.update(state, rd, assign, aux)
        util, part = traced_utility(assign, rd.outcomes, m,
                                    policy.spec.sqrt_utility)
        explored = aux.get("explored", torch.zeros(
            assign.shape[0], dtype=torch.bool, device=assign.device))
        return new_state, (assign, util, part, explored)

    return step


def _round_at(batch: Round, t: int) -> Round:
    return Round(*(f[:, t] for f in batch))


def collect(outs: List[StepOut], final_state) -> Dict[str, object]:
    """Per-round step outputs -> the engines' result dict (host numpy
    with leading axes (S, T), one device-to-host copy a field)."""
    cols = [torch.stack(c, dim=1).cpu().numpy() for c in zip(*outs)]
    return {"selections": cols[0], "utilities": cols[1],
            "participants": cols[2], "explored": cols[3],
            "final_state": final_state}


def _scan(step, state, batch: Round) -> Dict[str, object]:
    outs = []
    for t in range(batch.costs.shape[1]):
        state, out = step(state, _round_at(batch, t))
        outs.append(out)
    return collect(outs, state)


def full_budgets(policy: FunctionalPolicy, budgets, device
                  ) -> torch.Tensor:
    """(B,) per-element budget scalars -> (B, M) float32."""
    b = torch.as_tensor(np.asarray(budgets, np.float32), device=device)
    return b[:, None].expand(b.shape[0],
                             policy.spec.num_edge_servers).contiguous()


def stack_rounds_multi(rounds_per_seed: Sequence[Round]) -> Round:
    """S per-seed ``Round`` batches with (T, ...) leaves -> one batch with
    (S, T, ...) leaves."""
    return Round(*(torch.stack([torch.as_tensor(getattr(r, f))
                                for r in rounds_per_seed])
                   for f in Round._fields))


def run_rounds(policy: FunctionalPolicy, batch: Round, seed: int = 0
               ) -> Dict[str, object]:
    """One seed over a realized ``Round`` batch with (T, ...) leaves
    (``policies.base.round_from_arrays``); results with a leading S = 1
    axis dropped, as the reference's."""
    require_tensor_policy(policy, "run_rounds")
    one = Round(*(f[None] for f in batch))
    state0 = stack_states(policy, [seed], one.costs.device)
    out = _scan(policy_scan_step(policy), state0, one)
    return {k: (v[0] if k != "final_state" else v) for k, v in out.items()}


def run_rounds_multi_seed(policy: FunctionalPolicy, batch: Round,
                          seeds: Sequence[int]) -> Dict[str, object]:
    """Every seed at once over a (S, T, ...) batch (or S per-seed
    batches, ``stack_rounds_multi``); ``seeds`` are the policy seeds."""
    require_tensor_policy(policy, "run_rounds_multi_seed")
    if not isinstance(batch, Round):
        batch = stack_rounds_multi(batch)
    if batch.costs.shape[0] != len(seeds):
        raise ValueError(f"a batch of {batch.costs.shape[0]} seeds, "
                         f"{len(seeds)} seeds given")
    state0 = stack_states(policy, seeds, batch.costs.device)
    return _scan(policy_scan_step(policy), state0, batch)


def run_rounds_grid(policy: FunctionalPolicy, batch: Round, budgets,
                    policy_seeds: Sequence[int]) -> Dict[str, object]:
    """Config cells x seeds in one run: ``batch`` has (B, T, ...) leaves,
    B flattened (cell, seed) elements each with its own realized rounds,
    and ``budgets`` (B,) the per-ES budget of each element."""
    require_tensor_policy(policy, "run_rounds_grid")
    if not batch.costs.shape[0] == len(policy_seeds) == len(budgets):
        raise ValueError("batch, budgets and policy_seeds must have one "
                         "entry per element")
    dev = batch.costs.device
    state0 = stack_states(policy, policy_seeds, dev)
    step = policy_scan_step(policy, full_budgets(policy, budgets, dev))
    return _scan(step, state0, batch)


def run_rounds_grid_params(policy: FunctionalPolicy, batch: Round, budgets,
                           hs, zs, policy_seeds: Sequence[int]
                           ) -> Dict[str, object]:
    """``run_rounds_grid`` with each element's COCS resolution ``h`` and
    exponent ``z`` (``hs``, ``zs`` (B,)): the state is padded to
    ``max(hs)``, and ``policy``'s own ``h_t`` and ``alpha`` are ignored
    for these (its solver stays)."""
    require_tensor_policy(policy, "run_rounds_grid_params")
    if not hasattr(policy, "select_with_params"):
        raise ValueError(f"{policy.name} has no hypercube parameters")
    hs = np.asarray(hs, np.int32)
    if not (batch.costs.shape[0] == len(policy_seeds) == len(hs)
            == len(budgets) == len(zs)):
        raise ValueError("batch, budgets, hs, zs and policy_seeds must "
                         "have one entry per element")
    dev = batch.costs.device
    h = torch.as_tensor(hs, device=dev)
    z = torch.as_tensor(np.asarray(zs, np.float32), device=dev)
    b = full_budgets(policy, budgets, dev)
    m = policy.spec.num_edge_servers

    def step(state, rd: Round):
        assign, aux = policy.select_with_params(state, rd, b, h, z)
        new_state = policy.update_with_params(state, rd, assign, h)
        util, part = traced_utility(assign, rd.outcomes, m,
                                    policy.spec.sqrt_utility)
        return new_state, (assign, util, part, aux["explored"])

    state0 = policy.init_padded(len(hs), int(hs.max()), dev)
    return _scan(step, state0, batch)


def run_rounds_host(policy: FunctionalPolicy, rounds: Sequence,
                    seed: int = 0) -> Dict[str, object]:
    """The reference's sequential driver, for host-state policies: one
    seed over a list of ``RoundData``, select then update each round,
    utilities in float64 (``core.utility.realized_utility``). A tensor
    policy raises ``ValueError``: ``run_rounds`` drives it."""
    adapter = PolicyAdapter(policy, seed=seed)
    t_len = len(rounds)
    n = policy.spec.num_clients
    selections = np.zeros((t_len, n), np.int64)
    utils = np.zeros(t_len)
    parts = np.zeros(t_len)
    explored = np.zeros(t_len, bool)
    for t, rd in enumerate(rounds):
        assign = adapter.select(rd)
        adapter.update(rd, assign)
        utils[t] = realized_utility(assign, rd, policy.spec.sqrt_utility)
        parts[t] = realized_utility(assign, rd, False)
        selections[t] = assign
        explored[t] = adapter.last_explored
    return {"selections": selections, "utilities": utils,
            "participants": parts, "explored": explored,
            "final_state": adapter.state}
