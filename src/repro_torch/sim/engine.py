"""The bandit engine over the device simulator: each round is generated
(``sim.core.round_batch``) and fed straight to the policy
(``policies.engine.policy_scan_step``), for every batch element at once.

A run keeps nothing on the host but its loop counter: the Eq. 4/5 stage
launches ``context_pairwise`` once a round for all elements, the
selection launches its kernel once a round (``budgeted_topk``, P3's walk
after B2's keys-only launch, or ``random_assign``), and the outputs are
copied to the host once, when the run ends. The stages carry the
profiler labels ``round.env`` and ``round.select``, as the training
block's do (``experiment/fused.py``).

``run_bandit_device_grid`` batches config cells beside the seeds: each
element has its own env seed, policy seed, per-ES budget and deadline.
The deadline re-thresholds the realized Eq. 5 latencies,
``(latency <= deadline).float()`` in float32, which is the comparison a
``SimSpec`` with that ``deadline_s`` makes, so an element equals the
sequential run of its cell bit for bit in selections. ``true_p`` stays
the base spec's, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.kernels.common import resolve_device
from repro_torch.policies.base import FunctionalPolicy
from repro_torch.policies.engine import (collect, full_budgets,
                                         policy_scan_step,
                                         require_tensor_policy,
                                         stack_states)
from repro_torch.sim.core import init_statics, round_batch
from repro_torch.sim.spec import SimSpec


def _run(policy: FunctionalPolicy, spec: SimSpec, seeds: Sequence[int],
         horizon: int, policy_seeds: Sequence[int], dev: torch.device,
         budgets: Optional[torch.Tensor] = None,
         deadlines: Optional[torch.Tensor] = None) -> Dict[str, object]:
    seed_t = torch.as_tensor([int(s) for s in seeds], dtype=torch.int64,
                             device=dev)
    statics = init_statics(spec, seed_t)
    state = stack_states(policy, policy_seeds, dev)
    step = policy_scan_step(policy, budgets)
    pos, outs = statics.pos0, []
    for t in range(int(horizon)):
        with record_function("round.env"):
            pos, rd = round_batch(spec, seed_t, statics, pos, t)
            if deadlines is not None:
                rd = rd._replace(outcomes=(rd.latency <= deadlines)
                                 .to(torch.float32))
        with record_function("round.select"):
            state, out = step(state, rd)
        outs.append(out)
    return collect(outs, state)


def run_bandit_device(policy: FunctionalPolicy, spec: SimSpec,
                      seeds: Sequence[int], horizon: int,
                      policy_seeds: Optional[Sequence[int]] = None, *,
                      device=None) -> Dict[str, object]:
    """A multi-seed bandit run with the environment generated on the
    device. ``policy_seeds`` decouples the policy's init seeds from the
    env seeds (``POLICY_TABLE``'s offsets). Returns host numpy arrays
    with a leading S axis and the final state. ``device=None`` runs on
    CUDA and raises without a CUDA device."""
    require_tensor_policy(policy, "run_bandit_device")
    dev = resolve_device(device)
    return _run(policy, spec, seeds, horizon,
                seeds if policy_seeds is None else policy_seeds, dev)


def run_bandit_device_grid(policy: FunctionalPolicy, spec: SimSpec, seeds,
                           budgets, deadlines, horizon: int, policy_seeds,
                           *, device=None) -> Dict[str, object]:
    """Config cells x seeds in one run. ``seeds``, ``budgets``,
    ``deadlines`` and ``policy_seeds`` have one entry per element (B);
    results have a leading B axis."""
    require_tensor_policy(policy, "run_bandit_device_grid")
    if not len(seeds) == len(budgets) == len(deadlines) == len(
            policy_seeds):
        raise ValueError("seeds, budgets, deadlines and policy_seeds must "
                         "have one entry per element")
    dev = resolve_device(device)
    b = full_budgets(policy, budgets, dev)
    d = torch.as_tensor(np.asarray(deadlines, np.float32),
                        device=dev).view(-1, 1, 1)
    return _run(policy, spec, seeds, horizon, policy_seeds, dev, b, d)
