"""The reference's parameters and policy state, as numpy arrays, turned
into the port's tensors, so that tests start both packages from the
same state."""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.policies.cocs import COCSState


def from_jax_params(tree: Mapping[str, np.ndarray], device=None
                    ) -> dict:
    """A dict of numpy arrays (the reference's parameter pytree after
    ``np.asarray`` on every leaf) -> a dict of tensors, same dtypes."""
    return {k: torch.as_tensor(np.array(v, copy=True), device=device)
            for k, v in tree.items()}


def to_numpy_params(params: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of ``from_jax_params``."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def cocs_state_from_numpy(counters: np.ndarray, p_hat: np.ndarray,
                          device=None) -> COCSState:
    """The reference's ``COCSState`` leaves (per seed, stacked on a
    leading seed axis) -> the port's state."""
    return COCSState(
        counters=torch.as_tensor(np.array(counters, np.int32, copy=True),
                                 device=device),
        p_hat=torch.as_tensor(np.array(p_hat, np.float32, copy=True),
                              device=device))
