"""The reference's parameters and policy state, as numpy arrays, turned
into the port's tensors, so that tests start both packages from the
same state. LM parameters and serve states are nested dicts of the same
leaf layout in both packages, so the conversion is a flat copy."""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.models.logistic import cnn_from_reference_layout
from repro_torch.policies.cocs import COCSState


def from_jax_params(tree: Mapping[str, np.ndarray], device=None
                    ) -> dict:
    """A dict of numpy arrays (the reference's parameter pytree after
    ``np.asarray`` on every leaf) -> a dict of tensors, same dtypes."""
    return {k: torch.as_tensor(np.array(v, copy=True), device=device)
            for k, v in tree.items()}


def logreg_t_params_from_jax(tree: Mapping[str, np.ndarray], device=None
                             ) -> dict:
    """The reference's transposed logreg params (``init_logreg_t``:
    ``wt`` (..., classes, features), ``b``), as numpy, -> the port's
    ``logreg-t`` params, the same layout."""
    if set(tree) != {"wt", "b"}:
        raise ValueError(f"logreg-t params are 'wt' and 'b', got "
                         f"{sorted(tree)}")
    wt, b = np.asarray(tree["wt"]), np.asarray(tree["b"])
    if wt.shape[-2] != b.shape[-1]:
        raise ValueError(f"wt is (..., classes, features): {wt.shape} "
                         f"against b {b.shape}")
    return from_jax_params({"wt": wt, "b": b}, device)


def cnn_params_from_jax(tree: Mapping[str, np.ndarray], height: int = 32,
                        width: int = 32, device=None) -> dict:
    """The reference's CNN params (``init_cnn``: HWIO convolutions, ``f1``
    rows in NHWC-flatten order), as numpy, -> the port's layout (OIHW,
    NCHW-flatten rows)."""
    return cnn_from_reference_layout(from_jax_params(tree, device), height,
                                     width)


def cnn_params_to_numpy(params: Mapping[str, torch.Tensor],
                        height: int = 32, width: int = 32) -> dict:
    """The inverse of ``cnn_params_from_jax``: the reference's layout
    (HWIO convolutions, ``f1`` rows in NHWC-flatten order), as numpy."""
    out = dict(params)
    out["c1"] = params["c1"].permute(2, 3, 1, 0)
    out["c2"] = params["c2"].permute(2, 3, 1, 0)
    c = params["c2"].shape[0]
    out["f1"] = params["f1"].reshape(c, height // 4, width // 4, -1).permute(
        1, 2, 0, 3).reshape(params["f1"].shape)
    return to_numpy_params({k: v.contiguous() for k, v in out.items()})


def _leaf_to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(np.array(a.view(np.uint16), copy=True)
                                ).view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a, copy=True), device=device)


def lm_params_from_jax(tree: Mapping, device=None) -> dict:
    """The reference's LM parameter pytree (or serve state), a nested dict
    with every leaf as a numpy array, -> the port's tree of tensors with
    the same keys, shapes and dtypes (bfloat16 kept bit for bit)."""
    return {k: (lm_params_from_jax(v, device) if isinstance(v, Mapping)
                else _leaf_to_tensor(v, device))
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
