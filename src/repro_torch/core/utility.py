"""Utility accounting (Eq. 7-8, Eq. 19) and the policy table of the
paper's comparison, in numpy (a copy of the reference's
``core/utility.py``, :24-63).

``POLICY_TABLE`` maps each display name to its registry name and the
seed offset of its policy state: the paper's panels initialise Random
from ``seed + 3``, and so on, so a panel of the port draws what the
reference's draws.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.configs.paper_hfl import HFLExperimentConfig

# display name -> (registry name, seed offset)
POLICY_TABLE = {
    "Oracle": ("oracle", 0),
    "COCS": ("cocs", 0),
    "CUCB": ("cucb", 1),
    "LinUCB": ("linucb", 2),
    "Random": ("random", 3),
}


def realized_utility(assign: np.ndarray, rd, sqrt_utility: bool = False
                     ) -> float:
    """mu(s; X): the selected clients that arrive in time (Eq. 7-8), or
    ``sqrt((1/M) sum X)`` under the non-convex utility (Eq. 19). ``rd``
    holds one round's numpy ``outcomes`` (N, M) and ``contexts``."""
    sel = assign >= 0
    total = float(rd.outcomes[np.nonzero(sel)[0], assign[sel]].sum())
    if sqrt_utility:
        return math.sqrt(max(total, 0.0) / rd.contexts.shape[1])
    return total


def _policy_kwargs(cfg: HFLExperimentConfig, reg_name: str) -> dict:
    """The configuration's knobs a registry policy takes (COCS's Holder
    exponent and hypercube resolution)."""
    if reg_name in ("cocs", "cocs-phased"):
        return {"alpha": cfg.holder_alpha, "h_t": cfg.h_t}
    return {}
