"""The paper's own HFL experiment configurations (Table I): the convex
setting, the non-convex one (CNN, sqrt utility) and the 1000-client
cohorts the device simulator runs, by name in ``CONFIGS``.

A copy of the reference's ``configs/paper_hfl.py`` values (the port
imports nothing of the JAX package). Datasets are synthetic with the
paper's structure: non-IID, 2 labels per client.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HFLExperimentConfig:
    name: str
    num_clients: int = 50           # N
    num_edge_servers: int = 3       # M
    update_bits: float = 0.18e6     # a_DT = a_UT, size of model updates (bits)
    workload: float = 2.41e6        # q, bytes of computation workload
    tx_power_dbm: float = 23.0      # P_n
    deadline_s: float = 3.0         # tau_dead
    price_low: float = 0.5          # pricing U[0.5, 2] per MHz
    price_high: float = 2.0
    budget: float = 3.5             # B per ES
    context_dim: int = 2            # (download rate, compute) in [0,1]^2
    holder_alpha: float = 1.0
    h_t: int = 5                    # context partition per dim (Table I)
    local_epochs: int = 2           # E
    t_es: int = 5                   # global aggregation period
    lr: float = 0.005
    bandwidth_low: float = 0.3e6    # Hz
    bandwidth_high: float = 1.0e6
    compute_low: float = 2.0e6      # cycles/s-ish proxy ("MHz")
    compute_high: float = 4.0e6
    cell_radius_km: float = 2.0
    noise_dbm_per_hz: float = -174.0   # thermal noise PSD
    min_clients_z: int = 1          # Z: minimum updates per edge aggregation
    utility: str = "linear"         # "linear" (convex) | "sqrt" (non-convex)


MNIST_CONVEX = HFLExperimentConfig(name="mnist-convex")

# 1000 clients over 12 edge servers; the budget keeps each ES to a
# handful of clients a round
METROPOLIS_1K = HFLExperimentConfig(
    name="mnist-metropolis-1k",
    num_clients=1000,
    num_edge_servers=12,
    budget=12.0,
)

BURSTY_1K = HFLExperimentConfig(
    name="mnist-bursty-1k",
    num_clients=1024,
    num_edge_servers=8,
    budget=8.0,
)

# metropolis-scale cohorts for the client-sharded cohort engine
# (``repro_torch.mesh``): 10^5-10^6 clients split over the "clients"
# ranks. Budgets keep per-ES admissions bounded (the slot capacity, not
# N, sizes the training tensors), and the client count divides the
# power-of-two shard counts
METROPOLIS_100K = HFLExperimentConfig(
    name="mnist-metropolis-100k",
    num_clients=100_000,
    num_edge_servers=32,
    budget=16.0,
)

METROPOLIS_1M = HFLExperimentConfig(
    name="mnist-metropolis-1m",
    num_clients=1_000_000,
    num_edge_servers=64,
    budget=16.0,
)

# the non-convex setting (Figs. 5-7): the CNN's larger updates and
# workload, a longer deadline, the sqrt (P3) utility. lr = 0.1 is the
# reference's; at it the CNN's local SGD diverges on the synthetic data
# (ROADMAP, reference caveat R11)
CIFAR10_NONCONVEX = HFLExperimentConfig(
    name="cifar10-nonconvex",
    update_bits=18.7e6,
    workload=28.3e6,
    deadline_s=20.0,
    budget=40.0,
    bandwidth_low=2.0e6,
    bandwidth_high=4.0e6,
    compute_low=8.0e6,
    compute_high=15.0e6,
    local_epochs=5,
    lr=0.1,
    utility="sqrt",
)

CONFIGS = {c.name: c for c in (MNIST_CONVEX, CIFAR10_NONCONVEX,
                               METROPOLIS_1K, BURSTY_1K,
                               METROPOLIS_100K, METROPOLIS_1M)}


def get_config(name: str) -> HFLExperimentConfig:
    key = name.lower()
    if key not in CONFIGS:
        raise KeyError(f"unknown experiment config {name!r}; available: "
                       f"{tuple(sorted(CONFIGS))}")
    return CONFIGS[key]
