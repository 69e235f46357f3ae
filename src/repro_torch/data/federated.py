"""Federated dataset plumbing: per-client shards, and all shards stacked
into padded tensors on a device for the batched training loop.

The data are the reference's: the same numpy generators, the same
seeds, so both packages train on identical arrays.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from repro_torch.data.synthetic import (make_synthetic_classification,
                                        non_iid_split)


@dataclass(frozen=True)
class StackedClients:
    """All client shards as tensors, padded to the largest shard. Batch
    indices are drawn in ``[0, sizes[c])``, so padding is never
    sampled."""
    x: torch.Tensor        # (N, L, ...) float32, zero-padded
    y: torch.Tensor        # (N, L) int32
    sizes: torch.Tensor    # (N,) int32 — real samples per client


@dataclass
class ClientData:
    x: np.ndarray
    y: np.ndarray


@dataclass
class FederatedDataset:
    clients: List[ClientData]
    test_x: np.ndarray
    test_y: np.ndarray
    _stacked: Dict[str, StackedClients] = field(
        default_factory=dict, repr=False, compare=False)

    def stacked(self, device=None) -> StackedClients:
        """Stack all client shards into padded tensors on ``device``
        (cached per device)."""
        key = str(torch.device(device or "cpu"))
        if key not in self._stacked:
            self._stacked[key] = self.stacked_rows(0, len(self.clients),
                                                   device)
        return self._stacked[key]

    def stacked_rows(self, lo: int, hi: int, device=None
                     ) -> StackedClients:
        """Clients ``lo .. hi`` stacked as ``stacked`` stacks all (the
        same padded length, the longest shard of all), with ``sizes``
        the global (N,) vector: a client shard's data, indexed by
        ``client - lo``, its batch sampler by global client id."""
        sizes = np.array([len(c.y) for c in self.clients], np.int32)
        if sizes.min() < 1:
            raise ValueError("every client needs at least one sample")
        lmax = int(sizes.max())
        feat = self.clients[0].x.shape[1:]
        x = np.zeros((hi - lo, lmax) + feat, np.float32)
        y = np.zeros((hi - lo, lmax), np.int32)
        for c in range(lo, hi):
            x[c - lo, :sizes[c]] = self.clients[c].x
            y[c - lo, :sizes[c]] = self.clients[c].y
        t = lambda a: torch.as_tensor(a, device=device)
        return StackedClients(x=t(x), y=t(y), sizes=t(sizes))

    @classmethod
    def synthetic(cls, num_clients: int, kind: str = "mnist",
                  samples_per_client: int = 200, test_samples: int = 2000,
                  labels_per_client: int = 2, seed: int = 0
                  ) -> "FederatedDataset":
        shapes = {"mnist": (784,), "cifar": (32, 32, 3),
                  "cifar_small": (16, 16, 3), "tiny": (16,)}
        shape = shapes[kind]
        total = num_clients * samples_per_client + test_samples
        x, y = make_synthetic_classification(total, shape=shape, seed=seed)
        test_x, test_y = x[:test_samples], y[:test_samples]
        train_x, train_y = x[test_samples:], y[test_samples:]
        splits = non_iid_split(train_y, num_clients,
                               labels_per_client=labels_per_client,
                               seed=seed)
        clients = [ClientData(train_x[s], train_y[s]) for s in splits]
        return cls(clients=clients, test_x=test_x, test_y=test_y)
