"""Synthetic classification datasets with the paper's non-IID structure
(numpy; the same generators and seeds as the reference).

Nothing is downloaded: class-conditional Gaussian data are generated with
MNIST-like (784-d) / CIFAR-like (32x32x3) shapes and split it non-IID:
each client holds samples of only `labels_per_client` classes (=2, Sec VI-A).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def make_synthetic_classification(
        num_samples: int, num_classes: int = 10, shape: Tuple[int, ...] = (784,),
        seed: int = 0, class_sep: float = 3.2,
        ) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussian blobs: mu_c random unit direction * class_sep, sigma = 1."""
    rng = np.random.default_rng(seed)
    dim = int(np.prod(shape))
    mus = rng.standard_normal((num_classes, dim))
    mus *= class_sep / np.linalg.norm(mus, axis=1, keepdims=True)
    y = rng.integers(0, num_classes, num_samples)
    x = (rng.standard_normal((num_samples, dim)) + mus[y]).astype(np.float32)
    return x.reshape((num_samples,) + shape), y.astype(np.int32)


def non_iid_split(y: np.ndarray, num_clients: int,
                  labels_per_client: int = 2, seed: int = 0,
                  ) -> List[np.ndarray]:
    """Paper's split: each client gets samples of `labels_per_client` labels.

    Shard-based: sort by label, cut into num_clients*labels_per_client shards,
    deal labels_per_client shards to each client (McMahan et al. style).
    """
    rng = np.random.default_rng(seed)
    order = np.argsort(y, kind="stable")
    shards = np.array_split(order, num_clients * labels_per_client)
    shard_ids = rng.permutation(len(shards))
    out = []
    for c in range(num_clients):
        take = shard_ids[c * labels_per_client:(c + 1) * labels_per_client]
        idx = np.concatenate([shards[s] for s in take])
        rng.shuffle(idx)
        out.append(idx)
    return out
