"""Cohort-mesh construction and input staging for the sharded engine.

Thin glue over ``repro_torch.launch.mesh`` and ``launch.sharding``:
``cohort_mesh`` checks the process group against the mesh a ``ShardSpec``
asks for and builds it; ``shard_layouts`` gives this rank's blocks of
each input of the sharded tier-4 block in the reference's four staging
layouts: client-indexed (S, N, ...) on ``"seed"`` and ``"clients"``,
per-seed (S, ...) on ``"seed"``, (N, ...) on ``"clients"``, everything
else replicated.
"""
from __future__ import annotations

from typing import Any

from repro_torch.launch.mesh import (CohortMesh, make_cohort_mesh,
                                     mesh_num_devices, world_size)
from repro_torch.launch.sharding import shard


def check_ranks(seed_shards: int, client_shards: int) -> None:
    """Raise ``ValueError`` unless the default process group holds
    exactly ``seed_shards * client_shards`` ranks, saying how to start
    them (the reference's device-count check)."""
    need = seed_shards * client_shards
    have = world_size()
    if have != need:
        raise ValueError(
            f"ShardSpec wants {seed_shards}x{client_shards} = {need} ranks "
            f"but the process group has {have}; start {need} ranks, each "
            f"calling repro_torch.run(spec): torchrun --nproc-per-node="
            f"{need} ..., or repro_torch.launch.mesh.spawn_local(fn, {need}, "
            "backend='gloo', ...) (gloo on the CPU and where ranks share a "
            "card, nccl where each rank has its own)")


def cohort_mesh(seed_shards: int = 1, client_shards: int = 1
                ) -> CohortMesh:
    """The ``(seed_shards, client_shards)`` mesh over the default process
    group, which must hold exactly that many ranks."""
    check_ranks(seed_shards, client_shards)
    need = seed_shards * client_shards
    mesh = make_cohort_mesh(seed_shards, client_shards)
    assert mesh_num_devices(mesh) == need
    return mesh


def shard_layouts(mesh: CohortMesh, *, seed_client: Any = None,
                  seed_only: Any = None, client_only: Any = None,
                  replicated: Any = None) -> tuple:
    """This rank's blocks of the four staging layouts, in that order:
    ``seed_client`` leaves (S, N, ...) (dim 0 over "seed", dim 1 over
    "clients"), ``seed_only`` (S, ...), ``client_only`` (N, ...),
    ``replicated`` anything (returned as given)."""
    return (shard(seed_client, mesh, {0: "seed", 1: "clients"}),
            shard(seed_only, mesh, {0: "seed"}),
            shard(client_only, mesh, {0: "clients"}),
            shard(replicated, mesh, {}))
