"""Client-axis sharded cohort engine: the tier-4 HFL loop split over a
``("seed", "clients")`` mesh of ``torch.distributed`` ranks.

Everything client-indexed (statics, positions, per-round draws, COCS's
state, the segments the P2/P3 walks read) lives on the rank that owns
its client rows; everything ES-indexed (edge models, budgets, the
packed slots) is replicated. The counter-based draws
(``repro_torch.sim.draws``) make a shard's env rows bitwise the dense
stream's, and the cross-shard merge walk (``repro_torch.mesh.select``)
makes the hierarchical selection bitwise the dense greedy solvers, so
sharding is a capacity move: the same numbers, ``num_clients`` bounded
by the ranks' memory instead of one device's.
"""
from repro_torch.mesh.engine import ShardDims, sharded_block_device
from repro_torch.mesh.runner import sweep_sharded
from repro_torch.mesh.select import (hier_flgreedy_assign, hier_greedy_assign,
                                     merge_over_shards, shard_assign,
                                     shard_segments)
from repro_torch.mesh.topology import cohort_mesh, shard_layouts

__all__ = ["ShardDims", "cohort_mesh", "hier_flgreedy_assign",
           "hier_greedy_assign", "merge_over_shards", "shard_assign",
           "shard_layouts", "shard_segments", "sharded_block_device",
           "sweep_sharded"]
