"""Blocks of tensors over the cohort mesh's named dims.

The torch counterpart of the reference's ``dim_shardings``
(``src/repro/launch/sharding.py:137``): where a ``NamedSharding`` places
dim ``d`` of an array over a mesh axis, here a rank takes its own block
of that dim (``shard``), and ``assemble`` gathers every rank's block
back into the global tensor. Axis names are the cohort mesh's,
``"seed"`` and ``"clients"`` (``launch.mesh.CohortMesh``). The LM pod's
rules (``param_spec``, ``batch_shardings``, ...) belong to ROADMAP queue
A item 5.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from repro_torch.launch.mesh import CohortMesh, all_gather


def _coord(mesh: CohortMesh, axis: str):
    if axis == "seed":
        return mesh.seed, mesh.seed_shards
    if axis == "clients":
        return mesh.client, mesh.client_shards
    raise ValueError(f"unknown mesh axis {axis!r}; the cohort mesh has "
                     "'seed' and 'clients'")


def block(t: torch.Tensor, dim: int, index: int, parts: int
          ) -> torch.Tensor:
    """Block ``index`` of ``parts`` equal blocks of dim ``dim`` (a
    view); the dim must divide."""
    size = t.shape[dim]
    if size % parts:
        raise ValueError(f"dim {dim} of size {size} does not split into "
                         f"{parts} equal blocks")
    step = size // parts
    return t.narrow(dim, index * step, step)


def shard(tree, mesh: CohortMesh, dims: Mapping[int, str]):
    """This rank's block of every tensor leaf of ``tree`` (dicts,
    NamedTuples, tuples and lists are walked; None passes), dim ``d``
    split over mesh axis ``dims[d]``; an empty ``dims`` is the
    replicated layout."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: shard(v, mesh, dims) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(shard(v, mesh, dims) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard(v, mesh, dims) for v in tree)
    for d, axis in dims.items():
        index, parts = _coord(mesh, axis)
        tree = block(tree, d, index, parts)
    return tree


def assemble(t: torch.Tensor, mesh: CohortMesh, dims: Mapping[int, str],
             tag: str = "assemble") -> torch.Tensor:
    """The global tensor from every rank's block ``t`` (the same shape on
    every rank), dim ``d`` split over ``dims[d]``: one ``all_gather``
    over the whole mesh, then the blocks laid out by rank coordinates."""
    parts = all_gather(t, tag=tag)             # rank r at (r // c, r % c)
    c = mesh.client_shards
    rows = []
    for s in range(mesh.seed_shards):
        row = [parts[s * c + j] for j in range(c)]
        rows.append(_cat(row, dims, "clients"))
    return _cat(rows, dims, "seed")


def _cat(blocks, dims: Dict[int, str], axis: str) -> torch.Tensor:
    dim = [d for d, a in dims.items() if a == axis]
    if not dim:
        return blocks[0]                       # replicated over this axis
    return torch.cat(blocks, dim=dim[0])


__all__ = ["assemble", "block", "shard"]
