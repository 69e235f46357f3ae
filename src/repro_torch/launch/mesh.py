"""The cohort mesh over ``torch.distributed``, and a local launcher.

The reference lays its sharded cohort over a ``("seed", "clients")``
device mesh (``jax.make_mesh``). Here a mesh is a process group of
``seed_shards * client_shards`` ranks, rank ``r`` at coordinates
``(r // client_shards, r % client_shards)``: each seed row of ranks
shares a "clients" subgroup (the selection's merges, the packing's
exchange, the slot batches), each column a "seed" subgroup. Every rank
creates every subgroup in the same order (``dist.new_group`` is
collective). A seed row's collectives ride its own subgroup, so rows need
no lockstep with each other.

Collectives go through ``all_gather``/``all_reduce`` below: with the
``gloo`` backend a CUDA tensor is staged through the host (ranks that
share one card talk over gloo; NCCL puts no two ranks on one card), with
``nccl`` it stays on its device. ``COLLECTIVES`` counts them by the
caller's tag.

``spawn_local(fn, world, backend=..., device=..., init_file=...)`` starts
``world`` ranks on this host with ``torch.multiprocessing`` and a
``file://`` rendezvous and returns each rank's ``fn(rank, world, device,
*args)``, the counterpart of XLA's forced host device count. It builds
the CUDA kernels before any rank starts and joins with a timeout, so a
hung rank fails instead of hanging. ``run_specs`` is an ``fn`` for it:
every rank runs the same specs through ``repro_torch.run``.

``make_production_mesh`` (the TPU pod's LM mesh) belongs to the LM pod
rules, ROADMAP queue A item 6.
"""
from __future__ import annotations

import os
import queue
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

COLLECTIVES: Dict[str, int] = {}


def reset_collectives() -> None:
    COLLECTIVES.clear()


@dataclass(frozen=True)
class CohortMesh:
    """This rank's place in the ``(seed_shards, client_shards)`` mesh."""
    seed_shards: int
    client_shards: int
    rank: int
    seed: int                 # this rank's seed-row coordinate
    client: int               # this rank's client coordinate
    clients_group: Any        # the ranks of this seed row
    seed_group: Any           # the ranks of this client column
    backend: str


_MESHES: Dict[tuple, CohortMesh] = {}


def world_size() -> int:
    """Ranks in the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device() -> torch.device:
    """The CUDA device a run without an explicit device takes: rank r of
    a process group takes ``cuda:(r % device_count)``, a lone process
    the current device; raises without CUDA, as ``resolve_device``."""
    from repro_torch.kernels.common import resolve_device
    dev = resolve_device(None)
    if world_size() > 1:
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return dev


def make_cohort_mesh(seed_shards: int = 1, client_shards: int = 1
                     ) -> CohortMesh:
    """The cohort mesh over the default process group, which must hold
    exactly ``seed_shards * client_shards`` ranks (``topology.
    cohort_mesh`` checks and says how to start them). Cached a shape
    and group: every rank makes the same calls in the same order."""
    key = (seed_shards, client_shards, id(dist.group.WORLD))
    if key in _MESHES:
        return _MESHES[key]
    rank = dist.get_rank()
    rows = [dist.new_group([r * client_shards + c
                            for c in range(client_shards)])
            for r in range(seed_shards)]
    cols = [dist.new_group([r * client_shards + c
                            for r in range(seed_shards)])
            for c in range(client_shards)]
    seed, client = divmod(rank, client_shards)
    mesh = CohortMesh(seed_shards=seed_shards, client_shards=client_shards,
                      rank=rank, seed=seed, client=client,
                      clients_group=rows[seed], seed_group=cols[client],
                      backend=dist.get_backend())
    _MESHES[key] = mesh
    return mesh


def mesh_num_devices(mesh: CohortMesh) -> int:
    return mesh.seed_shards * mesh.client_shards


def _staged(t: torch.Tensor, backend: str) -> torch.Tensor:
    return t.cpu() if backend == "gloo" and t.is_cuda else t


def all_gather(t: torch.Tensor, group=None, tag: str = "gather"
               ) -> torch.Tensor:
    """``(k, *t.shape)``: every rank's ``t`` over ``group`` (the default
    group when None), in group rank order, on ``t``'s device."""
    k = dist.get_world_size(group)
    src = _staged(t.contiguous(), dist.get_backend(group))
    out = [torch.empty_like(src) for _ in range(k)]
    dist.all_gather(out, src, group=group)
    COLLECTIVES[tag] = COLLECTIVES.get(tag, 0) + 1
    return torch.stack(out).to(t.device)


def all_reduce(t: torch.Tensor, op: str = "sum", group=None,
               tag: str = "reduce") -> torch.Tensor:
    """``t`` summed (``op="sum"``) or maxed (``"max"``) over ``group``,
    as a new tensor on ``t``'s device."""
    src = _staged(t.contiguous(), dist.get_backend(group)).clone()
    dist.all_reduce(src, op=(dist.ReduceOp.SUM if op == "sum"
                             else dist.ReduceOp.MAX), group=group)
    COLLECTIVES[tag] = COLLECTIVES.get(tag, 0) + 1
    return src.to(t.device)


# -- the local launcher -------------------------------------------------------


def _rank_main(fn, rank: int, world: int, backend: str, device: str,
               init_file: str, timeout_s: float, args, results) -> None:
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout_s))
        try:
            results.put((rank, True, fn(rank, world, dev, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:                          # reported to the parent
        results.put((rank, False, traceback.format_exc()))


def spawn_local(fn, world: int, *, backend: str, device,
                init_file: str, args: Sequence = (),
                timeout: float = 600.0) -> List[Any]:
    """Run ``fn(rank, world, device, *args)`` on ``world`` ranks of this
    host (``backend`` "gloo" or "nccl"; ``device`` "cpu" or a CUDA
    device, which puts rank r on ``cuda:(r % device_count)``; it has no
    default, so no caller lands on the CPU unasked) and return the
    results in rank order. ``fn`` must be importable by name (the ranks are
    spawned). A rank that raises, or a run past ``timeout`` seconds,
    raises here after every rank is stopped."""
    import torch.multiprocessing as mp

    if torch.device(device).type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()                     # before any rank starts
    if os.path.exists(init_file):
        os.remove(init_file)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, str(device), init_file,
                               timeout, tuple(args), results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"spawn_local: {world - len(out)} of "
                                   f"{world} ranks gave no result within "
                                   f"{timeout:.0f} s")
            try:
                rank, ok, res = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.pid for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    time.sleep(0.5)            # a last report in flight
                    if results.empty():
                        raise RuntimeError(
                            f"spawn_local: ranks {dead} died without a "
                            "result")
                continue
            if not ok:
                raise RuntimeError(f"spawn_local: rank {rank} failed:\n{res}")
            out[rank] = res
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
        if os.path.exists(init_file):
            os.remove(init_file)
    return [out[r] for r in range(world)]


def run_specs(rank: int, world: int, device, specs: Sequence[str],
              data: Optional[dict] = None) -> List[dict]:
    """An ``fn`` for ``spawn_local``: every rank runs each spec (its
    JSON) through ``repro_torch.run`` on ``device``, with the synthetic
    dataset ``FederatedDataset.synthetic(**data)`` when given. Returns,
    a spec, the result's fields as numpy, the tier, the telemetry, the
    wall seconds, the peak device memory (CUDA), the sharded walk's host
    syncs, the collectives by tag and the kernels' launches."""
    import repro_torch
    from repro_torch import api
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.kernels import common
    from repro_torch.kernels.budgeted_topk.ref import WALK_SYNCS

    ds = FederatedDataset.synthetic(**data) if data is not None else None
    out = []
    for js in specs:
        spec = api.ExperimentSpec.from_json(js)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        reset_collectives()
        common.reset_launches()
        syncs0 = WALK_SYNCS["sharded_walk"]
        t0 = time.perf_counter()
        res = repro_torch.run(spec, data=ds, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        row = {f: getattr(res, f) for f in (
            "selections", "utilities", "participants", "explored",
            "eval_rounds", "accuracy", "loss")}
        row.update(tier=res.tier, telemetry=res.telemetry,
                   backend=(dist.get_backend() if dist.is_initialized()
                            else None),
                   seconds=time.perf_counter() - t0,
                   walk_syncs=WALK_SYNCS["sharded_walk"] - syncs0,
                   collectives=dict(COLLECTIVES),
                   launches=dict(common.LAUNCHES),
                   peak_bytes=(torch.cuda.max_memory_allocated(device)
                               if device.type == "cuda" else 0))
        out.append(row)
    return out


__all__ = ["COLLECTIVES", "CohortMesh", "all_gather", "all_reduce",
           "make_cohort_mesh", "mesh_num_devices", "rank_device",
           "reset_collectives", "run_specs", "spawn_local", "world_size"]
