#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py             # every phase, as below
    python3 chip_smoke.py --profile   # also: a profiler trace of the
                                      # main path (kernel time by name,
                                      # device busy share)

Phases, in order; any failure exits non-zero before a result is printed:

1. header: the card (nvidia-smi), torch and CUDA versions; TF32 off;
2. build the three CUDA kernels from ``src/repro_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at awkward ones, with its device time (summed
   kernel time under torch.profiler, with the L2 cache flushed before
   each call), the plain version's and a library call's device time
   where one exists, and the bound (bytes over 3.35 TB/s, or float32
   operations over 67 TFLOP/s);
4. the main path: ``sweep_experiments(("cocs",), "device:metropolis-1k",
   seeds=(0, 1), horizon=20, eval_every=5)`` on CUDA at full width
   (1000 clients, 12 ES, 784-d logreg, 200 samples per client), with
   each kernel's launch count, budget feasibility, finite metrics,
   rounds per second and the walk's host syncs. The aggregation's slot
   capacity is each round's largest per-ES cohort, known only once the
   path ran, so masked_aggregate is checked and timed at the main
   path's shapes here, at every capacity the run used;
5. the port on the CPU against the port on CUDA (``paper`` preset).

The last three lines are the card's name and power limit, a JSON line
of per-kernel numbers, and ``{"ok": true, "device": {...}}``. Needs no
network and nothing of the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12          # H100 SXM float32 outside tensor cores


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Wall time per call between CUDA events: what a caller pays,
    host-side launch overhead included."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def kernel_rows(prof):
    """The profiler's per-kernel rows: device events only (an aten op
    and the kernel it launched are not both counted), without the
    device-side copies of ``record_function`` labels."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith("round.")]


_FLUSH = {}


def device_ms(fn, iters: int = 20, cold: bool = True) -> float:
    """Device time per call: the summed kernel time of ``iters`` calls
    under torch.profiler, over ``iters``; excludes the host's launch
    overhead, which ``cuda_ms`` includes. With ``cold``, a 256 MB
    ``bitwise_not_`` before each call evicts the 50 MB L2, so inputs
    come from device memory; its kernel is left out of the sum."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if "buf" not in _FLUSH:
        _FLUSH["buf"] = torch.zeros(64 << 20, dtype=torch.int32,
                                    device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if cold:
                _FLUSH["buf"].bitwise_not_()
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in kernel_rows(prof)
                   if "bitwise_not" not in e.key)
    if total_us <= 0:
        fail("the profiler recorded no device time")
    return total_us / iters / 1e3


def bound_ms(nbytes: float, ops: float = 0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# -- phase 3: kernels against their plain versions --------------------------

def check_context_pairwise(dev, spec):
    import numpy as np
    import torch
    from repro_torch.kernels.context_pairwise.kernel import \
        context_pairwise_kernel
    from repro_torch.kernels.context_pairwise.ref import pairwise_context_ref
    from repro_torch.core.network import es_positions
    kw = dict(tx_w=spec.tx_w, noise_psd_w=spec.noise_psd_w,
              update_bits=spec.update_bits, workload=spec.workload)

    def inputs(s, n, m, seed):
        rng = np.random.default_rng(seed)
        es = es_positions(m).astype(np.float32)
        pos = rng.uniform(-3.5, 3.5, (s, n, 2)).astype(np.float32)
        k = min(n, 4)                     # a few clients within 10 m of an ES
        pos[:, :k] = es[0] + rng.uniform(-0.005, 0.005, (s, k, 2))
        bw = rng.uniform(0.3e6, 1e6, (s, n)).astype(np.float32)
        comp = rng.uniform(2e6, 4e6, (s, n)).astype(np.float32)
        fdt = rng.exponential(size=(s, n, m)).astype(np.float32)
        fut = rng.exponential(size=(s, n, m)).astype(np.float32)
        fdt[:, -1:] = 1e-7                # weak channels
        t = lambda a: torch.as_tensor(a, device=dev)
        return [t(a) for a in (pos, es, bw, comp, fdt, fut)]

    worst, flips, n_pairs = 0.0, 0, 0
    for (s, n, m, seed) in ((2, 1000, 12, 0), (1, 37, 3, 1), (3, 1, 1, 2),
                            (2, 257, 5, 3)):
        args = inputs(s, n, m, seed)
        k = context_pairwise_kernel(*args, **kw)
        r = pairwise_context_ref(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(k.dist, r.dist):
            fail(f"context_pairwise dist not bitwise at {(s, n, m)}")
        for f in ("gain", "rate", "tau"):
            a, b = getattr(k, f), getattr(r, f)
            if not torch.isfinite(a).all():
                fail(f"context_pairwise {f} not finite at {(s, n, m)}")
            rel = ((a - b).abs() / b.abs().clamp(min=1e-30)).max().item()
            worst = max(worst, rel)
            if rel > 5e-6:
                fail(f"context_pairwise {f} rel err {rel} > 5e-6 at "
                     f"{(s, n, m)}")
        cube = lambda rate: torch.floor(
            torch.clamp(rate / spec.rate_hi, 0, 1) * 5)
        flips += int((cube(k.rate) != cube(r.rate)).sum())
        n_pairs += k.rate.numel()
    args = inputs(2, 1000, 12, 0)
    k = context_pairwise_kernel(*args, **kw)
    r = pairwise_context_ref(*args, **kw)
    err = max((getattr(k, f) - getattr(r, f)).abs().max().item()
              for f in ("dist", "gain", "rate", "tau"))
    call = lambda: context_pairwise_kernel(*args, **kw)
    ms, wall = device_ms(call), cuda_ms(call, 200)
    warm = device_ms(call, cold=False)
    plain = device_ms(lambda: pairwise_context_ref(*args, **kw))
    s, n, m = args[4].shape
    nbytes = 4 * (s * n * 2 + m * 2 + 2 * s * n + 2 * s * n * m
                  + 4 * s * n * m)
    bnd, by = bound_ms(nbytes)
    print(f"  context_pairwise: dist bitwise, gain/rate/tau max rel err "
          f"{worst:.3e} (<= 5e-6); context-cube flips {flips} of "
          f"{n_pairs} pairs")
    return dict(name="context_pairwise", route="cuda",
                source="src/repro_torch/csrc/context_pairwise.cu",
                replaces="src/repro/kernels/context_pairwise/kernel.py:62",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=None, shape=[s, n, m],
                wall_ms=wall, warm_ms=warm)


def check_budgeted_topk(dev):
    import numpy as np
    import torch
    from repro_torch.kernels.budgeted_topk.kernel import density_sort_kernel
    from repro_torch.kernels.budgeted_topk.ref import (DEFAULT_TILE,
                                                       density_sort_ref)

    def inputs(s, n, m, seed, kind="random"):
        rng = np.random.default_rng(seed)
        v = rng.random((s, n, m)).astype(np.float32)
        c = rng.uniform(0.3, 4.0, (s, n)).astype(np.float32)
        e = rng.random((s, n, m)) < 0.4
        if kind == "ties":
            v[:] = 0.5
            c[:] = 1.0
        elif kind == "ineligible":
            e[:] = False
        elif kind == "zero-cost":
            c[:, ::3] = 0.0
        t = lambda a: torch.as_tensor(a, device=dev)
        return t(v), t(c), t(e)

    cases = [(2, 1000, 12, 0, "random"), (1, 37, 3, 1, "random"),
             (2, 130, 3, 2, "ties"), (2, 64, 12, 3, "ineligible"),
             (1, 1, 1, 4, "random"), (2, 300, 7, 5, "zero-cost")]
    for (s, n, m, seed, kind) in cases:
        v, c, e = inputs(s, n, m, seed, kind)
        kd, ki = density_sort_kernel(v, c, e, DEFAULT_TILE)
        rd, ri = density_sort_ref(v, c, e, DEFAULT_TILE)
        torch.cuda.synchronize()
        if not (torch.equal(kd, rd) and torch.equal(ki, ri)):
            fail(f"budgeted_topk not bitwise at {(s, n, m, kind)}")
    v, c, e = inputs(2, 1000, 12, 0)
    kd, _ = density_sort_kernel(v, c, e, DEFAULT_TILE)
    rd, _ = density_sort_ref(v, c, e, DEFAULT_TILE)
    fin = torch.isfinite(rd)
    err = (kd[fin] - rd[fin]).abs().max().item() if fin.any() else 0.0
    call = lambda: density_sort_kernel(v, c, e, DEFAULT_TILE)
    ms, wall = device_ms(call), cuda_ms(call, 200)
    warm = device_ms(call, cold=False)
    plain = device_ms(lambda: density_sort_ref(v, c, e, DEFAULT_TILE))
    # library yardstick: one stable sort of the same rows on the
    # composite (density, index) key
    b = rd.view(torch.int32).to(torch.int64)
    key = torch.where(b < 0, b ^ 0x7FFFFFFF, b) * (1 << 32)
    lib = device_ms(lambda: torch.sort(key, dim=-1, descending=True,
                                       stable=True))
    s, n, m = v.shape
    nt, p = kd.shape[1], kd.shape[2]
    nbytes = 4 * s * n * m + 4 * s * n + s * n * m + 8 * s * nt * p
    lg = int(math.log2(p))
    ops = s * nt * (p // 2) * lg * (lg + 1) // 2
    bnd, by = bound_ms(nbytes, ops)
    print(f"  budgeted_topk: densities and indices bitwise on "
          f"{len(cases)} cases (ties, all ineligible, zero costs, "
          f"N % tile != 0)")
    return dict(name="budgeted_topk", route="cuda",
                source="src/repro_torch/csrc/density_sort.cu",
                replaces="src/repro/kernels/budgeted_topk/kernel.py:96",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=lib, shape=[s, n, m, nt, p],
                wall_ms=wall, warm_ms=warm)


def masked_aggregate_inputs(dev, r, s, d, seed, kind="random",
                            counts=None):
    """params (r, d), deltas (r, s, d), weights (r, s). With ``counts``
    (r,), row i has ``counts[i]`` filled slots (weight 1 with
    probability 0.8, as deadline arrivals) and weight 0 beyond them."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((r, d)).astype(np.float32)
    dl = (rng.standard_normal((r, s, d)) * 0.01).astype(np.float32)
    w = (rng.random((r, s)) < 0.7).astype(np.float32)
    if counts is not None:
        w = ((rng.random((r, s)) < 0.8)
             & (np.arange(s)[None, :] < np.asarray(counts)[:, None])
             ).astype(np.float32)
    if kind == "zero":
        w[:] = 0.0
    elif kind == "padded":
        w[:, s // 2:] = 0.0
        dl[:, s // 2:] = 1e30          # finite garbage in padded slots
    t = lambda a: torch.as_tensor(a, device=dev)
    return t(p), t(dl), t(w)


def masked_aggregate_agrees(p, dl, w, what) -> float:
    import torch
    from repro_torch.kernels.masked_aggregate.kernel import \
        masked_aggregate_kernel
    from repro_torch.kernels.masked_aggregate.ref import masked_aggregate_ref
    k = masked_aggregate_kernel(p, dl, w)
    ref = masked_aggregate_ref(p, dl, w)
    torch.cuda.synchronize()
    if not torch.allclose(k, ref, rtol=1e-6, atol=1e-6):
        fail(f"masked_aggregate differs at {what}")
    if not torch.isfinite(k).all():
        fail(f"masked_aggregate not finite at {what}")
    return (k - ref).abs().max().item()


def check_masked_aggregate(dev):
    """The awkward shapes; the main path's shapes are checked after it
    ran (``masked_aggregate_main``), when its capacities are known."""
    cases = [(24, 1, 7850, 1, "random"), (5, 7, 1000, 2, "zero"),
             (24, 16, 7850, 3, "padded"), (1, 3, 1, 4, "random"),
             (3, 40, 257, 5, "random")]
    worst = 0.0
    for (r, s, d, seed, kind) in cases:
        worst = max(worst, masked_aggregate_agrees(
            *masked_aggregate_inputs(dev, r, s, d, seed, kind),
            (r, s, d, kind)))
    print(f"  masked_aggregate: max abs err {worst:.3e} (rtol 1e-6, "
          f"atol 1e-6) on {len(cases)} cases (one slot, all weights 0, "
          f"padded slots, 40 slots, D=1)")
    return worst


def masked_aggregate_main(dev, counts, d, worst):
    """B3 at the shapes the main path gave it: round t aggregated
    (S*M rows, cap_t slots, D) with cap_t the round's largest per-ES
    cohort. ``counts`` (T, S*M) holds each row's filled slots. Checked
    against the plain version at every capacity the run used, timed at
    each; the JSON numbers are means over the run's rounds, so
    launches x ms is the run's kernel time."""
    import numpy as np
    import torch
    from repro_torch.kernels.masked_aggregate.kernel import \
        masked_aggregate_kernel
    from repro_torch.kernels.masked_aggregate.ref import masked_aggregate_ref
    caps = np.maximum(counts.max(axis=1), 1)
    r = counts.shape[1]
    per_cap = {}
    for cap in sorted(set(caps.tolist())):
        t = int(np.nonzero(caps == cap)[0][0])       # first round with it
        p, dl, w = masked_aggregate_inputs(dev, r, cap, d, 10 + cap,
                                           counts=counts[t])
        worst = max(worst, masked_aggregate_agrees(p, dl, w,
                                                   (r, cap, d, "main")))
        lib = lambda: p + torch.einsum("rs,rsd->rd", w, dl) \
            / torch.clamp(w.sum(1), min=1.0)[:, None]
        bnd, by = bound_ms(4 * (r * cap * d + 2 * r * d + r * cap),
                           2 * r * cap * d)
        per_cap[cap] = dict(
            ms=device_ms(lambda: masked_aggregate_kernel(p, dl, w)),
            plain_ms=device_ms(lambda: masked_aggregate_ref(p, dl, w)),
            library_ms=device_ms(lib), bound_ms=bnd, bound_by=by)
        if cap == caps.max():
            per_cap[cap]["warm_ms"] = device_ms(
                lambda: masked_aggregate_kernel(p, dl, w), cold=False)
            per_cap[cap]["wall_ms"] = cuda_ms(
                lambda: masked_aggregate_kernel(p, dl, w), 200)
    print(f"  masked_aggregate at the main path's shapes: rows {r}, D {d}, "
          f"slot capacity per round {caps.tolist()}; agrees with its plain "
          f"version at every capacity (max abs err {worst:.3e})")
    for cap, v in per_cap.items():
        extra = ("" if "warm_ms" not in v else
                 f"; {v['warm_ms'] * 1e3:.2f} us warm, "
                 f"{v['wall_ms'] * 1e3:.2f} us a call from Python")
        print(f"    {cap:3d} slots ({int((caps == cap).sum())} rounds): "
              f"kernel {v['ms'] * 1e3:.2f} us{extra}, plain "
              f"{v['plain_ms'] * 1e3:.2f} us, library "
              f"{v['library_ms'] * 1e3:.2f} us, bound "
              f"{v['bound_ms'] * 1e3:.3f} us ({v['bound_by']})")
    mean = lambda f: float(np.mean([per_cap[c][f] for c in caps]))
    big = per_cap[int(caps.max())]
    by = "bytes" if all(v["bound_by"] == "bytes" for v in per_cap.values()) \
        else "operations"
    return dict(name="masked_aggregate", route="cuda",
                source="src/repro_torch/csrc/masked_aggregate.cu",
                replaces="src/repro/kernels/masked_aggregate/kernel.py:30",
                max_abs_err=worst, ms=mean("ms"), plain_ms=mean("plain_ms"),
                bound_ms=mean("bound_ms"), bound_by=by,
                library_ms=mean("library_ms"),
                shape=[r, f"{int(caps.min())}..{int(caps.max())}", d],
                wall_ms=big["wall_ms"], warm_ms=big["warm_ms"])


# -- phase 4: the main path ---------------------------------------------------

def main_path(dev, profile: bool, preset: str = "metropolis-1k",
              horizon: int = 20, samples: int = 200):
    import numpy as np
    import torch
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.experiment.sweep import sweep_experiments
    from repro_torch.kernels import common
    from repro_torch.kernels.budgeted_topk import ops as topk_ops
    from repro_torch.models.logistic import init_logreg
    from repro_torch.sim import spec as simspec
    from repro_torch.sim.core import init_statics, round_batch

    env = simspec.make(preset)
    seeds = (0, 1)
    data = FederatedDataset.synthetic(env.cfg.num_clients, kind="mnist",
                                      samples_per_client=samples, seed=0)
    data.stacked(dev)
    torch.cuda.synchronize()
    common.reset_launches()
    topk_ops.WALK_SYNCS["greedy_walk"] = 0
    t0 = time.perf_counter()
    res = sweep_experiments(("cocs",), f"device:{preset}", seeds=seeds,
                            horizon=horizon, eval_every=5, data=data,
                            device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    syncs = topk_ops.WALK_SYNCS["greedy_walk"]
    if launches["context_pairwise"] != horizon:
        fail(f"context_pairwise launched {launches['context_pairwise']} "
             f"times in {horizon} rounds")
    if launches["budgeted_topk"] != horizon:
        fail(f"budgeted_topk launched {launches['budgeted_topk']} times "
             f"in {horizon} rounds")
    if launches["masked_aggregate"] < horizon:
        fail(f"masked_aggregate launched {launches['masked_aggregate']} "
             f"times in {horizon} rounds")
    sel = res.selections["cocs"]
    m, n = env.cfg.num_edge_servers, env.cfg.num_clients
    if sel.shape != (len(seeds), horizon, n):
        fail(f"selections shape {sel.shape}")
    if sel.min() < -1 or sel.max() >= m:
        fail("an assignment names an ES that does not exist")
    # budget feasibility: replay the (deterministic) environment for the
    # per-round costs; these launches come after the counts were read
    seed_t = torch.as_tensor(seeds, device=dev)
    statics = init_statics(env.spec, seed_t)
    pos = statics.pos0
    worst_spend = 0.0
    for t in range(horizon):
        pos, rd = round_batch(env.spec, seed_t, statics, pos, t)
        costs = rd.costs.cpu().numpy().astype(np.float64)
        elig = rd.eligible.cpu().numpy()
        for si in range(len(seeds)):
            a = sel[si, t]
            chosen = np.nonzero(a >= 0)[0]
            if not elig[si, chosen, a[chosen]].all():
                fail(f"seed {si} round {t}: an ineligible pair selected")
            spend = np.bincount(a[chosen], weights=costs[si, chosen],
                                minlength=m)
            worst_spend = max(worst_spend, float(spend.max()))
            if (spend > env.cfg.budget + 1e-6).any():
                fail(f"seed {si} round {t}: ES spend {spend.max()} over "
                     f"budget {env.cfg.budget}")
    acc, loss = res.accuracy["cocs"], res.loss["cocs"]
    if not (np.isfinite(acc).all() and np.isfinite(loss).all()):
        fail("non-finite accuracy or loss")
    if not np.isfinite(res.utilities["cocs"]).all():
        fail("non-finite utilities")
    print(f"  launches in {horizon} rounds: {launches}")
    print(f"  no client assigned twice (one ES per client); max ES spend "
          f"{worst_spend:.6f} <= budget {env.cfg.budget}")
    print(f"  wall {wall:.3f} s = {horizon / wall:.3f} rounds/s "
          f"({len(seeds)} seeds x {n} clients x {m} ES, logreg 784-d)")
    print(f"  final accuracy per seed {acc[:, -1].tolist()}; loss "
          f"{loss[:, -1].tolist()}; mean participants per round "
          f"{res.participants['cocs'].mean():.3f}")
    print(f"  greedy walk host syncs: {syncs} ({syncs / horizon:.1f} per "
          f"round)")
    if profile:
        profile_main_path(dev, data, wall / horizon)
    # each round's cohort per (seed, ES) row: the slots B3 aggregated
    counts = np.stack([np.concatenate(
        [np.bincount(sel[si, t][sel[si, t] >= 0], minlength=m)
         for si in range(len(seeds))]) for t in range(horizon)])
    nf = int(np.prod(data.test_x.shape[1:]))
    d = sum(v.numel() for v in init_logreg(num_features=nf).values())
    return launches, horizon / wall, counts, d


def profile_main_path(dev, data, round_s: float):
    """Five rounds of the main path under torch.profiler: device time by
    kernel name, host time by stage (the ``round.*`` labels of
    ``experiment/fused.py``), and the device's busy share: kernel time
    per round over the unprofiled wall time per round (``round_s``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.experiment.sweep import sweep_experiments
    sweep_experiments(("cocs",), "device:metropolis-1k", seeds=(0, 1),
                      horizon=2, eval_every=5, data=data, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep_experiments(("cocs",), "device:metropolis-1k", seeds=(0, 1),
                          horizon=5, eval_every=5, data=data, device=dev)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = kernel_rows(prof)
    dev_total = sum(e.self_device_time_total for e in rows)
    print(f"  profile (5 rounds): wall {wall_us / 1e3:.1f} ms under the "
          f"profiler, summed kernel time {dev_total / 1e3:.1f} ms; device "
          f"busy share {dev_total / 5 / (round_s * 1e6):.3f} of the "
          f"unprofiled {round_s * 1e3:.1f} ms a round")
    from torch.autograd import DeviceType
    stages = [e for e in prof.key_averages() if e.key.startswith("round.")
              and e.device_type == DeviceType.CPU]
    for e in sorted(stages, key=lambda e: -e.cpu_time_total):
        print(f"    stage {e.key:16s} {e.cpu_time_total / 1e3 / 5:9.3f} ms "
              f"host a round")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x"
              f"  {e.key[:90]}")
    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    print("  host ops by launches (5 rounds):")
    for e in sorted(ops, key=lambda e: -e.count)[:8]:
        print(f"    {e.count:6d}x  {e.cpu_time_total / 1e3:9.3f} ms host"
              f"  {e.key}")


# -- phase 5: CPU against CUDA -------------------------------------------------

def cpu_vs_cuda(dev):
    import numpy as np
    from repro_torch.experiment.sweep import sweep_experiments
    kw = dict(seeds=(0, 1), horizon=10, eval_every=5, slots_per_es=11)
    a = sweep_experiments(("cocs",), "device:paper", device="cpu", **kw)
    b = sweep_experiments(("cocs",), "device:paper", device=dev, **kw)
    sa, sb = a.selections["cocs"], b.selections["cocs"]
    rows_diff = int((sa != sb).any(axis=-1).sum())
    n_rows = sa.shape[0] * sa.shape[1]
    gap = float(np.abs(a.accuracy["cocs"] - b.accuracy["cocs"]).max())
    print(f"  paper, 2 seeds x 10 rounds: {rows_diff} of {n_rows} "
          f"selection rows differ; max accuracy gap {gap:.3e}")
    if rows_diff > 0.01 * n_rows:
        fail(f"{rows_diff} of {n_rows} selection rows differ CPU vs CUDA")
    if rows_diff == 0 and gap > 1e-3:
        fail(f"accuracy gap {gap} with identical selections")


def main() -> int:
    profile = "--profile" in sys.argv[1:]
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.sim import spec as simspec

    print("phase 1: header")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  card: {card}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"  matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda", 0)

    print("phase 2: build")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"  built {', '.join(_build.SOURCES)} in "
          f"{time.perf_counter() - t0:.2f} s into {_build.build_dir()}")
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print("phase 3: kernels against their plain versions")
    spec = simspec.make("metropolis-1k").spec
    rows = [check_context_pairwise(dev, spec), check_budgeted_topk(dev)]
    b3_worst = check_masked_aggregate(dev)
    for r in rows:
        lib = ("-" if r["library_ms"] is None
               else f"{r['library_ms'] * 1e3:.2f} us")
        print(f"  {r['name']}: kernel {r['ms'] * 1e3:.2f} us (device, L2 "
              f"flushed; {r['warm_ms'] * 1e3:.2f} us warm; "
              f"{r['wall_ms'] * 1e3:.2f} us a call from Python), plain "
              f"{r['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
              f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}) at "
              f"{r['shape']}")

    print("phase 4: main path (metropolis-1k, cuda)")
    launches, rps, counts, d = main_path(dev, profile)
    rows.append(masked_aggregate_main(dev, counts, d, b3_worst))

    print("phase 5: port on CPU against port on CUDA")
    cpu_vs_cuda(dev)

    print(f"kernels: context_pairwise={launches['context_pairwise']} "
          f"budgeted_topk={launches['budgeted_topk']} "
          f"masked_aggregate={launches['masked_aggregate']}")
    for r in rows:
        r["launches"] = launches[r["name"]]
        r.pop("shape")
        r.pop("wall_ms")
        r.pop("warm_ms")
    print(card)
    print(json.dumps({"kernels": rows, "rounds_per_s": rps}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
