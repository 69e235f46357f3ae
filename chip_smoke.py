#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py             # every phase, as below
    python3 chip_smoke.py --profile   # also: profiler traces of the
                                      # HFL main path (with B1-B3's
                                      # time a launch inside it), of
                                      # the non-convex path, of the
                                      # bandit tier's stages, and of
                                      # a prefill and decode steps of
                                      # each LM (kernel time by name,
                                      # device busy share), a depth sweep
                                      # of prefill against decode steps
                                      # of qwen2 and rwkv6

Phases, in order; any failure exits non-zero before a result is printed:

1. header: the card (nvidia-smi), torch and CUDA versions; TF32 off;
2. build the nine CUDA sources from ``src/repro_torch/csrc`` (the six
   that replace TPU kernels, B2's with its tile grid, Random's scan,
   P3's walk and P2's segment walk);
3. each HFL kernel against its plain PyTorch version on the card, at the
   main path's shapes and at awkward ones, with its device time (summed
   kernel time under torch.profiler, the median of three traces, with
   the L2 cache flushed before each call), the plain version's and a
   library call's device time where one exists, and the bound (bytes
   over 3.35 TB/s, or operations over the peak rate of their type). B1
   is held bitwise in all four fields on four cases, each field's max
   error printed a case, with its ptxas registers and spills and its
   call time through ``ops.pairwise_context``. B3 is held bitwise
   (``torch.equal``) on eight cases, one and two columns a thread, with
   its ptxas registers and spills. Then ``launch_floor_us``, the device
   time of ``torch.cuda._sleep(0)`` timed the same way. B2, the
   one-pass P2 selection (density, sort and budget walk), is held
   bitwise in assignments and budgets left on eleven cases (negative
   costs, the size limit, seeds whose walks end apart among them) and
   must refuse one size over its limit; beside its time, its plain
   version's with host syncs (CUDA events), ``torch.sort`` of the same
   keys, the pick chain's latency floor, and its ptxas registers,
   spills and shared memory. P3's walk (``flgreedy_walk``, after B2's
   keys-only launch, whose keys and counts are held bitwise too) and
   Random's scan (``random_assign``) are held bitwise in assignments and
   budgets left on nine cases each (``P3_CASES``, ``RANDOM_CASES``),
   with 0 walk host syncs, and timed cold, warm and as a call beside
   their plain versions and bounds;
4. the HFL main path: ``sweep_experiments((policy,),
   "device:metropolis-1k", seeds=(0, 1), horizon=20, eval_every=5)`` on
   CUDA at full width (1000 clients, 12 ES, 784-d logreg, 200 samples
   per client) for each of cocs, oracle and random, the counts set to 0
   before each run: each kernel's launch count (B2 for cocs and oracle,
   Random's scan for random), budget feasibility, finite metrics,
   rounds per second and the walks' host syncs, which must be 0. The
   aggregation's slot capacity is each round's largest per-ES cohort,
   known only once the path ran, so masked_aggregate is checked
   (bitwise) and timed at the main path's shapes here, at every capacity
   the run used;
5. the HFL port on the CPU against the port on CUDA, the three policies
   on ``paper`` and ``flash-crowd``;
6. flash_attention against its plain float32 version at the qwen2-1.5b
   prompt's shapes (8, 512, 12 heads, 2 KV heads, 128), on the model
   layout's transposed views as the serve path passes them: bf16 (the
   wgmma kernel) and f32 (the scalar kernel) causal, bf16 with window
   128, bf16 once more on contiguous tensors; each with its error margin
   against ``FLASH_TOL``; the bf16 kernel's ptxas registers and spills
   and its shared memory; timed beside SDPA with its TFLOP/s and share
   of the bound; then bf16 at the mixtral-8x22b prompt's (8, 512, 48, 8,
   128), checked and timed the same way;
7. rwkv6_scan against its plain per-step version at the rwkv6-1.6b
   prompt's shapes (8, 32 heads, 512, 64, 64), bf16 r/k/v (the chunked
   tensor-core kernel), on the model layout's transposed views as the
   serve path passes them, on contiguous tensors, at a strong decay (w0
   = 1, where the reference's chunked form overflows) and at a ragged
   T = 100; float32 r/k/v (the sequential kernel) on the views at phase
   10's float32 prefill, (2, 32 heads, 512); each with its error margin
   against ``SCAN_TOL``; the kernels' ptxas registers and spills and the
   chunked kernel's shared memory; timed in bf16 on the views with its
   share of the bound. Phases 6 and 7 time with CUDA events around
   loops of calls (L2 flushed, the flushes' own time subtracted), which
   read steadier than summed profiler kernel times for these long
   kernels;
8. qwen2-1.5b served at full width and depth in bf16
   (``launch.serve.run``: batch 8, 512-token prompt, 32 greedy tokens)
   with 28 flash_attention launches in its prefill; its prefill against
   token-by-token decode steps;
9. ``ServingEngine`` on qwen2-1.5b: 8 slots, 16 requests of 16-64 prompt
   tokens, 16 new tokens each;
10. rwkv6-1.6b served the same way, 24 rwkv6_scan launches in its
    prefill, then the reference launcher's token-by-token state rebuild;
    its prefill against token-by-token steps in float32;
11. the serve slice on the CPU against CUDA (every served model at
    ``reduced()``, float32, ``LM_CPU_CASES``; mixtral with a 96-token
    prompt against its reduced window of 64, so that the flash kernel's
    window and the decode mask both cut);
12. moe_router against its plain version at the mixtral prefill's
    (4096, 8, 2), a decode step's (8, 8, 2), a ragged (1000, 8, 2),
    kimi-k2's prefill (4096, 384, 8) and decode step (8, 384, 8), rows
    of exact ties (f32 and bf16), rows whose probabilities underflow,
    rows with a non-finite logit (indices 0..k-1 and NaN gates, as the
    plain version's), E = 32 and 33 (the two paths' edges), rows not 16
    bytes long, T = 1, views one row and one element in, and
    probabilities below 2^-117
    (``ROUTER_CASES``); its ptxas registers and spills; timed as phase 3
    times;
13. mixtral-8x22b served at full width and 8 of its 56 layers in bf16
    (``launch.serve.run``: batch 8, 512-token prompts, 32 greedy tokens)
    after the earlier phases' models are freed: moe_router launched 8
    times a forward (8 x 32 in all), flash_attention 8 times, peak
    memory; its prefill against token-by-token decode steps in bf16 and
    in float32 (4 layers, the float32 weights of 8 do not fit);
14. the non-convex path: the three policies on ``paper`` under
    ``CIFAR10_NONCONVEX`` (P3, the sqrt utility) with the CNN at 32x32x3
    (1,756,426 parameters), 2 seeds, on CUDA. First as configured, lr =
    0.1, where the CNN diverges as on the reference (R11): it prints the
    loss and gates launches, host syncs, budgets and selections only.
    Then with one change, lr = 0.005: it also fails on a non-finite test
    or training loss, on local SGD that does not lower the training loss
    (for each policy and seed, the mean over rounds of the loss at the
    last local step against the first), and, on seed 0 run on the CPU
    and on CUDA (cuDNN's deterministic algorithms), on an accuracy gap
    above 1e-3 (2 of 2000 test samples) or any selection row that
    differs. The test loss is printed, not gated: on this synthetic data
    it shows no trend over 30 rounds at either lr (accuracy stays near
    0.1). B3 at the CNN's width at the capacities the gated run used;
15. the bandit tier (tier 1, Fig. 3's workload) through
    ``repro_torch.run``: paper-fig3's three policies (``POLICY_TABLE``'s
    seed offsets) on ``metropolis-1k``, 2 seeds, 200 rounds with
    analytic ``true_p``, each with B1 and its selection kernel launched
    once a round, no walk host sync, every (seed, round, ES) spend
    within budget (one replay of the env), utilities equal to
    participants; the same specs with Monte-Carlo ``true_p`` for 25
    rounds, bitwise equal to the analytic runs' first 25;
    ``run_bandit_device_grid`` over budgets (8, 12, 16) x 2 seeds,
    bitwise equal to one sequential run a budget; ``device:paper`` on
    the CPU against CUDA, 20 rounds, at most 1% of rows differing; tier
    4 through ``run`` (COCS, 10 rounds) equal to ``sweep_experiments``.
    Rounds/s per policy and mode, cumulative utility and regret against
    the Oracle are printed, not gated; ``--profile`` adds ``round.env``
    and ``round.select`` host ms for 5 COCS rounds in each mode.
16. the paper's panels as written (``repro/trials/suites.py``, copied
    here as specs) on the host env through ``repro_torch.run``:
    paper-fig3 (400 rounds, seed 1, the five policies with
    ``POLICY_TABLE``'s offsets), B2 launched 400 times for COCS and for
    the Oracle, Random's scan 400 times, no kernel for CUCB and LinUCB,
    no walk host sync, every (round, ES) spend within budget, the order
    Oracle > COCS > {CUCB, LinUCB, Random} of the cumulative utilities
    (printed beside the suite's committed ``BENCH_quick.json`` rows,
    not gated on them); paper-fig4-quick (40 rounds, ``eval_every`` 5,
    budgets 3.5 and 5.0, the five policies) through ``run(grid)``: the
    batched cells equal to each cell's sequential run in selections,
    B3 launched once a round in every tier-2 and tier-3 run, accuracy
    finite; its @smoke variant on the CPU and on CUDA, selections
    identical, accuracy within 1e-3. The host rollout's seconds and
    each run's rounds/s are printed.
17. faults and robust Eq. 3 through ``repro_torch.run`` (tier 4,
    ``metropolis-1k``, logreg, 2 seeds, 20 rounds) under
    ``FAULT_RATES`` (dropout, stragglers, ES outages, corrupted
    updates): COCS, Oracle and Random under ``mean``; COCS under
    ``trimmed_mean``, ``median`` and ``clipped``, with ``FaultSpec()``,
    with no faults, with corruption alone, and in the ``logreg-t``
    layout. Gates: B1 and B2 (or Random's scan) once a round, B3 once a
    round under ``mean`` and never under a robust rule, no walk host
    sync; ``FaultSpec()`` bitwise ``faults=None``; corruption alone
    leaves selections, utilities and explored bitwise; the robust
    rules' accuracies finite; one round's captured Eq. 3 inputs
    aggregated by each rule on the card within ``RULE_TOL`` of the CPU;
    B2, P3's walk and Random's scan bitwise their plain versions on the
    first round where an outage cleared an ES column and left a client
    row empty (seed and round printed); ``device:paper`` with the four
    faults, CPU against CUDA, at most 1% of rows differing. Prints
    rounds/s a run, the fault events, mean's against median's final
    accuracy, and a local-SGD step in each logreg layout.
18. resilience and observability through ``repro_torch.run``:
    ``metropolis-1k`` tier 4 (logreg, 2 seeds, 20 rounds in 4
    intervals) for COCS, Oracle and Random, and ``paper``'s COCS on tier
    3: two uninterrupted runs bitwise equal, then killed after 1, 2 and
    3 intervals (``stop_after_blocks``) and resumed, each bitwise the
    uninterrupted run, B1, the selection's kernel and B3 launched over
    the two halves as often as in the uninterrupted run, no walk host
    sync. The CNN (lr 0.005, 4 rounds): two runs bitwise equal, then a
    resume gated bitwise (under cuDNN's deterministic algorithms where
    the default ones differ run to run, the differing field printed); at
    its configuration's lr 0.1 (R11) the health guard's ``record`` names
    the non-finite leaves and ``halt`` raises; a clean logreg run
    records none. Taps on: decisions bitwise, the counts equal to the
    host oracle; ``device:paper`` under ``FAULT_RATES`` with ``median``,
    the ``agg_adjusted`` and ``corrupted`` series equal on the card and
    the CPU. A traced run with checkpoints writes ``run.resolve``,
    ``run.dispatch``, ``train.prepare``, 4 ``fused_block_device`` spans
    with their dispatch/execute split and 4 ``checkpoint.save`` spans,
    which ``python -m repro_torch.obs`` reports and exports; an
    ``ObsSpec.jax_profiler`` directory receives a ``torch.profiler``
    trace naming B1's kernel. Prints, not gated: rounds/s with
    checkpoints, health, taps, checkpoints and tracer on against off,
    and a checkpoint write's ms and bytes.
19. the trial bench through ``repro_torch.trials.run_suite`` on the
    card, every dispatch of its runner (``api.run``) counted on its own:
    ``paper-fig4-quick`` and ``robustness-panel`` as written, and all
    three with ``paper-fig3`` at ``@smoke`` (fig3 as written is phase
    16's), into ledgers: each record's tier (fig3 1; fig4 3, or 2 for
    CUCB and LinUCB; robustness 3), one dispatch a policy and sequential
    coordinate with ``budget`` batched, each dispatch's launches (B2 a
    round for COCS and the Oracle, Random's scan a round for Random, B3
    a round when it trains under ``mean`` and never under a robust rule,
    no walk host sync), finite accuracy, and the panel's claim that at
    ``corrupt_rate`` 0.25 ``median`` and ``trimmed_mean`` beat ``mean``
    for each policy; each suite's wall s, cells/s and every record's
    ``us_per_call``. The ``@smoke`` variants on the CPU against CUDA:
    ``check_suite`` with 0 failures, utilities, regret and participation
    equal, final accuracy within ``TRIAL_ACC_TOL``. A resume of
    fig4@smoke on its ledger dispatches nothing; with one COCS entry
    dropped it runs that budget grid alone, regret as first recorded. A
    ``metropolis-1k`` suite (COCS, Oracle, Random, budgets 8, 12, 16, 2
    seeds, 40 rounds, analytic ``true_p``): one dispatch a policy with
    B1 under the runner, each cell's selections equal to its sequential
    run. ``python -m repro_torch.trials run``/``check`` and ``python -m
    repro_torch.launch.train --paper`` as subprocesses.
20. the sharded cohort: B2's tile grid (``density_sort_tiles``, the TPU
    kernel's own layout) and P2's walk over its segments
    (``segment_walk``) bitwise their plain versions on five edge cases
    (all ineligible, ties, zero budgets, an ES no client can afford,
    negative costs) and at metropolis-100k's (2, 100000, 32) and
    metropolis-1m's (1, 1000000, 64) widths on the env's round-0 costs
    and eligibility, each timed cold, warm and as a call beside its
    plain version, ``torch.sort`` of the tile rows and its bound;
    ``hier_greedy_assign``/``hier_flgreedy_assign`` at (2, 1000, 12) and
    1, 2, 4, 8 shards bitwise the dense kernels; metropolis-100k at full
    width through ``repro_torch.run`` (COCS, analytic, batch 16, an eval
    every 2 rounds, 4 rounds, seeds 0 and 1, the 16-d tiny data): dense
    on the card (B1, the tile grid, the segment walk and B3 once a
    round, no B2 one-pass launch, no walk host sync, spend within
    budget, finite accuracy), then with ``ShardSpec(clients=4)`` and
    ``ShardSpec(clients=2, seeds=2)`` on 4 ranks on ``cuda:0`` over gloo
    (``launch.mesh.spawn_local``), every field of every rank bitwise the
    dense card run, printing rounds/s, peak memory a rank and the
    sharded walk's host syncs and collectives a round; metropolis-1m
    dense, 1 seed, 2 rounds (finite accuracy, participants, spend within
    budget, seconds, rounds/s, peak memory).

21. flash_attention at the new models' prompt shapes against its plain
    float32 version (``FLASH_TOL``), each timed beside SDPA and its plain
    version with its bound: ``causal=False`` at the seamless encoder's
    (8, 1024, 16, 16, 64) in bf16 and float32 (the flag's first use on
    the main path), granite-20b's MQA (8, 512, 48, 1, 128),
    qwen2.5-14b's group of 5 (8, 512, 40, 8, 128), granite-8b's (8, 512,
    32, 8, 128), kimi-k2's (8, 512, 64, 8, 128), the seamless decoder's
    causal prefill (8, 64, 16, 16, 64) (one tile of rows) and zamba2's
    at its served prompt (8, 256, 32, 32, 64) and at (8, 512, 32, 32,
    64);
22. zamba2-1.2b at full width and depth in bf16 (``launch.serve.run``:
    batch 8, 256-token prompts in chunks of 128, 32 greedy tokens): B4
    launched 7 times in the prefill (one a shared-attention site); the
    prompt's largest chunk decay must pass exp(88.72), where the
    reference's chunked form is inf (R12), with finite logits; the
    token-by-token rebuild's seconds; its prefill against token-by-token
    steps in float32 (2 x 256) within ``STEP_TOL``;
23. seamless-m4t-large-v2 at full width and depth in bf16 (24 encoder
    and 24 decoder layers; 8 x 1024 frames, 64-token prompts, 32 greedy
    tokens). The prefill encodes the frames once, so B4 launches 24 times
    non-causal (the encoder) and 24 times causal (the decoder), each
    flag gated; finite logits;
24. paligemma-3b at full width and depth in bf16 (8 x (256 patches + 512
    tokens), 32 greedy tokens): the prefix-LM mask at head dim 256 is not
    B4's function, so B4 must not launch; finite logits; peak memory;
25. granite-8b, qwen2.5-14b and granite-20b at full width and depth in
    bf16, each freed before the next: B4 launched ``num_layers`` times in
    each prefill, finite logits; granite-20b's prefill against its
    decode steps (2 x 64) within ``STEP_TOL``;
26. kimi-k2 at full width, 1 of its 61 layers, bf16: B6 at (4096, 384,
    8) and (8, 384, 8) launched 32 times, B4 once; two prefills bitwise
    equal (the pinned k = 8 combine); dropped assignments and peak
    memory printed.

27. LM-scale HFL training (``fed.distributed``, ``launch.train``): B4's
    backward (``flash_attention_bwd``) against autograd through the
    plain float32 version (``GRAD_TOL`` of each gradient's largest
    value) at D 64 causal, window 64 on a ragged S, non-causal, groups of
    1, 6 and 8, bf16 and float32, and qwen2-1.5b's (4, 512, 12, 2, 128)
    bf16, timed there (L2 flushed, warm, a call) beside autograd through
    the plain version, SDPA's backward and the bound, with its ptxas
    registers and spills; B5's backward (``rwkv6_scan_bwd``) the same way
    on the model's views in bf16 and float32, at a strong decay (w0 = 1),
    a ragged T = 100, a nonzero final-state gradient and rwkv6-1.6b's (4,
    32, 512), timed at that shape; B6's gate gradient (``MoERouter``)
    against autograd through ``moe_router_ref`` at mixtral-reduced's (256,
    4, 2) and kimi-k2's (2048, 384, 8), with exact ties; every arch id's
    ``reduced()`` loss and gradients on the CPU against CUDA within
    ``TRAIN_CPU_TOL`` (1e-4; the ssm's 2e-2, its gradients moving with the
    rounding of the scan's output); ``launch.train.main(["--arch", ...])`` on CUDA for
    qwen2-1.5b, rwkv6-1.6b and mixtral-8x22b, 3 rounds each: finite
    losses, B2 once a round, B4/B5/B6 and their backward kernels
    launched, 0 walk host syncs; at full width in bf16, 4 SGD steps
    (lr ``TRAIN_LR``) of qwen2-1.5b on one fixed 4 x 512 batch (28
    ``flash_attention`` and 28 ``flash_attention_bwd`` launches a step,
    the loss at step 4 below step 1's, ms a step and peak GB), then
    ``make_hfl_round`` with 2 edges, ``t_es`` 2, for 2 rounds (the edges
    equal after the sync round and only then); and the same 4 steps of
    rwkv6-1.6b (24 ``rwkv6_scan`` and 24 ``rwkv6_scan_bwd`` a step).

In phases 22-26 every B4 and B6 launch of the measured run is recorded
with its flags, dtype and shape; each must be a case that phase 21 or
12 held against the plain version.

Phases 4, 8, 9, 10, 13, 14, 15, 16, 17, 18, 20, 22-26 and 27's training
steps and launcher runs each zero the launch counts just before their
run and read them just after; phase 19 just before and after each
dispatch of the trial runner.

The last three lines are the card's name and power limit, a JSON line
of per-kernel numbers (with the launch floor), and ``{"ok": true,
"device": {...}}``. Needs no network and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12          # H100 SXM float32 outside tensor cores
# B2's latency floor: its picks form a dependent chain, each one shared-
# memory read-modify-write (~30 cycles) at the H100 SXM's boost clock
PICK_CYCLES = 30
BOOST_CLOCK_HZ = 1.98e9
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense

# B4 against its plain float32 version: f32 inputs, fmaf chains and an
# online softmax against einsums, values below 4: 1e-5; bf16 inputs, the
# output rounded once to bf16: one bf16 ulp of values below 4, 2 ** -6
FLASH_TOL = {"f32": 1e-5, "bf16": 2 ** -6}
# B5 against its per-step plain version, relative to max(1, |value|):
# bf16's chunked kernel sums in another order over split operands (TF32
# hi/lo, bf16 in three pieces: a float64 emulation of their rounding,
# tools/rwkv6_split_emulation.py, erred by 4.8e-6), float32's sequential
# kernel sums 64 terms in another order
SCAN_TOL = 1e-4
# prefill against token-by-token steps at full width and depth, last
# logits of values up to ~5: qwen2-1.5b in bf16 (measured gap 7.8e-2 at
# 2 x 64 tokens on an H100, bf16 rounding of 28 layers' activations), and
# rwkv6-1.6b in float32 (measured 6.6e-3 at 2 x 512; its layers amplify
# differences, so its bf16 forms decorrelate and only float32 is gated)
STEP_TOL = {"qwen2-1.5b": 0.25, "rwkv6-1.6b": 2e-2,
            # mixtral at 8 layers in bf16, rows whose last token is routed
            # alike in both forms: as qwen2's (measured 0.098-0.134 at 8 x
            # 64 on an H100; a row whose last token took another expert
            # read 1.41-1.53); in float32 at 4 layers (measured 3.2e-5 at
            # 2 x 64 and 3.9e-5 at 8 x 64, no routing difference)
            "mixtral-8x22b": 0.25, "mixtral-8x22b-f32": 1e-3,
            # zamba2-1.2b in float32, the chunked SSD form against its step
            # form through 38 layers (measured 4.6e-5 at 2 x 256 on an
            # H100); granite-20b in bf16 at 52 layers, as qwen2's (measured
            # 0.117 at 2 x 64)
            "zamba2-1.2b": 5e-4, "granite-20b": 0.25}
# B6 against its plain version: gates from float32 softmaxes summed in
# another order, values in [0, 1]; each row's sum; the probability gap
# under which two experts' order is not decided by the plain version
ROUTER_GATE_TOL = 1e-6
ROUTER_SUM_TOL = 1e-5
ROUTER_TIE_GAP = 1e-6
MIXTRAL_LAYERS = 8              # of 56: 40.9 GB of bf16 weights
# reduced models in float32, CPU against CUDA: 2 layers' float32 sums in
# another order, logits up to ~4 (measured 1.5e-5 on the H100)
LM_CPU_TOL = 1e-4


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
# how each device_ms result was taken: "profiler" (summed kernel time) or
# "events" (CUDA events around each call, where the profiler's traces
# came back empty); printed after phase 3 and in the JSON line
TIMED_WITH = {"profiler": 0, "events": 0}


def _event_ms(fn, iters: int, cold: bool) -> float:
    """Device time per call from a pair of CUDA events around each of
    ``iters`` calls (the flush before each call, with ``cold``, stays
    outside the pair). A ~2 ms spin first holds the device while the
    host queues every call, so a pair does not wait on the host's
    launches; unlike the profiler's sum it still counts the events' own
    cost and gaps between the kernels of one call."""
    import torch
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(4_000_000)
    for a, b in pairs:
        if cold:
            _FLUSH["buf"].bitwise_not_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def device_ms(fn, iters: int = 20, cold: bool = True) -> float:
    """Device time per call: the summed kernel time of ``iters`` calls
    under torch.profiler, over ``iters``, the median of three traces (a
    single trace now and then reads far off); excludes the host's launch
    overhead, which ``cuda_ms`` includes. With ``cold``, a 256 MB
    ``bitwise_not_`` before each call evicts the 50 MB L2, so inputs
    come from device memory; its kernel is left out of the sum. The
    profiler's trace now and then comes back with no device time; where
    fewer than three of six traces hold any, the time is the median of
    three ``_event_ms`` runs instead, and the fallback is printed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if "buf" not in _FLUSH:
        _FLUSH["buf"] = torch.zeros(64 << 20, dtype=torch.int32,
                                    device="cuda")
    fn()
    torch.cuda.synchronize()
    traces = []
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if cold:
                    _FLUSH["buf"].bitwise_not_()
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in kernel_rows(prof)
                       if "bitwise_not" not in e.key)
        if total_us > 0:
            traces.append(total_us / iters / 1e3)
        if len(traces) == 3:
            TIMED_WITH["profiler"] += 1
            return sorted(traces)[1]
    TIMED_WITH["events"] += 1
    ms = sorted(_event_ms(fn, iters, cold) for _ in range(3))[1]
    print(f"    (the profiler recorded device time in {len(traces)} of 6 "
          f"traces; timed with CUDA events instead: {ms * 1e3:.2f} us)")
    return ms


def launch_floor_ms() -> float:
    """Device time of an empty launch, ``torch.cuda._sleep(0)``, timed as
    ``device_ms`` times the kernels: the least any launch takes, against
    which a kernel far under its bound is judged."""
    import torch
    return device_ms(lambda: torch.cuda._sleep(0))


def ptxas_lines(name: str) -> None:
    """nvcc's ``-Xptxas -v`` registers and spills of one source's
    kernels, a line a kernel (by its mangled name)."""
    from repro_torch.kernels import _build
    if name not in _build.BUILD_LOG:
        print(f"    {name}: built before this run, no ptxas log")
        return
    kernel, spills = "?", ""
    for line in _build.BUILD_LOG[name].splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "spill stores" in line:
            spills = line.split(":", 1)[-1].strip()
        elif "Used" in line and "registers" in line:
            used = line[line.index("Used"):].split(",")[0]
            print(f"    ptxas {kernel}: {used}; {spills}")


def event_ms(fn, iters: int = 20, cold: bool = True) -> float:
    """Device time per call from CUDA events around a loop of calls, for
    calls that keep the device busy (a few long kernels, so the host's
    launches hide behind them). With ``cold``, the 256 MB flush of
    ``device_ms`` precedes each call and a loop of flushes alone is
    subtracted. The median of three loops."""
    import torch
    if "buf" not in _FLUSH:
        _FLUSH["buf"] = torch.zeros(64 << 20, dtype=torch.int32,
                                    device="cuda")

    def loop(call: bool) -> float:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            if cold:
                _FLUSH["buf"].bitwise_not_()
            if call:
                fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    fn()
    loop(True)
    runs = sorted((loop(True) - (loop(False) if cold else 0.0)) / iters
                  for _ in range(3))
    return runs[1]


def sm_clock() -> str:
    """The card's SM clock and power draw now, as nvidia-smi reads them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip() if out.returncode == 0 else "not read"


def bound_ms(nbytes: float, ops: float = 0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# -- phase 3: kernels against their plain versions --------------------------

CONTEXT_FIELDS = ("dist", "gain", "rate", "tau")
# (S, N, M, seed): the main path's shape, then awkward ones
CONTEXT_CASES = ((2, 1000, 12, 0), (1, 37, 3, 1), (3, 1, 1, 2),
                 (2, 257, 5, 3))


def context_pairwise_kw(spec) -> dict:
    return dict(tx_w=spec.tx_w, noise_psd_w=spec.noise_psd_w,
                update_bits=spec.update_bits, workload=spec.workload)


def context_pairwise_inputs(dev, s, n, m, seed):
    """pos, es, bandwidth, compute, fad_dt, fad_ut for B1: clients over
    the metropolis area, a few within 10 m of an ES (under the path
    loss's 0.01 km floor), the last ES of every client in a deep fade."""
    import numpy as np
    import torch
    from repro_torch.core.network import es_positions
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


def context_pairwise_errors(dev, spec, case):
    """B1 against its plain version at one case: the kernel's and the
    plain outputs, and each field's max abs error. One launch, counted."""
    import torch
    from repro_torch.kernels import common
    from repro_torch.kernels.context_pairwise.kernel import \
        context_pairwise_kernel
    from repro_torch.kernels.context_pairwise.ref import pairwise_context_ref
    args, kw = context_pairwise_inputs(dev, *case), context_pairwise_kw(spec)
    before = common.LAUNCHES["context_pairwise"]
    k = context_pairwise_kernel(*args, **kw)
    if common.LAUNCHES["context_pairwise"] != before + 1:
        fail("context_pairwise did not count its launch once")
    r = pairwise_context_ref(*args, **kw)
    torch.cuda.synchronize()
    errs = {f: (getattr(k, f) - getattr(r, f)).abs().max().item()
            for f in CONTEXT_FIELDS}
    return k, r, errs


def check_context_pairwise(dev, spec):
    """B1 bitwise with its plain version in all four fields at every
    case; its time at the main path's shape."""
    import torch
    from repro_torch.kernels.context_pairwise.kernel import \
        context_pairwise_kernel
    from repro_torch.kernels.context_pairwise.ops import pairwise_context
    from repro_torch.kernels.context_pairwise.ref import pairwise_context_ref
    kw = context_pairwise_kw(spec)
    flips, n_pairs, err = 0, 0, 0.0
    for case in CONTEXT_CASES:
        s, n, m, _ = case
        k, r, errs = context_pairwise_errors(dev, spec, case)
        print(f"  context_pairwise at {(s, n, m)}: max abs err "
              + ", ".join(f"{f} {e:.3e}" for f, e in errs.items()))
        for f in CONTEXT_FIELDS:
            a, b = getattr(k, f), getattr(r, f)
            if not torch.isfinite(a).all():
                fail(f"context_pairwise {f} not finite at {(s, n, m)}")
            if not torch.equal(a, b):
                fail(f"context_pairwise {f} not bitwise at {(s, n, m)}")
        cube = lambda rate: torch.floor(
            torch.clamp(rate / spec.rate_hi, 0, 1) * 5)
        flips += int((cube(k.rate) != cube(r.rate)).sum())
        n_pairs += k.rate.numel()
        if case == CONTEXT_CASES[0]:
            err = max(errs.values())
    args = context_pairwise_inputs(dev, *CONTEXT_CASES[0])
    call = lambda: context_pairwise_kernel(*args, **kw)
    ms, wall = device_ms(call), cuda_ms(call, 200)
    warm = device_ms(call, cold=False)
    ops_wall = cuda_ms(lambda: pairwise_context(*args, **kw), 200)
    plain = device_ms(lambda: pairwise_context_ref(*args, **kw))
    s, n, m = args[4].shape
    nbytes = 4 * (s * n * 2 + m * 2 + 2 * s * n + 2 * s * n * m
                  + 4 * s * n * m)
    bnd, by = bound_ms(nbytes)
    print(f"  context_pairwise: all four fields bitwise on "
          f"{len(CONTEXT_CASES)} cases; context-cube flips {flips} of "
          f"{n_pairs} pairs; "
          f"{ops_wall * 1e3:.2f} us a call through ops.pairwise_context "
          f"(the main path's)")
    ptxas_lines("context_pairwise")
    return dict(name="context_pairwise", route="cuda",
                source="src/repro_torch/csrc/context_pairwise.cu",
                replaces="src/repro/kernels/context_pairwise/kernel.py:62",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=None, shape=[s, n, m],
                wall_ms=wall, warm_ms=warm)


def topk_inputs(dev, s, n, m, seed, kind="random"):
    """values, costs, budgets, eligible for B2. ``main``: the main path's
    statistics on metropolis-1k (~28% of pairs eligible, costs 0.3-4,
    budget 12 an ES, ~200 picks a seed)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    v = rng.random((s, n, m)).astype(np.float32)
    c = rng.uniform(0.3, 4.0, (s, n)).astype(np.float32)
    e = rng.random((s, n, m)) < {"main": 0.285, "full": 0.95,
                                 "nonconvex": 0.6}.get(kind, 0.4)
    b = np.full((s, m), {"main": 12.0, "nonconvex": 40.0}.get(kind, 3.5),
                np.float32)
    if kind == "nonconvex":            # CIFAR10_NONCONVEX's costs, 2-16
        c = rng.uniform(2.0, 16.0, (s, n)).astype(np.float32)
    elif kind == "coarse":             # few distinct rates: ties
        v = np.round(v * 3) / 3
        c = np.round(c)
    elif kind == "ties":
        v[:] = 0.5
        c[:] = 1.0
    elif kind == "ineligible":
        e[:] = False
    elif kind == "zero-cost":
        c[:, ::3] = 0.0
    elif kind == "negative-cost":      # some budgets start below zero and
        c[:, ::5] = -rng.uniform(0.5, 2.0, c[:, ::5].shape)  # grow back
        c[:, 1::7] = 0.0
        b[:, ::3] = -1.0
    elif kind == "zero-budget":
        b[:, ::2] = 0.0
    elif kind == "tight":              # costs at the budget edge
        c[:] = 3.5
        c[:, ::4] = 0.0
    elif kind == "one-each":           # ties, one pick an ES
        v[:] = 0.5
        c[:] = 1.0
        b[:] = 1.0
    t = lambda a: torch.as_tensor(a, device=dev)
    return t(v), t(c), t(b), t(e)


def check_budgeted_topk(dev):
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.budgeted_topk.kernel import (
        MAX_PAIRS, budgeted_topk_kernel, smem_bytes)
    from repro_torch.kernels.budgeted_topk.ref import (budgeted_topk_ref,
                                                       pair_density)

    cases = [(2, 1000, 12, 0, "main"), (2, 1000, 12, 1, "random"),
             (2, 130, 3, 2, "ties"), (2, 64, 12, 3, "ineligible"),
             (2, 300, 7, 4, "zero-cost"), (2, 300, 12, 5, "negative-cost"),
             (2, 200, 6, 6, "zero-budget"), (2, 200, 6, 7, "tight"),
             (1, 1, 1, 8, "random"), (2, 2048, 8, 9, "full")]
    runs = [(c, topk_inputs(dev, *c)) for c in cases]
    # S = 3, walks of different lengths side by side: long, empty, short
    parts = [topk_inputs(dev, 1, 400, 6, 10 + i, k)
             for i, k in enumerate(("random", "ineligible", "one-each"))]
    runs.append(((3, 400, 6, 10, "long, empty, short walks"),
                 [torch.cat(x) for x in zip(*parts)]))
    for case, args in runs:
        ka, kr = budgeted_topk_kernel(*args)
        ra, rr = budgeted_topk_ref(*args)
        torch.cuda.synchronize()
        if not (torch.equal(ka, ra)
                and torch.equal(kr.view(torch.int32), rr.view(torch.int32))):
            fail(f"budgeted_topk not bitwise at {case}")
    try:
        budgeted_topk_kernel(*topk_inputs(dev, 1, MAX_PAIRS + 1, 1, 11))
    except ValueError:
        pass
    else:
        fail(f"budgeted_topk took N * M = {MAX_PAIRS + 1} > {MAX_PAIRS}")
    v, c, b, e = args = topk_inputs(dev, 2, 1000, 12, 0, "main")
    call = lambda: budgeted_topk_kernel(*args)
    ka, kr = call()
    ra, rr = budgeted_topk_ref(*args)
    err = float(max((ka - ra).abs().max().item(),
                    (kr - rr).abs().max().item()))
    ms, wall = device_ms(call), cuda_ms(call, 200)
    warm = device_ms(call, cold=False)
    plain = cuda_ms(lambda: budgeted_topk_ref(*args), iters=4, warmup=1)
    # yardstick of the sort alone: one library sort of the same composite
    # (density image, flat index) keys, every pair of each seed
    s, n, m = v.shape
    d = pair_density(v, c, e).reshape(s, n * m) + 0.0
    bits = d.view(torch.int32).to(torch.int64)
    comp = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits) * (1 << 32) \
        + torch.arange(n * m, device=dev)
    sort_ms = device_ms(lambda: torch.sort(comp, dim=-1, descending=True))
    nbytes = 4 * s * n * m + s * n * m + 4 * s * n + 4 * s * m \
        + 4 * s * n + 4 * s * m
    bnd, by = bound_ms(nbytes, s * n * m)
    picks = int((ka >= 0).sum(dim=1).max())
    kept = int((pair_density(v, c, e) > 0).sum(dim=(1, 2)).max())
    chain_ms = picks * PICK_CYCLES / BOOST_CLOCK_HZ * 1e3
    print(f"  budgeted_topk: assign and remaining bitwise on {len(runs)} "
          f"cases (main path's statistics, random, ties at N*M = 390, all "
          f"ineligible, zero costs, negative costs, zero budgets on "
          f"alternate ES, tight, (1, 1, 1), N*M = {MAX_PAIRS} at 95% "
          f"eligible, S = 3 with walks of different lengths); N*M = "
          f"{MAX_PAIRS + 1} refused")
    for line in _build.BUILD_LOG.get("budgeted_topk", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"    ptxas: {line.strip()}")
    print(f"    dynamic shared memory {smem_bytes(n, m)} B at N={n}, M={m} "
          f"({smem_bytes(2048, 8)} B at the limit)")
    print(f"    at {[s, n, m]}: {kept} pairs of density > 0 and {picks} "
          f"picks in the larger seed; torch.sort of the {n * m} composite "
          f"keys a seed {sort_ms * 1e3:.2f} us; latency floor of the pick "
          f"chain {chain_ms * 1e3:.3f} us ({picks} x {PICK_CYCLES} cycles "
          f"at {BOOST_CLOCK_HZ / 1e9:.2f} GHz); plain version with its host "
          f"syncs {plain * 1e3:.2f} us a call")
    return dict(name="budgeted_topk", route="cuda",
                source="src/repro_torch/csrc/budgeted_topk.cu",
                replaces="src/repro/kernels/budgeted_topk/kernel.py:96",
                max_abs_err=err,
                ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=None, shape=[s, n, m], wall_ms=wall,
                warm_ms=warm)


# (S, N, M, kind): the non-convex path's shape first, then metropolis-1k's
# and awkward ones
P3_CASES = ((2, 50, 3, "nonconvex"), (2, 1000, 12, "main"),
            (2, 130, 3, "ties"), (3, 130, 5, "coarse"),
            (2, 64, 12, "ineligible"), (2, 300, 7, "zero-cost"),
            (2, 300, 12, "negative-cost"), (1, 1, 1, "random"),
            (2, 2048, 8, "full"))


def check_flgreedy_walk(dev):
    """P3's walk: B2's keys-only launch held bitwise (keys, counts) against
    its plain sort, the walk held bitwise (assign, remaining) against the
    plain P3 walk, on ``P3_CASES`` and three seeds of different walk
    lengths side by side; no host sync in either launch. Timed (the walk
    kernel alone, on the keys) at the non-convex path's shape, with the
    plain walk on prebuilt segments."""
    import torch
    from repro_torch.kernels import common
    from repro_torch.kernels.budgeted_topk.kernel import (
        budgeted_topk_keys_kernel, flgreedy_walk_kernel, key_capacity)
    from repro_torch.kernels.budgeted_topk.ops import (WALK_SYNCS,
                                                       flgreedy_topk_walk)
    from repro_torch.kernels.budgeted_topk.ref import (
        build_segments, candidate_keys_ref, flgreedy_topk_ref,
        flgreedy_walk)
    runs = [(c, topk_inputs(dev, c[0], c[1], c[2], i, c[3]))
            for i, c in enumerate(P3_CASES)]
    parts = [topk_inputs(dev, 1, 400, 6, 20 + i, k)
             for i, k in enumerate(("random", "ineligible", "one-each"))]
    runs.append(((3, 400, 6, "long, empty, short walks"),
                 [torch.cat(x) for x in zip(*parts)]))
    picks = {}
    for case, (v, c, b, e) in runs:
        s, n, m = v.shape
        before = dict(common.LAUNCHES)
        syncs = WALK_SYNCS["flgreedy_walk"]
        keys, counts = budgeted_topk_keys_kernel(v, c, e)
        ka, kr = flgreedy_walk_kernel(keys, counts, v, c, b)
        kops = flgreedy_topk_walk(v, c, b, e)[0]
        for name in ("budgeted_topk", "flgreedy_walk"):
            if common.LAUNCHES[name] != before[name] + 2:
                fail(f"{name} did not count its launch once a call at "
                     f"{case}")
        if WALK_SYNCS["flgreedy_walk"] != syncs:
            fail(f"P3's walk synced with the host on CUDA at {case}")
        rk, rc = candidate_keys_ref(v, c, e, key_capacity(n, m))
        ra, rr = flgreedy_topk_ref(v, c, b, e)
        torch.cuda.synchronize()
        if not (torch.equal(keys, rk) and torch.equal(counts, rc)):
            fail(f"budgeted_topk's keys-only sort not bitwise at {case}")
        if not (torch.equal(ka, ra)
                and torch.equal(kr.view(torch.int32), rr.view(torch.int32))):
            fail(f"flgreedy_walk not bitwise at {case}")
        if not torch.equal(kops, ra):
            fail(f"ops.flgreedy_topk_walk not bitwise at {case}")
        picks[case] = int((ka >= 0).sum(dim=1).max())
    syncs_after = WALK_SYNCS["flgreedy_walk"]
    print(f"  flgreedy_walk: B2's keys and counts, then assign and "
          f"remaining, bitwise on {len(runs)} cases (the non-convex "
          f"path's statistics, metropolis-1k's, ties, coarse rates, all "
          f"ineligible, zero and negative costs, (1, 1, 1), N*M = 16384 "
          f"at 95% eligible, S = 3 with walks of different lengths); "
          f"walk host syncs on CUDA: 0; picks in the larger seed "
          f"{list(picks.values())}")
    ptxas_lines("flgreedy_walk")
    out = {}
    for case in P3_CASES[:2]:
        v, c, b, e = args = topk_inputs(dev, case[0], case[1], case[2], 0,
                                        case[3])
        s, n, m = v.shape
        keys, counts = budgeted_topk_keys_kernel(v, c, e)
        call = lambda: flgreedy_walk_kernel(keys, counts, v, c, b)
        ka, kr = call()
        ra, rr = flgreedy_topk_ref(*args)
        err = float(max((ka - ra).abs().max().item(),
                        (kr - rr).abs().max().item()))
        segs = build_segments(v, c, e, n)
        plain = cuda_ms(lambda: flgreedy_walk(segs, b, num_es=m,
                                              num_clients=n, m_div=float(m)),
                        iters=4, warmup=1)
        ms, warm = device_ms(call), device_ms(call, cold=False)
        wall = cuda_ms(call, 200)
        sort_ms = device_ms(lambda: budgeted_topk_keys_kernel(v, c, e))
        # bytes: values, costs, keys, budgets in; assign, remaining out;
        # operations: ~10 float operations (two roots, a division) per
        # candidate rescored, every candidate at every pick (+1 final)
        cand = int(counts.max())
        npick = int((ka >= 0).sum(dim=1).max())
        nbytes = 4 * s * n * m + 8 * s * n + 8 * int(counts.sum()) \
            + 8 * s * m
        bnd, by = bound_ms(nbytes, 10.0 * s * cand * (npick + 1))
        print(f"    at {[s, n, m]} ({case[3]}): {cand} candidates and "
              f"{npick} picks in the larger seed; walk kernel "
              f"{ms * 1e3:.2f} us cold, {warm * 1e3:.2f} warm, "
              f"{wall * 1e3:.2f} a call; B2's keys-only launch "
              f"{sort_ms * 1e3:.2f} us; plain walk {plain * 1e3:.2f} us "
              f"with its host syncs; bound {bnd * 1e3:.3f} us ({by})")
        out[case] = dict(name="flgreedy_walk", route="cuda",
                         source="src/repro_torch/csrc/flgreedy_walk.cu",
                         replaces="none: not a TPU kernel (the reference's "
                         "XLA while_loop, src/repro/kernels/budgeted_topk/"
                         "ops.py:244)",
                         max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=bnd, bound_by=by, library_ms=None,
                         shape=[s, n, m], wall_ms=wall, warm_ms=warm,
                         keys_ms=sort_ms)
    if WALK_SYNCS["flgreedy_walk"] - syncs_after == 0:
        fail("the plain walk made no host sync (its count is broken)")
    row = out[P3_CASES[0]]
    row.pop("keys_ms")
    return row


# (S, N, M, kind): metropolis-1k's shape first, then the non-convex path's
# and awkward ones; "ties" rounds the Gumbels to integers
RANDOM_CASES = ((2, 1000, 12, "main"), (2, 50, 3, "nonconvex"),
                (2, 130, 3, "ties"), (2, 64, 12, "ineligible"),
                (2, 300, 12, "negative-cost"), (2, 300, 40, "random"),
                (1, 200, 200, "random"), (1, 1, 1, "random"),
                (2, 1024, 8, "full"))


def check_random_assign(dev):
    """Random's scan held bitwise (assign, remaining) against its plain
    version on the same draws, on ``RANDOM_CASES``; timed at
    metropolis-1k's shape. It reads nothing back to the host."""
    import torch
    from repro_torch import random as jr
    from repro_torch.kernels import common
    from repro_torch.kernels.random_assign.kernel import random_assign_kernel
    from repro_torch.kernels.random_assign.ops import random_draws
    from repro_torch.kernels.random_assign.ref import random_assign_ref
    picks = []
    for i, (s, n, m, kind) in enumerate(RANDOM_CASES):
        v, c, b, e = topk_inputs(dev, s, n, m, 30 + i, kind)
        order, gum = random_draws(jr.PRNGKey(torch.arange(s, device=dev)
                                             + 100 * i), n, m)
        if kind == "ties":
            gum = torch.round(gum)
        before = common.LAUNCHES["random_assign"]
        ka, kr = random_assign_kernel(order, gum, c, b, e)
        if common.LAUNCHES["random_assign"] != before + 1:
            fail("random_assign did not count its launch once")
        ra, rr = random_assign_ref(order, gum, c, b, e)
        torch.cuda.synchronize()
        if not (torch.equal(ka, ra)
                and torch.equal(kr.view(torch.int32), rr.view(torch.int32))):
            fail(f"random_assign not bitwise at {(s, n, m, kind)}")
        picks.append(int((ka >= 0).sum(dim=1).max()))
    print(f"  random_assign: assign and remaining bitwise on "
          f"{len(RANDOM_CASES)} cases (metropolis-1k's statistics, the "
          f"non-convex path's, equal Gumbels, all ineligible, negative "
          f"costs, M = 40 and 200 (2 and 7 ESs a lane), (1, 1, 1), 95% "
          f"eligible); picks in the larger seed {picks}")
    ptxas_lines("random_assign")
    s, n, m, kind = RANDOM_CASES[0]
    v, c, b, e = topk_inputs(dev, s, n, m, 0, kind)
    order, gum = random_draws(jr.PRNGKey(torch.arange(s, device=dev)), n, m)
    call = lambda: random_assign_kernel(order, gum, c, b, e)
    ka, kr = call()
    ra, rr = random_assign_ref(order, gum, c, b, e)
    err = float(max((ka - ra).abs().max().item(),
                    (kr - rr).abs().max().item()))
    ms, warm = device_ms(call), device_ms(call, cold=False)
    wall = cuda_ms(call, 200)
    plain = cuda_ms(lambda: random_assign_ref(order, gum, c, b, e), iters=3,
                    warmup=1)
    # bytes: order, gumbel, costs, budgets, eligible in; assign, remaining
    # out; a compare a (client, ES)
    nbytes = 4 * s * n + 4 * s * n * m + 4 * s * n + 4 * s * m \
        + s * n * m + 4 * s * n + 4 * s * m
    bnd, by = bound_ms(nbytes, s * n * m)
    small = topk_inputs(dev, 2, 50, 3, 0, "nonconvex")
    so, sg = random_draws(jr.PRNGKey(torch.arange(2, device=dev)), 50, 3)
    small_ms = device_ms(lambda: random_assign_kernel(so, sg, small[1],
                                                      small[2], small[3]))
    print(f"    at {[s, n, m]}: kernel {ms * 1e3:.2f} us cold, "
          f"{warm * 1e3:.2f} warm, {wall * 1e3:.2f} a call; at the "
          f"non-convex path's [2, 50, 3] {small_ms * 1e3:.2f} us cold; "
          f"plain {plain * 1e3:.2f} us")
    return dict(name="random_assign", route="cuda",
                source="src/repro_torch/csrc/random_assign.cu",
                replaces="none: not a TPU kernel (the reference's XLA "
                "lax.scan, src/repro/policies/solvers.py:148)",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=None, shape=[s, n, m],
                wall_ms=wall, warm_ms=warm)


def masked_aggregate_inputs(dev, r, s, d, seed, kind="random",
                            counts=None):
    """params (r, d), deltas (r, s, d), weights (r, s). With ``counts``
    (r,), row i has ``counts[i]`` filled slots (weight 1 with
    probability 0.8, as deadline arrivals) and weight 0 beyond them.
    ``offset``: every tensor starts 4 bytes past an 8-byte boundary."""
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

    def t(a):
        if kind != "offset":
            return torch.as_tensor(a, device=dev)
        buf = torch.empty(a.size + 1, dtype=torch.float32, device=dev)
        buf[1:].copy_(torch.as_tensor(a.ravel()))
        return buf[1:].view(a.shape)
    return t(p), t(dl), t(w)


def masked_aggregate_agrees(p, dl, w, what) -> float:
    """B3 bitwise with its plain version on one input; one launch,
    counted."""
    import torch
    from repro_torch.kernels import common
    from repro_torch.kernels.masked_aggregate.kernel import \
        masked_aggregate_kernel
    from repro_torch.kernels.masked_aggregate.ref import masked_aggregate_ref
    before = common.LAUNCHES["masked_aggregate"]
    k = masked_aggregate_kernel(p, dl, w)
    if common.LAUNCHES["masked_aggregate"] != before + 1:
        fail("masked_aggregate did not count its launch once")
    ref = masked_aggregate_ref(p, dl, w)
    torch.cuda.synchronize()
    if not torch.equal(k, ref):
        fail(f"masked_aggregate not bitwise at {what} (max abs err "
             f"{(k - ref).abs().max().item():.3e})")
    if not torch.isfinite(k).all():
        fail(f"masked_aggregate not finite at {what}")
    return (k - ref).abs().max().item()


def check_masked_aggregate(dev):
    """The awkward shapes; the main path's shapes are checked after it
    ran (``masked_aggregate_main``), when its capacities are known.
    ``offset``: every tensor starts 4 bytes past an 8-byte boundary, so
    an even D takes the one-column loads."""
    cases = [(24, 1, 7850, 1, "random"), (5, 7, 1000, 2, "zero"),
             (24, 16, 7850, 3, "padded"), (1, 3, 1, 4, "random"),
             (3, 40, 257, 5, "random"), (24, 8, 7850, 6, "random"),
             (24, 9, 7850, 7, "padded"), (24, 27, 7850, 8, "offset")]
    worst = 0.0
    for (r, s, d, seed, kind) in cases:
        worst = max(worst, masked_aggregate_agrees(
            *masked_aggregate_inputs(dev, r, s, d, seed, kind),
            (r, s, d, kind)))
    print(f"  masked_aggregate: bitwise (torch.equal) on {len(cases)} "
          f"cases (one slot, all weights 0, padded slots of 1e30, D=1, 40 "
          f"slots, 8 and 9 slots, 27 slots at an offset)")
    ptxas_lines("masked_aggregate")
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
          f"slot capacity per round {caps.tolist()}; bitwise with its "
          f"plain version at every capacity")
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

POLICIES = ("cocs", "oracle", "random")
# the kernels each policy's selection launches once a round
SELECT_KERNELS = {"cocs": ("budgeted_topk",), "oracle": ("budgeted_topk",),
                  "random": ("random_assign",)}
P3_KERNELS = ("budgeted_topk", "flgreedy_walk")


def spend_within_budget(env, dev, seeds, sel, what):
    """Replays the (deterministic) environment for the per-round costs
    and holds every selection to eligibility and its ES's budget; these
    launches come after the counts were read. Returns the largest
    spend."""
    import numpy as np
    import torch
    from repro_torch.sim.core import init_statics, round_batch
    m, budget = env.cfg.num_edge_servers, env.cfg.budget
    seed_t = torch.as_tensor(seeds, device=dev)
    statics = init_statics(env.spec, seed_t)
    pos = statics.pos0
    worst = 0.0
    for t in range(sel.shape[1]):
        pos, rd = round_batch(env.spec, seed_t, statics, pos, t)
        costs = rd.costs.cpu().numpy().astype(np.float64)
        elig = rd.eligible.cpu().numpy()
        for si in range(len(seeds)):
            a = sel[si, t]
            chosen = np.nonzero(a >= 0)[0]
            if not elig[si, chosen, a[chosen]].all():
                fail(f"{what}: seed {si} round {t}: an ineligible pair "
                     f"selected")
            spend = np.bincount(a[chosen], weights=costs[si, chosen],
                                minlength=m)
            worst = max(worst, float(spend.max()))
            if (spend > budget + 1e-6).any():
                fail(f"{what}: seed {si} round {t}: ES spend "
                     f"{spend.max()} over budget {budget}")
    return worst


def main_path(dev, profile: bool, preset: str = "metropolis-1k",
              horizon: int = 20, samples: int = 200):
    """Each policy's run on the HFL main path, with the launch counts set
    to 0 just before it and read just after. Returns the launches summed
    over the three runs, rounds/s by policy, the per-round cohorts of
    every run (the slots B3 aggregated) and B3's width."""
    import numpy as np
    import torch
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.experiment.sweep import sweep_experiments
    from repro_torch.kernels import common
    from repro_torch.kernels.budgeted_topk import ops as topk_ops
    from repro_torch.models.logistic import init_logreg
    from repro_torch.sim import spec as simspec

    env = simspec.make(preset)
    seeds = (0, 1)
    m, n = env.cfg.num_edge_servers, env.cfg.num_clients
    data = FederatedDataset.synthetic(n, kind="mnist",
                                      samples_per_client=samples, seed=0)
    data.stacked(dev)
    torch.cuda.synchronize()
    total = {k: 0 for k in common.LAUNCHES}
    rps, counts = {}, []
    for pol in POLICIES:
        common.reset_launches()
        for k in topk_ops.WALK_SYNCS:
            topk_ops.WALK_SYNCS[k] = 0
        t0 = time.perf_counter()
        res = sweep_experiments((pol,), f"device:{preset}", seeds=seeds,
                                horizon=horizon, eval_every=5, data=data,
                                device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(common.LAUNCHES)
        syncs = dict(topk_ops.WALK_SYNCS)
        for k, v in launches.items():
            total[k] += v
        if launches["context_pairwise"] != horizon:
            fail(f"{pol}: context_pairwise launched "
                 f"{launches['context_pairwise']} times in {horizon} rounds")
        for k in ("budgeted_topk", "random_assign", "flgreedy_walk"):
            want = horizon if k in SELECT_KERNELS[pol] else 0
            if launches[k] != want:
                fail(f"{pol}: {k} launched {launches[k]} times in "
                     f"{horizon} rounds, expected {want}")
        if any(syncs.values()):
            fail(f"{pol}: a selection walk synced with the host on CUDA: "
                 f"{syncs}")
        if launches["masked_aggregate"] < horizon:
            fail(f"{pol}: masked_aggregate launched "
                 f"{launches['masked_aggregate']} times in {horizon} "
                 f"rounds")
        sel = res.selections[pol]
        if sel.shape != (len(seeds), horizon, n):
            fail(f"{pol}: selections shape {sel.shape}")
        if sel.min() < -1 or sel.max() >= m:
            fail(f"{pol}: an assignment names an ES that does not exist")
        worst = spend_within_budget(env, dev, seeds, sel, pol)
        acc, loss = res.accuracy[pol], res.loss[pol]
        if not (np.isfinite(acc).all() and np.isfinite(loss).all()):
            fail(f"{pol}: non-finite accuracy or loss")
        if not np.isfinite(res.utilities[pol]).all():
            fail(f"{pol}: non-finite utilities")
        rps[pol] = horizon / wall
        print(f"  {pol}: launches in {horizon} rounds "
              f"{ {k: v for k, v in launches.items() if v} }; walk host "
              f"syncs {syncs}; max ES spend {worst:.6f} <= budget "
              f"{env.cfg.budget}")
        print(f"    wall {wall:.3f} s = {rps[pol]:.3f} rounds/s "
              f"({len(seeds)} seeds x {n} clients x {m} ES, logreg 784-d); "
              f"final accuracy per seed {acc[:, -1].tolist()}; loss "
              f"{loss[:, -1].tolist()}; mean participants a round "
              f"{res.participants[pol].mean():.3f}")
        # each round's cohort per (seed, ES) row: the slots B3 aggregated
        counts.append(np.stack([np.concatenate(
            [np.bincount(sel[si, t][sel[si, t] >= 0], minlength=m)
             for si in range(len(seeds))]) for t in range(horizon)]))
    if profile:
        profile_main_path(dev, data, 1.0 / rps["cocs"])
    nf = int(np.prod(data.test_x.shape[1:]))
    d = sum(v.numel() for v in init_logreg(num_features=nf).values())
    return total, rps, np.concatenate(counts), d


def profile_main_path(dev, data, round_s: float):
    """Five rounds of the main path under torch.profiler: device time by
    kernel name, host time by stage (the ``round.*`` labels of
    ``experiment/fused.py``), the device's busy share: kernel time per
    round over the unprofiled wall time per round (``round_s``), and
    B1-B3's device time a launch inside the path, where B3 finds the
    deltas training has just written in the L2."""
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
    for name in ("context_pairwise", "budgeted_topk", "masked_aggregate"):
        hand = [e for e in rows if name in e.key]
        n = sum(e.count for e in hand)
        if n:
            print(f"    {name} in the path: {n} launches, "
                  f"{sum(e.self_device_time_total for e in hand) / n:.2f} "
                  f"us a launch")
    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    print("  host ops by launches (5 rounds):")
    for e in sorted(ops, key=lambda e: -e.count)[:8]:
        print(f"    {e.count:6d}x  {e.cpu_time_total / 1e3:9.3f} ms host"
              f"  {e.key}")


# -- phase 5: CPU against CUDA -------------------------------------------------

def cpu_vs_cuda(dev):
    """The HFL port on the CPU against the port on CUDA, each policy on
    ``paper`` and ``flash-crowd``, 2 seeds x 10 rounds."""
    import numpy as np
    from repro_torch.experiment.sweep import sweep_experiments
    kw = dict(seeds=(0, 1), horizon=10, eval_every=5, slots_per_es=11)
    out = {}
    for preset in ("paper", "flash-crowd"):
        a = sweep_experiments(POLICIES, f"device:{preset}", device="cpu",
                              **kw)
        b = sweep_experiments(POLICIES, f"device:{preset}", device=dev,
                              **kw)
        for pol in POLICIES:
            sa, sb = a.selections[pol], b.selections[pol]
            rows_diff = int((sa != sb).any(axis=-1).sum())
            n_rows = sa.shape[0] * sa.shape[1]
            gap = float(np.abs(a.accuracy[pol] - b.accuracy[pol]).max())
            lgap = float(np.abs(a.loss[pol] - b.loss[pol]).max())
            print(f"  {preset}/{pol}, 2 seeds x 10 rounds: {rows_diff} of "
                  f"{n_rows} selection rows differ; max accuracy gap "
                  f"{gap:.3e}, loss gap {lgap:.3e}")
            if rows_diff > 0.01 * n_rows:
                fail(f"{preset}/{pol}: {rows_diff} of {n_rows} selection "
                     f"rows differ CPU vs CUDA")
            if rows_diff == 0 and gap > 1e-3:
                fail(f"{preset}/{pol}: accuracy gap {gap} with identical "
                     f"selections")
            out[f"{preset}/{pol}"] = dict(rows_differ=rows_diff,
                                          accuracy_gap=gap, loss_gap=lgap)
    return out


# -- phase 14: the non-convex path -------------------------------------------

# CIFAR10_NONCONVEX at the paper's 50 clients and 3 ES, the CNN at 32x32x3
# (1,756,426 parameters), 2 seeds. The configuration's own lr = 0.1
# diverges (reference caveat R11): that run is held to its selections and
# host syncs only. The gated run changes lr alone, to 0.005.
NONCONVEX_SEEDS = (0, 1)
NONCONVEX_DIVERGED = (10, 5)        # horizon, eval_every at lr = 0.1
# at lr = 0.005: an eval at each sync; 30 rounds (was 60), cut to keep
# the whole script well inside its time limit
NONCONVEX_GATED = (30, 5)
# seed 0 on the CPU and on CUDA, one round: later rounds amplify float32
# differences (the packages' 10 local steps already move the test loss
# by 7.5e-4 relative, tests/test_torch_cnn.py's R11 pin), and the
# accuracy, near chance on this data, flips with the smallest margins
NONCONVEX_CPU = (1, 1)
GATED_LR = 0.005


def train_loss_ends(res, pol):
    """Local SGD's loss at its first and last step, mean over a round's
    filled slots, at the (seed, round)s that selected anyone: (S, R, 2)
    with R the fewest such rounds of a seed."""
    import numpy as np
    tl, sel = res.train_loss[pol], res.selections[pol]
    keep = [tl[si][(sel[si] >= 0).any(axis=-1)] for si in range(len(tl))]
    r = min(len(k) for k in keep)
    return np.stack([k[:r] for k in keep])


def nonconvex_run(dev, env, data, horizon, every, what):
    """One sweep of the three policies on the CNN with the launch counts
    and walk syncs set to 0 just before it and read just after; holds
    the counts, the syncs and every selection's budget."""
    import torch
    from repro_torch.experiment.sweep import sweep_experiments
    from repro_torch.kernels import common
    from repro_torch.kernels.budgeted_topk import ops as topk_ops
    common.reset_launches()
    for k in topk_ops.WALK_SYNCS:
        topk_ops.WALK_SYNCS[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = sweep_experiments(POLICIES, env, seeds=NONCONVEX_SEEDS,
                            horizon=horizon, eval_every=every,
                            model_kind="cnn", data=data, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    syncs = dict(topk_ops.WALK_SYNCS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"context_pairwise": 3 * horizon, "budgeted_topk": 2 * horizon,
            "flgreedy_walk": 2 * horizon, "random_assign": horizon}
    for k, v in want.items():
        if launches[k] != v:
            fail(f"{what}: {k} launched {launches[k]} times in {horizon} "
                 f"rounds of 3 policies, expected {v}")
    if launches["masked_aggregate"] < 3 * horizon:
        fail(f"{what}: masked_aggregate launched "
             f"{launches['masked_aggregate']} times")
    if any(syncs.values()):
        fail(f"{what}: a selection walk synced with the host: {syncs}")
    worst = max(spend_within_budget(env, dev, NONCONVEX_SEEDS,
                                    res.selections[p], f"{what} {p}")
                for p in POLICIES)
    print(f"  {what}: {horizon} rounds x 3 policies in {wall:.2f} s = "
          f"{3 * horizon / wall:.3f} policy-rounds/s; launches "
          f"{ {k: v for k, v in launches.items() if v} }; walk host syncs "
          f"{syncs}; peak device memory {peak:.2f} GiB; max ES spend "
          f"{worst:.4f} <= budget {env.cfg.budget}")
    for p in POLICIES:
        print(f"    {p}: test loss by eval {res.loss[p].tolist()}; "
              f"accuracy {res.accuracy[p].tolist()}; mean participants a "
              f"round {res.participants[p].mean():.3f}, utility "
              f"{res.utilities[p].mean():.4f}")
    return res, dict(wall_s=wall, policy_rounds_per_s=3 * horizon / wall,
                     peak_gib=peak, launches=launches)


def profile_nonconvex(dev, env, data):
    """Five rounds of COCS on the gated non-convex path (2 seeds) under
    torch.profiler, after an unprofiled run of the same: device time by
    kernel name, host time by stage, the device's busy share (kernel
    time over the unprofiled wall), and the hand kernels' time a launch
    inside the path."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.experiment.sweep import sweep_experiments
    kw = dict(seeds=NONCONVEX_SEEDS, horizon=5, eval_every=5,
              model_kind="cnn", data=data, device=dev)
    sweep_experiments(("cocs",), env, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep_experiments(("cocs",), env, **kw)
    torch.cuda.synchronize()
    round_s = (time.perf_counter() - t0) / 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep_experiments(("cocs",), env, **kw)
        torch.cuda.synchronize()
        traced_s = (time.perf_counter() - t0) / 5
    rows = kernel_rows(prof)
    dev_total = sum(e.self_device_time_total for e in rows)
    # the trace slows cuDNN's convolutions, so the busy share is taken
    # against the traced wall, beside the untraced one
    print(f"  profile (cocs, 5 rounds, 2 seeds, one eval): "
          f"{round_s * 1e3:.1f} ms a round untraced, {traced_s * 1e3:.1f} "
          f"traced; summed kernel time {dev_total / 5 / 1e3:.1f} ms a "
          f"round; device busy share {dev_total / 5 / (traced_s * 1e6):.3f} "
          f"of the traced wall")
    stages = [e for e in prof.key_averages() if e.key.startswith("round.")
              and e.device_type == DeviceType.CPU]
    for e in sorted(stages, key=lambda e: -e.cpu_time_total):
        print(f"    stage {e.key:16s} {e.cpu_time_total / 1e3 / 5:9.3f} ms "
              f"host a round")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x"
              f"  {e.key[:90]}")
    for name in ("context_pairwise", "budgeted_topk", "flgreedy_walk",
                 "masked_aggregate"):
        hand = [e for e in rows if name in e.key]
        n = sum(e.count for e in hand)
        if n:
            print(f"    {name} in the path: {n} launches, "
                  f"{sum(e.self_device_time_total for e in hand) / n:.2f} "
                  f"us a launch")


def nonconvex_path(dev, b3_worst, profile: bool = False):
    """Phase 14: the non-convex path twice on CUDA (CIFAR10_NONCONVEX as
    configured, then at lr = 0.005), seed 0 on the CPU against CUDA, and
    B3 at the CNN's width at the capacities the gated run used."""
    import dataclasses
    import numpy as np
    from repro_torch.configs.paper_hfl import CIFAR10_NONCONVEX
    from repro_torch.data.federated import FederatedDataset
    import torch
    from repro_torch.experiment.sweep import sweep_experiments
    from repro_torch.models.logistic import init_cnn
    from repro_torch.sim import spec as simspec
    data = FederatedDataset.synthetic(50, kind="cifar", seed=0)
    data.stacked(dev)
    cfg = CIFAR10_NONCONVEX
    gated_cfg = dataclasses.replace(cfg, lr=GATED_LR)
    out = {}
    env = simspec.make("paper", cfg)
    h, e = NONCONVEX_DIVERGED
    div, out["as_configured"] = nonconvex_run(
        dev, env, data, h, e, f"{cfg.name} as configured (lr {cfg.lr})")
    bad = {p: int((~np.isfinite(div.loss[p])).sum()) for p in POLICIES}
    rose = {p: int((~(train_loss_ends(div, p)[..., 1]
                      < train_loss_ends(div, p)[..., 0])).sum())
            for p in POLICIES}
    print(f"    R11: at the configuration's lr = {cfg.lr} the CNN's local "
          f"SGD diverges on the reference too (ROADMAP, reference caveat "
          f"R11); non-finite test losses by policy {bad} of "
          f"{div.loss['cocs'].size} evals each; rounds where local SGD "
          f"did not lower the training loss {rose}. Gated here: "
          f"launches, host syncs, budgets, selections against the CPU; "
          f"not the loss")
    out["as_configured"]["nonfinite_loss_evals"] = bad
    genv = simspec.make("paper", gated_cfg)
    h, e = NONCONVEX_GATED
    res, out["gated"] = nonconvex_run(
        dev, genv, data, h, e, f"{cfg.name} with one change, lr = "
        f"{GATED_LR}")
    fell = {}
    for p in POLICIES:
        loss = res.loss[p]
        if not np.isfinite(loss).all():
            fail(f"lr {GATED_LR} {p}: a non-finite test loss {loss}")
        tl = train_loss_ends(res, p)
        if not np.isfinite(tl).all():
            fail(f"lr {GATED_LR} {p}: a non-finite local training loss")
        for si in range(tl.shape[0]):
            first, last = tl[si, :, 0].mean(), tl[si, :, 1].mean()
            if not last < first:
                fail(f"lr {GATED_LR} {p} seed {si}: local SGD did not "
                     f"lower the training loss (mean over rounds {first} "
                     f"at the first step, {last} at the last)")
        fell[p] = (int((tl[..., 1] < tl[..., 0]).sum()), int(tl[..., 0].size))
    tests = {p: (float(res.loss[p][:, 0].mean()),
                 float(res.loss[p][:, -1].mean())) for p in POLICIES}
    print(f"    local SGD lowered the training loss in {fell} (rounds "
          f"where it fell, of rounds with a selection); the test loss, "
          f"mean over seeds, first and last eval {tests}: not gated, it "
          f"shows no trend on this data (accuracy stays near 0.1)")
    out["gated"]["train_loss_fell"] = fell
    out["gated"]["loss"] = {p: res.loss[p].tolist() for p in POLICIES}
    if profile:
        profile_nonconvex(dev, genv, data)
    out["gated"]["accuracy"] = {p: res.accuracy[p].tolist()
                                for p in POLICIES}
    # seed 0 on the CPU and on CUDA, same arguments; the policies see no
    # training output, so their selections are the same at either lr and
    # are held against both CUDA runs above too
    h, e = NONCONVEX_CPU
    kw = dict(seeds=NONCONVEX_SEEDS[:1], horizon=h, eval_every=e,
              model_kind="cnn", data=data)
    t0 = time.perf_counter()
    cpu = sweep_experiments(POLICIES, genv, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    # cuDNN's deterministic algorithms, so that the CUDA side of the
    # comparison is the same run to run (its nondeterministic ones move
    # a test sample or two between runs, tools/nonconvex_losses.py cpu)
    torch.backends.cudnn.deterministic = True
    cuda = sweep_experiments(POLICIES, genv, device=dev, **kw)
    torch.backends.cudnn.deterministic = False
    n_test = len(data.test_y)
    correct = lambda r, p: np.rint(r.accuracy[p].astype(np.float64)
                                   * n_test).astype(np.int64)
    gaps = {p: dict(accuracy_gap=float(np.abs(correct(cpu, p)
                                              - correct(cuda, p)).max()
                                       / n_test),
                    loss_gap=float(np.abs(cpu.loss[p]
                                          - cuda.loss[p]).max()),
                    cpu_correct=correct(cpu, p).tolist(),
                    cuda_correct=correct(cuda, p).tolist())
            for p in POLICIES}
    print(f"  seed 0, {h} round(s), on the CPU ({cpu_s:.1f} s) against "
          f"CUDA (cuDNN deterministic): test samples classified right of "
          f"{n_test}, accuracy and loss gaps {gaps}")
    for p in POLICIES:
        sc = cpu.selections[p][0]
        for name, other in (("cuda", cuda.selections[p][0]),
                            ("gated", res.selections[p][0, :h]),
                            ("as configured", div.selections[p][0, :h])):
            if not np.array_equal(sc, other):
                rows = int((sc != other).any(axis=-1).sum())
                fail(f"{p}: {rows} of {h} selection rows differ between "
                     f"the CPU and the CUDA run ({name})")
        if gaps[p]["accuracy_gap"] > 1e-3:
            fail(f"lr {GATED_LR} {p}: CPU and CUDA accuracy differ by "
                 f"{gaps[p]['accuracy_gap']}")
    print(f"    selection rows equal for all 3 policies, and equal to "
          f"both CUDA runs' first {h} round(s)")
    out["cpu_vs_cuda"] = gaps
    # B3 at the CNN's width, at the capacities the gated run used
    m = genv.cfg.num_edge_servers
    counts = np.concatenate([np.stack([np.concatenate(
        [np.bincount(sel[si, t][sel[si, t] >= 0], minlength=m)
         for si in range(sel.shape[0])]) for t in range(sel.shape[1])])
        for sel in (res.selections[p] for p in POLICIES)])
    d = sum(v.numel() for v in init_cnn(torch.zeros(2, dtype=torch.int64)
                                        ).values())
    b3 = masked_aggregate_main(dev, counts, d, b3_worst)
    out["masked_aggregate"] = {k: b3[k] for k in ("ms", "plain_ms",
                                                  "library_ms", "bound_ms",
                                                  "shape")}
    return out


# -- phases 6-7: the serve slice's kernels against their plain versions ------

def lm_bound_ms(nbytes: float, ops: float, ops_per_s: float):
    """``bound_ms`` with the operations at their own type's peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def flash_inputs(dev, b, s, h, kv, d, dtype, seed):
    """Model layout: q (B, S, H, D), k/v (B, S, KV, D)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


def flash_views(dev, b, s, h, kv, d, dtype, seed):
    """The kernel's (B, H, S, D) views of model-layout inputs, as
    ``ops.flash_attention`` passes them (non-contiguous, no copy)."""
    return [a.transpose(1, 2)
            for a in flash_inputs(dev, b, s, h, kv, d, dtype, seed)]


def flash_agrees(q, k, v, window, tol, what, causal=True) -> float:
    """B4 (causal unless ``causal=False``) against the plain float32
    version; the max abs error."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref
    f32 = torch.float32
    got = flash_attention_kernel(q, k, v, causal=causal, window=window)
    want = attention_ref(q.to(f32), k.to(f32), v.to(f32), causal=causal,
                         window=window)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"flash_attention not finite ({what})")
    err = (got.to(f32) - want).abs()
    rel = (err / want.abs().clamp(min=1e-3)).max().item()
    mx = err.max().item()
    print(f"  flash_attention {what}: max abs err {mx:.3e}, max rel err "
          f"{rel:.3e} against the plain f32 version (tol {tol}, margin "
          f"{tol / max(mx, 1e-30):.2f}x)")
    if mx > tol:
        fail(f"flash_attention differs by {mx} > {tol} ({what})")
    return mx


def flash_ptxas() -> None:
    """nvcc's ``-Xptxas -v`` lines of the bf16 kernel at each head dim:
    registers, spills, and the dynamic shared memory it launches with."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import \
        wgmma_smem_bytes
    if "flash_attention" not in _build.BUILD_LOG:
        print("  flash_attention_wgmma: built before this run, no ptxas log")
    name = None
    for line in _build.BUILD_LOG.get("flash_attention", "").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "wgmma" in line else None
        elif name and ("registers" in line or "spill" in line):
            d = int(name.split("wgmmaILi")[1].split("EEEv")[0])
            extra = (f"; {wgmma_smem_bytes(d)} bytes of dynamic shared "
                     f"memory" if "registers" in line else "")
            print(f"  flash_attention_wgmma<D={d}>: "
                  f"{line.replace('ptxas info    :', '').strip()}{extra}")


def flash_rates(ms: float, nbytes: float, ops: float, what: str):
    """The bound, and the achieved TFLOP/s and share of the bound."""
    bnd, by = lm_bound_ms(nbytes, ops, BF16_OPS_PER_S)
    print(f"  flash_attention bf16 {what}: {ops / ms / 1e9:.1f} TFLOP/s, "
          f"{bnd / ms:.3f} of the bound {bnd * 1e3:.3f} us ({by})")
    return bnd, by


def check_flash_attention(dev):
    """B4 at the qwen2-1.5b prompt's shapes, (B, S, H, KV, D) = (8, 512, 12,
    2, 128): bf16 and f32 causal, and bf16 causal with window 128, on the
    model layout's transposed views (and bf16 once on contiguous (B, H,
    S, D) tensors), against the plain float32 version on the same inputs.
    Timed in bf16, causal, on the views, as the serve path calls it,
    beside SDPA on contiguous tensors."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    b, s, h, kv, d = 8, 512, 12, 2, 128
    flash_ptxas()
    worst = 0.0
    for dtype, window, tol in ((torch.bfloat16, 0, FLASH_TOL["bf16"]),
                               (torch.float32, 0, FLASH_TOL["f32"]),
                               (torch.bfloat16, 128, FLASH_TOL["bf16"])):
        q, k, v = flash_views(dev, b, s, h, kv, d, dtype, 7 + window)
        err = flash_agrees(q, k, v, window, tol, f"{str(dtype)[6:]} causal "
                           f"window {window}")
        if dtype == torch.bfloat16:
            worst = max(worst, err)
        if dtype == torch.bfloat16 and window == 0:
            args = (q, k, v)
            contig = [a.contiguous() for a in args]
            worst = max(worst, flash_agrees(
                *contig, 0, tol, "bf16 causal window 0, contiguous (B, H, "
                "S, D)"))
    q, k, v = args
    out = flash_attention(*(a.transpose(1, 2) for a in args))
    if not out.is_contiguous():
        fail("ops.flash_attention's output is not contiguous (B, S, H, D)")
    call = lambda: flash_attention_kernel(q, k, v, causal=True)
    ms, wall = event_ms(call), cuda_ms(call, 50)
    warm = event_ms(call, cold=False)
    print(f"  flash_attention timed; SM clock, power: {sm_clock()}")
    plain = event_ms(lambda: attention_ref(q, k, v, causal=True), iters=5)
    qc, kc, vc = contig
    lib = event_ms(lambda: F.scaled_dot_product_attention(
        qc, kc, vc, is_causal=True, enable_gqa=True))
    nbytes = 2 * (2 * b * h * s * d + 2 * b * kv * s * d)
    ops = 4 * b * h * d * s * (s + 1) // 2
    bnd, by = flash_rates(ms, nbytes, ops, f"at {(b, s, h, kv, d)}")
    flash_mixtral(dev)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:83",
                max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=lib, shape=[b, s, h, kv, d],
                wall_ms=wall, warm_ms=warm)


def flash_mixtral(dev) -> None:
    """B4 at the mixtral-8x22b prompt's shape, (B, S, H, KV, D) = (8, 512,
    48, 8, 128) bf16, causal, its native window 4096 (which cuts nothing
    at 512 tokens), on the model layout's views: checked against the
    plain float32 version, timed beside SDPA on contiguous tensors
    (printed, not in the JSON row)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    q, k, v = flash_views(dev, 8, 512, 48, 8, 128, torch.bfloat16, 13)
    err = flash_agrees(q, k, v, 4096, FLASH_TOL["bf16"], "bf16 at the "
                       "mixtral-8x22b prompt (8, 512, 48, 8, 128), window "
                       "4096")
    ms = event_ms(lambda: flash_attention_kernel(q, k, v, causal=True,
                                                 window=4096))
    qc, kc, vc = (a.contiguous() for a in (q, k, v))
    lib = event_ms(lambda: F.scaled_dot_product_attention(
        qc, kc, vc, is_causal=True, enable_gqa=True))
    nbytes = 2 * (2 * 8 * 48 * 512 * 128 + 2 * 8 * 8 * 512 * 128)
    bnd, by = flash_rates(ms, nbytes, 4 * 8 * 48 * 128 * 512 * 513 // 2,
                          "at the mixtral-8x22b prompt")
    print(f"  flash_attention bf16 at the mixtral-8x22b prompt: max abs err "
          f"{err:.3e}; kernel {ms * 1e3:.2f} us, SDPA {lib * 1e3:.2f} us, "
          f"bound {bnd * 1e3:.3f} us ({by})")


def scan_inputs(dev, b, h, t, w0, views, seed, dtype="bfloat16"):
    """B5's inputs: r, k, v N(0, 1) in ``dtype``, log_w = -exp(0.5 N + w0)
    and u float32; with ``views`` the transposed (B, H, T, 64) views of
    (B, T, H, 64) tensors, as the model passes them (non-contiguous, no
    copy)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (b, t, h, 64) if views else (b, h, t, 64)
    r, k, v = (torch.randn(shape, generator=gen, device=dev)
               .to(getattr(torch, dtype)) for _ in range(3))
    lw = -torch.exp(torch.randn(shape, generator=gen, device=dev) * 0.5
                    + w0)
    u = torch.randn((h, 64), generator=gen, device=dev) * 0.1
    if views:
        r, k, v, lw = (a.transpose(1, 2) for a in (r, k, v, lw))
    return r, k, v, lw, u


def scan_agrees(r, k, v, lw, u, what) -> float:
    """B5 against its per-step plain version on the same inputs, within
    ``SCAN_TOL`` of max(1, |value|); the max abs error."""
    import torch
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_kernel
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
    y, fin = rwkv6_scan_kernel(r, k, v, lw, u)
    wy, wf = rwkv6_scan_ref(r, k, v, lw, u)
    torch.cuda.synchronize()
    if not (torch.isfinite(y).all() and torch.isfinite(fin).all()):
        fail(f"rwkv6_scan not finite ({what})")
    if not y.transpose(1, 2).is_contiguous():
        fail("rwkv6_scan's y is not a view of (B, T, H, 64)")
    worst_abs, worst_rel = 0.0, 0.0
    for a, w in ((y, wy), (fin, wf)):
        err = (a - w).abs()
        worst_abs = max(worst_abs, err.max().item())
        worst_rel = max(worst_rel,
                        (err / w.abs().clamp(min=1.0)).max().item())
    scale = max(wy.abs().max().item(), wf.abs().max().item())
    print(f"  rwkv6_scan {what}: max abs err {worst_abs:.3e}, max err "
          f"relative to max(1, |value|) {worst_rel:.3e} (values up to "
          f"{scale:.1f}; tol {SCAN_TOL}, margin "
          f"{SCAN_TOL / max(worst_rel, 1e-30):.1f}x)")
    if worst_rel > SCAN_TOL:
        fail(f"rwkv6_scan differs beyond {SCAN_TOL} relative ({what})")
    return worst_abs


def scan_ptxas() -> None:
    """nvcc's ``-Xptxas -v`` lines of both B5 kernels: registers, spills,
    and the dynamic shared memory the chunked (bf16) kernel launches
    with."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6_scan.kernel import chunked_smem_bytes
    if "rwkv6_scan" not in _build.BUILD_LOG:
        print("  rwkv6_scan: built before this run, no ptxas log")
    name = None
    for line in _build.BUILD_LOG.get("rwkv6_scan", "").splitlines():
        if "Compiling entry function" in line:
            name = ("rwkv6_scan_chunked" if "chunked" in line
                    else "rwkv6_scan_seq")
        elif name and ("registers" in line or "spill" in line):
            extra = (f"; {chunked_smem_bytes()} bytes of dynamic shared "
                     f"memory" if "registers" in line
                     and name == "rwkv6_scan_chunked" else "")
            print(f"  {name}: "
                  f"{line.replace('ptxas info    :', '').strip()}{extra}")


def reference_chunk_overflows(lw) -> float:
    """The largest exp(-cumsum log_w) over a 64-step chunk that the
    reference's chunked form (its Pallas kernel, kernel.py:38) would
    multiply k by, as a natural exponent; above ~88.7 it is inf in
    float32."""
    t = lw.shape[2] // 64 * 64
    chunks = lw[:, :, :t].unflatten(2, (-1, 64))
    return (-chunks.cumsum(3)).max().item()


def check_rwkv6_scan(dev):
    """B5 at the rwkv6-1.6b prompt's shapes, (B, H, T, dk, dv) = (8, 32,
    512, 64, 64), bf16 r/k/v, float32 log_w and u, against the per-step
    plain version: on the model's strided views (the decays of the
    model's init, w0 = -2), on contiguous tensors, at a strong decay
    (w0 = 1) where the reference's chunked form overflows, and at a
    ragged T = 100 on the views; then float32 r/k/v (the sequential
    kernel) on the views at phase 10's float32 prefill, (2, 32, 512).
    Timed in bf16 on the views, as the serve path calls it."""
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_kernel
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
    b, h, t, dk = 8, 32, 512, 64
    scan_ptxas()
    args = scan_inputs(dev, b, h, t, -2.0, True, 11)
    worst = scan_agrees(*args, "prompt (8, 32, 512), model's views")
    worst = max(worst, scan_agrees(
        *scan_inputs(dev, b, h, t, -2.0, False, 12),
        "prompt (8, 32, 512), contiguous (B, H, T, 64)"))
    strong = scan_inputs(dev, b, h, t, 1.0, True, 13)
    peak = reference_chunk_overflows(strong[3])
    if peak < 88.8:
        fail(f"the strong-decay case does not overflow the reference's "
             f"chunked form (exp({peak:.1f}))")
    worst = max(worst, scan_agrees(
        *strong, f"strong decay w0 = 1, model's views (the reference's "
        f"chunked form would scale k by exp({peak:.1f}) = inf in float32)"))
    worst = max(worst, scan_agrees(
        *scan_inputs(dev, b, h, 100, -2.0, True, 14),
        "ragged T = 100 (8, 32, 100), model's views"))
    worst = max(worst, scan_agrees(
        *scan_inputs(dev, 2, h, t, -2.0, True, 15, "float32"),
        "float32 (the sequential kernel) at phase 10's (2, 32, 512), "
        "model's views"))
    r, k, v, lw, u = args
    call = lambda: rwkv6_scan_kernel(r, k, v, lw, u)
    ms, wall = event_ms(call), cuda_ms(call, 50)
    warm = event_ms(call, cold=False)
    print(f"  rwkv6_scan timed; SM clock, power: {sm_clock()}")
    # 512 steps of small kernels, launch-bound: summed kernel time, not
    # events
    plain = device_ms(lambda: rwkv6_scan_ref(r, k, v, lw, u), iters=2)
    nbytes = 3 * 2 * b * h * t * dk + 4 * b * h * t * dk + 4 * h * dk \
        + 4 * b * h * t * dk + 4 * b * h * dk * dk
    ops = 4 * b * h * t * dk * dk
    bnd, by = lm_bound_ms(nbytes, ops, FP32_OPS_PER_S)
    print(f"  rwkv6_scan at {(b, h, t, dk, dk)} bf16, model's views: "
          f"{bnd / ms:.3f} of the bound {bnd * 1e3:.3f} us ({by})")
    return dict(name="rwkv6_scan", route="cuda",
                source="src/repro_torch/csrc/rwkv6_scan.cu",
                replaces="src/repro/kernels/rwkv6_scan/kernel.py:61",
                max_abs_err=worst, ms=ms, plain_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=None,
                shape=[b, h, t, dk, dk], wall_ms=wall, warm_ms=warm)


# -- phases 8-10: the serve slice at full width ------------------------------

def serve_full_width(dev, cfg, prompt_len: int = 512, recorder=None):
    """``launch.serve.run`` of ``cfg`` at full width (bf16, random weights
    from seed 0): batch 8, a ``prompt_len``-token prompt (and, for audio
    or VLM configs, frames or patches the launcher draws from the seed),
    32 greedy tokens, after one short warm-up run. The launch counts are
    zeroed just before the measured run and read just after it; a
    ``recorder`` context, when given, is open around the measured run
    only. Peak device memory is read after the weights are drawn and
    over the two runs."""
    import torch
    from repro_torch.kernels import common
    from repro_torch.launch import serve
    from repro_torch.models import registry as R
    arch = cfg.name
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = R.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in leaves(params))
    init_peak = torch.cuda.max_memory_allocated()
    print(f"  {arch}: {cfg.num_layers} layers, {n / 1e9:.3f} B parameters "
          f"({cfg.dtype}, {nbytes / 1e9:.2f} GB) drawn in "
          f"{time.perf_counter() - t0:.2f} s; peak memory while drawing "
          f"{init_peak / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    serve.run(cfg, batch=8, prompt_len=64, gen_len=2, seed=1, device=dev,
              params=params)
    torch.cuda.synchronize()
    with (recorder() if recorder else contextlib.nullcontext()) as records:
        common.reset_launches()
        res = serve.run(cfg, batch=8, prompt_len=prompt_len, gen_len=32,
                        seed=0, device=dev, params=params)
        torch.cuda.synchronize()
        launches = dict(common.LAUNCHES)
    if recorder:
        launches["records"] = records
    mem = dict(init_peak_gb=init_peak / 1e9,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    for name, x in (("prefill", res.prefill_logits), ("decode",
                                                      res.step_logits)):
        if not torch.isfinite(x).all():
            fail(f"{arch}: non-finite {name} logits")
    if tuple(res.tokens.shape) != (8, 32):
        fail(f"{arch}: tokens {tuple(res.tokens.shape)}")
    step_ms = res.decode_s / 31 * 1e3
    print(f"  {arch}: prefill {res.prefill_s * 1e3:.2f} ms (8 x "
          f"{prompt_len} tokens), decode {res.decode_tok_per_s:.2f} tok/s at "
          f"batch 8 ({step_ms:.2f} ms a step)"
          + (f", state rebuild {res.rebuild_s * 1e3:.1f} ms" if
             cfg.arch_type in ("ssm", "hybrid") else "")
          + f"; peak memory serving {mem['peak_gb']:.2f} GB")
    print(f"    launches: "
          f"{ {k: v for k, v in launches.items() if k != 'records'} }")
    print(f"    sample: {res.tokens[0, :12].tolist()}")
    return cfg, params, res, launches, mem


def profile_serve(dev, cfg, params):
    """One prefill (batch 8 x 512 tokens; the seamless phase's prompt over
    its frames; paligemma's after its patches) and four decode steps of the
    full-width model under torch.profiler: wall time, summed kernel time,
    the device's busy share (kernel time over wall time) and the kernels
    that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import registry as R
    gen = torch.Generator(device=dev).manual_seed(2)
    plen = SEAMLESS_PROMPT if cfg.arch_type == "audio" else 512
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, plen),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    for kind, name, n in (("audio", "frames", cfg.num_frames),
                          ("vlm", "patches", cfg.num_patches)):
        if cfg.arch_type == kind:
            batch[name] = torch.randn((8, n, cfg.d_model), generator=gen,
                                      device=dev).to(cfg.torch_dtype)

    def prefill():
        state = R.init_serve_state(cfg, 8, plen + 32, device=dev)
        return R.prefill(params, cfg, batch, state)

    logits, state = prefill()
    if cfg.arch_type in ("ssm", "hybrid"):  # decode from a state at step 0
        state = R.init_serve_state(cfg, 8, plen + 32, device=dev)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)

    def decode():
        nonlocal state, tok
        for _ in range(4):
            out, state = R.serve_step(params, cfg, tok, state)
            tok = torch.argmax(out[:, -1:], dim=-1).to(torch.int32)

    decode()
    for label, fn, n in (("prefill", prefill, 1), ("decode step", decode,
                                                      4)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
        rows = kernel_rows(prof)
        busy = sum(e.self_device_time_total for e in rows) / 1e3 / n
        kernels = sum(e.count for e in rows) / n
        print(f"  profile {cfg.name} {label}: {wall:.2f} ms wall under the "
              f"profiler, {kernels:.0f} kernels taking {busy:.2f} ms, "
              f"device busy share {busy / wall:.3f}")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
            print(f"    {e.self_device_time_total / 1e3 / n:8.3f} ms "
                  f"{e.count // n:5d}x  {e.key[:80]}")


def _serve_row(cfg, res, mem, prompt_len: int = 512) -> dict:
    row = dict(batch=8, prompt=prompt_len, generated=32,
               layers=cfg.num_layers, prefill_ms=res.prefill_s * 1e3,
               decode_tok_per_s=res.decode_tok_per_s,
               decode_step_ms=res.decode_s / 31 * 1e3, **mem)
    if cfg.arch_type in ("ssm", "hybrid"):
        row["rebuild_ms"] = res.rebuild_s * 1e3
    return row


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def engine_full_width(dev, cfg, params):
    """``ServingEngine`` on qwen2-1.5b at full width: 8 slots, 16 requests
    with prompts of 16-64 tokens, 16 new tokens each."""
    import numpy as np
    import torch
    from repro_torch.kernels import common
    from repro_torch.serving.engine import ServingEngine
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 65, 16)
    eng = ServingEngine(cfg, params, batch_slots=8, max_len=80)
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, n).tolist(),
                       max_tokens=16) for n in lens]
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(done) != 16 or not all(r.done and len(r.output) == 16
                                  for r in reqs):
        fail(f"engine finished {len(done)} of 16 requests")
    if any(not 0 <= t < cfg.vocab_size for r in reqs for t in r.output):
        fail("engine produced a token outside the vocabulary")
    steps, toks = eng.stats["steps"], eng.stats["tokens_out"]
    print(f"  engine: 16 requests (prompts {int(lens.min())}-"
          f"{int(lens.max())} tokens, {int(lens.sum())} in all) x 16 new "
          f"tokens in {steps} steps, {wall:.2f} s: {toks / wall:.2f} new "
          f"tok/s, {(int(lens.sum()) + toks) / wall:.2f} tok/s fed and "
          f"produced; launches {dict(common.LAUNCHES)}")
    return dict(requests=16, steps=steps, wall_s=wall,
                new_tok_per_s=toks / wall)


def depth_sweep(dev) -> None:
    """``prefill_vs_steps`` of both models at full width, 2 x 64 tokens,
    in float32 and bf16, at growing depth: how a difference between the
    two forms grows through the layers (reported, not gated)."""
    for arch, full in (("rwkv6-1.6b", 24), ("qwen2-1.5b", 28)):
        for dtype in ("float32", "bfloat16"):
            for n in (1, 2, 4, 8, 16, full):
                prefill_vs_steps(dev, arch, dtype, 2, 64, math.inf, n)


def rwkv6_prefill_vs_rebuild(res) -> dict:
    """The bf16 serve run's two forms of one function: the WKV scan's
    prefill and the token-by-token rebuild. Reported, not gated: with
    random weights each RWKV6 layer amplifies a difference ~1.25x, so
    bf16 rounding decorrelates the two forms by 16 layers
    (``depth_sweep``, run with ``--profile``, measured on an H100
    relative gaps of 6e-3 at 2 layers, 0.45 at 16 and 0.94 at 24 in bf16;
    1.5e-3 at 24 in float32). ``prefill_vs_steps`` gates the same
    comparison in float32."""
    a = res.prefill_logits[:, -1].float()
    b = res.logits[:, -1].float()
    gap = (a - b).abs().max().item()
    scale = b.abs().max().item()
    agree = int((a.argmax(-1) == b.argmax(-1)).sum())
    print(f"  rwkv6-1.6b bf16: prefill (scan) against rebuild (step) last "
          f"logits: max abs gap {gap:.4f} on values up to {scale:.2f}; "
          f"argmax agrees on {agree} of {a.shape[0]} (not gated: see "
          f"phase 10's float32 check)")
    return dict(gap=gap, scale=scale, argmax_agree=agree)


def prefill_vs_steps(dev, arch: str, dtype: str, batch: int,
                     prompt_len: int, tol: float, layers: int = 0,
                     params=None) -> dict:
    """``arch`` at full width and depth (or ``layers`` deep) in ``dtype``
    (random weights, seed 0, or ``params``): the prefill's last-position
    logits (B4 or B5 over the prompt) against ``serve_step`` fed the
    prompt token by token from a fresh state (the plain decode path).
    Fails beyond ``tol``.

    An MoE model runs with capacity factor E / k, so that no expert can
    overflow: the two forms are one function only when nothing is
    dropped, and a prefill of batch x prompt tokens caps an expert at
    1.25 x tokens x k / E where a decode step of ``batch`` tokens never
    reaches its cap of 8. Each form's routing is recorded: in bf16 the
    two forms' rounding differs enough to flip near-tied router choices,
    and a token sent to another expert is another function. So a row is
    held to ``tol`` when its last position went to the same experts in
    both forms in every layer (a flip earlier in the prompt reaches it
    only through attention); the other rows are counted, and the check
    fails if no row is left to hold."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    if params is None:
        params = R.init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=dev, dtype=torch.int32)
    state = R.init_serve_state(cfg, batch, prompt_len, device=dev)
    with recorded_routes() as pre:
        pl, _ = R.prefill(params, cfg, {"tokens": prompt}, state)
    state = R.init_serve_state(cfg, batch, prompt_len, device=dev)
    with recorded_routes() as steps:
        for i in range(prompt_len):
            sl, state = R.serve_step(params, cfg, prompt[:, i:i + 1], state)
    a, b = pl[:, -1].float(), sl[:, -1].float()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        fail(f"{arch} {dtype}: non-finite logits")
    gap = (a - b).abs().max().item()
    scale = b.abs().max().item()
    agree = int((a.argmax(-1) == b.argmax(-1)).sum())
    print(f"  {arch} {dtype} {cfg.num_layers} layers ({batch} x "
          f"{prompt_len} tokens): prefill "
          f"against token-by-token steps, last logits max abs gap "
          f"{gap:.3e} on values up to {scale:.2f} (tol {tol}); argmax "
          f"agrees on {agree} of {batch}")
    flips = None
    row_gap = (a - b).abs().max(-1)[0]
    held = torch.ones(batch, dtype=torch.bool, device=dev)
    if cfg.moe is not None:
        # the expert set each (layer, row, position) was routed to, by the
        # prefill (one call a layer) and by the steps (one a layer a step)
        lay, k = cfg.num_layers, cfg.moe.top_k
        sp = torch.stack(pre).view(lay, batch, prompt_len, k)
        ss = torch.stack(steps).view(prompt_len, lay, batch, k).permute(
            1, 2, 0, 3)
        differ = (sp.sort(-1)[0] != ss.sort(-1)[0]).any(-1)
        flips = differ.sum((1, 2)).tolist()
        held = ~differ[:, :, -1].any(0)
        print(f"    routing differs between the two forms at {flips} of "
              f"{batch * prompt_len} (row, position)s per layer; rows whose "
              f"last position is routed alike in every layer "
              f"{int(held.sum())} of {batch}; last-logit gap per row "
              f"[{', '.join(f'{g:.3e}' for g in row_gap.tolist())}]")
        if not held.any():
            fail(f"{arch} {dtype}: every row's last position was routed "
                 f"differently by the two forms; nothing left to hold")
    held_gap = row_gap[held].max().item()
    if held_gap > tol:
        fail(f"{arch} {dtype}: prefill and steps differ by {held_gap} > "
             f"{tol}")
    return dict(dtype=dtype, batch=batch, prompt=prompt_len, gap=gap,
                held_gap=held_gap, rows_held=int(held.sum()),
                routing_flips=flips,
                scale=scale, argmax_agree=agree)


# -- phase 12: moe_router against its plain version --------------------------

# (T, E, k, kind, dtype): the mixtral prefill's and a decode step's
# shapes, a ragged T, kimi-k2's prefill and decode step, exact ties,
# underflowing rows; rows with a non-finite logit; E = 32 (the widest a
# thread a row) and 33 (the narrowest a warp a row); rows not 16 bytes
# long; T = 1; views one row in and one element in; probabilities below
# 2^-117, subnormal ones among them
ROUTER_CASES = (
    (4096, 8, 2, "normal", "float32"), (8, 8, 2, "normal", "float32"),
    (1000, 8, 2, "normal", "float32"), (4096, 384, 8, "normal", "float32"),
    (8, 384, 8, "normal", "float32"),
    (4096, 8, 2, "normal", "bfloat16"), (1024, 8, 2, "ties", "float32"),
    (1024, 8, 2, "ties", "bfloat16"), (512, 384, 8, "ties", "bfloat16"),
    (64, 8, 2, "underflow", "float32"), (64, 384, 8, "underflow", "float32"),
    (500, 8, 2, "nonfinite", "float32"), (500, 8, 2, "nonfinite", "bfloat16"),
    (500, 32, 8, "nonfinite", "float32"),
    (500, 384, 8, "nonfinite", "float32"),
    (4096, 32, 8, "normal", "float32"), (4096, 33, 8, "normal", "float32"),
    (1000, 5, 2, "normal", "float32"), (1000, 6, 2, "normal", "bfloat16"),
    (1, 8, 2, "normal", "float32"), (1000, 8, 2, "row_offset", "float32"),
    (1000, 8, 2, "elem_offset", "float32"), (1000, 8, 2, "tiny", "float32"),
    (1000, 32, 8, "tiny", "float32"))


def router_inputs(dev, t, e, kind, dtype, seed):
    """(T, E) logits: standard normal; integers in {0, 1, 2} (rows of
    exact ties); -200 but one 0 a row (every other probability
    underflows to 0, so the k-th pick is a tie among zeros); standard
    normal with four rows in five non-finite (one NaN, one +inf, all
    -inf, all NaN); standard normal with the upper half of each row 85
    to 105 lower (probabilities below 2^-117); or standard normal as a
    contiguous view one row or one element into a larger buffer."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind == "ties":
        x = torch.randint(0, 3, (t, e), generator=gen, device=dev).float()
    elif kind == "underflow":
        x = torch.full((t, e), -200.0, device=dev)
        x[torch.arange(t, device=dev), torch.arange(t, device=dev) % e] = 0.0
    elif kind == "row_offset":
        x = torch.randn((t + 1, e), generator=gen, device=dev)[1:]
    elif kind == "elem_offset":
        x = torch.randn((t * e + 1,), generator=gen, device=dev)[1:]
        x = x.view(t, e)
    else:
        x = torch.randn((t, e), generator=gen, device=dev)
    if kind == "tiny":
        x[:, e // 2:] = -85.0 - 20.0 * torch.rand(
            (t, e - e // 2), generator=gen, device=dev)
    if kind == "nonfinite":
        rows = torch.arange(t, device=dev)
        x[rows[0::5], rows[0::5] % e] = float("nan")
        x[rows[1::5], rows[1::5] % e] = float("inf")
        x[2::5] = float("-inf")
        x[3::5] = float("nan")
    return x.to(dtype)


def router_agrees(x, k, what):
    """B6 against its plain version on ``x``. On a row with a non-finite
    logit (every probability NaN) the indices must equal the plain
    version's, 0..k-1, and the gates be NaN as its are. On the other
    rows, indices must be equal on every row whose plain probabilities,
    sorted down to the (k+1)-th, are apart by more than ROUTER_TIE_GAP
    or exactly equal (a tie: both break it to the lower index); the
    other rows are counted. Returns (max gate error, undecided rows,
    rows with a tie, non-finite rows)."""
    import torch
    from repro_torch.kernels.moe_router.kernel import moe_router_kernel
    from repro_torch.kernels.moe_router.ref import moe_router_ref
    g, i = moe_router_kernel(x, k)
    wg, wi = moe_router_ref(x, k)
    torch.cuda.synchronize()
    if not ((i >= 0) & (i < x.shape[1])).all():
        fail(f"moe_router index out of range at {what}: "
             f"{i.min().item()}..{i.max().item()}")
    bad = ~torch.isfinite(x.float()).all(-1)
    if not (torch.equal(i[bad], wi[bad])
            and (i[bad] == torch.arange(k, device=x.device)).all()):
        fail(f"moe_router indices on non-finite rows at {what} are not "
             f"0..{k - 1} as the plain version's")
    if not torch.allclose(g[bad], wg[bad], rtol=0, atol=0, equal_nan=True):
        fail(f"moe_router gates on non-finite rows at {what} are not NaN "
             f"as the plain version's")
    x, g, i, wg, wi = x[~bad], g[~bad], i[~bad], wg[~bad], wi[~bad]
    p = torch.sort(torch.softmax(x.float(), -1), -1, descending=True)[0]
    gaps = p[:, :k] - p[:, 1:k + 1]
    decided = ((gaps > ROUTER_TIE_GAP) | (gaps == 0)).all(-1)
    if not torch.equal(i[decided], wi[decided]):
        bad_rows = int((i[decided] != wi[decided]).any(-1).sum())
        fail(f"moe_router indices differ on {bad_rows} decided rows at "
             f"{what}")
    # a tie inside the picks goes to the lower index
    tie = gaps[:, :-1] == 0
    if (tie & (i[:, 1:] < i[:, :-1])).any():
        fail(f"moe_router breaks a tie to the higher index at {what}")
    err = (g - wg).abs().max().item()
    total = (g.sum(-1) - 1.0).abs().max().item()
    if not (err <= ROUTER_GATE_TOL and total <= ROUTER_SUM_TOL):
        fail(f"moe_router gates off by {err} (sum by {total}) at {what}")
    return (err, int((~decided).sum()), int((gaps == 0).any(-1).sum()),
            int(bad.sum()))


def router_cases_agree(dev) -> float:
    """B6 against its plain version on every case of ROUTER_CASES, a
    line a case; returns the largest gate error."""
    import torch
    worst = 0.0
    for n, (t, e, k, kind, dtype) in enumerate(ROUTER_CASES):
        what = (t, e, k, kind, dtype)
        x = router_inputs(dev, t, e, kind, getattr(torch, dtype), 20 + n)
        err, undecided, tied, nonfinite = router_agrees(x, k, what)
        worst = max(worst, err)
        print(f"  moe_router {what}: max gate err {err:.3e}; rows with a "
              f"tie {tied}, non-finite {nonfinite}, left undecided (a gap "
              f"<= {ROUTER_TIE_GAP}) {undecided} of {t}")
    return worst


def check_moe_router(dev):
    """B6 on ROUTER_CASES with its ptxas registers and spills. Timed at
    the prefill's and the decode's shapes in float32, the dtype of the
    router's logits on the serve path."""
    import torch
    from repro_torch.kernels.moe_router.kernel import moe_router_kernel
    from repro_torch.kernels.moe_router.ref import moe_router_ref
    f32 = torch.float32
    ptxas_lines("moe_router")
    worst = router_cases_agree(dev)
    times = {}
    for t in (4096, 8):
        x = router_inputs(dev, t, 8, "normal", f32, 1)
        call = lambda: moe_router_kernel(x, 2)
        times[t] = dict(ms=device_ms(call), warm_ms=device_ms(call,
                                                               cold=False),
                        wall_ms=cuda_ms(call, 200),
                        plain_ms=device_ms(lambda: moe_router_ref(x, 2)))
        nbytes = 4 * t * 8 + 2 * 4 * t * 2
        times[t]["bound_ms"], times[t]["bound_by"] = lm_bound_ms(
            nbytes, t * (8 * (5 + 2) + 2 * 2), FP32_OPS_PER_S)
    d = times[8]
    print(f"  moe_router at a decode step (8, 8, 2): kernel "
          f"{d['ms'] * 1e3:.2f} us ({d['warm_ms'] * 1e3:.2f} us warm; "
          f"{d['wall_ms'] * 1e3:.2f} us a call from Python), plain "
          f"{d['plain_ms'] * 1e3:.2f} us, bound {d['bound_ms'] * 1e3:.4f} "
          f"us ({d['bound_by']})")
    p = times[4096]
    return dict(name="moe_router", route="cuda",
                source="src/repro_torch/csrc/moe_router.cu",
                replaces="src/repro/kernels/moe_router/kernel.py:43",
                max_abs_err=worst, ms=p["ms"], plain_ms=p["plain_ms"],
                bound_ms=p["bound_ms"], bound_by=p["bound_by"],
                library_ms=None, shape=[4096, 8, 2], wall_ms=p["wall_ms"],
                warm_ms=p["warm_ms"])


# -- phase 13: mixtral-8x22b at full width -----------------------------------

def mixtral_full_width(dev, profile: bool):
    """mixtral-8x22b at full width and MIXTRAL_LAYERS of its 56 layers,
    bf16, through ``launch.serve.run`` (``serve_full_width``), after the
    earlier phases' weights are freed. B6 runs once a layer in each
    forward (the prefill and 31 decode steps), B4 once a layer in the
    prefill. Then its prefill against token-by-token decode: in bf16 at
    the served depth, and in float32 at 4 layers (8 would need 82 GB)."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_config
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("mixtral-8x22b"),
                              num_layers=MIXTRAL_LAYERS)
    cfg, params, res, launches, mem = serve_full_width(dev, cfg)
    want = cfg.num_layers * (1 + 31)
    if launches["moe_router"] != want:
        fail(f"moe_router launched {launches['moe_router']} times, not "
             f"{want} ({cfg.num_layers} layers x (prefill + 31 steps))")
    if launches["flash_attention"] != cfg.num_layers:
        fail(f"flash_attention launched {launches['flash_attention']} "
             f"times in one mixtral prefill of {cfg.num_layers} layers")
    row = _serve_row(cfg, res, mem)
    row["launches"] = launches
    row["dropped"] = prefill_drops(dev, cfg, params)
    if profile:
        profile_serve(dev, cfg, params)
    row["prefill_vs_steps"] = prefill_vs_steps(
        dev, "mixtral-8x22b", "bfloat16", 8, 64, STEP_TOL["mixtral-8x22b"],
        cfg.num_layers, params=params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    row["prefill_vs_steps_f32"] = prefill_vs_steps(
        dev, "mixtral-8x22b", "float32", 2, 64,
        STEP_TOL["mixtral-8x22b-f32"], 4)
    return row, launches


@contextlib.contextmanager
def recorded_routes():
    """For the block's duration ``models.moe.route`` also keeps each
    call's expert indices (T, k), in call order, in the yielded list: a
    check's view of the routing, outside every counted or timed run."""
    from repro_torch.models import moe
    calls = []
    route = moe.route

    def recording(p, x2d, mcfg, aux=False):
        out = route(p, x2d, mcfg, aux)
        calls.append(out[1])
        return out

    moe.route = recording
    try:
        yield calls
    finally:
        moe.route = route


def prefill_drops(dev, cfg, params) -> list:
    """Assignments dropped past capacity in each MoE layer of the served
    prefill (batch 8 x 512 tokens, the prompt ``launch.serve.run`` draws
    from seed 0), read in one more prefill, after the launch counts."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models import registry as R
    gen = torch.Generator(device=dev).manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen,
                           device=dev, dtype=torch.int32)
    with recorded_routes() as calls:
        R.prefill(params, cfg, {"tokens": prompt},
                  R.init_serve_state(cfg, 8, 512, device=dev))
    loads = [torch.bincount(idx.reshape(-1), minlength=cfg.moe.num_experts)
             for idx in calls]
    cap = moe._capacity(8 * 512, cfg.moe)
    dropped = [int((ld - cap).clamp(min=0).sum()) for ld in loads]
    print(f"  {cfg.name} prefill: expert capacity {cap}; largest load per "
          f"layer {[int(ld.max()) for ld in loads]}; assignments dropped "
          f"per layer {dropped} of {8 * 512 * cfg.moe.top_k}")
    return dropped


# -- phase 15: the bandit tier -----------------------------------------------

# paper-fig3's workload (Fig. 3: cumulative utility and regret against the
# Oracle, no training) at full width: metropolis-1k, 2 seeds, through the
# facade (tier 1, analytic true_p); 200 of its 400 rounds, cut to keep the
# whole script well inside its time limit (phase 16 runs fig3 as written)
BANDIT_SEEDS = (0, 1)
BANDIT_HORIZON = 200
BANDIT_MC_ROUNDS = 25               # the Monte-Carlo mode's prefix
BANDIT_GRID_BUDGETS = (8.0, 12.0, 16.0)
BANDIT_GRID_ROUNDS = 25
BANDIT_CPU_ROUNDS = 20              # device:paper, CPU against CUDA
BANDIT_TIER4_ROUNDS = 10
BANDIT_PROFILE_ROUNDS = 5


def bandit_spec(reg, true_p, horizon, scenario="metropolis-1k"):
    """paper-fig3's spec of one policy (``POLICY_TABLE``'s seed offset)
    on a device env."""
    from repro_torch import api
    from repro_torch.core.utility import POLICY_TABLE
    offset = dict(POLICY_TABLE.values())[reg]
    return api.ExperimentSpec(
        policy=api.PolicySpec(reg, seed_offset=offset),
        env=api.EnvSpec(scenario, backend="device", true_p=true_p),
        horizon=horizon, seeds=BANDIT_SEEDS)


def counted(fn):
    """``fn()`` with the launch counts and walk syncs set to 0 just
    before it and read just after: (result, wall s, launches, syncs)."""
    import torch
    from repro_torch.kernels import common
    from repro_torch.kernels.budgeted_topk import ops as topk_ops
    common.reset_launches()
    for k in topk_ops.WALK_SYNCS:
        topk_ops.WALK_SYNCS[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, dict(common.LAUNCHES), dict(topk_ops.WALK_SYNCS)


def bandit_budget_check(env, dev, sels):
    """Replays the environment once for the per-round costs and holds
    every policy's selections (``sels``: name -> (S, T, N)) to
    eligibility and to each ES's budget, for every (seed, round, ES), on
    the card. Returns the largest spend of each policy."""
    import torch
    from repro_torch.sim.core import init_statics, round_batch
    m, budget = env.cfg.num_edge_servers, env.cfg.budget
    seed_t = torch.as_tensor(BANDIT_SEEDS, device=dev)
    statics = init_statics(env.spec, seed_t)
    pos = statics.pos0
    sel_d = {k: torch.as_tensor(v, device=dev).long()
             for k, v in sels.items()}
    worst = {k: [] for k in sels}
    bad = {k: [] for k in sels}
    for t in range(next(iter(sels.values())).shape[1]):
        pos, rd = round_batch(env.spec, seed_t, statics, pos, t)
        costs = rd.costs.double()
        for k, a_all in sel_d.items():
            a = a_all[:, t]
            chosen = a >= 0
            j = a.clamp(min=0)
            ok = torch.gather(rd.eligible, 2, j[..., None])[..., 0]
            spend = torch.zeros(a.shape[0], m, dtype=torch.float64,
                                device=dev).scatter_add_(
                1, j, torch.where(chosen, costs, torch.zeros_like(costs)))
            worst[k].append(spend.max())
            bad[k].append((chosen & ~ok).any() | (spend > budget
                                                  + 1e-6).any())
    out = {}
    for k in sels:
        if bool(torch.stack(bad[k]).any()):
            fail(f"bandit {k}: an ineligible pair or an ES over its budget "
                 f"{budget}")
        out[k] = float(torch.stack(worst[k]).max())
    return out


def bandit_profile(dev):
    """``round.env`` and ``round.select`` host ms a round, COCS in each
    ``true_p`` mode (``sim/engine.py``'s labels), under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import repro_torch
    out = {}
    for mode in ("analytic", "mc"):
        spec = bandit_spec("cocs", mode, BANDIT_PROFILE_ROUNDS)
        repro_torch.run(spec, device=dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            repro_torch.run(spec, device=dev)
            torch.cuda.synchronize()
        stages = {e.key: e.cpu_time_total / 1e3 / BANDIT_PROFILE_ROUNDS
                  for e in prof.key_averages()
                  if e.key.startswith("round.")
                  and e.device_type == DeviceType.CPU}
        out[mode] = stages
        print(f"  profile, cocs {mode}: " + ", ".join(
            f"{k} {v:.3f} ms host a round" for k, v in sorted(
                stages.items())))
    return out


def bandit_tier(dev, profile: bool = False):
    """Phase 15: the bandit tier on the card, through ``repro_torch.run``
    (tier 1): paper-fig3's three policies at full width in both ``true_p``
    modes, the budget grid against sequential runs, the CPU against CUDA,
    and tier 4 through the facade against ``sweep_experiments``."""
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import policies
    from repro_torch.core.utility import _policy_kwargs
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.experiment.sweep import sweep_experiments
    from repro_torch.sim import spec as simspec
    from repro_torch.sim.engine import (run_bandit_device,
                                        run_bandit_device_grid)
    t_phase = time.perf_counter()
    env = simspec.make("metropolis-1k", true_p="analytic")
    n, m = env.cfg.num_clients, env.cfg.num_edge_servers
    fields = ("selections", "utilities", "participants", "explored")
    out = {"rounds_per_s": {}, "cumulative_utility": {}, "regret": {}}
    runs = {}
    for mode, horizon in (("analytic", BANDIT_HORIZON),
                          ("mc", BANDIT_MC_ROUNDS)):
        for pol in POLICIES:
            res, wall, launches, syncs = counted(
                lambda: repro_torch.run(bandit_spec(pol, mode, horizon),
                                        device=dev))
            what = f"bandit {pol} ({mode})"
            if res.tier != 1 or res.env_backend != "device":
                fail(f"{what}: tier {res.tier}, {res.env_backend} env")
            if launches["context_pairwise"] != horizon:
                fail(f"{what}: context_pairwise launched "
                     f"{launches['context_pairwise']} times in {horizon} "
                     f"rounds")
            for k in ("budgeted_topk", "random_assign", "flgreedy_walk",
                      "masked_aggregate"):
                want = horizon if k in SELECT_KERNELS[pol] else 0
                if launches[k] != want:
                    fail(f"{what}: {k} launched {launches[k]} times in "
                         f"{horizon} rounds, expected {want}")
            if any(syncs.values()):
                fail(f"{what}: a selection walk synced with the host: "
                     f"{syncs}")
            sel = res.selections
            if sel.shape != (len(BANDIT_SEEDS), horizon, n) or \
                    sel.min() < -1 or sel.max() >= m:
                fail(f"{what}: selections of shape {sel.shape} in "
                     f"[{sel.min()}, {sel.max()}]")
            if not (np.isfinite(res.utilities).all()
                    and np.isfinite(res.participants).all()):
                fail(f"{what}: non-finite utilities")
            if not np.array_equal(res.utilities, res.participants):
                fail(f"{what}: utilities differ from participants under "
                     f"the linear utility")
            runs[(pol, mode)] = res
            rps = horizon / wall
            out["rounds_per_s"][f"{pol}/{mode}"] = rps
            print(f"  {pol} ({mode} true_p): {horizon} rounds in "
                  f"{wall:.3f} s = {rps:.3f} rounds/s ({len(BANDIT_SEEDS)} "
                  f"seeds x {n} clients x {m} ES); launches "
                  f"{ {k: v for k, v in launches.items() if v} }; walk "
                  f"host syncs {syncs}")
    t0 = time.perf_counter()
    worst = bandit_budget_check(
        env, dev, {p: runs[(p, "analytic")].selections for p in POLICIES})
    print(f"  max ES spend over {BANDIT_HORIZON} rounds: "
          f"{ {k: round(v, 6) for k, v in worst.items()} } <= budget "
          f"{env.cfg.budget} (replay {time.perf_counter() - t0:.1f} s)")
    oracle = runs[("oracle", "analytic")].utilities
    for pol in POLICIES:
        a, b = runs[(pol, "analytic")], runs[(pol, "mc")]
        for f in fields:
            if not np.array_equal(getattr(a, f)[:, :BANDIT_MC_ROUNDS],
                                  getattr(b, f)):
                fail(f"bandit {pol}: mc mode's {f} differ from the "
                     f"analytic run's first {BANDIT_MC_ROUNDS} rounds")
        cum = a.utilities.sum(axis=1)
        reg = (oracle - a.utilities).sum(axis=1)
        out["cumulative_utility"][pol] = cum.tolist()
        out["regret"][pol] = reg.tolist()
        print(f"  {pol}: cumulative utility at T={BANDIT_HORIZON} "
              f"{cum.tolist()}, regret against the Oracle {reg.tolist()}")
    print(f"  mc mode's first {BANDIT_MC_ROUNDS} rounds bitwise equal to "
          f"the analytic run's, three policies")

    # the budget grid, cell-major, against one sequential run a budget
    t0 = time.perf_counter()
    kw = _policy_kwargs(env.cfg, "cocs")
    h = BANDIT_GRID_ROUNDS
    cells = BANDIT_GRID_BUDGETS
    s = len(BANDIT_SEEDS)
    grid_seeds = [x for _ in cells for x in BANDIT_SEEDS]
    pol = policies.make("cocs", policies.PolicySpec.from_experiment(
        env.cfg, h), **kw)
    grid, wall, launches, syncs = counted(lambda: run_bandit_device_grid(
        pol, env.spec, grid_seeds, [b for b in cells for _ in range(s)],
        [env.cfg.deadline_s] * len(grid_seeds), h, grid_seeds,
        device=dev))
    if launches["context_pairwise"] != h or launches["budgeted_topk"] != h \
            or any(syncs.values()):
        fail(f"bandit grid: launches {launches}, walk syncs {syncs}")
    for i, b in enumerate(cells):
        seq_pol = policies.make("cocs", policies.PolicySpec.from_experiment(
            env.cfg, h, budget=b), **kw)
        seq = run_bandit_device(seq_pol, env.spec, BANDIT_SEEDS, h,
                                device=dev)
        for f in fields:
            if not np.array_equal(seq[f], grid[f][i * s:(i + 1) * s]):
                fail(f"bandit grid: budget {b}: {f} differ from the "
                     f"sequential run")
    sizes = [int((grid["selections"][i * s:(i + 1) * s] >= 0).sum())
             for i in range(len(cells))]
    print(f"  grid over budgets {cells} x {s} seeds, {h} rounds: one run "
          f"of {len(grid_seeds)} elements in {wall:.3f} s, bitwise equal "
          f"to the sequential runs ({time.perf_counter() - t0:.1f} s in "
          f"all); clients selected per cell {sizes}")
    out["grid"] = dict(budgets=list(cells), rounds=h, wall_s=wall,
                       selected=sizes)

    # the port on the CPU against the port on CUDA, device:paper
    t0 = time.perf_counter()
    out["cpu_vs_cuda"] = {}
    for pol in POLICIES:
        spec = bandit_spec(pol, "mc", BANDIT_CPU_ROUNDS, scenario="paper")
        a = repro_torch.run(spec, device="cpu").selections
        b = repro_torch.run(spec, device=dev).selections
        rows = int((a != b).any(axis=-1).sum())
        n_rows = a.shape[0] * a.shape[1]
        print(f"  paper/{pol}, CPU against CUDA, {len(BANDIT_SEEDS)} seeds x "
              f"{BANDIT_CPU_ROUNDS} rounds: {rows} of {n_rows} selection "
              f"rows differ")
        if rows > 0.01 * n_rows:
            fail(f"bandit paper/{pol}: {rows} of {n_rows} selection rows "
                 f"differ CPU vs CUDA")
        out["cpu_vs_cuda"][pol] = rows
    print(f"  CPU against CUDA in {time.perf_counter() - t0:.1f} s")

    # tier 4 through the facade against sweep_experiments
    t0 = time.perf_counter()
    from repro_torch import api
    data = FederatedDataset.synthetic(n, kind="mnist", samples_per_client=50,
                                      seed=0)
    data.stacked(dev)
    t4 = api.ExperimentSpec(
        policy=api.PolicySpec("cocs"), env=api.EnvSpec("metropolis-1k"),
        train=api.TrainSpec(), eval=api.EvalSpec(eval_every=5),
        horizon=BANDIT_TIER4_ROUNDS, seeds=BANDIT_SEEDS)
    got = repro_torch.run(t4, data=data, device=dev)
    want = sweep_experiments(("cocs",), "device:metropolis-1k",
                             seeds=BANDIT_SEEDS,
                             horizon=BANDIT_TIER4_ROUNDS, eval_every=5,
                             data=data, device=dev)
    if got.tier != 4:
        fail(f"tier 4: the facade ran tier {got.tier}")
    for f in fields:
        if not np.array_equal(getattr(got, f), getattr(want, f)["cocs"]):
            fail(f"tier 4: {f} differ between run and sweep_experiments")
    gap = max(float(np.abs(got.accuracy - want.accuracy["cocs"]).max()),
              float(np.abs(got.loss - want.loss["cocs"]).max()))
    if not np.isfinite(got.accuracy).all() or gap > 1e-6:
        fail(f"tier 4: accuracy or loss gap {gap} between run and "
             f"sweep_experiments")
    print(f"  tier 4 (cocs, metropolis-1k, {BANDIT_TIER4_ROUNDS} rounds): "
          f"run equals sweep_experiments (selections bitwise, accuracy and "
          f"loss gap {gap:.3e}); final accuracy {got.final_accuracy()} "
          f"({time.perf_counter() - t0:.1f} s)")
    out["tier4_gap"] = gap
    if profile:
        out["profile"] = bandit_profile(dev)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 15 in {out['phase_s']:.1f} s")
    return out


# -- phase 16: the paper's panels as written ----------------------------------

# repro/trials/suites.py's paper-fig3 and paper-fig4-quick, as specs: the
# host env (scenario "paper", backend "auto"), POLICY_TABLE's five
# policies and seed offsets, fig4's budget axis and both @smoke variants
FIG4_BUDGETS = (3.5, 5.0)
# the suite's committed fig3a_cumulative_utility_* rows (BENCH_quick.json,
# taken with the reference on an older jax: printed beside the port's,
# not gated, as the draws depend on jax's version)
FIG3_COMMITTED = {"Oracle": 4353, "COCS": 3559, "CUCB": 1414,
                  "LinUCB": 2356, "Random": 2316}
# the kernels each panel policy launches once a round (host policies none)
PANEL_KERNELS = {"Oracle": ("budgeted_topk",), "COCS": ("budgeted_topk",),
                 "CUCB": (), "LinUCB": (), "Random": ("random_assign",)}
PANEL_KERNEL_NAMES = ("context_pairwise", "budgeted_topk", "random_assign",
                      "flgreedy_walk", "masked_aggregate")


def panel_specs(smoke: bool = False):
    """{display: spec} of paper-fig3 and of paper-fig4-quick (a grid)."""
    import dataclasses
    from repro_torch import api
    from repro_torch.core.utility import POLICY_TABLE
    fig3 = api.ExperimentSpec(
        env=api.EnvSpec(scenario="paper", config="mnist-convex"),
        horizon=60 if smoke else 400, seeds=(1,))
    fig4 = api.ExperimentSpec(
        env=api.EnvSpec(scenario="paper", config="mnist-convex",
                        overrides=(("lr", 0.01),)),
        train=api.TrainSpec(model="logreg"),
        eval=api.EvalSpec(eval_every=6 if smoke else 5),
        horizon=12 if smoke else 40, seeds=(0,))
    pols = {d: api.PolicySpec(name=reg, seed_offset=off)
            for d, (reg, off) in POLICY_TABLE.items()}
    return ({d: dataclasses.replace(fig3, policy=p) for d, p in pols.items()},
            {d: dataclasses.replace(fig4, policy=p).grid(
                budget=list(FIG4_BUDGETS)) for d, p in pols.items()})


def panel_budget_check(rounds, sel, budget, what):
    """Every (round, ES) spend of ``sel`` (T, N) within ``budget`` on the
    host env's realized costs, every pair eligible. Returns the largest
    spend."""
    import numpy as np
    worst = 0.0
    for t, rd in enumerate(rounds):
        a = sel[t]
        chosen = np.nonzero(a >= 0)[0]
        if not rd.eligible[chosen, a[chosen]].all():
            fail(f"{what}: round {t}: an ineligible pair selected")
        spend = np.bincount(a[chosen], weights=rd.costs[chosen],
                            minlength=rd.eligible.shape[1])
        worst = max(worst, float(spend.max()))
        if (spend > budget + 1e-6).any():
            fail(f"{what}: round {t}: ES spend {spend.max()} over budget "
                 f"{budget}")
    return worst


def panel_launches_ok(launches, syncs, display, rounds, what):
    """Each selection kernel once a round for ``rounds`` rounds (none for
    a host policy), B1 never (the host env is numpy), no walk sync."""
    for k in PANEL_KERNEL_NAMES:
        want = rounds if k in PANEL_KERNELS[display] else 0
        if k != "masked_aggregate" and launches[k] != want:
            fail(f"{what}: {k} launched {launches[k]} times, expected "
                 f"{want}")
    if any(syncs.values()):
        fail(f"{what}: a selection walk synced with the host: {syncs}")


def paper_panels(dev):
    """Phase 16: paper-fig3 and paper-fig4-quick as written, on the host
    env, through ``repro_torch.run`` on the card."""
    import numpy as np
    import repro_torch
    from repro_torch.api.run import build_env, cached_rollout
    t_phase = time.perf_counter()
    out = {"fig3": {}, "fig4": {}, "fig4_smoke": {}}
    fig3, fig4 = panel_specs()

    # the host rollout, timed alone: the five fig3 runs share it (cache)
    spec0 = next(iter(fig3.values()))
    env = build_env(spec0.env)
    t0 = time.perf_counter()
    rounds = cached_rollout(env, spec0.seeds[0], spec0.horizon)
    roll_s = time.perf_counter() - t0
    out["fig3_rollout_s"] = roll_s
    print(f"  host rollout, paper, seed {spec0.seeds[0]}, {spec0.horizon} "
          f"rounds (float64 numpy, mc true_p, the CPU): {roll_s:.3f} s = "
          f"{spec0.horizon / roll_s:.1f} rounds/s")
    cum = {}
    for display, spec in fig3.items():
        res, wall, launches, syncs = counted(
            lambda: repro_torch.run(spec, device=dev))
        what = f"paper-fig3 {display}"
        if (res.tier, res.env_backend) != (1, "host"):
            fail(f"{what}: tier {res.tier}, {res.env_backend} env")
        panel_launches_ok(launches, syncs, display, spec.horizon, what)
        if launches["masked_aggregate"]:
            fail(f"{what}: masked_aggregate launched without training")
        worst = panel_budget_check(rounds, res.selections[0],
                                   env.cfg.budget, what)
        cum[display] = float(res.utilities.sum())
        rps = spec.horizon / wall
        out["fig3"][display] = dict(cumulative_utility=cum[display],
                                    rounds_per_s=rps, max_spend=worst,
                                    launches={k: v for k, v in
                                              launches.items() if v})
        print(f"  fig3 {display}: {spec.horizon} rounds in {wall:.3f} s = "
              f"{rps:.1f} rounds/s; launches "
              f"{ {k: v for k, v in launches.items() if v} }; max ES spend "
              f"{worst:.6f} <= {env.cfg.budget}")
    for display in fig3:
        reg = cum["Oracle"] - cum[display]
        out["fig3"][display]["regret"] = reg
        print(f"  fig3 {display}: cumulative utility {cum[display]:.0f}, "
              f"regret against the Oracle {reg:.0f} (the suite's committed "
              f"row {FIG3_COMMITTED[display]}, not gated)")
    rest = max(cum[d] for d in ("CUCB", "LinUCB", "Random"))
    if not cum["Oracle"] > cum["COCS"] > rest:
        fail(f"paper-fig3: cumulative utilities {cum} are not ordered "
             f"Oracle > COCS > CUCB, LinUCB, Random")

    # fig4-quick: the budget grid against each cell's sequential run
    for display, grid in fig4.items():
        horizon = grid.base.horizon
        gres, wall, launches, syncs = counted(
            lambda: repro_torch.run(grid, device=dev))
        what = f"paper-fig4-quick {display}"
        tier = gres.results[0].tier
        batched = bool(gres.results[0].batched_axes)
        runs = 1 if batched else len(gres.results)
        panel_launches_ok(launches, syncs, display, horizon * runs, what)
        if launches["masked_aggregate"] != horizon * runs:
            fail(f"{what}: masked_aggregate launched "
                 f"{launches['masked_aggregate']} times in {runs} run(s) of "
                 f"{horizon} rounds")
        t0 = time.perf_counter()
        for cell, r in zip(gres.cells, gres.results):
            if r.tier != (2 if display in ("CUCB", "LinUCB") else 3):
                fail(f"{what}: tier {r.tier}")
            if not np.isfinite(r.accuracy).all():
                fail(f"{what}: non-finite accuracy {r.accuracy}")
            seq, _, seq_launch, _ = counted(
                lambda: repro_torch.run(cell, device=dev))
            if seq_launch["masked_aggregate"] != horizon:
                fail(f"{what}: a sequential cell launched masked_aggregate "
                     f"{seq_launch['masked_aggregate']} times in {horizon} "
                     f"rounds")
            if not np.array_equal(seq.selections, r.selections):
                fail(f"{what}: budget {cell.policy.budget}: the grid's "
                     f"selections differ from the sequential run's")
        seq_s = time.perf_counter() - t0
        acc = gres.final_accuracy()[:, 0].tolist()
        rps = horizon * len(gres.results) / wall
        out["fig4"][display] = dict(tier=tier, batched=batched, wall_s=wall,
                                    cell_rounds_per_s=rps,
                                    final_accuracy=acc,
                                    cumulative_utility=gres
                                    .cumulative_utility()[:, 0].tolist())
        print(f"  fig4 {display}: tier {tier}, budgets {FIG4_BUDGETS} "
              f"{'batched in one run' if batched else 'one run a cell'}, "
              f"{horizon} rounds in {wall:.3f} s = {rps:.1f} cell-rounds/s; "
              f"launches { {k: v for k, v in launches.items() if v} }; "
              f"final accuracy {acc}; equal to the sequential runs "
              f"({seq_s:.1f} s)")

    # the @smoke variant, the port on the CPU against the port on CUDA
    t0 = time.perf_counter()
    _, fig4s = panel_specs(smoke=True)
    for display, grid in fig4s.items():
        a = repro_torch.run(grid, device="cpu")
        b = repro_torch.run(grid, device=dev)
        gap = 0.0
        for ra, rb in zip(a.results, b.results):
            if not np.array_equal(ra.selections, rb.selections):
                fail(f"fig4-quick@smoke {display}: selections differ CPU "
                     f"vs CUDA")
            gap = max(gap, float(np.abs(ra.accuracy - rb.accuracy).max()))
        if gap > 1e-3:
            fail(f"fig4-quick@smoke {display}: accuracy gap {gap} CPU vs "
                 f"CUDA")
        out["fig4_smoke"][display] = gap
    print(f"  fig4-quick@smoke, CPU against CUDA: selections identical, "
          f"accuracy gaps {out['fig4_smoke']} "
          f"({time.perf_counter() - t0:.1f} s)")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 16 in {out['phase_s']:.1f} s")
    return out


# -- phase 17: faults and robust Eq. 3 -----------------------------------------

# metropolis-1k under all four fault processes, tier 4 through
# repro_torch.run: logreg, 2 seeds, 20 rounds, 50 samples a client
FAULT_RATES = dict(dropout_rate=0.05, straggler_rate=0.2, outage_rate=0.05,
                   corrupt_rate=0.25)
FAULT_SEEDS = (0, 1)
FAULT_ROUNDS = 20
FAULT_EVERY = 10
FAULT_CAPTURE_ROUND = 10        # the round whose Eq. 3 inputs are captured
# each rule on the card against the same rule on the CPU, one round's
# captured inputs: |cuda - cpu| over the largest |cpu| (the sort and the
# median are exact; the sums and norms reduce in another order)
RULE_TOL = 1e-5


def fault_spec(model="logreg", aggregator="mean", faults="all",
               scenario="metropolis-1k", policy="cocs"):
    """Phase 17's spec: tier 4, ``faults`` "all" (``FAULT_RATES``),
    "off" (``FaultSpec()``), "corrupt" (corruption alone) or None."""
    from repro_torch import api
    from repro_torch.sim.faults import FaultSpec
    f = {"all": FaultSpec(**FAULT_RATES), "off": FaultSpec(),
         "corrupt": FaultSpec(corrupt_rate=FAULT_RATES["corrupt_rate"]),
         None: None}[faults]
    return api.ExperimentSpec(
        policy=api.PolicySpec(policy),
        env=api.EnvSpec(scenario, backend="device", faults=f),
        train=api.TrainSpec(aggregator=aggregator,
                            transposed_gemm=model == "logreg-t"),
        eval=api.EvalSpec(eval_every=FAULT_EVERY), horizon=FAULT_ROUNDS,
        seeds=FAULT_SEEDS)


def fault_events(env, dev):
    """Dropout, straggler, outage and corruption events over phase 17's
    seeds and rounds, from the shared fault draws on the card."""
    import torch
    from repro_torch.core.fmath import f32
    from repro_torch.sim.draws import fault_draws
    f = env.spec.faults
    seeds = torch.as_tensor(FAULT_SEEDS, device=dev)
    n, m = env.cfg.num_clients, env.cfg.num_edge_servers
    total = torch.zeros(4, dtype=torch.int64, device=dev)
    for t in range(FAULT_ROUNDS):
        fd = fault_draws(seeds, t, n, m, dev)
        total += torch.stack([(u < f32(r)).sum()
                              for u, r in ((fd.drop_u, f.dropout_rate),
                                           (fd.strag_u, f.straggler_rate),
                                           (fd.out_u, f.outage_rate),
                                           (fd.corr_u, f.corrupt_rate))])
    return dict(zip(("dropout", "straggler", "outage", "corruption"),
                    total.tolist()))


def outage_round_kernels(env, dev):
    """B2, P3's walk (after B2's keys-only launch) and Random's scan
    against their plain versions on the first round of phase 17's env
    where an outage cleared an ES column and left a client with no
    eligible ES: values ``true_p``, the round's costs and eligibility,
    the config's budget. Returns (seed, round)."""
    import torch
    from repro_torch import random as jr
    from repro_torch.kernels.budgeted_topk.kernel import (
        budgeted_topk_kernel, budgeted_topk_keys_kernel,
        flgreedy_walk_kernel)
    from repro_torch.kernels.budgeted_topk.ref import (budgeted_topk_ref,
                                                       flgreedy_topk_ref)
    from repro_torch.kernels.random_assign.kernel import random_assign_kernel
    from repro_torch.kernels.random_assign.ops import random_draws
    from repro_torch.kernels.random_assign.ref import random_assign_ref
    from repro_torch.sim.core import init_statics, round_batch
    seeds = torch.as_tensor(FAULT_SEEDS, device=dev)
    statics = init_statics(env.spec, seeds)
    pos = statics.pos0
    n, m = env.cfg.num_clients, env.cfg.num_edge_servers
    for t in range(FAULT_ROUNDS):
        pos, rd = round_batch(env.spec, seeds, statics, pos, t)
        cleared = ~rd.eligible.any(dim=1)            # (S, M)
        empty = ~rd.eligible.any(dim=2)              # (S, N)
        both = (cleared.any(dim=1) & empty.any(dim=1)).nonzero()
        if len(both):
            break
    else:
        fail(f"phase 17: no round of {FAULT_ROUNDS} cleared an ES column "
             f"and left a client row empty")
    si = int(both[0, 0])
    v, c, e = rd.true_p.contiguous(), rd.costs.contiguous(), \
        rd.eligible.contiguous()
    b = torch.full((len(FAULT_SEEDS), m), env.cfg.budget,
                   dtype=torch.float32, device=dev)
    ka, kr = budgeted_topk_kernel(v, c, b, e)
    ra, rr = budgeted_topk_ref(v, c, b, e)
    keys, counts = budgeted_topk_keys_kernel(v, c, e)
    pa, pr = flgreedy_walk_kernel(keys, counts, v, c, b)
    qa, qr = flgreedy_topk_ref(v, c, b, e)
    order, gum = random_draws(jr.PRNGKey(seeds + 7), n, m)
    xa, xr = random_assign_kernel(order, gum, c, b, e)
    ya, yr = random_assign_ref(order, gum, c, b, e)
    torch.cuda.synchronize()
    for name, (a1, r1, a2, r2) in (("budgeted_topk", (ka, kr, ra, rr)),
                                   ("flgreedy_walk", (pa, pr, qa, qr)),
                                   ("random_assign", (xa, xr, ya, yr))):
        if not (torch.equal(a1, a2)
                and torch.equal(r1.view(torch.int32), r2.view(torch.int32))):
            fail(f"phase 17: {name} differs from its plain version on the "
                 f"outage round (seed {FAULT_SEEDS[si]}, round {t})")
        if bool((a1[si][empty[si]] >= 0).any()) or bool(
                (a1[si][:, None] == cleared[si].nonzero()[:, 0]).any()):
            fail(f"phase 17: {name} assigned a client with no eligible ES "
                 f"or an ES in outage")
    print(f"  outage round: seed {FAULT_SEEDS[si]}, round {t}: "
          f"{int(cleared[si].sum())} of {m} ES columns cleared, "
          f"{int(empty[si].sum())} of {n} client rows empty; B2, P3's walk "
          f"(after B2's keys-only launch) and Random's scan bitwise their "
          f"plain versions (picks {int((ka[si] >= 0).sum())}, "
          f"{int((pa[si] >= 0).sum())}, {int((xa[si] >= 0).sum())})")
    return FAULT_SEEDS[si], t


def rules_cpu_vs_cuda(captured):
    """Each Eq. 3 rule on the captured (params, deltas, weights) of one
    round, on the card and on the CPU. Returns the largest gap over the
    largest value, a rule."""
    import torch
    from repro_torch.fed.robust import AGGREGATORS, robust_aggregate_rows
    edge, deltas, w = captured
    cpu = lambda x: x.detach().cpu()
    out = {}
    for rule in AGGREGATORS:
        a = robust_aggregate_rows(edge, deltas, w, aggregator=rule)
        b = robust_aggregate_rows({k: cpu(v) for k, v in edge.items()},
                                  cpu(deltas), cpu(w), aggregator=rule)
        gap = max(float((cpu(a[k]) - b[k]).abs().max()
                        / b[k].abs().max().clamp(min=1e-30)) for k in b)
        if not gap <= RULE_TOL:
            fail(f"phase 17: the {rule!r} rule on the card is {gap} away "
                 f"from the CPU's (relative), above {RULE_TOL}")
        out[rule] = gap
    return out


def logreg_step_ms(dev, k: int, batch: int = 32, nf: int = 784):
    """One local-SGD gradient step of ``k`` slots in each layout (CUDA
    events around loops)."""
    import torch
    from repro_torch.models.logistic import (init_logreg, init_logreg_t,
                                             loss_and_grad)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((k, batch, nf), device=dev, generator=g)
    y = torch.randint(0, 10, (k, batch), device=dev, generator=g)
    out = {}
    for kind, init in (("logreg", init_logreg), ("logreg-t",
                                                 init_logreg_t)):
        p = {n: v.expand((k,) + v.shape).contiguous()
             for n, v in init(nf, device=dev).items()}
        fn = loss_and_grad(kind)
        out[kind] = cuda_ms(lambda: fn(p, x, y), iters=100)
    return out


def faults_phase(dev):
    """Phase 17: faults and robust Eq. 3 on metropolis-1k through
    ``repro_torch.run`` (tier 4)."""
    import numpy as np
    import torch
    import repro_torch
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.fed import batched
    from repro_torch.sim import spec as simspec
    from repro_torch.sim.faults import FaultSpec
    t_phase = time.perf_counter()
    env = simspec.make("metropolis-1k", faults=FaultSpec(**FAULT_RATES))
    n = env.cfg.num_clients
    data = FederatedDataset.synthetic(n, kind="mnist", samples_per_client=50,
                                      seed=0)
    data.stacked(dev)
    fields = ("selections", "utilities", "participants", "explored")
    out = {"rates": FAULT_RATES, "rounds_per_s": {}, "final_accuracy": {}}
    captured = []
    orig = batched.robust_aggregate_rows

    def capture(edge, deltas, w, **kw):
        if len(captured) == FAULT_CAPTURE_ROUND:
            captured.append(({k: v.clone() for k, v in edge.items()},
                             deltas.clone(), w.clone()))
        else:
            captured.append(None)
        return orig(edge, deltas, w, **kw)

    runs = {}
    cases = [("cocs", "mean", "logreg", "all"),
             ("oracle", "mean", "logreg", "all"),
             ("random", "mean", "logreg", "all"),
             ("cocs", "trimmed_mean", "logreg", "all"),
             ("cocs", "median", "logreg", "all"),
             ("cocs", "clipped", "logreg", "all"),
             ("cocs", "mean", "logreg", "off"),
             ("cocs", "mean", "logreg", None),
             ("cocs", "mean", "logreg", "corrupt"),
             ("cocs", "mean", "logreg-t", "all")]
    for pol, rule, model, faults in cases:
        spec = fault_spec(model, rule, faults, policy=pol)
        key = f"{pol}/{rule}/{model}/faults={faults}"
        if key == "cocs/mean/logreg/faults=all":
            batched.robust_aggregate_rows = capture
        try:
            res, wall, launches, syncs = counted(
                lambda: repro_torch.run(spec, data=data, device=dev))
        finally:
            batched.robust_aggregate_rows = orig
        if (res.tier, res.env_backend) != (4, "device"):
            fail(f"phase 17 {key}: tier {res.tier}, {res.env_backend} env")
        want = {"context_pairwise": FAULT_ROUNDS,
                "masked_aggregate": FAULT_ROUNDS if rule == "mean" else 0,
                "flgreedy_walk": 0}
        for k in ("budgeted_topk", "random_assign"):
            want[k] = FAULT_ROUNDS if k in SELECT_KERNELS[pol] else 0
        bad = {k: launches[k] for k, v in want.items() if launches[k] != v}
        if bad:
            fail(f"phase 17 {key}: launches {bad} in {FAULT_ROUNDS} rounds, "
                 f"expected {want}")
        if any(syncs.values()):
            fail(f"phase 17 {key}: a selection walk synced with the host: "
                 f"{syncs}")
        if not np.isfinite(res.utilities).all():
            fail(f"phase 17 {key}: non-finite utilities")
        runs[key] = res
        rps = FAULT_ROUNDS / wall
        out["rounds_per_s"][key] = rps
        out["final_accuracy"][key] = res.final_accuracy().tolist()
        print(f"  {key}: {FAULT_ROUNDS} rounds in {wall:.3f} s = "
              f"{rps:.3f} rounds/s; launches "
              f"{ {k: v for k, v in launches.items() if v} }; final "
              f"accuracy {res.final_accuracy().tolist()}")
    for rule in ("median", "trimmed_mean"):
        acc = runs[f"cocs/{rule}/logreg/faults=all"].accuracy
        if not np.isfinite(acc).all():
            fail(f"phase 17: {rule}'s accuracy is not finite")
    clean = runs["cocs/mean/logreg/faults=None"]
    off = runs["cocs/mean/logreg/faults=off"]
    for f in fields + ("accuracy", "loss"):
        if not np.array_equal(getattr(clean, f), getattr(off, f)):
            fail(f"phase 17: FaultSpec() changed {f} against faults=None")
    corrupt = runs["cocs/mean/logreg/faults=corrupt"]
    for f in ("selections", "utilities", "explored"):
        if not np.array_equal(getattr(clean, f), getattr(corrupt, f)):
            fail(f"phase 17: corruption alone changed {f}")
    print("  FaultSpec() bitwise equal to faults=None in every output; "
          "corruption alone leaves selections, utilities and explored "
          "bitwise")
    events = fault_events(env, dev)
    out["events"] = events
    mean_acc = runs["cocs/mean/logreg/faults=all"].final_accuracy()
    med_acc = runs["cocs/median/logreg/faults=all"].final_accuracy()
    print(f"  fault events over {len(FAULT_SEEDS)} seeds x {FAULT_ROUNDS} "
          f"rounds: {events}; final accuracy under corruption: mean "
          f"{mean_acc.tolist()}, median {med_acc.tolist()}")

    cap = [c for c in captured if c is not None]
    if len(cap) != 1:
        fail(f"phase 17: captured {len(cap)} rounds of Eq. 3 inputs")
    out["rules_cpu_vs_cuda"] = rules_cpu_vs_cuda(cap[0])
    slots = cap[0][1].shape[0] * cap[0][1].shape[1]
    print(f"  round {FAULT_CAPTURE_ROUND}'s Eq. 3 inputs "
          f"({tuple(cap[0][1].shape)} deltas), each rule on the card "
          f"against the CPU: {out['rules_cpu_vs_cuda']} <= {RULE_TOL}")
    out["outage_round"] = outage_round_kernels(env, dev)

    # device:paper with all four faults, the port on the CPU and on CUDA
    t0 = time.perf_counter()
    spec = fault_spec(scenario="paper")
    a = repro_torch.run(spec, device="cpu")
    b = repro_torch.run(spec, device=dev)
    rows = int((a.selections != b.selections).any(axis=-1).sum())
    n_rows = a.selections.shape[0] * a.selections.shape[1]
    gap = float(np.abs(a.accuracy - b.accuracy).max())
    print(f"  device:paper with all four faults, COCS, CPU against CUDA: "
          f"{rows} of {n_rows} selection rows differ, accuracy gap "
          f"{gap:.3e} ({time.perf_counter() - t0:.1f} s)")
    if rows > 0.01 * n_rows:
        fail(f"phase 17: device:paper, {rows} of {n_rows} selection rows "
             f"differ CPU vs CUDA")
    if rows == 0 and gap > 1e-3:
        fail(f"phase 17: device:paper, accuracy gap {gap} with identical "
             f"selections")
    out["paper_cpu_vs_cuda"] = dict(rows_differ=rows, accuracy_gap=gap)

    steps = logreg_step_ms(dev, slots)
    lt = runs["cocs/mean/logreg-t/faults=all"]
    lr = runs["cocs/mean/logreg/faults=all"]
    out["logreg_t"] = dict(step_ms=steps, selections_equal=bool(
        np.array_equal(lt.selections, lr.selections)),
        accuracy_gap=float(np.abs(lt.accuracy - lr.accuracy).max()))
    print(f"  transposed_gemm: one local-SGD step of {slots} slots "
          f"(32 x 784) {steps['logreg-t'] * 1e3:.2f} us against logreg's "
          f"{steps['logreg'] * 1e3:.2f} us; run {out['rounds_per_s']['cocs/mean/logreg-t/faults=all']:.3f} "
          f"against {out['rounds_per_s']['cocs/mean/logreg/faults=all']:.3f} "
          f"rounds/s; selections equal {out['logreg_t']['selections_equal']}"
          f", accuracy gap {out['logreg_t']['accuracy_gap']:.3e}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 17 in {out['phase_s']:.1f} s")
    return out


# -- phase 18: resilience and observability ----------------------------------

# metropolis-1k tier 4 (logreg, 2 seeds, 50 samples a client): 20 rounds
# in 4 intervals, so kills after 1, 2 and 3 intervals leave a first, a
# middle and a last-but-one checkpoint
RESUME_SEEDS = (0, 1)
RESUME_ROUNDS = 20
RESUME_EVERY = 5
RESUME_KILLS = (1, 2, 3)
RUN_FIELDS = ("selections", "utilities", "participants", "explored",
              "accuracy", "loss")
# the CNN's determinism probe and its health runs: paper under
# CIFAR10_NONCONVEX, COCS, 4 rounds in 2 intervals
CNN_PROBE = (4, 2)


def resilient_spec(scenario="metropolis-1k", policy="cocs", backend="device",
                   checkpoint_dir=None, resume=False, health="off",
                   telemetry=False, trace=None, profiler=None,
                   horizon=RESUME_ROUNDS, every=RESUME_EVERY):
    """Phase 18's spec: tier 4 (``backend="device"``) or tier 3
    (``"host"``), logreg, ``RESUME_SEEDS``."""
    from repro_torch import api
    from repro_torch.obs.spec import ObsSpec
    return api.ExperimentSpec(
        policy=api.PolicySpec(policy),
        env=api.EnvSpec(scenario, backend=backend),
        train=api.TrainSpec(),
        eval=api.EvalSpec(eval_every=every, checkpoint_dir=checkpoint_dir,
                          resume=resume, health=health),
        obs=ObsSpec(telemetry=telemetry, trace=trace, jax_profiler=profiler),
        horizon=horizon, seeds=RESUME_SEEDS)


def first_difference(a, b, fields=RUN_FIELDS):
    """The first field in which two runs differ, or None."""
    import numpy as np
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if x.shape != y.shape or not np.array_equal(x, y, equal_nan=True):
            return f
    return None


def kill_after(spec, ckpt, blocks, dev, data=None):
    """The facade's construction of ``spec``, killed after ``blocks``
    intervals by ``stop_after_blocks``."""
    from repro_torch.api.run import build_env, build_policy
    from repro_torch.experiment.sweep import SimulatedKill, sweep_experiments
    env = build_env(spec.env)
    pol = build_policy(spec.policy, env.cfg, spec.horizon)
    try:
        sweep_experiments({spec.policy.name: pol}, env, list(spec.seeds),
                          spec.horizon, eval_every=spec.eval.eval_every,
                          data=data, checkpoint_dir=ckpt,
                          stop_after_blocks=blocks, device=dev)
    except SimulatedKill:
        return
    fail(f"phase 18: stop_after_blocks={blocks} did not stop the run")


def resume_case(dev, tmp, data, scenario, backend, policy, kernels):
    """Two uninterrupted runs (bitwise equal), then a kill after each of
    ``RESUME_KILLS`` intervals and a resume, each bitwise the
    uninterrupted run, with ``kernels``' launches over both halves equal
    to the uninterrupted run's and no walk host sync. Returns the second
    uninterrupted run, its wall, and the kills' launch sums."""
    import repro_torch
    tier = 4 if backend == "device" else 3
    what = f"phase 18 {scenario}/{policy} tier {tier}"
    spec = resilient_spec(scenario, policy, backend)
    runs = [counted(lambda: repro_torch.run(spec, data=data, device=dev))
            for _ in range(2)]
    (a, _, want, _), (b, wall, _, _) = runs
    diff = first_difference(a, b)
    if diff is not None:
        fail(f"{what}: two uninterrupted runs differ in {diff}")
    for k in kernels:
        if want[k] != RESUME_ROUNDS:
            fail(f"{what}: {k} launched {want[k]} times in "
                 f"{RESUME_ROUNDS} rounds")
    sums = {}
    for kill in RESUME_KILLS:
        ckpt = os.path.join(tmp, f"{scenario}-{backend}-{policy}-{kill}")
        _, _, l1, s1 = counted(lambda: kill_after(spec, ckpt, kill, dev,
                                                  data))
        res, _, l2, s2 = counted(lambda: repro_torch.run(
            resilient_spec(scenario, policy, backend, checkpoint_dir=ckpt,
                           resume=True), data=data, device=dev))
        diff = first_difference(b, res)
        if diff is not None:
            fail(f"{what}: killed after {kill} intervals and resumed, "
                 f"{diff} differs from the uninterrupted run")
        both = {k: l1[k] + l2[k] for k in kernels}
        if both != {k: want[k] for k in kernels}:
            fail(f"{what}: launches over the killed and resumed halves "
                 f"{both}, the uninterrupted run's "
                 f"{ {k: want[k] for k in kernels} }")
        if any(s1.values()) or any(s2.values()):
            fail(f"{what}: a selection walk synced with the host")
        sums[kill] = both
    print(f"  {what}: 2 uninterrupted runs bitwise equal; killed after "
          f"{list(RESUME_KILLS)} intervals and resumed, each bitwise; "
          f"launches over both halves {sums[RESUME_KILLS[0]]} (each kill); "
          f"walk syncs 0")
    return b, wall, sums


def cnn_probe(dev, tmp):
    """The CNN (P3, 32x32x3) at lr 0.005: two runs bitwise equal, then a
    resume gated bitwise; where two runs differ, the field is printed and
    the probe repeats under cuDNN's deterministic algorithms. Then the
    configuration's own lr 0.1, which diverges (R11): the health guard
    records its leaves under ``record`` and raises under ``halt``."""
    import dataclasses
    import torch
    from repro_torch.configs.paper_hfl import CIFAR10_NONCONVEX
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.experiment.sweep import SimulatedKill, sweep_experiments
    from repro_torch.sim import spec as simspec
    data = FederatedDataset.synthetic(50, kind="cifar", seed=0)
    h, e = CNN_PROBE
    out = {}

    def sweep(env, **kw):
        return sweep_experiments(("cocs",), env, seeds=RESUME_SEEDS,
                                 horizon=h, eval_every=e, model_kind="cnn",
                                 data=data, device=dev, **kw)

    gated = simspec.make("paper", dataclasses.replace(CIFAR10_NONCONVEX,
                                                      lr=GATED_LR))
    fields = ("selections", "utilities", "participants", "explored",
              "accuracy", "loss", "train_loss")
    for mode in ("default", "deterministic"):
        torch.backends.cudnn.deterministic = mode == "deterministic"
        try:
            a, b = sweep(gated), sweep(gated)
            diff = next((f for f in fields
                         if not (getattr(a, f)["cocs"]
                                 == getattr(b, f)["cocs"]).all()), None)
            out[mode] = {"runs_equal": diff is None, "first_diff": diff}
            if diff is not None:
                print(f"  CNN, cuDNN {mode}: two runs differ first in "
                      f"{diff}; resume not gated in this mode")
                continue
            ckpt = os.path.join(tmp, f"cnn-{mode}")
            try:
                sweep(gated, checkpoint_dir=ckpt, stop_after_blocks=1)
            except SimulatedKill:
                pass
            r = sweep(gated, checkpoint_dir=ckpt, resume=True)
            rdiff = next((f for f in fields
                          if not (getattr(a, f)["cocs"]
                                  == getattr(r, f)["cocs"]).all()), None)
            if rdiff is not None:
                fail(f"phase 18: the CNN (cuDNN {mode}) resumed differs in "
                     f"{rdiff}, two uninterrupted runs do not")
            out[mode]["resume_bitwise"] = True
            print(f"  CNN, cuDNN {mode}: two runs bitwise equal; killed "
                  f"after 1 of 2 intervals and resumed, bitwise")
            break
        finally:
            torch.backends.cudnn.deterministic = False
    env = simspec.make("paper", CIFAR10_NONCONVEX)
    rec = sweep(env, health="record").health["cocs"]
    if not rec["events"]:
        fail(f"phase 18: the CNN at lr {CIFAR10_NONCONVEX.lr} recorded no "
             f"health event: {rec}")
    bad = rec["events"][0]["bad"] if rec["events"] else []
    if not any(x.startswith("carry['edge']") for x in bad):
        fail(f"phase 18: the health event names no edge leaf: {bad}")
    try:
        sweep(env, health="halt")
    except RuntimeError as err:
        if "non-finite" not in str(err):
            raise
    else:
        fail("phase 18: health='halt' did not raise on the diverged CNN")
    out["health_record"] = rec
    print(f"  CNN at lr {CIFAR10_NONCONVEX.lr} (R11): 'record' logged "
          f"{len(rec['events'])} of {rec['checked']} intervals, first "
          f"{rec['events'][:1]}; 'halt' raised")
    return out


def taps_check(off, on):
    """Taps on against off: decisions bitwise, the counts equal to the
    host oracle taken from the run's own outputs, the totals to the
    series' sums."""
    import numpy as np
    diff = first_difference(off, on)
    if diff is not None:
        fail(f"phase 18: taps on changed {diff}")
    t = on.telemetry
    s, tot = t["series"], t["totals"]
    checks = {
        "selected": np.array_equal(s["selected"],
                                   (on.selections >= 0).sum(axis=2)),
        "arrived": np.array_equal(s["arrived"], on.participants),
        "deadline_miss": np.array_equal(s["deadline_miss"],
                                        s["selected"] - s["arrived"]),
        "explored": np.array_equal(tot["explored"],
                                   on.explored.sum(axis=1)),
        "totals": all(np.array_equal(tot[k], s[k].sum(axis=1))
                      for k in ("selected", "arrived", "deadline_miss"))}
    if not all(checks.values()):
        fail(f"phase 18: taps against the host oracle {checks}")
    print(f"  taps on: decisions bitwise the run without; counts equal "
          f"the host oracle {sorted(checks)}; summary "
          f"{ {k: round(v, 4) for k, v in t['summary'].items()} }")
    return t["summary"]


def faulty_taps_cpu_vs_cuda(dev):
    """``device:paper`` under ``FAULT_RATES`` with ``median``, taps on:
    the ``agg_adjusted`` and ``corrupted`` series on the card equal the
    CPU's."""
    import dataclasses
    import numpy as np
    import repro_torch
    from repro_torch.obs.spec import ObsSpec
    spec = dataclasses.replace(fault_spec(scenario="paper",
                                          aggregator="median"),
                               obs=ObsSpec(telemetry=True))
    a = repro_torch.run(spec, device="cpu")
    b = repro_torch.run(spec, device=dev)
    rows = int((a.selections != b.selections).any(axis=-1).sum())
    out = {"selection_rows_differ": rows}
    for k in ("agg_adjusted", "corrupted"):
        x, y = a.telemetry["series"][k], b.telemetry["series"][k]
        if not np.array_equal(x, y):
            fail(f"phase 18: device:paper under FAULT_RATES with median, "
                 f"{k} on the card differs from the CPU's ({rows} "
                 f"selection rows differ)")
        out[k] = float(y.sum())
    print(f"  device:paper, FAULT_RATES, median, taps on: agg_adjusted "
          f"({out['agg_adjusted']:.0f} slots) and corrupted "
          f"({out['corrupted']:.0f}) series equal on the card and the CPU; "
          f"{rows} selection rows differ")
    return out


def tracer_check(dev, tmp, data):
    """A traced tier-4 run with checkpoints: its spans, the report and
    the Perfetto export through ``python -m repro_torch.obs``; a
    ``torch.profiler`` capture into ``ObsSpec.jax_profiler`` that names
    B1's kernel. Returns the checkpoint writes' ms and bytes, the run and
    the profiler attempts."""
    import repro_torch
    trace = os.path.join(tmp, "run.jsonl")
    ckpt = os.path.join(tmp, "traced")
    res, wall, _, _ = counted(lambda: repro_torch.run(
        resilient_spec(checkpoint_dir=ckpt, trace=trace), data=data,
        device=dev))
    recs = [json.loads(ln) for ln in open(trace)]
    names = [r["name"] for r in recs]
    blocks = [r for r in recs if r["name"] == "fused_block_device"]
    saves = [r for r in recs if r["name"] == "checkpoint.save"]
    n = RESUME_ROUNDS // RESUME_EVERY
    missing = {"run.resolve", "run.dispatch", "train.prepare"} - set(names)
    if missing or len(blocks) != n or len(saves) != n or not all(
            {"dispatch_us", "execute_us"} <= set(b) for b in blocks):
        fail(f"phase 18: the trace holds {sorted(set(names))}, {len(blocks)} "
             f"blocks, {len(saves)} checkpoint writes; missing {missing}")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.obs"]
    rep = subprocess.run(cmd + ["report", trace], capture_output=True,
                         text=True, env=env, timeout=120)
    exp = subprocess.run(cmd + ["export", trace, "-o",
                                os.path.join(tmp, "run.trace.json")],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    if rep.returncode or "## Fused blocks" not in rep.stdout \
            or exp.returncode:
        fail(f"phase 18: report exit {rep.returncode}, export exit "
             f"{exp.returncode}: {rep.stderr} {exp.stderr}")
    sizes = [os.path.getsize(os.path.join(ckpt, "cocs", f))
             for f in sorted(os.listdir(os.path.join(ckpt, "cocs")))]
    disp = sum(b["dispatch_us"] for b in blocks) / 1e3
    execute = sum(b["execute_us"] for b in blocks) / 1e3
    print(f"  traced run: {len(recs)} records; {n} fused_block_device spans "
          f"(dispatch {disp:.1f} ms, execute {execute:.1f} ms in all), {n} "
          f"checkpoint.save spans; report ({len(rep.stdout)} bytes) and "
          f"Perfetto export through python -m repro_torch.obs")
    found, attempts = False, 0
    while not found and attempts < 3:
        attempts += 1
        prof = os.path.join(tmp, f"prof{attempts}")
        repro_torch.run(resilient_spec(profiler=prof, horizon=2, every=2),
                        data=data, device=dev)
        for f in os.listdir(prof):
            with open(os.path.join(prof, f)) as fh:
                found = found or "context_pairwise_kernel" in fh.read()
    if not found:
        fail("phase 18: the torch.profiler traces of 3 runs name no "
             "context_pairwise_kernel")
    print(f"  ObsSpec.jax_profiler: a torch.profiler trace naming "
          f"context_pairwise_kernel (attempt {attempts})")
    return dict(save_ms=[r["dur_us"] / 1e3 for r in saves],
                save_bytes=sizes, rounds_per_s=RESUME_ROUNDS / wall,
                profiler_attempts=attempts)


def resilience_phase(dev):
    """Phase 18: checkpoints and resume, the health guard, the taps and
    the tracer through ``repro_torch.run`` on the card."""
    import tempfile
    import repro_torch
    from repro_torch.data.federated import FederatedDataset
    t_phase = time.perf_counter()
    data = FederatedDataset.synthetic(1000, kind="mnist",
                                      samples_per_client=50, seed=0)
    data.stacked(dev)
    out = {"resume": {}, "rounds_per_s": {}}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        plain = {}
        for pol in POLICIES:
            kernels = ("context_pairwise", "masked_aggregate") \
                + SELECT_KERNELS[pol]
            plain[pol], wall, sums = resume_case(
                dev, tmp, data, "metropolis-1k", "device", pol, kernels)
            out["resume"][f"metropolis-1k/{pol}/tier4"] = sums
            out["rounds_per_s"][f"{pol}, off"] = RESUME_ROUNDS / wall
        _, _, sums = resume_case(dev, tmp, None, "paper", "host", "cocs",
                                 ("budgeted_topk", "masked_aggregate"))
        out["resume"]["paper/cocs/tier3"] = sums
        out["cnn"] = cnn_probe(dev, tmp)

        costs = {}
        for what, kw in (("checkpoints", dict(checkpoint_dir=os.path.join(
                              tmp, "costs"))),
                         ("health", dict(health="record")),
                         ("taps", dict(telemetry=True))):
            res, wall, _, _ = counted(lambda: repro_torch.run(
                resilient_spec(**kw), data=data, device=dev))
            costs[what] = (res, wall)
            out["rounds_per_s"][f"cocs, {what}"] = RESUME_ROUNDS / wall
        clean = costs["health"][0].health
        if clean != {"checked": RESUME_ROUNDS // RESUME_EVERY, "events": []}:
            fail(f"phase 18: a clean logreg run's health report {clean}")
        diff = first_difference(plain["cocs"], costs["checkpoints"][0])
        if diff is not None:
            fail(f"phase 18: checkpoints changed {diff}")
        out["taps"] = taps_check(plain["cocs"], costs["taps"][0])
        out["faulty_taps"] = faulty_taps_cpu_vs_cuda(dev)
        out["tracer"] = tracer_check(dev, tmp, data)
        out["rounds_per_s"]["cocs, checkpoints + tracer"] = \
            out["tracer"]["rounds_per_s"]
    r = out["rounds_per_s"]
    t = out["tracer"]
    save_ms = sorted(t["save_ms"])[len(t["save_ms"]) // 2]
    print(f"  costs (not gated), COCS rounds/s: off {r['cocs, off']:.3f}, "
          f"checkpoints {r['cocs, checkpoints']:.3f}, health "
          f"{r['cocs, health']:.3f}, taps {r['cocs, taps']:.3f}, "
          f"checkpoints + tracer {r['cocs, checkpoints + tracer']:.3f}; a "
          f"checkpoint write {save_ms:.2f} ms (median of "
          f"{len(t['save_ms'])}), {t['save_bytes'][0]} to "
          f"{t['save_bytes'][-1]} bytes")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 18 in {out['phase_s']:.1f} s")
    return out


# -- phase 19: the trial bench ----------------------------------------------

TRIAL_SUITES = ("paper-fig3", "paper-fig4-quick", "robustness-panel")
# the variants run on CUDA, as written then @smoke; paper-fig3 as written
# is phase 16's
TRIAL_VARIANTS = {"paper-fig3": (True,)}
HOST_POLICIES = ("CUCB", "LinUCB")     # tier 2 when they train
TRIAL_ACC_TOL = 1e-3                   # phase 16's CPU-against-CUDA gate
DEVICE_SUITE_BUDGETS = (8.0, 12.0, 16.0)
DEVICE_SUITE_ROUNDS = 40              # cut from 100 for the time limit
TRIAL_KERNELS = ("context_pairwise", "budgeted_topk", "random_assign",
                 "flgreedy_walk", "masked_aggregate")


class Dispatches:
    """Wraps ``repro_torch.api.run``, the trial runner's one dispatch
    point: each call's spec, result, wall s, launches and walk syncs,
    the counts set to 0 just before the call and read just after."""

    def __enter__(self):
        from repro_torch import api
        self.log = []
        self._api, self._real = api, api.run

        def run(spec, **kw):
            res, wall, launches, syncs = counted(
                lambda: self._real(spec, **kw))
            self.log.append(dict(spec=spec, result=res, wall=wall,
                                 launches=launches, syncs=syncs))
            return res
        api.run = run
        return self

    def __exit__(self, *exc):
        self._api.run = self._real


def dispatch_launches_ok(d, what):
    """One dispatch's launches: B2 once a round for COCS and the Oracle,
    Random's scan once a round for Random, B3 once a round when it
    trains under ``mean`` and never under a robust rule, B1 once a round
    on a device env and never on the host env, P3's walk never, no walk
    host sync. A grid whose cells could not batch ran each cell in turn:
    a round of each counts."""
    from repro_torch.api.spec import ExperimentGrid
    spec = d["spec"]
    grid = isinstance(spec, ExperimentGrid)
    base = spec.base if grid else spec
    results = d["result"].results if grid else [d["result"]]
    rounds = base.horizon * (1 if results[0].batched_axes else len(results))
    name = base.policy.name
    mean = base.train is not None and base.train.aggregator == "mean"
    want = {"context_pairwise": rounds if results[0].env_backend == "device"
            else 0,
            "budgeted_topk": rounds if name in ("cocs", "oracle") else 0,
            "random_assign": rounds if name == "random" else 0,
            "flgreedy_walk": 0,
            "masked_aggregate": rounds if mean else 0}
    got = {k: d["launches"][k] for k in TRIAL_KERNELS}
    if got != want or any(d["syncs"].values()):
        fail(f"{what}: {name} launched {got}, expected {want}; walk syncs "
             f"{d['syncs']}")
    return got


def trial_run(suite, dev, ledger, smoke=False, resume=False):
    """``run_suite`` on ``dev`` under :class:`Dispatches`: (result, wall
    s, dispatches)."""
    from repro_torch.trials import run_suite
    with Dispatches() as disp:
        t0 = time.perf_counter()
        result = run_suite(suite, smoke=smoke, ledger=ledger, resume=resume,
                           device=dev)
        wall = time.perf_counter() - t0
    return result, wall, disp.log


def trial_gates(suite, result, log, what):
    """Tiers, batched axes, launches a dispatch and finite accuracy of
    one suite run. Returns the launches summed over its dispatches."""
    import numpy as np
    from repro_torch.api.spec import GRID_AXES
    batchable = tuple(a for a, _ in suite.axes if GRID_AXES[a][0])
    n_seq = 1
    for a, v in suite.axes:
        n_seq *= 1 if GRID_AXES[a][0] else len(v)
    if len(log) != len(suite.policies) * n_seq:
        fail(f"{what}: {len(log)} dispatches, expected one a policy and "
             f"sequential coordinate ({len(suite.policies) * n_seq})")
    total = dict.fromkeys(TRIAL_KERNELS, 0)
    for d in log:
        for k, v in dispatch_launches_ok(d, what).items():
            total[k] += v
    for rec in result.records:
        trains = suite.base.train is not None
        tier = (2 if rec.policy in HOST_POLICIES else 3) if trains else 1
        if rec.tier != tier:
            fail(f"{what} {rec.cell_id}: tier {rec.tier}, expected {tier}")
        want = () if rec.policy in HOST_POLICIES else batchable
        if tuple(rec.batched_axes) != want:
            fail(f"{what} {rec.cell_id}: batched axes {rec.batched_axes}, "
                 f"expected {want}")
        if trains and not (rec.final_acc is not None
                           and np.isfinite(rec.acc_curve).all()):
            fail(f"{what} {rec.cell_id}: accuracy {rec.acc_curve}")
        if not (rec.us_per_call and rec.us_per_call > 0):
            fail(f"{what} {rec.cell_id}: us_per_call {rec.us_per_call}")
    return total


def robust_claim(result):
    """The robustness panel's own claim: at ``corrupt_rate`` 0.25 the
    robust rules beat ``mean`` in final accuracy, for each policy."""
    acc = {(r.policy, dict(r.coord)["aggregator"]): r.final_acc
           for r in result.records if dict(r.coord)["corrupt_rate"] == 0.25}
    for display in dict(result.suite.policies):
        mean = acc[(display, "mean")]
        for rule in ("median", "trimmed_mean"):
            if not acc[(display, rule)] > mean:
                fail(f"robustness-panel {display}: {rule} final accuracy "
                     f"{acc[(display, rule)]} does not beat mean's {mean} "
                     f"at corrupt_rate 0.25")
    return {f"{p}/{rule}": a for (p, rule), a in acc.items()}


def trials_cpu_vs_cuda(name, cpu, gpu):
    """``check_suite`` of the CUDA ledger against the CPU's, and the
    stricter gate: utilities, regret and participation equal, final
    accuracy within ``TRIAL_ACC_TOL``. Returns the accuracy gap."""
    from repro_torch.trials import check_suite, load_entries
    label = f"{name}@smoke"
    n, report = check_suite(load_entries(cpu), load_entries(gpu), label)
    if n:
        fail(f"{label}: check_suite CUDA against CPU: {n} failures: "
             f"{[r for r in report if r.endswith('FAIL')]}")
    want, got = load_entries(cpu), load_entries(gpu)
    gap = 0.0
    for entry_name, w in want.items():
        mw, mg = w["metrics"], got[entry_name]["metrics"]
        for key in ("cum_utility", "cum_utility_seeds", "participation",
                    "regret", "regret_seeds"):
            if mw.get(key) != mg.get(key):
                fail(f"{entry_name}: {key} {mw.get(key)} on the CPU, "
                     f"{mg.get(key)} on CUDA")
        if "final_acc" in mw:
            gap = max(gap, abs(mw["final_acc"] - mg["final_acc"]))
    if gap > TRIAL_ACC_TOL:
        fail(f"{label}: final accuracy CPU against CUDA {gap}")
    return gap


def trials_resume(dev, ledger, first):
    """A resume of ``paper-fig4-quick@smoke`` on its ledger dispatches
    nothing; with one non-Oracle entry dropped only that cell's dispatch
    group runs, and its regret is the first run's."""
    from repro_torch.kernels import common
    common.reset_launches()
    again, _, log = trial_run("paper-fig4-quick", dev, ledger, smoke=True,
                              resume=True)
    moved = {k: common.LAUNCHES[k] for k in TRIAL_KERNELS}
    if log or any(moved.values()):
        fail(f"resume of a complete ledger: {len(log)} dispatches, "
             f"launches {moved}")
    for rec in first.records:
        if again.record(rec.policy, rec.coord).to_entry()["metrics"] \
                != rec.to_entry()["metrics"]:
            fail(f"resume: {rec.name} differs from the first run")
    drop = "trial_paper-fig4-quick@smoke_COCS_budget_5.0"
    with open(ledger) as f:
        entries = json.load(f)
    with open(ledger, "w") as f:
        json.dump([e for e in entries if e["name"] != drop], f)
    resumed, wall, log = trial_run("paper-fig4-quick", dev, ledger,
                                   smoke=True, resume=True)
    if len(log) != 1 or log[0]["spec"].base.policy.name != "cocs":
        fail(f"resume after dropping {drop}: {len(log)} dispatches")
    launches = dispatch_launches_ok(log[0], "resume")
    want = first.record("COCS", (("budget", 5.0),))
    got = resumed.record("COCS", (("budget", 5.0),))
    if (got.regret, got.cum_utility_seeds) != (want.regret,
                                               want.cum_utility_seeds):
        fail(f"resume: COCS budget 5.0 regret {got.regret}, first run "
             f"{want.regret}")
    print(f"  resume of fig4-quick@smoke on its ledger: 0 dispatches, 0 "
          f"launches, records equal; {drop} dropped: 1 dispatch (the COCS "
          f"budget grid, launches {launches}) in {wall:.3f} s, regret "
          f"{got.regret} as first recorded")
    return {"dropped": drop, "wall_s": wall, "launches": launches}


def device_suite():
    """COCS, Oracle and Random on ``metropolis-1k`` (analytic true_p)
    over a budget axis, 2 seeds, bandit tier 1: B1 under the runner."""
    from repro_torch import api
    from repro_torch.core.utility import POLICY_TABLE
    from repro_torch.trials import TrialSuite
    return TrialSuite(
        name="metropolis-1k-budgets",
        base=api.ExperimentSpec(
            env=api.EnvSpec("metropolis-1k", true_p="analytic"),
            horizon=DEVICE_SUITE_ROUNDS, seeds=BANDIT_SEEDS),
        policies=tuple((d, api.PolicySpec(POLICY_TABLE[d][0],
                                          seed_offset=POLICY_TABLE[d][1]))
                       for d in ("COCS", "Oracle", "Random")),
        axes=(("budget", DEVICE_SUITE_BUDGETS),))


def trials_device_suite(dev, ledger):
    import numpy as np
    import repro_torch
    suite = device_suite()
    result, wall, log = trial_run(suite, dev, ledger)
    launches = trial_gates(suite, result, log, suite.name)
    t0 = time.perf_counter()
    for d in log:
        for cell, res in zip(d["spec"].expand(), d["result"].results):
            if res.env_backend != "device":
                fail(f"{suite.name}: a {res.env_backend} env")
            seq = repro_torch.run(cell, device=dev)
            if not np.array_equal(seq.selections, res.selections):
                fail(f"{suite.name} {cell.policy.name} budget "
                     f"{cell.policy.budget}: the batched selections differ "
                     f"from the sequential run's")
    seq_s = time.perf_counter() - t0
    regret = {r.cell_id: r.regret for r in result.records
              if r.regret is not None}
    print(f"  {suite.name}: {len(result.records)} cells in {len(log)} "
          f"dispatches, {wall:.3f} s ({len(result.records) / wall:.3f} "
          f"cells/s); launches {launches}; every cell's selections equal "
          f"to its sequential run ({seq_s:.1f} s); regret {regret}")
    return {"wall_s": wall, "cells": len(result.records),
            "dispatches": len(log), "launches": launches,
            "sequential_s": seq_s, "regret": regret}


def trials_clis(tmp):
    """``python -m repro_torch.trials run``/``check`` and ``python -m
    repro_torch.launch.train --paper`` as subprocesses."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

    def call(*args, timeout=300):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                             env=env, capture_output=True, text=True,
                             timeout=timeout)
        return out, time.perf_counter() - t0

    ledger = os.path.join(tmp, "cli.json")
    label = "paper-fig4-quick@smoke"
    run, run_s = call("repro_torch.trials", "run", "paper-fig4-quick",
                      "--smoke", "--ledger", ledger)
    if run.returncode or "appended 10 records" not in run.stdout:
        fail(f"trials run: exit {run.returncode}: {run.stdout[-2000:]} "
             f"{run.stderr[-2000:]}")
    check = ["repro_torch.trials", "check", "--baseline", ledger,
             "--suite", label, "--current"]
    same, _ = call(*check, ledger)
    with open(ledger) as f:
        entries = json.load(f)
    entries[1]["metrics"]["cum_utility"] += 1.0
    changed = os.path.join(tmp, "cli_changed.json")
    with open(changed, "w") as f:
        json.dump(entries, f)
    worse, _ = call(*check, changed)
    if same.returncode != 0 or worse.returncode != 1:
        fail(f"trials check: exit {same.returncode} on the ledger itself, "
             f"{worse.returncode} with one cum_utility changed: "
             f"{worse.stdout[-1000:]}")
    train, train_s = call("repro_torch.launch.train", "--paper", "--rounds",
                          "10", "--eval-every", "5")
    final = [line for line in train.stdout.splitlines()
             if line.startswith("final accuracy: ")]
    if train.returncode or not final or not math.isfinite(
            float(final[0].split(": ")[1])):
        fail(f"launch.train --paper: exit {train.returncode}: "
             f"{train.stdout[-1000:]} {train.stderr[-1000:]}")
    acc = float(final[0].split(": ")[1])
    print(f"  python -m repro_torch.trials run paper-fig4-quick --smoke: "
          f"exit 0 in {run_s:.1f} s; check exits 0 on itself, 1 with one "
          f"cum_utility changed; python -m repro_torch.launch.train --paper "
          f"--rounds 10: exit 0 in {train_s:.1f} s, final accuracy {acc}")
    return ledger, {"run_s": run_s, "train_s": train_s, "train_acc": acc}


def trials_phase(dev):
    """Phase 19: the trial bench on the card through ``run_suite``. Each
    suite runs on CUDA as written and at ``@smoke``, except paper-fig3,
    which phase 16 runs as written and which runs here at ``@smoke``
    only (phase 19's time); each ``@smoke`` run also runs on the CPU."""
    import tempfile
    from repro_torch.trials import check_suite, get_suite, load_entries
    t_phase = time.perf_counter()
    out = {"suites": {}, "smoke": {}}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for name in TRIAL_SUITES:
            suite = get_suite(name)
            for smoke in TRIAL_VARIANTS.get(name, (False, True)):
                label = suite.label(smoke)
                ledger = os.path.join(tmp, f"{label}.cuda.json")
                result, wall, log = trial_run(name, dev, ledger, smoke)
                launches = trial_gates(suite, result, log, label)
                row = {"wall_s": wall, "cells": len(result.records),
                       "cells_per_s": len(result.records) / wall,
                       "dispatches": len(log), "launches": launches,
                       "us_per_call": {r.cell_id: r.us_per_call
                                       for r in result.records}}
                if name == "robustness-panel":
                    row["final_acc_at_0.25"] = robust_claim(result)
                out["suites"][label] = row
                print(f"  {label}: {len(result.records)} cells in "
                      f"{len(log)} dispatches, {wall:.3f} s = "
                      f"{row['cells_per_s']:.3f} cells/s; launches "
                      f"{launches}")
                print("    us_per_call: " + ", ".join(
                    f"{k} {v:.0f}" for k, v in row["us_per_call"].items()))
                if name == "robustness-panel":
                    print(f"    final accuracy at corrupt_rate 0.25: "
                          f"{row['final_acc_at_0.25']}")
            # the @smoke variant on the CPU against its CUDA run
            cpu = os.path.join(tmp, f"{label}.cpu.json")
            t0 = time.perf_counter()
            trial_run(name, "cpu", cpu, smoke=True)
            cpu_s = time.perf_counter() - t0
            gap = trials_cpu_vs_cuda(name, cpu, ledger)
            out["smoke"][name] = {"cpu_s": cpu_s, "acc_gap": gap}
            print(f"  {label} on the CPU in {cpu_s:.1f} s against CUDA: "
                  f"check_suite 0 failures, utilities, regret and "
                  f"participation equal, final accuracy gap {gap}")
            if name == "paper-fig4-quick":
                fig4_smoke = (ledger, result)

        gpu, first = fig4_smoke
        out["resume"] = trials_resume(dev, gpu, first)
        out["device_suite"] = trials_device_suite(
            dev, os.path.join(tmp, "device.json"))
        cli_ledger, out["cli"] = trials_clis(tmp)
        label = "paper-fig4-quick@smoke"
        n, report = check_suite(load_entries(gpu), load_entries(cli_ledger),
                                label)
        if n:
            fail(f"the CLI's {label} ledger against run_suite's: {report}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 19 in {out['phase_s']:.1f} s")
    return out


# -- phase 11: the serve slice on CPU against CUDA ---------------------------

# phase 11's models: (arch, prompt length); "kimi-k2-e16-k8" is kimi's
# reduced() with 16 experts and top-8 (reduced() caps k at 2)
LM_CPU_CASES = (("qwen2-1.5b", 64), ("rwkv6-1.6b", 64),
                ("mixtral-8x22b", 96), ("zamba2-1.2b", 64),
                ("seamless-m4t-large-v2", 64), ("paligemma-3b", 64),
                ("granite-8b", 64), ("granite-20b", 64), ("qwen2.5-14b", 64),
                ("kimi-k2-1t-a32b", 64), ("kimi-k2-e16-k8", 64))


def lm_cpu_vs_cuda(dev):
    """Every served model at ``reduced()`` (float32, TF32 off): the same
    parameters, prompt and (audio, VLM) frames or patches through
    ``launch.serve.run`` on the CPU (plain versions) and on CUDA (the
    kernels). mixtral's 96-token prompt is longer than its reduced window
    of 64, so B4's window and the decode mask both cut; zamba2's 64
    tokens are two chunks of 32; the seamless encoder runs B4 non-causal."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import registry as R
    out = {}
    for arch, plen in LM_CPU_CASES:
        if arch == "kimi-k2-e16-k8":
            cfg = get_config("kimi-k2-1t-a32b").reduced()
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, num_experts=16, top_k=8))
        else:
            cfg = get_config(arch).reduced()
        params = R.init_params(cfg, 0, device="cpu")
        gen = torch.Generator().manual_seed(3)
        prompt = torch.randint(0, cfg.vocab_size, (4, plen), generator=gen,
                               dtype=torch.int32)
        extra = {}
        if cfg.arch_type == "audio":
            extra["frames"] = torch.randn((4, cfg.num_frames, cfg.d_model),
                                          generator=gen)
        if cfg.arch_type == "vlm":
            extra["patches"] = torch.randn((4, cfg.num_patches, cfg.d_model),
                                           generator=gen)
        a = serve.run(cfg, gen_len=16, device="cpu", params=params,
                      prompt=prompt, **extra)
        b = serve.run(cfg, gen_len=16, device=dev,
                      params=to_device(params, dev),
                      prompt=prompt.to(dev),
                      **{k: v.to(dev) for k, v in extra.items()})
        gaps = {f: (getattr(a, f).float() - getattr(b, f).float().cpu())
                .abs().max().item()
                for f in ("prefill_logits", "logits", "step_logits")}
        flips = int((a.tokens != b.tokens.cpu()).sum())
        print(f"  {arch} reduced ({plen}-token prompt): max logit gap "
              f"prefill "
              f"{gaps['prefill_logits']:.3e}, first token "
              f"{gaps['logits']:.3e}, decode {gaps['step_logits']:.3e} "
              f"(tol {LM_CPU_TOL}); greedy tokens differing {flips} of "
              f"{a.tokens.numel()}")
        if max(gaps.values()) > LM_CPU_TOL:
            fail(f"{arch}: CPU and CUDA logits differ by "
                 f"{max(gaps.values())}")
        out[arch] = dict(gaps=gaps, token_flips=flips)
    return out


# -- phase 20: the sharded cohort --------------------------------------------

MESH_SEEDS = (0, 1)
MESH_ROUNDS = 4
MESH_EVERY = 2
MESH_LAYOUTS = ((4, 1), (2, 2))        # (clients, seeds) ranks on cuda:0
MESH_1M_ROUNDS = 2
MESH_TIMEOUT = 600.0
# above B2's one-pass limit, the edge cases of the tile grid and its walk
TILE_EDGE_CASES = ((2, 3000, 12, "ineligible"), (2, 3000, 12, "ties"),
                   (2, 3000, 12, "zero-budget"), (2, 3000, 12, "dead-es"),
                   (2, 4100, 5, "negative-cost"))
HIER_SHARDS = (1, 2, 4, 8)


def mesh_spec(scenario: str, seeds, rounds: int, shard=None):
    from repro_torch import api
    return api.ExperimentSpec(
        policy=api.PolicySpec("cocs"),
        env=api.EnvSpec(scenario, true_p="analytic"),
        train=api.TrainSpec(batch_size=16),
        eval=api.EvalSpec(eval_every=MESH_EVERY), horizon=rounds,
        seeds=tuple(seeds), shard=shard)


def preset_inputs(dev, preset: str, s: int):
    """values, costs, budgets, eligible at a preset's full width: the
    env's round-0 costs and eligibility (seeds 0 .. s-1), uniform values
    (COCS's scores once explored), the preset's budget an ES."""
    import torch
    from repro_torch.sim import spec as simspec
    from repro_torch.sim.core import init_statics, round_batch
    env = simspec.make(preset, true_p="analytic")
    seed_t = torch.arange(s, device=dev)
    statics = init_statics(env.spec, seed_t)
    _, rd = round_batch(env.spec, seed_t, statics, statics.pos0, 0)
    gen = torch.Generator(device=dev).manual_seed(s)
    v = torch.rand(rd.eligible.shape, generator=gen, device=dev)
    b = torch.full((s, env.cfg.num_edge_servers), env.cfg.budget,
                   device=dev)
    return v, rd.costs.contiguous(), b, rd.eligible.contiguous()


def tile_agree(v, c, b, e, tile: int, what: str):
    """The tile grid and the segment walk against their plain versions,
    bitwise; returns (density, flat, assign, remaining, plain walk s,
    plain walk's host syncs)."""
    import torch
    from repro_torch.kernels.budgeted_topk import kernel as K
    from repro_torch.kernels.budgeted_topk import ref
    m = v.shape[-1]
    d, f = K.density_sort_tiles_kernel(v, c, e, tile)
    rd, ri = ref.density_sort_ref(v, c, e, tile)
    if not (torch.equal(d.view(torch.int32), rd.view(torch.int32))
            and torch.equal(f, ri)):
        fail(f"density_sort_tiles not bitwise at {what}")
    del rd, ri
    a, r = K.segment_walk_kernel(d, f, c, b, m)
    syncs = ref.WALK_SYNCS["greedy_walk"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pa, pr = ref.greedy_walk(ref.build_segments(v, c, e, tile), b,
                             num_es=m, num_clients=v.shape[1])
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if not (torch.equal(a, pa)
            and torch.equal(r.view(torch.int32), pr.view(torch.int32))):
        fail(f"segment_walk not bitwise at {what}")
    return d, f, a, r, plain_s, ref.WALK_SYNCS["greedy_walk"] - syncs


def check_tile_grid(dev):
    """B2's tile grid (``density_sort_tiles``) and P2's walk over its
    segments (``segment_walk``) against their plain versions, bitwise,
    at metropolis-100k's and metropolis-1m's widths and on edge cases;
    timed at both widths. Returns the two kernel rows (at 100k) and the
    numbers of both widths."""
    import torch
    from repro_torch.kernels.budgeted_topk import kernel as K
    from repro_torch.kernels.budgeted_topk.ref import pair_density
    for s, n, m, kind in TILE_EDGE_CASES:
        v, c, b, e = topk_inputs(dev, s, n, m, 40, kind if kind in (
            "ties", "ineligible", "negative-cost") else "random")
        if kind == "zero-budget":
            b.zero_()
        elif kind == "dead-es":
            b[:, 0] = 0.1                  # below every cost
        _, _, a, _, _, _ = tile_agree(v, c, b, e, K.tile_for(m),
                                      f"{(s, n, m)} {kind}")
        if kind in ("zero-budget", "ineligible") and (a >= 0).any():
            fail(f"segment_walk picked at {kind}")
        if kind == "dead-es" and (a == 0).any():
            fail("segment_walk assigned to an ES no client can afford")
    print(f"  density_sort_tiles and segment_walk bitwise on "
          f"{len(TILE_EDGE_CASES)} edge cases: "
          f"{[c[3] for c in TILE_EDGE_CASES]}")
    out, rows = {}, None
    for preset, s in (("metropolis-100k", 2), ("metropolis-1m", 1)):
        v, c, b, e = preset_inputs(dev, preset, s)
        _, n, m = v.shape
        tile = K.tile_for(m)
        d, f, a, r, plain_walk_s, plain_syncs = tile_agree(
            v, c, b, e, tile, preset)
        sort_call = lambda: K.density_sort_tiles_kernel(v, c, e, tile)
        walk_call = lambda: K.segment_walk_kernel(d, f, c, b, m)
        iters = 5 if n > 200_000 else 10
        a_ms, a_warm = device_ms(sort_call, iters), device_ms(
            sort_call, iters, cold=False)
        a_wall = cuda_ms(sort_call, iters, 1)
        b_ms, b_warm = device_ms(walk_call, iters), device_ms(
            walk_call, iters, cold=False)
        b_wall = cuda_ms(walk_call, iters, 1)
        from repro_torch.kernels.budgeted_topk.ref import density_sort_ref
        a_plain = cuda_ms(lambda: density_sort_ref(v, c, e, tile), 2, 1)
        # the library yardstick: one torch.sort of the same rows by the
        # composite (density image, flat + 1) key
        nt, p = K.tile_shape(n, m, tile)
        dens = pair_density(v, c, e) + 0.0
        dens = torch.cat([dens, dens.new_full((s, nt * tile - n, m),
                                              -torch.inf)], 1)
        bits = dens.reshape(s, nt, tile * m).view(torch.int32).to(
            torch.int64)
        comp = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits) * (1 << 32) \
            + torch.arange(1, nt * tile * m + 1, device=dev).view(
                1, nt, tile * m)
        if p > tile * m:
            comp = torch.cat([comp, comp.new_full(
                (s, nt, p - tile * m), -(1 << 62))], -1)
        del dens, bits
        lib_ms = device_ms(lambda: torch.sort(comp, dim=-1,
                                              descending=True), iters)
        del comp
        picks = int((a >= 0).sum())
        kept = int((d > 0).sum())
        a_bytes = 5 * s * n * m + 4 * s * n + 8 * s * nt * p
        b_bytes = 8 * kept + 4 * min(kept, s * n) + 8 * s * m + 4 * s * n
        a_bnd, a_by = bound_ms(a_bytes, s * n * m)
        b_bnd, b_by = bound_ms(b_bytes)
        out[preset] = dict(
            shape=[s, n, m], tile=tile, segments=nt, row=p, picks=picks,
            positive_pairs=kept, sort_us=a_ms * 1e3, sort_warm_us=a_warm * 1e3,
            sort_call_us=a_wall * 1e3, sort_plain_us=a_plain * 1e3,
            torch_sort_us=lib_ms * 1e3, sort_bound_us=a_bnd * 1e3,
            walk_us=b_ms * 1e3, walk_warm_us=b_warm * 1e3,
            walk_call_us=b_wall * 1e3, walk_plain_us=plain_walk_s * 1e6,
            walk_plain_syncs=plain_syncs, walk_bound_us=b_bnd * 1e3,
            walk_us_a_pick=b_ms * 1e3 / max(picks, 1),
            walk_smem=K.walk_smem(n, m, nt))
        print(f"  {preset} {[s, n, m]}, tile {tile}: {nt} segments of {p}; "
              f"{kept} pairs of density > 0, {picks} picks")
        print(f"    density_sort_tiles {a_ms * 1e3:.2f} us (L2 flushed), "
              f"{a_warm * 1e3:.2f} warm, {a_wall * 1e3:.2f} a call; plain "
              f"{a_plain * 1e3:.2f} us; torch.sort of the rows "
              f"{lib_ms * 1e3:.2f} us; bound {a_bnd * 1e3:.3f} us ({a_by})")
        print(f"    segment_walk {b_ms * 1e3:.2f} us (L2 flushed), "
              f"{b_warm * 1e3:.2f} warm, {b_wall * 1e3:.2f} a call, "
              f"{b_ms * 1e3 / max(picks, 1):.3f} us a pick; plain walk "
              f"{plain_walk_s * 1e6:.2f} us with {plain_syncs} host syncs; "
              f"bound {b_bnd * 1e3:.3f} us ({b_by}); shared memory "
              f"{K.walk_smem(n, m, nt)} B")
        if rows is None:
            common_kw = dict(route="cuda", max_abs_err=0.0, shape=[s, n, m])
            rows = [dict(name="density_sort_tiles",
                         source="src/repro_torch/csrc/budgeted_topk.cu",
                         replaces="src/repro/kernels/budgeted_topk/"
                         "kernel.py:96",
                         ms=a_ms, plain_ms=a_plain, bound_ms=a_bnd,
                         bound_by=a_by, library_ms=lib_ms, wall_ms=a_wall,
                         warm_ms=a_warm, **common_kw),
                    dict(name="segment_walk",
                         source="src/repro_torch/csrc/segment_walk.cu",
                         replaces="none: not a TPU kernel (the reference's "
                         "XLA while_loop, src/repro/kernels/budgeted_topk/"
                         "ops.py:170)",
                         ms=b_ms, plain_ms=plain_walk_s * 1e3,
                         bound_ms=b_bnd, bound_by=b_by, library_ms=None,
                         wall_ms=b_wall, warm_ms=b_warm, **common_kw)]
        del v, c, b, e, d, f, a, r
        torch.cuda.empty_cache()
    return rows, out


def hier_on_card(dev):
    """The single-process emulation of the sharded walk on the card, at
    (1000, 12) and shards 1, 2, 4, 8: bitwise the dense kernels' P2
    (B2's one pass) and P3 (keys, then P3's walk)."""
    import torch
    from repro_torch.mesh import hier_flgreedy_assign, hier_greedy_assign
    from repro_torch.policies.solvers import flgreedy_assign, greedy_assign
    v, c, b, e = topk_inputs(dev, 2, 1000, 12, 3, "main")
    dense, dense_fl = greedy_assign(v, c, b, e), flgreedy_assign(v, c, b, e)
    for shards in HIER_SHARDS:
        if not torch.equal(hier_greedy_assign(v, c, b, e, shards), dense):
            fail(f"hier_greedy_assign at {shards} shards")
        if not torch.equal(hier_flgreedy_assign(v, c, b, e, shards),
                           dense_fl):
            fail(f"hier_flgreedy_assign at {shards} shards")
    print(f"  hier_greedy_assign and hier_flgreedy_assign at (2, 1000, 12), "
          f"shards {HIER_SHARDS}: bitwise the dense kernels' "
          f"({int((dense >= 0).sum())} and {int((dense_fl >= 0).sum())} "
          f"picks)")


def mesh_run_checks(res, env, dev, seeds, what):
    import numpy as np
    worst = spend_within_budget(env, dev, seeds, np.asarray(res.selections),
                                what)
    if not np.isfinite(np.asarray(res.accuracy)).all():
        fail(f"{what}: non-finite accuracy")
    if not np.asarray(res.participants).max() > 0:
        fail(f"{what}: no participant in any round")
    return worst


def sharded_cohort(dev):
    """metropolis-100k at full width (2 seeds, 4 rounds), dense on the
    card and sharded over 4 ranks on cuda:0 (gloo) as 4x1 and 2x2, every
    field bitwise the dense run; metropolis-1m dense (1 seed, 2 rounds);
    the launches of the tile grid and the segment walk in the dense
    100k run are the kernel rows' launches."""
    import tempfile
    import threading
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import api
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.kernels import common
    from repro_torch.kernels.budgeted_topk.ref import WALK_SYNCS
    from repro_torch.launch.mesh import run_specs, spawn_local
    from repro_torch.sim import spec as simspec

    out = {}
    data_kw = dict(num_clients=100_000, kind="tiny", samples_per_client=20,
                   seed=0)
    t0 = time.perf_counter()
    data = FederatedDataset.synthetic(**data_kw)
    out["data_100k_s"] = time.perf_counter() - t0
    spec = mesh_spec("metropolis-100k", MESH_SEEDS, MESH_ROUNDS)
    env = simspec.make("metropolis-100k", true_p="analytic")
    common.reset_launches()
    for k in WALK_SYNCS:
        WALK_SYNCS[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    dense = repro_torch.run(spec, data=data, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    if any(WALK_SYNCS.values()):
        fail(f"metropolis-100k dense: a walk synced with the host "
             f"{WALK_SYNCS}")
    want = {"context_pairwise": MESH_ROUNDS, "density_sort_tiles":
            MESH_ROUNDS, "segment_walk": MESH_ROUNDS, "budgeted_topk": 0,
            "masked_aggregate": MESH_ROUNDS}
    for k, v in want.items():
        if launches[k] != v:
            fail(f"metropolis-100k dense: {k} launched {launches[k]} "
                 f"times in {MESH_ROUNDS} rounds, expected {v}")
    worst = mesh_run_checks(dense, env, dev, MESH_SEEDS, "metropolis-100k")
    out["dense_100k"] = dict(
        wall_s=wall, rounds_per_s=MESH_ROUNDS / wall,
        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        launches={k: v for k, v in launches.items() if v},
        max_spend=worst, accuracy=np.asarray(dense.accuracy)[:, -1].tolist(),
        picks_a_round=float((np.asarray(dense.selections) >= 0).sum()
                            / (len(MESH_SEEDS) * MESH_ROUNDS)))
    print(f"  metropolis-100k dense on the card: {wall:.3f} s, "
          f"{MESH_ROUNDS / wall:.3f} rounds/s, peak "
          f"{out['dense_100k']['peak_gb']:.3f} GB; launches "
          f"{out['dense_100k']['launches']}; walk host syncs 0; max ES "
          f"spend {worst:.6f} <= {env.cfg.budget}; accuracy "
          f"{out['dense_100k']['accuracy']}; "
          f"{out['dense_100k']['picks_a_round']:.1f} picks a seed a round")
    fields = ("selections", "utilities", "participants", "explored",
              "accuracy", "loss")
    out["sharded_100k"] = {}
    # the metropolis-1m run's tiny data (~35 s of host numpy) is made
    # while the ranks run, when this process only waits on them
    made = {}

    def make_1m():
        t0 = time.perf_counter()
        try:
            made["data"] = FederatedDataset.synthetic(
                1_000_000, kind="tiny", samples_per_client=20, seed=0)
        finally:
            made["s"] = time.perf_counter() - t0

    maker = threading.Thread(target=make_1m, daemon=True)
    maker.start()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for cl, sd in MESH_LAYOUTS:
            sspec = mesh_spec("metropolis-100k", MESH_SEEDS, MESH_ROUNDS,
                              api.ShardSpec(clients=cl, seeds=sd))
            t0 = time.perf_counter()
            ranks = spawn_local(run_specs, cl * sd, backend="gloo",
                                device=dev, init_file=os.path.join(
                                    tmp, f"rdv{cl}{sd}"),
                                args=([sspec.to_json()], data_kw),
                                timeout=MESH_TIMEOUT)
            spawn_s = time.perf_counter() - t0
            for r, rows in enumerate(ranks):
                row = rows[0]
                for f in fields:
                    if not np.array_equal(np.asarray(getattr(dense, f)),
                                          row[f]):
                        fail(f"metropolis-100k {cl}x{sd}: rank {r} {f} "
                             "differs from the dense card run")
            r0 = ranks[0][0]
            per_round = {k: v / MESH_ROUNDS
                         for k, v in r0["collectives"].items()}
            out["sharded_100k"][f"{cl}x{sd}"] = dict(
                backend=r0["backend"], spawn_s=spawn_s,
                run_s=[rk[0]["seconds"] for rk in ranks],
                rounds_per_s=MESH_ROUNDS / max(rk[0]["seconds"]
                                               for rk in ranks),
                peak_gb=[rk[0]["peak_bytes"] / 1e9 for rk in ranks],
                walk_syncs_a_round=r0["walk_syncs"] / MESH_ROUNDS,
                collectives_a_round=per_round,
                launches=[{k: v for k, v in rk[0]["launches"].items() if v}
                          for rk in ranks])
            o = out["sharded_100k"][f"{cl}x{sd}"]
            print(f"  metropolis-100k {cl} client x {sd} seed shards, "
                  f"{cl * sd} ranks on {dev} over {o['backend']}: every "
                  f"field bitwise the dense card run on every rank; "
                  f"{o['rounds_per_s']:.3f} rounds/s (ranks' runs "
                  f"{[round(x, 3) for x in o['run_s']]} s, spawn and all "
                  f"{spawn_s:.1f} s); peak GB a rank "
                  f"{[round(x, 3) for x in o['peak_gb']]}; rank 0's walk "
                  f"host syncs {o['walk_syncs_a_round']:.1f} and "
                  f"collectives {per_round} a round; rank 0's launches "
                  f"{o['launches'][0]}")
    del data
    maker.join()
    if "data" not in made:
        fail("metropolis-1m: the tiny data could not be made")
    data1m, data_s = made["data"], made["s"]
    spec1m = mesh_spec("metropolis-1m", (0,), MESH_1M_ROUNDS)
    env1m = simspec.make("metropolis-1m", true_p="analytic")
    common.reset_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = repro_torch.run(spec1m, data=data1m, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in common.LAUNCHES.items() if v}
    if any(WALK_SYNCS.values()):
        fail(f"metropolis-1m dense: a walk synced with the host "
             f"{WALK_SYNCS}")
    for k in ("density_sort_tiles", "segment_walk", "context_pairwise"):
        if launches.get(k) != MESH_1M_ROUNDS:
            fail(f"metropolis-1m: {k} launched {launches.get(k)} times")
    del data1m
    worst = mesh_run_checks(res, env1m, dev, (0,), "metropolis-1m")
    out["dense_1m"] = dict(
        data_s=data_s, wall_s=wall, rounds_per_s=MESH_1M_ROUNDS / wall,
        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        launches=launches, max_spend=worst,
        accuracy=np.asarray(res.accuracy)[:, -1].tolist(),
        participants=np.asarray(res.participants).tolist())
    print(f"  metropolis-1m dense on the card, 1 seed, {MESH_1M_ROUNDS} "
          f"rounds: {wall:.3f} s ({MESH_1M_ROUNDS / wall:.3f} rounds/s; its "
          f"tiny data took {data_s:.1f} s on the host while the ranks "
          f"ran), peak "
          f"{out['dense_1m']['peak_gb']:.3f} GB; launches {launches}; max "
          f"ES spend {worst:.6f} <= {env1m.cfg.budget}; accuracy "
          f"{out['dense_1m']['accuracy']}; participants "
          f"{out['dense_1m']['participants']}")
    return out, dict(launches=out["dense_100k"]["launches"])


def mesh_phase(dev):
    """Phase 20."""
    t0 = time.perf_counter()
    rows, tiles = check_tile_grid(dev)
    hier_on_card(dev)
    runs, main = sharded_cohort(dev)
    print(f"  phase 20 in {time.perf_counter() - t0:.1f} s")
    return rows, dict(tiles=tiles, **runs,
                      phase_s=time.perf_counter() - t0), main["launches"]


# -- phases 21-26: the rest of the LM zoo -----------------------------------

# B4 at the new models' prompt shapes: (what, (B, S, H, KV, D), causal,
# dtype). The seamless encoder is the first non-causal use on the path
FLASH_ZOO_CASES = (
    ("seamless encoder", (8, 1024, 16, 16, 64), False, "bfloat16"),
    ("seamless encoder", (8, 1024, 16, 16, 64), False, "float32"),
    ("granite-20b MQA", (8, 512, 48, 1, 128), True, "bfloat16"),
    ("qwen2.5-14b group of 5", (8, 512, 40, 8, 128), True, "bfloat16"),
    ("granite-8b", (8, 512, 32, 8, 128), True, "bfloat16"),
    ("kimi-k2", (8, 512, 64, 8, 128), True, "bfloat16"),
    ("seamless decoder", (8, 64, 16, 16, 64), True, "bfloat16"),
    ("zamba2 shared attention", (8, 256, 32, 32, 64), True, "bfloat16"),
    ("zamba2 shared attention", (8, 512, 32, 32, 64), True, "bfloat16"))
# the float32 overflow edge of the reference's exp(-cumsum log_w)
EXP_F32_MAX = 88.72
ZAMBA2_PROMPT = 256             # 2 of zamba2's chunks of 128 (512 doubles
                                # the rebuild's ~30 s)
ZAMBA2_F32_PROMPT = 256         # prefill against steps, float32
SEAMLESS_PROMPT = 64
KIMI_LAYERS = 1                 # of 61: 33.8 GB of experts, 4.7 GB embed/head


def flash_zoo(dev) -> list:
    """Phase 21: B4 at FLASH_ZOO_CASES against its plain float32 version on
    the model layout's views, within FLASH_TOL; each timed (CUDA events,
    L2 flushed) beside SDPA on contiguous tensors and its plain version,
    with its bound (bytes at 3.35 TB/s, or the products at the bf16
    tensor-core or float32 rate)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rows = []
    for n, (what, (b, s, h, kv, d), causal, dt) in enumerate(
            FLASH_ZOO_CASES):
        dtype = getattr(torch, dt)
        tol = FLASH_TOL["bf16" if dtype == torch.bfloat16 else "f32"]
        q, k, v = flash_views(dev, b, s, h, kv, d, dtype, 40 + n)
        label = (f"{dt} {'causal' if causal else 'non-causal'} at {what} "
                 f"{(b, s, h, kv, d)}")
        err = flash_agrees(q, k, v, 0, tol, label, causal=causal)
        ms = event_ms(lambda: flash_attention_kernel(q, k, v,
                                                     causal=causal))
        plain = event_ms(lambda: attention_ref(q, k, v, causal=causal),
                         iters=5)
        qc, kc, vc = (a.contiguous() for a in (q, k, v))
        lib = event_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, is_causal=causal, enable_gqa=True))
        size = q.element_size()
        nbytes = size * (2 * b * h * s * d + 2 * b * kv * s * d)
        pairs = s * (s + 1) // 2 if causal else s * s
        ops = 4 * b * h * d * pairs
        bnd, by = lm_bound_ms(nbytes, ops, BF16_OPS_PER_S
                              if dtype == torch.bfloat16
                              else FP32_OPS_PER_S)
        print(f"  flash_attention {label}: kernel {ms * 1e3:.2f} us, SDPA "
              f"{lib * 1e3:.2f} us ({lib / ms:.3f}x the kernel's speed), "
              f"plain {plain * 1e3:.2f} us, bound {bnd * 1e3:.3f} us ({by}; "
              f"{bnd / ms:.3f} of it), {ops / ms / 1e9:.1f} TFLOP/s")
        rows.append(dict(case=what, shape=[b, s, h, kv, d], causal=causal,
                         dtype=dt, max_abs_err=err, ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=bnd, bound_by=by))
    print(f"  flash_attention zoo timed; SM clock, power: {sm_clock()}")
    return rows


@contextlib.contextmanager
def recorded_kernels():
    """For the block's duration every B4 launch also appends
    ("flash_attention", causal, window, dtype, (B, S, H, KV, D)) to the
    yielded list, and every B6 launch ("moe_router", dtype, (T, E, k))."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.moe_router import kernel as mr
    calls = []
    flash, router = fa.flash_attention_kernel, mr.moe_router_kernel

    def flash_rec(q, k, v, causal=True, window=0, sm_scale=0.0):
        b, h, s, d = q.shape
        calls.append(("flash_attention", bool(causal), int(window),
                      str(q.dtype)[6:], (b, s, h, k.shape[1], d)))
        return flash(q, k, v, causal=causal, window=window,
                     sm_scale=sm_scale)

    def router_rec(logits, top_k):
        calls.append(("moe_router", str(logits.dtype)[6:],
                      (*logits.shape, top_k)))
        return router(logits, top_k)

    fa.flash_attention_kernel, mr.moe_router_kernel = flash_rec, router_rec
    try:
        yield calls
    finally:
        fa.flash_attention_kernel, mr.moe_router_kernel = flash, router


# the launches phases 21 and 12 hold against the plain version, as
# recorded_kernels notes them
CHECKED_LAUNCHES = (
    {("flash_attention", causal, 0, dt, shape)
     for _, shape, causal, dt in FLASH_ZOO_CASES}
    | {("moe_router", dt, (t, e, k)) for t, e, k, _, dt in ROUTER_CASES})


def launches_checked(launches, arch) -> list:
    """Pops the measured run's B4 and B6 records from ``launches``; fails
    if one ran at a case that no phase held against its plain version."""
    records = launches.pop("records")
    kinds = sorted(set(records), key=str)
    unchecked = [r for r in kinds if r not in CHECKED_LAUNCHES]
    if unchecked:
        fail(f"{arch}: launched at cases no phase checked: {unchecked}")
    print(f"  {arch}: {len(records)} B4/B6 launches at {len(kinds)} "
          f"cases, each checked in phase 21 or 12: {kinds}")
    return records


@contextlib.contextmanager
def recorded_chunk_decays():
    """For the block's duration each call of the inclusive chunked
    recurrence also appends its largest chunk decay -sum(log_w) over a
    chunk: the exponent the reference's form (exp(-cumsum log_w), its
    ``layers.py:245``) would scale k by."""
    from repro_torch.models import layers
    out = []
    real = layers._inclusive_chunked

    def recording(r, k, v, log_w, chunk, init_state=None):
        t = log_w.shape[2] // chunk * chunk
        out.append(-log_w[:, :, :t].unflatten(2, (-1, chunk)).sum(3).min())
        return real(r, k, v, log_w, chunk, init_state)

    layers._inclusive_chunked = recording
    try:
        yield out
    finally:
        layers._inclusive_chunked = real


def free_memory() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _finite_or_fail(res, arch) -> None:
    import torch
    for name in ("prefill_logits", "logits", "step_logits"):
        if not torch.isfinite(getattr(res, name)).all():
            fail(f"{arch}: non-finite {name}")


def zamba2_full_width(dev, profile: bool = False) -> dict:
    """Phase 22: zamba2-1.2b at full width and depth (38 Mamba2 layers, 7
    shared-attention sites), bf16, through ``launch.serve.run``: batch 8,
    a ZAMBA2_PROMPT-token prompt (chunks of 128), 32 greedy tokens, B4
    launched 7 times in the prefill, the rebuild's seconds. The prompt's
    chunk decays are read in one more prefill: they must pass the float32
    edge where the reference's form is inf (R12) while the port's logits
    stay finite. Then the prefill against token-by-token steps in
    float32 within STEP_TOL."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    free_memory()
    cfg, params, res, launches, mem = serve_full_width(
        dev, get_config("zamba2-1.2b"), prompt_len=ZAMBA2_PROMPT,
        recorder=recorded_kernels)
    launches_checked(launches, "zamba2-1.2b")
    if launches["flash_attention"] != 7:
        fail(f"zamba2: flash_attention launched "
             f"{launches['flash_attention']} times in the prefill, not 7")
    _finite_or_fail(res, "zamba2-1.2b")
    gen = torch.Generator(device=dev).manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (8, ZAMBA2_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)
    with recorded_chunk_decays() as decays:
        logits, _ = R.prefill(params, cfg, {"tokens": prompt},
                              R.init_serve_state(cfg, 8, ZAMBA2_PROMPT,
                                                 device=dev))
    peak = max(float(x) for x in decays)
    print(f"  zamba2 prefill: largest chunk decay over {len(decays)} layers "
          f"exp({peak:.1f}) (the reference's form is inf past "
          f"exp({EXP_F32_MAX})); logits finite: "
          f"{bool(torch.isfinite(logits).all())}")
    if peak <= EXP_F32_MAX:
        fail(f"zamba2: no chunk of the prompt passes the reference's "
             f"overflow edge (exp({peak:.1f}))")
    a, b = res.prefill_logits[:, -1].float(), res.logits[:, -1].float()
    gap = (a - b).abs().max().item()
    print(f"  zamba2 bf16: prefill (chunked) against rebuild (steps) last "
          f"logits: max abs gap {gap:.4f} on values up to "
          f"{b.abs().max().item():.2f}; argmax agrees on "
          f"{int((a.argmax(-1) == b.argmax(-1)).sum())} of 8 (not gated: "
          f"the float32 check below is); rebuild of {ZAMBA2_PROMPT} tokens "
          f"{res.rebuild_s:.2f} s")
    row = _serve_row(cfg, res, mem, ZAMBA2_PROMPT)
    row.update(launches=launches, chunk_decay_max=peak,
               prefill_vs_rebuild_bf16=gap, rebuild_s=res.rebuild_s)
    if profile:
        profile_serve(dev, cfg, params)
    del params
    free_memory()
    row["prefill_vs_steps"] = prefill_vs_steps(
        dev, "zamba2-1.2b", "float32", 2, ZAMBA2_F32_PROMPT,
        STEP_TOL["zamba2-1.2b"])
    return row


def seamless_full_width(dev, profile: bool = False) -> dict:
    """Phase 23: seamless-m4t-large-v2 at full width and depth (24 encoder
    and 24 decoder layers), bf16: 8 x 1024 frames (drawn by the launcher
    from the seed), SEAMLESS_PROMPT-token prompts, 32 greedy tokens. The
    frames are encoded once, so the prefill launches B4 24 times
    non-causal (the encoder) and 24 times causal (the decoder's
    self-attention); decode attends in plain torch. R13: decoding starts
    at position 0, as in the reference."""
    from repro_torch.configs import get_config
    free_memory()
    cfg = get_config("seamless-m4t-large-v2")
    cfg, params, res, launches, mem = serve_full_width(
        dev, cfg, prompt_len=SEAMLESS_PROMPT, recorder=recorded_kernels)
    calls = launches_checked(launches, "seamless-m4t-large-v2")
    nc = sum(1 for r in calls if r[0] == "flash_attention" and not r[1])
    ca = sum(1 for r in calls if r[0] == "flash_attention" and r[1])
    print(f"  seamless prefill: flash_attention {nc} non-causal, {ca} "
          f"causal")
    if (nc, ca) != (cfg.encoder_layers, cfg.num_layers) or \
            launches["flash_attention"] != nc + ca:
        fail(f"seamless: flash_attention {nc} non-causal and {ca} causal "
             f"({launches['flash_attention']} counted), not "
             f"{cfg.encoder_layers} and {cfg.num_layers}")
    _finite_or_fail(res, "seamless-m4t-large-v2")
    row = _serve_row(cfg, res, mem, SEAMLESS_PROMPT)
    row.update(frames=cfg.num_frames, launches=launches,
               non_causal=nc, causal=ca)
    if profile:
        profile_serve(dev, cfg, params)
    del params
    return row


def paligemma_full_width(dev, profile: bool = False) -> dict:
    """Phase 24: paligemma-3b at full width and depth, bf16: 8 x (256
    patches + 512 tokens), 32 greedy tokens. The prefix-LM mask at head
    dim 256 is not B4's function: the prompt attends in plain torch, so
    B4 must not launch."""
    from repro_torch.configs import get_config
    free_memory()
    cfg, params, res, launches, mem = serve_full_width(
        dev, get_config("paligemma-3b"), recorder=recorded_kernels)
    launches_checked(launches, "paligemma-3b")
    if launches["flash_attention"]:
        fail(f"paligemma: flash_attention launched "
             f"{launches['flash_attention']} times")
    _finite_or_fail(res, "paligemma-3b")
    row = _serve_row(cfg, res, mem)
    row.update(patches=cfg.num_patches, launches=launches)
    if profile:
        profile_serve(dev, cfg, params)
    del params
    return row


def dense_zoo_full_width(dev, profile: bool = False) -> dict:
    """Phase 25: granite-8b, qwen2.5-14b and granite-20b at full width and
    depth, bf16, each freed before the next (granite-20b's 52 layers hold
    ~56 GB, so it runs last): B4 launched once a layer in each prefill;
    granite-20b's prefill against its decode steps within STEP_TOL."""
    from repro_torch.configs import get_config
    out = {}
    for arch in ("granite-8b", "qwen2.5-14b", "granite-20b"):
        free_memory()
        cfg, params, res, launches, mem = serve_full_width(
            dev, get_config(arch), recorder=recorded_kernels)
        launches_checked(launches, arch)
        if launches["flash_attention"] != cfg.num_layers:
            fail(f"{arch}: flash_attention launched "
                 f"{launches['flash_attention']} times in a prefill of "
                 f"{cfg.num_layers} layers")
        _finite_or_fail(res, arch)
        out[arch] = _serve_row(cfg, res, mem)
        if profile:
            profile_serve(dev, cfg, params)
        if arch == "granite-20b":
            out[arch]["prefill_vs_steps"] = prefill_vs_steps(
                dev, arch, "bfloat16", 2, 64, STEP_TOL[arch],
                params=params)
        del params
    free_memory()
    return out


def kimi_full_width(dev, profile: bool = False) -> dict:
    """Phase 26: kimi-k2 at full width, KIMI_LAYERS of its 61 layers, bf16,
    through ``launch.serve.run`` (batch 8, 512-token prompts, 32 greedy
    tokens): B6 at (4096, 384, 8) in the prefill and (8, 384, 8) a step,
    32 launches; B4 once. Two more prefills of one prompt must be bitwise
    equal (the pinned k = 8 combine on the card); the assignments dropped
    past capacity and peak memory are printed."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    free_memory()
    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b"),
                              num_layers=KIMI_LAYERS)
    cfg, params, res, launches, mem = serve_full_width(
        dev, cfg, recorder=recorded_kernels)
    launches_checked(launches, "kimi-k2")
    want = cfg.num_layers * 32
    if launches["moe_router"] != want or \
            launches["flash_attention"] != cfg.num_layers:
        fail(f"kimi: moe_router {launches['moe_router']} (want {want}), "
             f"flash_attention {launches['flash_attention']} (want "
             f"{cfg.num_layers})")
    _finite_or_fail(res, "kimi-k2")
    gen = torch.Generator(device=dev).manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen,
                           device=dev, dtype=torch.int32)
    twice = [R.prefill(params, cfg, {"tokens": prompt},
                       R.init_serve_state(cfg, 8, 512, device=dev))[0]
             for _ in range(2)]
    same = torch.equal(twice[0].view(torch.int16), twice[1].view(torch.int16))
    print(f"  kimi prefill twice: bitwise equal {same}")
    if not same:
        fail("kimi: two prefills of one prompt differ (the k = 8 combine)")
    row = _serve_row(cfg, res, mem)
    row.update(launches=launches, dropped=prefill_drops(dev, cfg, params),
               prefills_bitwise=same)
    if profile:
        profile_serve(dev, cfg, params)
    del params, twice
    free_memory()
    return row


# -- phase 27: LM-scale HFL training ----------------------------------------

# the backward kernels against autograd through their plain float32
# versions, the error over each gradient's largest reference value:
# float32 inputs, float32 sums in another order; bf16 inputs, each
# gradient rounded once to bf16 (2^-8 of a value) and B4 reading the
# forward's bf16 output for rowsum(dO o O)
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2 ** -7}
# B6's gate gradient: the same picks, float32 products of gates in [0, 1]
ROUTER_GRAD_TOL = 1e-6
# reduced models in float32, loss and gradients, CPU against CUDA, max
# abs gap: two layers' float32 sums in another order, gradients up to
# ~0.5. The ssm's (rwkv6) gradients move with the rounding of the WKV
# scan's output itself: rounding that output once from float64 instead
# of in the plain version's float32 order moves the embedding's gradient
# (largest value 3.34) by 1.34e-3 on the CPU, and the plain versions on
# the card differ from the CPU by 7.2e-4 (tools/train_numerics.py); the
# kernels' route, by 5.41e-3
TRAIN_CPU_TOL = {"ssm": 2e-2}
TRAIN_CPU_TOL_DEFAULT = 1e-4
# full width, bf16: SGD's step lr * g must clear half a bf16 ulp of the
# weights (~0.02: 6e-5) for the update to land, and stay below what the
# random-init models diverge at: on the card at lr 0.1 qwen2-1.5b's loss
# rose after step 2 (12.10, 10.90, 14.15, 19.22) and rwkv6-1.6b's was
# NaN from step 2 (0.03 likewise); at 0.01 both fell every step
# (tools/train_numerics.py)
TRAIN_LR = 0.01
TRAIN_STEPS = 4
FLASH_BWD_CASES = (
    # (B, S, H, KV, D, dtype, causal, window)
    (2, 256, 4, 4, 64, "bfloat16", True, 0),
    (2, 200, 12, 2, 64, "bfloat16", True, 64),
    (2, 256, 8, 1, 64, "bfloat16", False, 0),
    (2, 256, 4, 4, 64, "float32", True, 0),
    (2, 200, 12, 2, 64, "float32", True, 64),
    (2, 192, 8, 1, 128, "float32", False, 0),
    (4, 512, 12, 2, 128, "bfloat16", True, 0),   # qwen2-1.5b's training
)
SCAN_BWD_CASES = (
    # (B, H, T, w0, views, dtype, final-state gradient)
    (4, 32, 512, -2.0, True, "bfloat16", False),  # rwkv6-1.6b's training
    (4, 32, 512, -2.0, True, "float32", True),
    (2, 32, 512, 1.0, True, "bfloat16", True),    # strong decay
    (2, 32, 100, -2.0, True, "bfloat16", False),  # ragged T
    (2, 8, 256, -2.0, False, "float32", True),    # contiguous (B, H, T, 64)
)
LAUNCHER_ARCHS = ("qwen2-1.5b", "rwkv6-1.6b", "mixtral-8x22b")


def grad_margin(got, want, tol, what) -> float:
    """Each gradient's max abs error over its largest reference value,
    against ``tol``; the max abs error."""
    import torch
    worst_rel, worst_abs = 0.0, 0.0
    for name, g, w in zip(what[1], got, want):
        if not torch.isfinite(g).all():
            fail(f"{what[0]}: non-finite d{name}")
        err = (g.float() - w).abs().max().item()
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / max(w.abs().max().item(), 1e-12))
    print(f"  {what[0]}: max abs err {worst_abs:.3e}, max err over the "
          f"gradient's largest value {worst_rel:.3e} (tol {tol:.3e}, "
          f"margin {tol / max(worst_rel, 1e-30):.1f}x)")
    if worst_rel > tol:
        fail(f"{what[0]}: gradients differ by {worst_rel} > {tol}")
    return worst_abs


def autograd_grads(fn, inputs, grads_out):
    """Autograd through ``fn`` on float32 copies of ``inputs``, the
    outputs' gradients ``grads_out`` (None: the output takes none)."""
    import torch
    xs = [x.detach().float().requires_grad_(True) for x in inputs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, g.float()) for o, g in zip(outs, grads_out) if g is not None]
    return list(torch.autograd.grad([o for o, _ in pairs],
                                    xs, [g for _, g in pairs]))


def check_flash_attention_bwd(dev):
    """B4's backward on ``FLASH_BWD_CASES`` (the model layout's views, as
    ``ops.FlashAttention`` passes them) against autograd through
    ``attention_ref`` in float32; timed at qwen2-1.5b's training shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_kernel, flash_attention_kernel)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    ptxas_lines("flash_attention_bwd")
    worst = 0.0
    for i, (b, s, h, kv, d, dt, causal, window) in enumerate(
            FLASH_BWD_CASES):
        dtype = getattr(torch, dt)
        q, k, v = flash_views(dev, b, s, h, kv, d, dtype, 30 + i)
        gen = torch.Generator(device=dev).manual_seed(40 + i)
        do = torch.randn((b, s, h, d), generator=gen, device=dev).to(
            dtype).transpose(1, 2)
        o = flash_attention_kernel(q, k, v, causal=causal, window=window)
        got = flash_attention_bwd_kernel(q, k, v, o, do, causal=causal,
                                         window=window)
        want = autograd_grads(
            lambda a, bb, c: attention_ref(a, bb, c, causal=causal,
                                           window=window), (q, k, v), (do,))
        err = grad_margin(got, want, GRAD_TOL[dt], (
            f"flash_attention_bwd {dt} {(b, s, h, kv, d)} causal={causal} "
            f"window={window} (group {h // kv})", "qkv"))
        if dt == "bfloat16":
            worst = max(worst, err)
    # timing at qwen2-1.5b's training shape: q, k, v, o, do as above
    b, s, h, kv, d = FLASH_BWD_CASES[-1][:5]
    call = lambda: flash_attention_bwd_kernel(q, k, v, o, do, causal=True)
    ms, wall = event_ms(call), cuda_ms(call, 20)
    warm = event_ms(call, cold=False)
    print(f"  flash_attention_bwd timed; SM clock, power: {sm_clock()}")
    xs = [a.detach().requires_grad_(True) for a in (q, k, v)]
    out = attention_ref(*xs, causal=True)
    plain = event_ms(lambda: torch.autograd.grad(out, xs, do,
                                                 retain_graph=True), iters=5)
    xc = [a.detach().contiguous().requires_grad_(True) for a in (q, k, v)]
    out_c = F.scaled_dot_product_attention(*xc, is_causal=True,
                                           enable_gqa=True)
    do_c = do.contiguous()
    lib = event_ms(lambda: torch.autograd.grad(out_c, xc, do_c,
                                               retain_graph=True))
    nbytes = 2 * (4 * b * h * s * d + 4 * b * kv * s * d)
    ops = 10 * b * h * d * s * (s + 1) // 2
    bnd, by = lm_bound_ms(nbytes, ops, BF16_OPS_PER_S)
    print(f"  flash_attention_bwd bf16 at {(b, s, h, kv, d)}: kernel "
          f"{ms * 1e3:.2f} us, SDPA backward {lib * 1e3:.2f} us, plain "
          f"{plain * 1e3:.2f} us; {ops / ms / 1e9:.1f} TFLOP/s, "
          f"{bnd / ms:.3f} of the bound {bnd * 1e3:.3f} us ({by})")
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/csrc/flash_attention_bwd.cu",
                replaces="none: not a TPU kernel (XLA autodiff of jnp in "
                         "the reference)",
                max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=lib, shape=[b, s, h, kv, d],
                wall_ms=wall, warm_ms=warm)


def check_rwkv6_scan_bwd(dev):
    """B5's backward on ``SCAN_BWD_CASES`` against autograd through
    ``rwkv6_scan_ref`` in float32; timed at rwkv6-1.6b's training shape
    (the first case)."""
    import torch
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_bwd_kernel
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
    ptxas_lines("rwkv6_scan_bwd")
    worst, timed = 0.0, None
    for i, (b, h, t, w0, views, dt, fin) in enumerate(SCAN_BWD_CASES):
        r, k, v, lw, u = scan_inputs(dev, b, h, t, w0, views, 50 + i, dt)
        gen = torch.Generator(device=dev).manual_seed(60 + i)
        dy = torch.randn((b, t, h, 64), generator=gen,
                         device=dev).transpose(1, 2)
        dfin = (torch.randn((b, h, 64, 64), generator=gen, device=dev)
                if fin else None)
        got = rwkv6_scan_bwd_kernel(r, k, v, lw, u, dy, dfin)
        want = autograd_grads(rwkv6_scan_ref, (r, k, v, lw, u), (dy, dfin))
        err = grad_margin(got, want, GRAD_TOL[dt], (
            f"rwkv6_scan_bwd {dt} {(b, h, t)} w0={w0} "
            f"{'views' if views else 'contiguous'}"
            f"{', final-state gradient' if fin else ''}",
            ("r", "k", "v", "log_w", "u")))
        if dt == "bfloat16":
            worst = max(worst, err)
        if timed is None:
            timed = (r, k, v, lw, u, dy)
    r, k, v, lw, u, dy = timed
    b, h, t = SCAN_BWD_CASES[0][:3]
    call = lambda: rwkv6_scan_bwd_kernel(r, k, v, lw, u, dy)
    ms, wall = event_ms(call), cuda_ms(call, 20)
    warm = event_ms(call, cold=False)
    print(f"  rwkv6_scan_bwd timed; SM clock, power: {sm_clock()}")
    xs = [a.detach().requires_grad_(True) for a in (r, k, v, lw, u)]
    y, _ = rwkv6_scan_ref(*xs)
    # 512 steps of small kernels each way, launch-bound: summed kernel
    # time, as phase 7 times the plain forward
    plain = device_ms(lambda: torch.autograd.grad(y, xs, dy,
                                                  retain_graph=True),
                      iters=2)
    n = b * h * t * 64
    nbytes = 2 * 3 * n + 4 * 2 * n + 2 * 3 * n + 4 * n
    ops = 12 * 64 * 64 * b * h * t
    bnd, by = lm_bound_ms(nbytes, ops, FP32_OPS_PER_S)
    print(f"  rwkv6_scan_bwd bf16 at {(b, h, t, 64, 64)}, model's views: "
          f"kernel {ms * 1e3:.2f} us, plain {plain * 1e3:.2f} us; "
          f"{bnd / ms:.3f} of the bound {bnd * 1e3:.3f} us ({by})")
    return dict(name="rwkv6_scan_bwd", route="cuda",
                source="src/repro_torch/csrc/rwkv6_scan_bwd.cu",
                replaces="none: not a TPU kernel (XLA autodiff of jnp in "
                         "the reference)",
                max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=None, shape=[b, h, t, 64, 64],
                wall_ms=wall, warm_ms=warm)


def check_router_gate_grad(dev) -> float:
    """B6's gates through ``ops.MoERouter`` and their gradient against
    autograd through ``moe_router_ref``: mixtral-reduced's (256, 4, 2)
    and kimi-k2's (2048, 384, 8), each also with logits rounded to halves
    (exact ties in every row)."""
    import torch
    from repro_torch.kernels import common
    from repro_torch.kernels.moe_router.ops import moe_router
    from repro_torch.kernels.moe_router.ref import moe_router_ref
    worst = 0.0
    for t, e, k in ((256, 4, 2), (2048, 384, 8)):
        for ties in (False, True):
            gen = torch.Generator(device=dev).manual_seed(e + ties)
            logits = torch.randn((t, e), generator=gen, device=dev)
            if ties:
                logits = torch.round(logits * 2) / 2
            dg = torch.randn((t, k), generator=gen, device=dev)
            x = logits.clone().requires_grad_(True)
            before = common.LAUNCHES["moe_router"]
            gates, idx = moe_router(x, k)
            gates.backward(dg)
            if common.LAUNCHES["moe_router"] != before + 1:
                fail("MoERouter did not launch moe_router")
            xr = logits.clone().requires_grad_(True)
            wg, wi = moe_router_ref(xr, k)
            wg.backward(dg)
            if not torch.equal(idx, wi):
                fail(f"moe_router picks differ at {(t, e, k)} ties={ties}")
            err = (x.grad - xr.grad).abs().max().item()
            worst = max(worst, err)
            print(f"  moe_router gate gradient {(t, e, k)} ties={ties}: max "
                  f"abs err {err:.3e} (tol {ROUTER_GRAD_TOL}, margin "
                  f"{ROUTER_GRAD_TOL / max(err, 1e-30):.1f}x)")
            if err > ROUTER_GRAD_TOL:
                fail(f"moe_router gate gradient differs by {err}")
    return worst


def train_cpu_vs_cuda(dev) -> dict:
    """Every arch id at ``reduced()`` (float32, TF32 off): the same
    parameters and batch (2 x 64 tokens, weights (1, 0), frames or
    patches for audio and VLM) through ``fed.distributed.value_and_grad``
    on the CPU (plain versions) and on CUDA (the kernels and their
    backward); loss and every gradient leaf within the arch type's
    ``TRAIN_CPU_TOL``."""
    import torch
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.fed.distributed import value_and_grad
    from repro_torch.kernels import common
    from repro_torch.models import registry as R
    out = {}
    shape = InputShape("train", 64, 2, "train")
    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced()
        params = R.init_params(cfg, 0, device="cpu")
        batch = R.make_concrete_batch(cfg, shape, seed=1, device="cpu")
        w = torch.tensor([1.0, 0.0])
        want_l, want_g = value_and_grad(cfg, params, batch, w)
        common.reset_launches()
        got_l, got_g = value_and_grad(
            cfg, to_device(params, dev), to_device(batch, dev), w.to(dev))
        launches = {k: v for k, v in common.LAUNCHES.items() if v}
        gap = abs(float(got_l) - float(want_l))
        gaps = [(got.cpu() - want).abs().max().item()
                for got, want in zip(leaves(got_g), leaves(want_g))]
        tol = TRAIN_CPU_TOL.get(cfg.arch_type, TRAIN_CPU_TOL_DEFAULT)
        print(f"  {arch} reduced: loss {float(want_l):.5f}, gap {gap:.3e}; "
              f"max gradient gap {max(gaps):.3e} over {len(gaps)} leaves "
              f"(tol {tol}); launches {launches}")
        if max([gap] + gaps) > tol:
            fail(f"{arch}: CPU and CUDA training gradients differ by "
                 f"{max([gap] + gaps)}")
        want_k = {"ssm": "rwkv6_scan_bwd"}.get(cfg.arch_type,
                                               "flash_attention_bwd")
        if cfg.arch_type != "vlm" and not launches.get(want_k):
            fail(f"{arch}: {want_k} did not launch in the training step")
        out[arch] = dict(loss_gap=gap, grad_gap=max(gaps))
    return out


def launcher_runs(dev) -> dict:
    """``launch.train.main(["--arch", id, ...])`` on CUDA, 3 rounds of 8
    clients, batch 2 x 64, for ``LAUNCHER_ARCHS``: the printed round-1
    loss finite, B2 once a round, the arch's forward and backward kernels
    launched, no walk host sync."""
    import contextlib
    import io
    import re
    from repro_torch.kernels import common
    from repro_torch.kernels.budgeted_topk.ref import WALK_SYNCS
    from repro_torch.launch.train import main as train_main
    out = {}
    for arch in LAUNCHER_ARCHS:
        buf = io.StringIO()
        syncs = dict(WALK_SYNCS)
        common.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = train_main(["--arch", arch, "--rounds", "3", "--clients",
                             "8", "--seq-len", "64", "--batch", "2"])
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in common.LAUNCHES.items() if v}
        walk = sum(WALK_SYNCS[k] - syncs[k] for k in WALK_SYNCS)
        losses = [float(m) for m in re.findall(r"mean_loss (\S+)",
                                               buf.getvalue())]
        print(f"  launch.train --arch {arch}: {buf.getvalue().strip()}; "
              f"launches {launches}, walk host syncs {walk}, {wall:.2f} s")
        if rc != 0 or not losses or not all(math.isfinite(x)
                                            for x in losses):
            fail(f"launch.train --arch {arch}: rc {rc}, losses {losses}")
        b2 = launches.get("budgeted_topk")
        if b2 != 3 or walk:
            fail(f"launch.train --arch {arch}: B2 {b2} launches in 3 "
                 f"rounds, {walk} walk host syncs")
        need = {"qwen2-1.5b": ("flash_attention", "flash_attention_bwd"),
                "rwkv6-1.6b": ("rwkv6_scan", "rwkv6_scan_bwd"),
                "mixtral-8x22b": ("flash_attention", "flash_attention_bwd",
                                  "moe_router")}[arch]
        for name in need:
            if not launches.get(name):
                fail(f"launch.train --arch {arch}: {name} not launched")
        out[arch] = dict(losses=losses, launches=launches, wall_s=wall)
    return out


def fixed_batch(cfg, dev, batch: int = 4, seq: int = 512, seed: int = 0):
    """One Zipf token batch as the training loop draws them
    (``data.tokens``), on the card."""
    import numpy as np
    import torch
    from repro_torch.data.tokens import TokenStream
    b = TokenStream(cfg.vocab_size, seq, batch, seed=seed).sample(
        np.random.default_rng(seed))
    return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}


def train_full_width(dev, arch: str, kernels) -> dict:
    """``TRAIN_STEPS`` steps of ``make_train_step`` (lr ``TRAIN_LR``) at
    full width and depth in bf16 (random weights from seed 0) on one
    fixed 4 x 512 batch: each step's launches of ``kernels`` equal to the
    layer count, finite losses, the last below the first; ms a step
    (host clock around a synchronised step) and peak GB."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.fed.distributed import make_train_step
    from repro_torch.kernels import common
    from repro_torch.models import registry as R
    cfg = get_config(arch)
    params = R.init_params(cfg, 0, device=dev)
    batch = fixed_batch(cfg, dev)
    w = torch.ones(4, device=dev)
    step = make_train_step(cfg, lr=TRAIN_LR)
    losses, ms, total = [], [], {k: 0 for k in kernels}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p = params
    for i in range(TRAIN_STEPS):
        common.reset_launches()
        t0 = time.perf_counter()
        p, loss = step(p, batch, w)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        for k in kernels:
            if common.LAUNCHES[k] != cfg.num_layers:
                fail(f"{arch} step {i + 1}: {k} launched "
                     f"{common.LAUNCHES[k]} times, not {cfg.num_layers}")
            total[k] += common.LAUNCHES[k]
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated() / 1e9
    each = ", ".join(f"{k} {v // TRAIN_STEPS} a step"
                     for k, v in total.items())
    print(f"  {arch} full width bf16, {TRAIN_STEPS} steps on one 4 x 512 "
          f"batch, lr {TRAIN_LR}: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; ms a step "
          f"{', '.join(f'{x:.1f}' for x in ms)}; peak {peak:.2f} GB; "
          f"{each}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"{arch}: the loss did not fall over {TRAIN_STEPS} steps "
             f"({losses})")
    return dict(params=params, cfg=cfg, losses=losses, ms=ms, peak_gb=peak,
                launches=total)


def hfl_round_full_width(dev, cfg, params) -> dict:
    """``make_hfl_round`` at full width: 2 edges (each 2 x 512 of its own
    batch), ``t_es`` 2, 2 rounds: the edges differ after round 1 and are
    bitwise equal after round 2 (the sync); ms a round, peak GB."""
    import torch
    from repro_torch.fed.distributed import make_hfl_round, stack_edge_params
    from repro_torch.kernels import common
    rnd = make_hfl_round(cfg, n_edge=2, t_es=2, lr=TRAIN_LR)
    ep = stack_edge_params(params, 2)
    batch = {k: v.reshape(2, 2, -1) for k, v in fixed_batch(cfg, dev, seed=1)
             .items()}
    w = torch.ones((2, 2), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for step in (0, 1):
        common.reset_launches()
        t0 = time.perf_counter()
        ep, loss = rnd(ep, batch, w, step)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        equal = all(torch.equal(a[0], a[1]) for a in leaves(ep))
        if equal != (step == 1):
            fail(f"make_hfl_round: edges {'equal' if equal else 'differ'} "
                 f"after round {step + 1}")
        if common.LAUNCHES["flash_attention_bwd"] != 2 * cfg.num_layers:
            fail(f"make_hfl_round: {common.LAUNCHES['flash_attention_bwd']} "
                 f"flash_attention_bwd launches in a round of 2 edges")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"  make_hfl_round {cfg.name} full width, 2 edges, t_es 2: "
          f"losses {losses[0]:.4f}, {losses[1]:.4f}; edges differ after "
          f"round 1, equal after the sync round 2; ms a round "
          f"{ms[0]:.1f}, {ms[1]:.1f}; peak {peak:.2f} GB")
    return dict(losses=losses, ms=ms, peak_gb=peak)


def training_phase(dev):
    """Phase 27; returns (the two backward kernels' rows, the launches of
    each on its full-width run, the JSON record)."""
    rows = [check_flash_attention_bwd(dev), check_rwkv6_scan_bwd(dev)]
    for r in rows:
        print_row(r)
    rec = {"router_grad_err": check_router_gate_grad(dev)}
    rec["cpu_vs_cuda"] = train_cpu_vs_cuda(dev)
    rec["launcher"] = launcher_runs(dev)
    q = train_full_width(dev, "qwen2-1.5b",
                         ("flash_attention", "flash_attention_bwd"))
    rec["hfl_round"] = hfl_round_full_width(dev, q.pop("cfg"),
                                            q.pop("params"))
    free_memory()
    r = train_full_width(dev, "rwkv6-1.6b", ("rwkv6_scan", "rwkv6_scan_bwd"))
    r.pop("cfg")
    r.pop("params")
    free_memory()
    rec["qwen2-1.5b"], rec["rwkv6-1.6b"] = q, r
    launches = {"flash_attention_bwd": q["launches"]["flash_attention_bwd"],
                "rwkv6_scan_bwd": r["launches"]["rwkv6_scan_bwd"]}
    return rows, launches, rec


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def print_row(r) -> None:
    lib = ("-" if r["library_ms"] is None
           else f"{r['library_ms'] * 1e3:.2f} us")
    print(f"  {r['name']}: kernel {r['ms'] * 1e3:.2f} us (device, L2 "
          f"flushed; {r['warm_ms'] * 1e3:.2f} us warm; "
          f"{r['wall_ms'] * 1e3:.2f} us a call from Python), plain "
          f"{r['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
          f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}) at "
          f"{r['shape']}")


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
    rows = [check_context_pairwise(dev, spec), check_budgeted_topk(dev),
            check_flgreedy_walk(dev), check_random_assign(dev)]
    b3_worst = check_masked_aggregate(dev)
    floor = launch_floor_ms()
    print(f"  launch_floor_us {floor * 1e3:.2f} (torch.cuda._sleep(0), "
          f"timed as the kernels are)")
    print(f"  device times taken with {TIMED_WITH}")
    for r in rows:
        print_row(r)

    print("phase 4: main path (metropolis-1k, cuda, cocs/oracle/random)")
    launches, rps, counts, d = main_path(dev, profile)
    rows.append(masked_aggregate_main(dev, counts, d, b3_worst))

    print("phase 5: port on CPU against port on CUDA (paper, flash-crowd; "
          "cocs/oracle/random)")
    hfl_cpu_vs_cuda = cpu_vs_cuda(dev)

    print("phase 6: flash_attention against its plain version")
    rows.append(check_flash_attention(dev))
    print("phase 7: rwkv6_scan against its plain version")
    rows.append(check_rwkv6_scan(dev))
    for r in rows[-2:]:
        print_row(r)

    print("phase 8: qwen2-1.5b serve at full width (launch.serve.run)")
    from repro_torch.configs import get_config
    qcfg, qparams, qres, qlaunch, qmem = serve_full_width(
        dev, get_config("qwen2-1.5b"))
    if qlaunch["flash_attention"] != qcfg.num_layers:
        fail(f"flash_attention launched {qlaunch['flash_attention']} times "
             f"in one qwen2 prefill of {qcfg.num_layers} layers")
    serve_rows = {"qwen2-1.5b": _serve_row(qcfg, qres, qmem)}
    if profile:
        profile_serve(dev, qcfg, qparams)

    serve_rows["qwen2-1.5b"]["prefill_vs_steps"] = prefill_vs_steps(
        dev, "qwen2-1.5b", "bfloat16", 2, 64, STEP_TOL["qwen2-1.5b"])

    print("phase 9: ServingEngine on qwen2-1.5b at full width")
    serve_rows["engine"] = engine_full_width(dev, qcfg, qparams)
    del qparams

    print("phase 10: rwkv6-1.6b serve at full width (launch.serve.run)")
    rcfg, rparams, rres, rlaunch, rmem = serve_full_width(
        dev, get_config("rwkv6-1.6b"))
    if rlaunch["rwkv6_scan"] != rcfg.num_layers:
        fail(f"rwkv6_scan launched {rlaunch['rwkv6_scan']} times in one "
             f"rwkv6 prefill of {rcfg.num_layers} layers")
    serve_rows["rwkv6-1.6b"] = _serve_row(rcfg, rres, rmem)
    serve_rows["rwkv6-1.6b"]["prefill_vs_rebuild_bf16"] = \
        rwkv6_prefill_vs_rebuild(rres)
    if profile:
        profile_serve(dev, rcfg, rparams)
    del rparams
    if profile:
        depth_sweep(dev)
    serve_rows["rwkv6-1.6b"]["prefill_vs_steps"] = prefill_vs_steps(
        dev, "rwkv6-1.6b", "float32", 2, 512, STEP_TOL["rwkv6-1.6b"])

    print("phase 11: serve slice on CPU against CUDA (reduced, float32)")
    serve_rows["cpu_vs_cuda"] = lm_cpu_vs_cuda(dev)

    print("phase 12: moe_router against its plain version")
    rows.append(check_moe_router(dev))
    print_row(rows[-1])

    print(f"phase 13: mixtral-8x22b serve at full width, {MIXTRAL_LAYERS} "
          f"layers (launch.serve.run)")
    serve_rows["mixtral-8x22b"], mlaunch = mixtral_full_width(dev, profile)

    print("phase 14: non-convex path (paper, CIFAR10_NONCONVEX, CNN 32x32x3, "
          "P3; cocs/oracle/random)")
    nonconvex = nonconvex_path(dev, b3_worst, profile)

    print("phase 15: bandit tier (repro_torch.run, tier 1, metropolis-1k, "
          "cocs/oracle/random)")
    bandit = bandit_tier(dev, profile)

    print("phase 16: the paper's panels as written (repro_torch.run, host "
          "env: paper-fig3, paper-fig4-quick)")
    panels = paper_panels(dev)

    print("phase 17: faults and robust Eq. 3 (repro_torch.run, tier 4, "
          "metropolis-1k)")
    faults = faults_phase(dev)

    print("phase 18: resilience and observability (repro_torch.run, tiers 3 "
          "and 4: checkpoints and resume, health, taps, tracer)")
    resilience = resilience_phase(dev)

    print("phase 19: the trial bench (repro_torch.trials.run_suite: "
          "paper-fig3, paper-fig4-quick, robustness-panel, their @smoke on "
          "the CPU against CUDA, resume, a metropolis-1k suite, the CLIs)")
    trials = trials_phase(dev)

    print("phase 20: the sharded cohort (B2's tile grid and the segment "
          "walk at metropolis-100k and -1m, metropolis-100k dense and on "
          "4x1 and 2x2 ranks, metropolis-1m dense)")
    mesh_rows, mesh, mesh_launch = mesh_phase(dev)
    rows += mesh_rows
    for r in mesh_rows:
        print_row(r)

    t_zoo = time.perf_counter()
    print("phase 21: flash_attention at the new models' shapes (the seamless "
          "encoder non-causal, granite-20b's MQA, qwen2.5-14b's group of 5, "
          "zamba2's)")
    serve_rows["flash_zoo"] = flash_zoo(dev)
    print(f"phase 22: zamba2-1.2b serve at full width (launch.serve.run, "
          f"{ZAMBA2_PROMPT}-token prompts)")
    serve_rows["zamba2-1.2b"] = zamba2_full_width(dev, profile)
    print("phase 23: seamless-m4t-large-v2 serve at full width "
          "(launch.serve.run, 8 x 1024 frames)")
    serve_rows["seamless-m4t-large-v2"] = seamless_full_width(dev, profile)
    print("phase 24: paligemma-3b serve at full width (launch.serve.run, 256 "
          "patches + 512 tokens)")
    serve_rows["paligemma-3b"] = paligemma_full_width(dev, profile)
    print("phase 25: granite-8b, qwen2.5-14b, granite-20b serve at full "
          "width (launch.serve.run)")
    serve_rows.update(dense_zoo_full_width(dev, profile))
    print(f"phase 26: kimi-k2 serve at full width, {KIMI_LAYERS} of 61 "
          f"layers (launch.serve.run)")
    serve_rows["kimi-k2-1t-a32b"] = kimi_full_width(dev, profile)
    serve_rows["zoo_phases_s"] = time.perf_counter() - t_zoo
    print(f"  phases 21-26 in {serve_rows['zoo_phases_s']:.1f} s")

    t_train = time.perf_counter()
    print("phase 27: LM-scale HFL training (B4 and B5 backward kernels, B6's "
          "gate gradient, reduced CPU against CUDA, launch.train --arch, "
          "qwen2-1.5b and rwkv6-1.6b at full width)")
    train_rows, train_launch, training = training_phase(dev)
    rows += train_rows
    training["phase_s"] = time.perf_counter() - t_train
    print(f"  phase 27 in {training['phase_s']:.1f} s")

    # each kernel's launches on its own main path: B1-B3 and Random's
    # scan the HFL runs of phase 4 (three policies), P3's walk the gated
    # non-convex run, B4 the qwen2 serve (the shape its row is timed at;
    # 8 more in mixtral's), B5 the rwkv6 serve, B6 the mixtral serve, the
    # backward kernels the full-width training steps of phase 27
    counts = {**{k: launches[k] for k in ("context_pairwise",
                                          "budgeted_topk",
                                          "masked_aggregate",
                                          "random_assign")},
              "flgreedy_walk":
                  nonconvex["gated"]["launches"]["flgreedy_walk"],
              "flash_attention": qlaunch["flash_attention"],
              "rwkv6_scan": rlaunch["rwkv6_scan"],
              "moe_router": mlaunch["moe_router"],
              "density_sort_tiles": mesh_launch["density_sort_tiles"],
              "segment_walk": mesh_launch["segment_walk"],
              **train_launch}
    for k, v in counts.items():
        if v <= 0:
            fail(f"{k} was launched no time on its main path")
    print("kernels: " + " ".join(f"{k}={v}" for k, v in counts.items()))
    for r in rows:
        r["launches"] = counts[r["name"]]
        r.pop("shape")
        r.pop("wall_ms")
        r.pop("warm_ms")
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - START:.1f} s")
    print(card)
    for r in nonconvex.values():
        r.pop("launches", None)
    print(json.dumps({"kernels": rows, "launch_floor_us": floor * 1e3,
                      "device_times_taken_with": TIMED_WITH,
                      "rounds_per_s": rps, "hfl_cpu_vs_cuda":
                      hfl_cpu_vs_cuda, "nonconvex": nonconvex,
                      "bandit": bandit, "panels": panels,
                      "faults": faults, "resilience": resilience,
                      "trials": trials, "mesh": mesh,
                      "serve": serve_rows, "training": training}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
