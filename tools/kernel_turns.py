"""B1 (context_pairwise), B3 (masked_aggregate) and B6 (moe_router)
device and call times of one or more checkouts, in turns on one card:
the way to compare the kernels with their parent's. On the GPU:

    python3 tools/kernel_turns.py [ROOT ...]     # turns, e.g. P . . P
    python3 tools/kernel_turns.py --variants [SOURCE ...]  # this tree

Turns: each ROOT is the root of a checkout (default: this one); give the
parent and the change in turns (parent, change, change, parent). For
each ROOT, in the order given, a fresh process imports ``ROOT/src``'s
``repro_torch`` (its kernels built into this checkout's
``build/kernel_turns``, keyed on their sources, so nothing is written
into ROOT; the first process of a ROOT prints their ptxas registers and
spills) and, with this checkout's ``chip_smoke`` helpers (``device_ms``:
summed kernel time under torch.profiler, median of three traces, the L2
flushed before each call unless warm; a call: wall per call from
Python, ``cuda_ms`` over 200 calls, the median of five such loops):

* holds B1 against its plain version at ``chip_smoke``'s four phase-3
  cases and prints each field's max abs error a case;
* times B1 at the main path's (2, 1000, 12): cold, warm, a call of the
  kernel wrapper and one through ``ops.pairwise_context``;
* holds B3 bitwise at (24 rows, 24-27 slots, D = 7850) and times it cold
  at each slot count, warm and a call at 27;
* holds B6 against its plain version on phase 12's ``ROUTER_CASES`` as
  phase 12 does, and lists the cases it fails (``b6_failed``: a ROOT
  other than this checkout is reported, not stopped; this checkout must
  pass them all); times B6 at the mixtral prefill's (4096, 8, 2) and a
  decode step's (8, 8, 2), float32: cold, warm, a call of the kernel
  wrapper and one through ``ops.moe_router``;
* times the launch floor, ``torch.cuda._sleep(0)``.

Each process prints one JSON line of microseconds after its root.

Variants: one process of this checkout builds copies of a kernel's
source with one text change each and times them beside the source as it
is, in two rounds (the order reversed in the second); with no SOURCE,
both of:

* ``context_pairwise``, B1 cold and warm at (2, 1000, 12), each held
  bitwise: ``pow`` (10^x by the double pow alone, as the first kernel
  had it), ``exp10f`` (10^x by the float exp10f: not exact, what
  removing the double-precision work altogether would save), and
  ``threads=32``, ``64``, ``128``, ``512``, ``1024`` (other block
  sizes);
* ``moe_router``, B6 cold and warm at (4096, 8, 2) and (8, 8, 2), each
  held against its plain version on the prefill's rows, on non-finite
  rows and on rows with probabilities below 2^-117: ``threads=32``,
  ``64``, ``128``, ``256`` (the block size of the thread-a-row path, E
  <= 32), ``warp-a-row`` (E <= 32 sent to the warp-a-row path instead,
  the first kernel's layout) and ``rcp`` (the thread-a-row path's E
  IEEE divisions by the sum as products with its float reciprocal: not
  exact, what the divisions cost).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

PRELUDE = r'''
import importlib.util, json, sys
root, here = sys.argv[1], sys.argv[2]
sys.path.insert(0, root + "/src")
import repro_torch  # noqa: F401  (ROOT's package, before chip_smoke's path)
import torch
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              here + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from repro_torch.kernels import _build
from repro_torch.kernels.context_pairwise import kernel as b1
from repro_torch.kernels.context_pairwise.ops import pairwise_context
from repro_torch.sim import spec as simspec
dev = torch.device("cuda", 0)
env = simspec.make("metropolis-1k").spec
kw = cs.context_pairwise_kw(env)
args = cs.context_pairwise_inputs(dev, *cs.CONTEXT_CASES[0])
us = lambda ms: round(ms * 1e3, 3)
'''

TURN = PRELUDE + r'''
from repro_torch.kernels.masked_aggregate.kernel import \
    masked_aggregate_kernel
from repro_torch.kernels.masked_aggregate.ref import masked_aggregate_ref
from repro_torch.kernels.moe_router.kernel import moe_router_kernel
from repro_torch.kernels.moe_router.ops import moe_router
_build.build_all()
for name in ("context_pairwise", "masked_aggregate", "moe_router"):
    cs.ptxas_lines(name)
call_us = lambda f: us(sorted(cs.cuda_ms(f, 200) for _ in range(5))[2])
out = {}
for case in cs.CONTEXT_CASES:
    _, _, errs = cs.context_pairwise_errors(dev, env, case)
    out["b1_err_%d_%d_%d" % case[:3]] = errs
call = lambda: b1.context_pairwise_kernel(*args, **kw)
out["b1"] = us(cs.device_ms(call))
out["b1_warm"] = us(cs.device_ms(call, cold=False))
out["b1_call"] = call_us(call)
out["b1_call_ops"] = call_us(lambda: pairwise_context(*args, **kw))
for s in (24, 25, 26, 27):
    p, dl, w = cs.masked_aggregate_inputs(dev, 24, s, 7850, 10 + s)
    if not torch.equal(masked_aggregate_kernel(p, dl, w),
                       masked_aggregate_ref(p, dl, w)):
        sys.exit(f"masked_aggregate not bitwise at {s} slots")
    call = lambda: masked_aggregate_kernel(p, dl, w)
    out[f"b3_{s}"] = us(cs.device_ms(call))
out["b3_mean"] = round(sum(out[f"b3_{s}"] for s in (24, 25, 26, 27)) / 4, 3)
out["b3_27_warm"] = us(cs.device_ms(call, cold=False))
out["b3_27_call"] = call_us(call)
out["b6_failed"] = []
for n, (t, e, k, kind, dtype) in enumerate(cs.ROUTER_CASES):
    x = cs.router_inputs(dev, t, e, kind, getattr(torch, dtype), 20 + n)
    try:
        cs.router_agrees(x, k, (t, e, k, kind, dtype))
    except SystemExit as exc:
        out["b6_failed"].append(str(exc).split("FAILED: ")[-1])
for t in (4096, 8):
    x = cs.router_inputs(dev, t, 8, "normal", torch.float32, 1)
    call = lambda: moe_router_kernel(x, 2)
    out[f"b6_{t}"] = us(cs.device_ms(call))
    out[f"b6_{t}_warm"] = us(cs.device_ms(call, cold=False))
    out[f"b6_{t}_call"] = call_us(call)
    out[f"b6_{t}_call_ops"] = call_us(lambda: moe_router(x, 2))
out["launch_floor"] = us(cs.launch_floor_ms())
print(json.dumps(out))
if out["b6_failed"] and root == here:
    sys.exit("moe_router fails phase 12's cases in this checkout")
'''

# source: {variant: (a regular expression matching one span of the
# source, its replacement)}
VARIANTS = {
    "context_pairwise": {
        "pow": (r"const float g0 = pow10_rn\(pl \* c\.neg_tenth\);",
                "const float g0 = "
                "(float)pow(10.0, (double)(pl * c.neg_tenth));"),
        "exp10f": (r"const float g0 = pow10_rn\(pl \* c\.neg_tenth\);",
                   "const float g0 = exp10f(pl * c.neg_tenth);"),
        **{f"threads={n}": (r"constexpr int kThreads = \d+;",
                            f"constexpr int kThreads = {n};")
           for n in (32, 64, 128, 512, 1024)}},
    "moe_router": {
        **{f"threads={n}": (r"constexpr int kRowThreads = \d+;",
                            f"constexpr int kRowThreads = {n};")
           for n in (32, 64, 128, 256)},
        "warp-a-row": (r"if \(e <= kWarp\) \{", "if (false) {"),
        "rcp": (r"for \(int j = 0; j < kE; \+\+j\) p\[j\] = p\[j\] / s;",
                "for (int j = 0; j < kE; ++j) p[j] = p[j] * __frcp_rn(s);")},
}

VARIANT_RUN = PRELUDE + r'''
import ctypes, re, subprocess
from repro_torch.kernels.context_pairwise.ref import pairwise_context_ref
from repro_torch.kernels.moe_router import kernel as b6
variants = json.loads(sys.argv[3])
out_dir = _build.build_dir().parent / "kernel_variants"
out_dir.mkdir(parents=True, exist_ok=True)


def build(source, entry, table):
    # {variant: the entry point of its library}, the source as it is
    # first; every variant built at once
    src = (_build.CSRC / f"{source}.cu").read_text()
    procs = {}
    for name, (old, new) in [("as is", (None, None))] + list(table.items()):
        text, n = (src, 1) if old is None else re.subn(old, new, src)
        if n != 1:
            sys.exit(f"variant {name}: {old!r} matches {n} times in "
                     f"{source}.cu")
        tag = source + "_" + name.replace(" ", "_").replace("=", "")
        cu = out_dir / f"{tag}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{tag}.so"
        cmd = [_build._nvcc(), *_build.flags(source), "-o", str(lib),
               str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    fns = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"variant {name} failed to build:\n{log}")
        regs = [l.strip() for l in log.splitlines() if "Used" in l]
        print(f"  {source} {name}: {'; '.join(regs)}")
        fns[name] = getattr(ctypes.CDLL(str(lib)), entry)
    return fns


def in_turns(fns, bind, measure):
    # {variant: [measure() of round 1, of round 2]}, the order reversed
    # in round 2
    times = {name: [] for name in fns}
    order = list(fns)
    for rnd in range(2):
        for name in order if rnd == 0 else order[::-1]:
            bind(fns[name])
            times[name].append(measure())
    return times


if "context_pairwise" in variants:
    fns = build("context_pairwise", "context_pairwise_launch",
                variants["context_pairwise"])
    for f in fns.values():
        f.argtypes, f.restype = b1._fn().argtypes, b1._fn().restype
    ref = pairwise_context_ref(*args, **kw)

    def b1_bind(f):
        b1._fn = lambda: f

    def b1_measure():
        k = b1.context_pairwise_kernel(*args, **kw)
        exact = all(torch.equal(getattr(k, f), getattr(ref, f))
                    for f in cs.CONTEXT_FIELDS)
        call = lambda: b1.context_pairwise_kernel(*args, **kw)
        return (us(cs.device_ms(call)), us(cs.device_ms(call, cold=False)),
                exact)
    for name, runs in in_turns(fns, b1_bind, b1_measure).items():
        print(json.dumps({"variant": "context_pairwise " + name,
                          "cold": [r[0] for r in runs],
                          "warm": [r[1] for r in runs],
                          "bitwise": all(r[2] for r in runs)}))

if "moe_router" in variants:
    f32 = b6._fn(torch.float32)
    fns = build("moe_router", "moe_router_f32_launch",
                variants["moe_router"])
    for f in fns.values():
        f.argtypes, f.restype = f32.argtypes, f32.restype
    xs = {t: cs.router_inputs(dev, t, 8, "normal", torch.float32, 1)
          for t in (4096, 8)}
    bad = cs.router_inputs(dev, 500, 8, "nonfinite", torch.float32, 30)
    tiny = cs.router_inputs(dev, 1000, 8, "tiny", torch.float32, 31)

    def b6_bind(f):
        b6._fn = lambda dtype: f

    def b6_measure():
        try:
            cs.router_agrees(xs[4096], 2, "prefill")
            cs.router_agrees(bad, 2, "non-finite rows")
            cs.router_agrees(tiny, 2, "probabilities below 2^-117")
            agrees = True
        except SystemExit:
            agrees = False
        row = {"agrees": agrees}
        for t, x in xs.items():
            call = lambda: b6.moe_router_kernel(x, 2)
            row[f"{t}"] = us(cs.device_ms(call))
            row[f"{t}_warm"] = us(cs.device_ms(call, cold=False))
        return row
    for name, runs in in_turns(fns, b6_bind, b6_measure).items():
        print(json.dumps({"variant": "moe_router " + name,
                          **{key: [r[key] for r in runs]
                             for key in runs[0]}}))
'''


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip()


def run(code: str, *argv: str) -> str:
    env = dict(os.environ,
               REPRO_TORCH_BUILD=str(HERE / "build" / "kernel_turns"))
    out = subprocess.run([sys.executable, "-c", code, *argv],
                         capture_output=True, text=True, cwd=HERE, env=env)
    if out.returncode:
        sys.exit(f"kernel_turns failed:\n{out.stdout[-2000:]}\n"
                 f"{out.stderr[-3000:]}")
    return out.stdout.rstrip()


def main() -> None:
    print(smi())
    if sys.argv[1:2] == ["--variants"]:
        chosen = {src: VARIANTS[src] for src in sys.argv[2:] or VARIANTS}
        print(run(VARIANT_RUN, str(HERE), str(HERE), json.dumps(chosen)))
        return
    roots = [Path(a).resolve() for a in sys.argv[1:]] or [HERE]
    for root in roots:
        print(f"{root}:")
        print(run(TURN, str(root), str(HERE)))


if __name__ == "__main__":
    main()
