"""B1 (context_pairwise) and B3 (masked_aggregate) device and call times
of one or more checkouts, in turns on one card: the way to compare the
two kernels with their parent's. On the GPU:

    python3 tools/kernel_turns.py [ROOT ...]     # turns, e.g. P . . P
    python3 tools/kernel_turns.py --variants     # B1 variants, this tree

Turns: each ROOT is the root of a checkout (default: this one); give the
parent and the change in turns (parent, change, change, parent). For
each ROOT, in the order given, a fresh process imports ``ROOT/src``'s
``repro_torch`` (its kernels built into this checkout's
``build/kernel_turns``, keyed on their sources, so nothing is written
into ROOT; the first process of a ROOT prints their ptxas registers and
spills) and, with this checkout's ``chip_smoke`` helpers (``device_ms``:
summed kernel time under torch.profiler, median of three traces, the L2
flushed before each call unless warm; ``cuda_ms``: wall per call from
Python):

* holds B1 against its plain version at ``chip_smoke``'s four phase-3
  cases and prints each field's max abs error a case;
* times B1 at the main path's (2, 1000, 12): cold, warm, a call of the
  kernel wrapper and one through ``ops.pairwise_context``;
* holds B3 bitwise at (24 rows, 24-27 slots, D = 7850) and times it cold
  at each slot count, warm and a call at 27;
* times the launch floor, ``torch.cuda._sleep(0)``.

Each process prints one JSON line of microseconds after its root.

Variants: one process of this checkout builds copies of
``csrc/context_pairwise.cu`` with one text change each and times B1 cold
and warm at (2, 1000, 12) with each, in two rounds (the order reversed in
the second), beside the source as it is:

* ``pow``: 10^x by the double pow alone, as the first kernel had it;
* ``exp10f``: 10^x by the float exp10f (not exact: what removing the
  double-precision work altogether would save);
* ``threads=32``, ``64``, ``128``, ``512``, ``1024``: other block sizes.
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
_build.build_all()
for name in ("context_pairwise", "masked_aggregate"):
    cs.ptxas_lines(name)
out = {}
for case in cs.CONTEXT_CASES:
    _, _, errs = cs.context_pairwise_errors(dev, env, case)
    out["b1_err_%d_%d_%d" % case[:3]] = errs
call = lambda: b1.context_pairwise_kernel(*args, **kw)
out["b1"] = us(cs.device_ms(call))
out["b1_warm"] = us(cs.device_ms(call, cold=False))
out["b1_call"] = us(cs.cuda_ms(call, 200))
out["b1_call_ops"] = us(cs.cuda_ms(lambda: pairwise_context(*args, **kw),
                                   200))
for s in (24, 25, 26, 27):
    p, dl, w = cs.masked_aggregate_inputs(dev, 24, s, 7850, 10 + s)
    if not torch.equal(masked_aggregate_kernel(p, dl, w),
                       masked_aggregate_ref(p, dl, w)):
        sys.exit(f"masked_aggregate not bitwise at {s} slots")
    call = lambda: masked_aggregate_kernel(p, dl, w)
    out[f"b3_{s}"] = us(cs.device_ms(call))
out["b3_mean"] = round(sum(out[f"b3_{s}"] for s in (24, 25, 26, 27)) / 4, 3)
out["b3_27_warm"] = us(cs.device_ms(call, cold=False))
out["b3_27_call"] = us(cs.cuda_ms(call, 200))
out["launch_floor"] = us(cs.launch_floor_ms())
print(json.dumps(out))
'''

# name: (a regular expression matching one span of the source, its
# replacement)
VARIANTS = {
    "pow": (r"const float g0 = pow10_rn\(pl \* c\.neg_tenth\);",
            "const float g0 = (float)pow(10.0, (double)(pl * c.neg_tenth));"),
    "exp10f": (r"const float g0 = pow10_rn\(pl \* c\.neg_tenth\);",
               "const float g0 = exp10f(pl * c.neg_tenth);"),
    **{f"threads={n}": (r"constexpr int kThreads = \d+;",
                        f"constexpr int kThreads = {n};")
       for n in (32, 64, 128, 512, 1024)},
}

VARIANT_RUN = PRELUDE + r'''
import ctypes, re, subprocess
from repro_torch.kernels.context_pairwise.ref import pairwise_context_ref
variants = json.loads(sys.argv[3])
src = (_build.CSRC / "context_pairwise.cu").read_text()
out_dir = _build.build_dir().parent / "kernel_variants"
out_dir.mkdir(parents=True, exist_ok=True)
procs = {}
for name, (old, new) in [("as is", (None, None))] + list(variants.items()):
    text, n = (src, 1) if old is None else re.subn(old, new, src)
    if n != 1:
        sys.exit(f"variant {name}: {old!r} matches {n} times in the source")
    tag = name.replace(" ", "_").replace("=", "")
    cu = out_dir / f"{tag}.cu"
    cu.write_text(text)
    lib = out_dir / f"lib{tag}.so"
    cmd = [_build._nvcc(), *_build.flags("context_pairwise"), "-o", str(lib),
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
    print(f"  {name}: {'; '.join(regs)}")
    fn = ctypes.CDLL(str(lib)).context_pairwise_launch
    fn.argtypes, fn.restype = b1._fn().argtypes, b1._fn().restype
    fns[name] = fn
ref = pairwise_context_ref(*args, **kw)
times = {name: [] for name in fns}
order = list(fns)
for rnd in range(2):
    for name in order if rnd == 0 else order[::-1]:
        b1._fn = lambda f=fns[name]: f
        k = b1.context_pairwise_kernel(*args, **kw)
        exact = all(torch.equal(getattr(k, f), getattr(ref, f))
                    for f in cs.CONTEXT_FIELDS)
        call = lambda: b1.context_pairwise_kernel(*args, **kw)
        times[name].append((us(cs.device_ms(call)),
                            us(cs.device_ms(call, cold=False)), exact))
for name, runs in times.items():
    print(json.dumps({"variant": name,
                      "cold": [r[0] for r in runs],
                      "warm": [r[1] for r in runs],
                      "bitwise": all(r[2] for r in runs)}))
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
    if sys.argv[1:] == ["--variants"]:
        print(run(VARIANT_RUN, str(HERE), str(HERE), json.dumps(VARIANTS)))
        return
    roots = [Path(a).resolve() for a in sys.argv[1:]] or [HERE]
    for root in roots:
        print(f"{root}:")
        print(run(TURN, str(root), str(HERE)))


if __name__ == "__main__":
    main()
