"""What each phase of B2's one-pass kernel costs on the card: builds
``src/repro_torch/csrc/budgeted_topk.cu`` (or each source given) as it is,
without the walk, and without the sort and the walk, and times each
build at the HFL main path's shape and statistics ((2, 1000, 12),
metropolis-1k's ~28% eligible pairs, budget 12 an ES). A later phase
consumes an earlier one's output and nothing flows back, so the walk
costs full - (no walk) and the sort (no walk) - (no sort, no walk); what
is left is the density, the compaction and the set-up. A phase is the
code between the source's ``// phase-cost cut begin: <name>`` and
``// phase-cost cut end: <name>`` lines.

    PYTHONPATH=src python3 tools/budgeted_topk_phase_cost.py [SOURCE.cu ...]

On the GPU. Warm device time (the summed kernel time of 20 calls under
torch.profiler, as ``chip_smoke.device_ms``: a cut build can take less
time than a launch from Python, which events around a loop would
measure), the builds in turn (full, each cut, full again); the full
build is first checked bitwise against the plain version. Builds go to
``build/phase_cost_b2/``.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "phase_cost_b2"
VARIANTS = {"full": None, "no walk": "walk", "no sort, no walk": "sort-walk"}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("budgeted_topk_phase_cost: needs a CUDA device")
    from chip_smoke import device_ms, topk_inputs
    from repro_torch.kernels import _build
    from repro_torch.kernels.budgeted_topk.ref import budgeted_topk_ref
    from rwkv6_phase_cost import cut
    sources = [Path(a) for a in sys.argv[1:]] or [
        _build.CSRC / "budgeted_topk.cu"]
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for si, src_path in enumerate(sources):
        base = src_path.read_text()
        for vi, (name, region) in enumerate(VARIANTS.items()):
            cu = OUT / f"s{si}v{vi}.cu"
            cu.write_text(cut(base, region) if region else base)
            so = OUT / f"libs{si}v{vi}.so"
            procs[si, name] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.flags("budgeted_topk"), "-o",
                 str(so), str(cu)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    dev = torch.device("cuda", 0)
    v, c, b, e = args = topk_inputs(dev, 2, 1000, 12, 0, "main")
    s, n, m = v.shape
    assign = torch.empty((s, n), dtype=torch.int32, device=dev)
    rem = torch.empty((s, m), dtype=torch.float32, device=dev)
    fns = {}
    for key, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"budgeted_topk_phase_cost: {key} did not build:\n{log}")
        if key[1] == "full":
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"{sources[key[0]].name}: {line.strip()}")
        fn = ctypes.CDLL(str(so)).budgeted_topk_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fns[key] = fn

    def call(fn):
        code = fn(v.data_ptr(), c.data_ptr(), b.data_ptr(), e.data_ptr(),
                  assign.data_ptr(), rem.data_ptr(), s, n, m,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            sys.exit(f"budgeted_topk_phase_cost: launch failed ({code})")

    def time_us(fn) -> float:
        return device_ms(lambda: call(fn), cold=False) * 1e3

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    want_a, want_r = budgeted_topk_ref(*args)
    for si, src_path in enumerate(sources):
        call(fns[si, "full"])
        torch.cuda.synchronize()
        same = torch.equal(assign, want_a) and torch.equal(
            rem.view(torch.int32), want_r.view(torch.int32))
        t = {name: time_us(fns[si, name]) for name in VARIANTS}
        again = time_us(fns[si, "full"])
        print(f"{src_path}: bitwise {same}; full {t['full']:.2f} / "
              f"{again:.2f} us, no walk {t['no walk']:.2f}, no sort and "
              f"no walk {t['no sort, no walk']:.2f}: walk "
              f"{t['full'] - t['no walk']:.2f} us, sort "
              f"{t['no walk'] - t['no sort, no walk']:.2f} us, density "
              f"and set-up {t['no sort, no walk']:.2f} us")


if __name__ == "__main__":
    main()
