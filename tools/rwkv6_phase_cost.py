"""What each phase of B5's chunked kernel costs on the card: builds
``src/repro_torch/csrc/rwkv6_scan.cu`` as it is and with one phase of a
chunk compiled out, times each build at the rwkv6-1.6b prompt (8, 32
heads, 512, 64, 64, bf16 r/k/v on the model's (B, T, H, 64) views) and
prints the times; the time a build without a phase saves is that phase's
share of the critical path (its results are wrong, its timing is not).
A phase is the code between the source's ``// phase-cost cut begin:
<name>`` and ``// phase-cost cut end: <name>`` lines.

    PYTHONPATH=src python3 tools/rwkv6_phase_cost.py       # on the GPU

Warm device time, CUDA events around 20 calls, the builds in turn
(full, each phase, full again). Builds go to ``build/phase_cost/``.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "phase_cost"
MARK = re.compile(r"^ *// phase-cost cut (begin|end): (\S+)$", re.M)
# what each build leaves out: the regions of the source marked with that
# name ("y-u" marks both bodies of the Y / U branch)
VARIANTS = {
    "full": None,
    "no y store": "y-store",
    "no decays after the scan": "decays",
    "no phase S (a), in-half pairs": "pairs",
    "no phase S (b), score tiles": "scores",
    "no phase Y/U": "y-u",
}


def cut(src: str, name: str) -> str:
    """``src`` with every region marked ``name`` inside ``#if 0``."""
    out, n = src, 0
    for m in reversed(list(MARK.finditer(src))):
        if m.group(2) == name:
            n += 1
            fill = "#if 0\n" if m.group(1) == "begin" else "#endif\n"
            pos = m.start() if m.group(1) == "begin" else m.end() + 1
            out = out[:pos] + fill + out[pos:]
    if n == 0 or n % 2:
        sys.exit(f"rwkv6_phase_cost: {n} markers of {name!r} in the source")
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("rwkv6_phase_cost: needs a CUDA device")
    OUT.mkdir(parents=True, exist_ok=True)
    base = (CSRC / "rwkv6_scan.cu").read_text()
    nvcc = "/usr/local/cuda/bin/nvcc"
    procs = {}
    for i, (name, region) in enumerate(VARIANTS.items()):
        src = cut(base, region) if region else base
        cu = OUT / f"v{i}.cu"
        cu.write_text(src)
        so = OUT / f"libv{i}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    dev = torch.device("cuda", 0)
    b, h, t = 8, 32, 512
    gen = torch.Generator(device=dev).manual_seed(11)
    shape = (b, t, h, 64)
    r, k, v = (torch.randn(shape, generator=gen, device=dev)
               .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    lw = -torch.exp(torch.randn(shape, generator=gen, device=dev) * 0.5
                    - 2.0).transpose(1, 2)
    u = torch.randn((h, 64), generator=gen, device=dev) * 0.1
    strides = [s for a in (r, k, v, lw) for s in a.stride()[:3]]
    st = (ctypes.c_longlong * 12)(*strides)
    y = torch.empty((b, t, h, 64), device=dev)
    fin = torch.empty((b, h, 64, 64), device=dev)
    fns = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"rwkv6_phase_cost: {name} did not build:\n{log}")
        fn = ctypes.CDLL(str(so)).rwkv6_scan_bf16_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fns[name] = fn

    def time_us(fn) -> float:
        def call():
            code = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                      lw.data_ptr(), u.data_ptr(), y.data_ptr(),
                      fin.data_ptr(), st, b, h, t, 64, 64,
                      torch.cuda.current_stream().cuda_stream)
            if code:
                sys.exit(f"rwkv6_phase_cost: launch failed ({code})")
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(20):
            call()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / 20 * 1e3

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    full = [time_us(fns["full"])]
    for name, fn in fns.items():
        if name != "full":
            us = time_us(fn)
            print(f"  {name}: {us:.1f} us")
    full.append(time_us(fns["full"]))
    print(f"  full kernel, before and after: {full[0]:.1f} us, "
          f"{full[1]:.1f} us")


if __name__ == "__main__":
    main()
