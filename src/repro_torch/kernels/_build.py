"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each source in ``repro_torch/csrc`` has a plain C entry point (no PyTorch
headers, so a build takes seconds). At first use every source is
compiled, all at once, into ``build/repro_torch/<hash>/`` at the root of
the checkout (or ``$REPRO_TORCH_BUILD``), keyed on a hash of every
source with its own flags and of every header (``*.cuh``) in
``csrc``, so an edited source, header or flag is never served stale. A
build or load error raises.

``--fmad=false`` (no contraction of a multiply and an add into one FMA)
applies only to the sources whose plain versions they must match
bitwise (the HFL path's six); the attention, scan and router kernels
and the attention and scan backward kernels round differently from
their plain versions anyway and keep nvcc's default contraction.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("context_pairwise", "budgeted_topk", "masked_aggregate",
           "flash_attention", "rwkv6_scan", "moe_router", "random_assign",
           "flgreedy_walk", "segment_walk", "flash_attention_bwd",
           "rwkv6_scan_bwd")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BITWISE = ("--fmad=false",)
EXTRA_FLAGS = {"context_pairwise": BITWISE, "budgeted_topk": BITWISE,
               "masked_aggregate": BITWISE, "random_assign": BITWISE,
               "flgreedy_walk": BITWISE, "segment_walk": BITWISE}


def flags(name: str) -> tuple:
    """nvcc's flags for one source."""
    return FLAGS + EXTRA_FLAGS.get(name, ())

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}


def _build_root() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from source at first use")
    return found


def build_dir() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(f"{name}\0{' '.join(flags(name))}\0".encode())
        h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(f"{header.name}\0".encode())
        h.update(header.read_bytes())
    return _build_root() / h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every source not yet built (one nvcc each, all started
    together); returns the shared-library paths."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    # one builder at a time (ranks of one host share the directory); the
    # lock dies with its process, so a killed build leaves none behind
    with open(out / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_locked(out)


def _build_locked(out: Path) -> Dict[str, Path]:
    libs = {n: out / f"lib{n}.so" for n in SOURCES}
    todo = [n for n in SOURCES if not libs[n].exists()]
    procs = {}
    for n in todo:
        tmp = out / f"lib{n}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *flags(n), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    errors = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        BUILD_LOG[n] = log
        if p.returncode != 0:
            errors.append(f"nvcc {n}.cu failed ({p.returncode}):\n{log}")
            continue
        os.replace(tmp, libs[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source (builds everything first)."""
    if name not in _LIBS:
        path = build_all()[name]
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]
