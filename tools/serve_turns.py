"""Served prefill and decode times of one or more checkouts, in turns on
one card: the way to compare a model's serve path with its parent's. On
the GPU:

    python3 tools/serve_turns.py [--arch ARCH] [--layers N] [--runs R] \
        [ROOT ...]                          # turns, e.g. P . . P
    python3 tools/serve_turns.py --combine  # this tree

Turns: each ROOT is the root of a checkout (default: this one); give the
parent and the change in turns (parent, change, change, parent). For
each ROOT, in the order given, a fresh process imports ``ROOT/src``'s
``repro_torch`` (its kernels built into this checkout's
``build/serve_turns``, keyed on their sources, so nothing is written
into ROOT), draws ARCH (default mixtral-8x22b) at full width with N of
its layers (default 8, as ``chip_smoke.py``'s phase 13) in bf16 from
seed 0, runs ``launch.serve.run`` once to warm up (8 x 64 tokens, 2 new)
and then R times (default 3) at batch 8, 512-token prompts and 32 greedy
tokens. It prints one JSON line: the prefill's ms and decode tok/s of
each run (host wall with a sync, as ``ServeResult`` reports them) and
the first run's first sample tokens.

``--combine``: in this checkout, the MoE combine at top-2 as the model
runs it (``moe.combine_ascending``, one ``index_add_``) beside the
general ascending sum (``moe._ascending_sum``: a scatter, a gather and k
adds) at mixtral's width d = 6144 in bf16, at the prefill's T = 4096 and
a decode step's T = 8: device ms (CUDA events; L2 flushed at T = 4096,
warm at T = 8), ms a call from Python (``chip_smoke.cuda_ms``), and
whether the two are bitwise equal. One JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

TURN = r'''
import dataclasses, json, sys
root, arch, layers, runs = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    int(sys.argv[4])
sys.path.insert(0, root + "/src")
import torch
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import registry as R
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
cfg = dataclasses.replace(get_config(arch), num_layers=layers)
params = R.init_params(cfg, 0, device=dev)
serve.run(cfg, batch=8, prompt_len=64, gen_len=2, seed=1, device=dev,
          params=params)
out = {"prefill_ms": [], "decode_tok_per_s": []}
for n in range(runs):
    res = serve.run(cfg, batch=8, prompt_len=512, gen_len=32, seed=0,
                    device=dev, params=params)
    out["prefill_ms"].append(res.prefill_s * 1e3)
    out["decode_tok_per_s"].append(res.decode_tok_per_s)
    if n == 0:
        out["sample"] = res.tokens[0, :12].tolist()
print(json.dumps({"arch": arch, "layers": layers, **out}))
'''

COMBINE = r'''
import json, sys
sys.path.insert(0, sys.argv[1] + "/src")
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from repro_torch.models import moe
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
out = {}
for t in (4096, 8):
    k, d = 2, 6144
    contrib = torch.randn((t * k, d), generator=gen, device=dev).to(
        torch.bfloat16)
    idx = torch.stack([torch.randperm(8, generator=gen, device=dev)[:k]
                       for _ in range(t)]).to(torch.int32)
    order = torch.argsort(idx.reshape(-1).long(), stable=True)
    cold = t > 8
    row = {}
    for name, fn in (("index_add", moe.combine_ascending),
                     ("ascending_sum", moe._ascending_sum)):
        call = lambda: fn(contrib, order, idx)
        row[name + "_ms"] = cs.event_ms(call, cold=cold)
        row[name + "_call_ms"] = cs.cuda_ms(call, 200)
    a = moe.combine_ascending(contrib, order, idx)
    b = moe._ascending_sum(contrib, order, idx)
    row["bitwise"] = torch.equal(a.view(torch.int16), b.view(torch.int16))
    row["l2_flushed"] = cold
    out[f"T={t}"] = row
print(json.dumps({"combine_top2_d6144_bf16": out}))
'''


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip()


def run(code: str, *argv: str) -> str:
    env = dict(os.environ,
               REPRO_TORCH_BUILD=str(HERE / "build" / "serve_turns"))
    out = subprocess.run([sys.executable, "-c", code, *argv],
                         capture_output=True, text=True, cwd=HERE, env=env)
    if out.returncode:
        sys.exit(f"serve_turns failed:\n{out.stdout[-2000:]}\n"
                 f"{out.stderr[-3000:]}")
    return out.stdout.rstrip().splitlines()[-1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--arch", default="mixtral-8x22b")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--combine", action="store_true")
    args = ap.parse_args()
    print(smi())
    if args.combine:
        print(run(COMBINE, str(HERE)))
        return
    for root in [r.resolve() for r in args.roots] or [HERE]:
        print(f"{root}:")
        print(run(TURN, str(root), args.arch, str(args.layers),
                  str(args.runs)))


if __name__ == "__main__":
    main()
