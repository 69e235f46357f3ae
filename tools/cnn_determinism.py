#!/usr/bin/env python3
"""Which of the CNN's operations give different bits run to run on the
card: the non-convex path's local-SGD step (``cnn_loss_and_grad`` over
``SLOTS`` per-slot models, a minibatch of 32 at 32x32x3) and its
evaluation (``batched_logits`` over 2 seeds' models on 2000 test
images), each called ``REPEATS`` times on the same inputs, under cuDNN's
default algorithms and then its deterministic ones, TF32 off.

    PYTHONPATH=src python3 tools/cnn_determinism.py      # on the card

Prints, per mode, each output (the loss, each gradient leaf, the
evaluation's logits) and whether every repeat equals the first bitwise,
with the largest gap. A checkpointed CNN run resumes bitwise only where
every output here is stable (``chip_smoke.py`` phase 18).
"""
from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "..", "src"))

SLOTS = 9           # phase 14's most frequent slot capacity
BATCH = 32
REPEATS = 4


def outputs(params, x, y, test_x, seeds_params):
    from repro_torch.models.logistic import batched_logits, \
        cnn_loss_and_grad
    loss, grads = cnn_loss_and_grad(params, x, y)
    out = {"loss": loss}
    out.update({f"grad[{k}]": v for k, v in grads.items()})
    out["eval logits"] = batched_logits("cnn", seeds_params, test_x)
    torch.cuda.synchronize()
    return {k: v.clone() for k, v in out.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("cnn_determinism: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch import random as jr
    from repro_torch.models.logistic import init_cnn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    inits = [init_cnn(jr.PRNGKey(s, dev)) for s in range(SLOTS)]
    params = {k: torch.stack([p[k] for p in inits]) for k in inits[0]}
    seeds_params = {k: v[:2] for k, v in params.items()}
    x = torch.rand((SLOTS, BATCH, 32, 32, 3), device=dev, generator=g)
    y = torch.randint(0, 10, (SLOTS, BATCH), device=dev, generator=g)
    test_x = torch.rand((2000, 32, 32, 3), device=dev, generator=g)
    print(f"card: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, cuDNN "
          f"{torch.backends.cudnn.version()}")
    for mode in ("default", "deterministic"):
        torch.backends.cudnn.deterministic = mode == "deterministic"
        runs = [outputs(params, x, y, test_x, seeds_params)
                for _ in range(REPEATS)]
        print(f"cuDNN {mode}, {REPEATS} repeats:")
        for k, first in runs[0].items():
            gaps = [float((r[k] - first).abs().max()) for r in runs[1:]]
            same = all(torch.equal(r[k], first) for r in runs[1:])
            print(f"  {k:16s} {'bitwise' if same else 'differs'}; largest "
                  f"gap {max(gaps):.3e} of max |value| "
                  f"{float(first.abs().max()):.3e}")
    torch.backends.cudnn.deterministic = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
