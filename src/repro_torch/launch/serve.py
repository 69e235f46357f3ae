"""Serving launcher: batched autoregressive decoding, the counterpart of
the reference's ``launch/serve.py``.

    python -m repro_torch.launch.serve --arch zamba2-1.2b --device cpu
    python -m repro_torch.launch.serve --arch rwkv6-1.6b   # on CUDA

``--arch`` takes the reference's ten ids. The command line runs the
``reduced()`` config, as the reference's does: prefill of a random
prompt (with random frame embeddings for ``audio`` and patch embeddings
for ``vlm``), for recurrent archs (``ssm``, ``hybrid``) a token-by-token
rebuild of the state over the prompt, then a greedy decode loop. It
prints the prefill time and the decode rate. ``run`` carries the flow for any
config (the registry functions take any), which is how a full-width
model is driven.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import registry as R


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor          # (B, gen_len) greedy tokens
    prefill_logits: torch.Tensor  # (B, 1, V) from the prefill
    logits: torch.Tensor          # (B, 1, V) that chose the first token
    step_logits: torch.Tensor     # (gen_len - 1, B, V) float32, each step's
    prefill_s: float              # prefill seconds
    rebuild_s: float              # recurrent archs' state rebuild seconds
    decode_s: float               # decode loop seconds

    @property
    def decode_tok_per_s(self) -> float:
        b, n = self.tokens.shape
        return n * b / max(self.decode_s, 1e-9)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg: ModelConfig, batch: int = 4, prompt_len: int = 32,
        gen_len: int = 32, seed: int = 0, device=None,
        params: Optional[dict] = None,
        prompt: Optional[torch.Tensor] = None,
        frames: Optional[torch.Tensor] = None,
        patches: Optional[torch.Tensor] = None) -> ServeResult:
    """Prefill a (batch, prompt_len) prompt, then decode gen_len tokens
    greedily. ``params``, ``prompt`` and, for ``audio``, ``frames``
    (batch, num_frames, d_model) or, for ``vlm``, ``patches`` (batch,
    num_patches, d_model) default to random ones from ``seed`` (one
    ``torch.Generator``, in that order; standard normal embeddings in the
    model dtype, as the reference's launcher draws them)."""
    dev = resolve_device(device)
    if params is None:
        params = R.init_params(cfg, seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if prompt is None:
        prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                               generator=gen, device=dev, dtype=torch.int32)
    batch, prompt_len = prompt.shape
    inputs = {"tokens": prompt}
    for kind, name, given, n in (("audio", "frames", frames, cfg.num_frames),
                                 ("vlm", "patches", patches,
                                  cfg.num_patches)):
        if cfg.arch_type == kind:
            inputs[name] = given if given is not None else torch.randn(
                (batch, n, cfg.d_model), generator=gen, device=dev
            ).to(cfg.torch_dtype)
    max_len = prompt_len + gen_len
    state = R.init_serve_state(cfg, batch, max_len, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    prefill_logits, state = R.prefill(params, cfg, inputs, state)
    logits = prefill_logits
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if cfg.arch_type in ("ssm", "hybrid"):
        # recurrent archs rebuild the state token by token in this launcher
        state = R.init_serve_state(cfg, batch, max_len, device=dev)
        for i in range(prompt_len):
            logits, state = R.serve_step(params, cfg, prompt[:, i:i + 1],
                                         state)
    _sync(dev)
    rebuild_s = time.perf_counter() - t0

    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    out, steps = [tok], []
    t0 = time.perf_counter()
    for _ in range(gen_len - 1):
        step_logits, state = R.serve_step(params, cfg, tok, state)
        steps.append(step_logits[:, -1].float())
        tok = torch.argmax(step_logits[:, -1:], dim=-1).to(torch.int32)
        out.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    step_stack = (torch.stack(steps) if steps else
                  torch.zeros((0, batch, cfg.vocab_size), device=dev))
    return ServeResult(tokens=torch.cat(out, dim=1),
                       prefill_logits=prefill_logits, logits=logits,
                       step_logits=step_stack, prefill_s=prefill_s,
                       rebuild_s=rebuild_s, decode_s=decode_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="qwen2-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    res = run(cfg, batch=args.batch, prompt_len=args.prompt_len,
              gen_len=args.gen_len, seed=args.seed, device=args.device)
    print(f"prefill({args.prompt_len} tokens): "
          f"{res.prefill_s + res.rebuild_s:.2f}s")
    print(f"decoded {args.gen_len} tokens x batch {args.batch} in "
          f"{res.decode_s:.2f}s ({res.decode_tok_per_s:.1f} tok/s)")
    print("sample:", res.tokens[0, :16].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
