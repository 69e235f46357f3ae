"""The paper's training models: multinomial logistic regression (the
convex "MNIST" setting of Figs. 3/4) and the CNN of the non-convex
"CIFAR-10" setting (Figs. 5-7).

Parameters are plain dicts. Logistic regression is ``{"w": (F, C), "b":
(C,)}``, and in the reference's transposed layout (``logreg-t``,
``TrainSpec.transposed_gemm``) ``{"wt": (C, F), "b": (C,)}``; their
functions take optional leading batch axes on the parameters (one
model per (seed, ES) or per slot). The CNN is two 5x5
convolutions of 64 channels (``SAME``, each with ReLU and a 2x2 max-pool)
and three dense layers (384, 192, classes). Its inputs are NHWC, as the
reference's; its parameters are in PyTorch's layout: convolutions OIHW,
and ``f1``'s rows in the order of an NCHW flatten (``models.convert``
carries the reference's HWIO / NHWC-flatten params across). A batch of
per-slot CNNs trains under ``torch.func.vmap`` (``cnn_loss_and_grad``).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import random as jr

Params = Dict[str, torch.Tensor]
MODEL_KINDS = ("logreg", "logreg-t", "cnn")


def init_logreg(num_features: int = 784, num_classes: int = 10,
                device=None) -> Params:
    """Zeros, as the reference's init (the key is unused there)."""
    return {"w": torch.zeros((num_features, num_classes),
                             dtype=torch.float32, device=device),
            "b": torch.zeros((num_classes,), dtype=torch.float32,
                             device=device)}


def logreg_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x (..., B, F) @ w (..., F, C) + b (..., C) -> (..., B, C)."""
    return torch.matmul(x, params["w"]) + params["b"][..., None, :]


def init_logreg_t(num_features: int = 784, num_classes: int = 10,
                  device=None) -> Params:
    """The transposed layout: ``wt`` (classes, features), zeros
    (``wt == w.T`` of ``init_logreg``)."""
    return {"wt": torch.zeros((num_classes, num_features),
                              dtype=torch.float32, device=device),
            "b": torch.zeros((num_classes,), dtype=torch.float32,
                             device=device)}


def logreg_t_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x (..., B, F) @ wt (..., C, F)^T + b (..., C) -> (..., B, C)."""
    return (torch.matmul(x, params["wt"].transpose(-1, -2))
            + params["b"][..., None, :])


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
    """Mean cross-entropy over the batch axis (-2)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    picked = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -picked.mean(dim=-1)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(logits, dim=-1) == labels).to(
        torch.float32).mean(dim=-1)


def logreg_loss_and_grad(params: Params, x: torch.Tensor,
                         y: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """Loss and its gradient for batched models: params leaves
    (K, ...), x (K, B, F), y (K, B) -> loss (K,), grads like params.
    The gradient of mean softmax cross-entropy is (softmax - onehot) / B
    through the logits; the products are batched matmuls."""
    logits = logreg_logits(params, x)
    b = x.shape[-2]
    p = torch.softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(y.long(), p.shape[-1]).to(p.dtype)
    g = (p - onehot) / b
    gw = torch.matmul(x.transpose(-1, -2), g)
    gb = g.sum(dim=-2)
    return softmax_xent(logits, y), {"w": gw, "b": gb}


def logreg_t_loss_and_grad(params: Params, x: torch.Tensor,
                           y: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """``logreg_loss_and_grad`` in the transposed layout: the weight
    gradient is ``g^T x`` (K, C, F)."""
    logits = logreg_t_logits(params, x)
    b = x.shape[-2]
    p = torch.softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(y.long(), p.shape[-1]).to(p.dtype)
    g = (p - onehot) / b
    gwt = torch.matmul(g.transpose(-1, -2), x)
    gb = g.sum(dim=-2)
    return softmax_xent(logits, y), {"wt": gwt, "b": gb}


def cnn_from_reference_layout(tree: Dict[str, torch.Tensor], height: int,
                              width: int) -> Params:
    """The reference's CNN params (HWIO convolutions, ``f1`` rows in
    NHWC-flatten order) -> the port's layout (OIHW, rows in NCHW-flatten
    order)."""
    out = dict(tree)
    for k in ("c1", "c2"):
        out[k] = tree[k].permute(3, 2, 0, 1).contiguous()
    c = tree["c2"].shape[-1]
    out["f1"] = tree["f1"].reshape(height // 4, width // 4, c, -1).permute(
        2, 0, 1, 3).reshape(tree["f1"].shape).contiguous()
    return out


def init_cnn(key: torch.Tensor, height: int = 32, width: int = 32,
             channels: int = 3, num_classes: int = 10) -> Params:
    """The reference's ``init_cnn`` draws: ``split(key, 5)``, normals
    scaled by ``1 / sqrt(fan_in)`` (within ``random.normal``'s few ulp),
    zero biases; then the port's layout. ``key`` (2,) on the device the
    params go to."""
    ks = jr.split(key, 5)
    flat = (height // 4) * (width // 4) * 64
    dev = key.device

    def scaled(k, shape, fan_in):
        # jnp.sqrt of the weak-typed fan-in: a float32 root; a true
        # division outside jit
        return jr.normal(k, shape) / torch.tensor(
            np.sqrt(np.float32(fan_in)), dtype=torch.float32, device=dev)

    zeros = lambda d: torch.zeros((d,), dtype=torch.float32, device=dev)
    tree = {
        "c1": scaled(ks[0], (5, 5, channels, 64), 5 * 5 * channels),
        "b1": zeros(64),
        "c2": scaled(ks[1], (5, 5, 64, 64), 5 * 5 * 64),
        "b2": zeros(64),
        "f1": scaled(ks[2], (flat, 384), flat),
        "fb1": zeros(384),
        "f2": scaled(ks[3], (384, 192), 384),
        "fb2": zeros(192),
        "out": scaled(ks[4], (192, num_classes), 192),
        "outb": zeros(num_classes),
    }
    return cnn_from_reference_layout(tree, height, width)


def cnn_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) -> logits (B, classes), one model (unbatched
    params; ``torch.func.vmap`` adds the slot axis)."""
    h = x.permute(0, 3, 1, 2)
    h = F.conv2d(h, params["c1"], params["b1"], padding=2)
    h = F.max_pool2d(F.relu(h), 2, 2)
    h = F.conv2d(h, params["c2"], params["b2"], padding=2)
    h = F.max_pool2d(F.relu(h), 2, 2)
    h = h.reshape(h.shape[0], -1)
    h = F.relu(h @ params["f1"] + params["fb1"])
    h = F.relu(h @ params["f2"] + params["fb2"])
    return h @ params["out"] + params["outb"]


def _cnn_loss(params: Params, x: torch.Tensor, y: torch.Tensor):
    return softmax_xent(cnn_logits(params, x), y)


def cnn_loss_and_grad(params: Params, x: torch.Tensor, y: torch.Tensor
                      ) -> Tuple[torch.Tensor, Params]:
    """``logreg_loss_and_grad`` for per-slot CNNs: params leaves (K, ...),
    x (K, B, H, W, C), y (K, B) -> loss (K,), grads like params."""
    from torch.func import grad_and_value, vmap
    grads, loss = vmap(grad_and_value(_cnn_loss))(params, x, y)
    return loss, grads


def batched_logits(kind: str, params: Params, x: torch.Tensor
                   ) -> torch.Tensor:
    """Logits of per-seed models: params leaves (S, ...), x (T, ...)
    shared -> (S, T, classes)."""
    if kind == "logreg":
        return logreg_logits(params, x)
    if kind == "logreg-t":
        return logreg_t_logits(params, x)
    from torch.func import vmap
    return vmap(cnn_logits, in_dims=(0, None))(params, x)


def loss_and_grad(kind: str) -> Callable:
    """The batched ``(params, x, y) -> (loss (K,), grads)`` of a model."""
    return {"logreg": logreg_loss_and_grad,
            "logreg-t": logreg_t_loss_and_grad,
            "cnn": cnn_loss_and_grad}[kind]


def make_loss_fn(kind: str) -> Callable:
    """kind: 'logreg' | 'logreg-t' | 'cnn'. Returns ``loss(params,
    batch)`` -> the mean cross-entropy of one model (or of per-model
    logreg batches)."""
    logits = {"logreg": logreg_logits, "logreg-t": logreg_t_logits,
              "cnn": cnn_logits}.get(kind)
    if logits is None:
        raise ValueError(f"unknown model kind {kind!r}; the port has "
                         f"{MODEL_KINDS}")

    def loss(params: Params, batch: Dict[str, torch.Tensor]):
        return softmax_xent(logits(params, batch["x"]), batch["y"])

    return loss
