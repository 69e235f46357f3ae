"""Step-indexed pytree checkpoints with atomic writes (the reference's
``checkpoint/checkpoint.py`` without msgpack).

A tree is nested dicts, lists, tuples and NamedTuples over tensors,
numpy arrays, Python scalars, strings and ``None``. ``save_pytree``
moves every tensor to the CPU, turns numpy arrays into tensors and each
NamedTuple into a list of its fields, and writes the tree with
``torch.save``; ``restore_pytree`` reads it back with ``torch.load(...,
weights_only=True)``, which unpickles tensors and plain containers only.
A caller rebuilds NamedTuples in its template's structure
(``experiment.sweep._like``). Every dtype keeps its shape and dtype
(bool, the integer types, float32, float64, bfloat16).
"""
from __future__ import annotations

import io
import os
import re
import tempfile
from typing import Any, Optional

import numpy as np
import torch

_EXT = ".pt"
_MAGIC = "repro_torch-checkpoint/v1"
_NAME = re.compile(r"ckpt_(\d+)\.pt$")


def _pack(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree, copy=True))
    if isinstance(tree, dict):
        return {k: _pack(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [_pack(v) for v in tree]          # a NamedTuple -> list
    if isinstance(tree, (list, tuple)):
        return type(tree)(_pack(v) for v in tree)
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def save_pytree(path: str, tree: Any, step: Optional[int] = None) -> str:
    """Write ``tree`` to ``<path>/ckpt_<step:08d>.pt`` (or to ``path``
    itself when ``step`` is None). Atomic: a temporary file in the
    target directory, then ``os.replace``."""
    if step is not None:
        os.makedirs(path, exist_ok=True)
        final = os.path.join(path, f"ckpt_{step:08d}{_EXT}")
    else:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        final = path
    buf = io.BytesIO()
    torch.save({"magic": _MAGIC, "tree": _pack(tree)}, buf)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(final) or ".")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(buf.getvalue())
        os.replace(tmp, final)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return final


def restore_pytree(path: str) -> Any:
    """Inverse of ``save_pytree``, its tensors on the CPU. Raises a
    ``ValueError`` naming the file when it is empty, truncated or not a
    checkpoint."""
    with open(path, "rb") as f:
        raw = f.read()
    if not raw:
        raise ValueError(f"corrupt or truncated checkpoint file {path!r}: "
                         "file is empty")
    try:
        payload = torch.load(io.BytesIO(raw), weights_only=True)
    except Exception as e:   # noqa: BLE001 — any decode failure of the bytes
        first = str(e).splitlines()[0] if str(e) else ""
        raise ValueError(f"corrupt or truncated checkpoint file {path!r}: "
                         f"{type(e).__name__}: {first}") from e
    if not (isinstance(payload, dict) and payload.get("magic") == _MAGIC
            and "tree" in payload):
        raise ValueError(f"corrupt or truncated checkpoint file {path!r}: "
                         "not a repro_torch checkpoint")
    return payload["tree"]


def latest_checkpoint(directory: str) -> Optional[str]:
    """The checkpoint of the highest step in ``directory`` (by number,
    not by name), or None."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        m = _NAME.match(name)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(directory, name), int(m.group(1))
    return best
