"""Checkpoint save/load for model parameters (the serving weight-load path).

The counterpart of the JAX package's ``models/checkpoint.py``, in the same
format, so a checkpoint written by either package loads in the other: one
``.npz`` holding the flattened parameter dict under '/'-joined keys, with a
``QuantizedTensor`` stored as ``<key>/__qt{bits}__values`` and
``<key>/__qt{bits}__scales``.

numpy has no bfloat16. ``np.savez`` stores an ml_dtypes bf16 array (what
the JAX package saves for a bf16 weight) as raw 2-byte records, ``|V2``,
and this module writes a bf16 tensor the same way; the loader reads a
``|V2`` entry back as bf16.
"""

from __future__ import annotations

import numpy as np
import torch

from flash_attention_tpu_torch.ops.quant import QuantizedTensor

_QT = "__qt{bits}__"


def _array(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _flatten(tree, prefix=""):
    if isinstance(tree, QuantizedTensor):
        tag = prefix + _QT.format(bits=tree.bits)
        return {tag + "values": _array(tree.values),
                tag + "scales": _array(tree.scales)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): _array(tree)}


def save_checkpoint(path: str, params) -> None:
    np.savez(path, **_flatten(params))


def to_tensor(a) -> torch.Tensor:
    """A numpy array as a writable CPU tensor; an ml_dtypes bf16 array and
    raw 2-byte records (``|V2``, bf16 as ``np.load`` returns it) become
    bf16 by their bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def load_checkpoint(path: str, dtype=None, device="cuda"):
    """Load a checkpoint onto ``device``; non-quantized float leaves are
    cast to ``dtype`` when it is given. Quantized leaves come back as
    ``QuantizedTensor``s with int8 values and fp32 scales."""
    tree: dict = {}
    qt_parts: dict = {}
    with np.load(path) as data:
        for key in data.files:
            t = to_tensor(data[key])
            if "__qt" in key:
                base, rest = key.split("__qt", 1)
                bits, part = rest.split("__", 1)
                qt_parts.setdefault(base, {"bits": int(bits)})[part] = t
                continue
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            _insert(tree, key.split("/"), t.to(device))
    for base, parts in qt_parts.items():
        qt = QuantizedTensor(parts["values"].to(device),
                             parts["scales"].to(device), parts["bits"])
        _insert(tree, base.rstrip("/").split("/"), qt)
    return tree


def _insert(tree, keys, value):
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value
