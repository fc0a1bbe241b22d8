"""Carries a reference (JAX) parameter tree into the port.

``params_from_jax`` takes the tree as numpy arrays, e.g.
``jax.tree.map(np.asarray, params)``, and returns the same nested
dict/list of torch tensors.  bf16 leaves arrive as ``ml_dtypes``
bfloat16 and are reinterpreted byte for byte, so this module needs
neither ``ml_dtypes`` nor ``jax``.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(arr, device, dtype):
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree, device, dtype=None):
    """Nested dict/list of numpy arrays -> the same of torch tensors on
    ``device`` (cast to ``dtype`` where given)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device, dtype) for v in tree]
    return _leaf(tree, device, dtype)


def flatten(tree, prefix=()):
    """{"/"-joined path: leaf}, the keys of the reference checkpoint
    manifest (``repro/ckpt/checkpoint.py::_flatten``: dict keys sorted,
    list entries by index)."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {"/".join(prefix): tree}
    out = {}
    for name, sub in items:
        out.update(flatten(sub, prefix + (name,)))
    return out


def unflatten(like, flat, prefix=()):
    """The tree of ``like``'s structure whose leaf at each path is
    ``flat[path]``: the inverse of ``flatten``."""
    if isinstance(like, dict):
        return {k: unflatten(v, flat, prefix + (str(k),)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [unflatten(v, flat, prefix + (str(i),)) for i, v in enumerate(like)]
    return flat["/".join(prefix)]
