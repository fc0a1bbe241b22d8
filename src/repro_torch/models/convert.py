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


def _leaf(arr, device):
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_jax(tree, device):
    """Nested dict/list of numpy arrays -> the same of torch tensors on
    ``device``, byte for byte, each leaf in its own dtype: the fp32 leaves
    of a bf16 tree (rwkv6's ``u`` and ``decay_bias``) stay fp32.  There is
    no cast option, since one dtype would change what a model keeps in
    fp32."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return _leaf(tree, device)


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
