"""Weights drawn from the seed, on the device, in the types they are
served in.

``leaves(cfg)`` lists the parameter tree of a decoder-only model with
attention and a dense SwiGLU or routed-expert FFN, in the layout the
program takes: blocks stacked on a leading axis, linear weights ``(d_in,
d_out)``, the router in fp32.  ``draw`` fills it from one generator on the
device, one call a leaf (a leaf holds all the blocks), so the same seed
gives the same tensors, leaf by leaf, whenever it is drawn again.  The
benchmark hands these tensors to the program and, in fp32, to the
reference.
"""

from __future__ import annotations

import math

#: spread of the RMSNorm scales about 1, so a norm that drops its scale
#: shows in the outputs
NORM_SPREAD = 0.1


def leaves(cfg: dict) -> list:
    """[(path, shape, dtype name, kind, std)] in drawing order; ``kind`` is
    "normal" (mean 0) or "norm" (mean 1)."""
    d, V, L = cfg["d_model"], cfg["vocab_size"], cfg["n_layers"]
    H, KV, dh, f = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], cfg["d_ff"]
    pd = cfg["param_dtype"]
    lay = "blocks/layers/0/"
    out = [("embed/table", (V, d), pd, "normal", 1 / math.sqrt(d)),
           ("final_norm/scale", (d,), pd, "norm", NORM_SPREAD),
           (lay + "norm1/scale", (L, d), pd, "norm", NORM_SPREAD),
           (lay + "norm2/scale", (L, d), pd, "norm", NORM_SPREAD),
           (lay + "attn/wq/w", (L, d, H * dh), pd, "normal", 1 / math.sqrt(d)),
           (lay + "attn/wk/w", (L, d, KV * dh), pd, "normal", 1 / math.sqrt(d)),
           (lay + "attn/wv/w", (L, d, KV * dh), pd, "normal", 1 / math.sqrt(d)),
           (lay + "attn/wo/w", (L, H * dh, d), pd, "normal", 1 / math.sqrt(H * dh * 2 * L))]
    moe = cfg.get("moe")
    out_std = 1 / math.sqrt(f * 2 * L)
    if moe is None:
        out += [(lay + "mlp/wi/w", (L, d, f), pd, "normal", 1 / math.sqrt(d)),
                (lay + "mlp/wg/w", (L, d, f), pd, "normal", 1 / math.sqrt(d)),
                (lay + "mlp/wo/w", (L, f, d), pd, "normal", out_std)]
    else:
        E = moe["n_experts"]
        out += [(lay + "moe/router/w", (L, d, E), cfg["router_dtype"], "normal", 1 / math.sqrt(d)),
                (lay + "moe/wi", (L, E, d, f), pd, "normal", 1 / math.sqrt(d)),
                (lay + "moe/wg", (L, E, d, f), pd, "normal", 1 / math.sqrt(d)),
                (lay + "moe/wo", (L, E, f, d), pd, "normal", out_std)]
    if not cfg["tie_embeddings"]:
        out.append(("lm_head/w", (d, V), pd, "normal", 1 / math.sqrt(d)))
    return out


def draw(torch, cfg: dict, seed: int, device, dtype=None):
    """Yields (path, tensor) of ``leaves(cfg)`` in order, drawn from one
    generator on ``device`` seeded with ``seed``, each in its served type,
    or, with ``dtype``, converted to that type once drawn."""
    gen = torch.Generator(device).manual_seed(seed)
    for path, shape, dt, kind, std in leaves(cfg):
        t = torch.randn(shape, generator=gen, device=device, dtype=getattr(torch, dt))
        t.mul_(std)
        if kind == "norm":
            t.add_(1.0)
        yield path, (t if dtype is None else t.to(dtype))


def tree(flat: dict) -> dict:
    """The nested dict / list tree of ``{path: tensor}``; a path's numeric
    part is a list index."""
    root: dict = {}
    for path, t in flat.items():
        parts = path.split("/")
        node = root
        for i, part in enumerate(parts[:-1]):
            nxt = [] if parts[i + 1].isdigit() else {}
            if isinstance(node, list):
                j = int(part)
                while len(node) <= j:
                    node.append(nxt)
                node = node[j]
            else:
                node = node.setdefault(part, nxt)
        node[parts[-1]] = t
    return root
