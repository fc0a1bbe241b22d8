"""``remat="dots"``: the reference's ``jax.checkpoint`` with the
``dots_with_no_batch_dims_saveable`` policy over the decoder blocks, in the
port a selective checkpoint (``models/transformer.py::DOTS_SAVEABLE``).

* The loss and every gradient of a 2-block scaled-down config of each
  family (dense, MoE, rwkv6, jamba, whisper, llava) equal the reference's
  ``jax.value_and_grad`` under ``"dots"`` at tests/test_torch_train.py's
  tolerance, and the port's ``"block"`` within 1e-6 in fp32.
* A dispatch recorder: the backward under ``"dots"`` runs as many
  ``aten.mm`` / ``aten.addmm`` as under ``"block"`` less the blocks' forward
  ones (those it saved), and every ``aten.bmm`` again; the encoder's blocks
  get no remat under ``"dots"``.

The dry run's counts under ``"dots"`` are in tests/test_torch_dryrun.py,
its 2x2 gloo train steps in tests/test_torch_cells.py.
"""

import dataclasses
from collections import Counter

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes; leave the cores to the other test workers

from torch.utils.checkpoint import set_checkpoint_early_stop  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import flatten, params_from_jax, unflatten  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.roofline import ProductCounter  # noqa: E402
from repro_torch.runtime.steps import value_and_grad  # noqa: E402

FAMILIES = {"dense": "h2o-danube-3-4b", "moe": "granite-moe-1b-a400m", "rwkv6": "rwkv6-7b",
            "jamba": "jamba-1.5-large-398b", "whisper": "whisper-medium",
            "llava": "llava-next-mistral-7b"}
#: against the reference: tests/test_torch_train.py's tolerance
TOL = dict(rtol=1e-4, atol=1e-4)
#: "dots" against the port's own "block", fp32: a remat recomputes the same
#: ops on the same inputs
REMAT_TOL = 1e-6
S = 128


def _batch(cfg, seed, batch=2):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((batch, 1), -1, np.int32)], axis=1)
    data = {"tokens": tokens, "labels": labels}
    if cfg.is_encdec:
        data["audio_embeds"] = rng.standard_normal(
            (batch, cfg.encdec.n_audio_ctx, cfg.d_model)).astype(np.float32)
    if cfg.vlm is not None:
        data["image_embeds"] = rng.standard_normal(
            (batch, cfg.vlm.n_image_tokens, cfg.vlm.patch_dim)).astype(np.float32)
    return data


def _port(arch, remat, params, batch):
    api = build(dataclasses.replace(get_config(arch).scaled_down(), remat=remat), "cpu")
    loss, metrics, grads = value_and_grad(api, params,
                                          {k: torch.from_numpy(v) for k, v in batch.items()})
    return loss, flatten(grads)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_dots_loss_and_grads_match_jax_and_block(family):
    arch = FAMILIES[family]
    jcfg = dataclasses.replace(jax_get_config(arch).scaled_down(), remat="dots")
    assert jcfg.n_blocks == 2
    japi = jax_build(jcfg)
    jparams = jax.jit(japi.init)(jax.random.PRNGKey(3))
    batch = _batch(jcfg, seed=3)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    loss, grads = _port(arch, "dots", params, batch)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), err_msg="loss", **TOL)
    want = flatten(jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(want)
    for path in want:
        np.testing.assert_allclose(grads[path].numpy(), want[path], err_msg=path, **TOL)
    loss_b, grads_b = _port(arch, "block", params, batch)
    assert abs(loss.item() - loss_b.item()) <= REMAT_TOL
    for path, g in grads_b.items():
        assert (grads[path] - g).abs().max().item() <= REMAT_TOL, path


def _record(arch, remat, monkeypatch):
    """(forward counts, backward counts, the decoder's and the encoder's
    blocks' forward counts) of one loss and gradient under ``remat``."""
    cfg = dataclasses.replace(get_config(arch).scaled_down(), remat=remat)
    api = build(cfg, "cpu")
    params = api.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=4).items()}
    # the decoder's blocks call block_apply causal, the encoder's non-causal
    rec = ProductCounter(scopes=("decoder", "encoder"))
    block_apply = tf.block_apply

    def counted(*args, causal=True, **kw):
        outer, rec.scope = rec.scope, "decoder" if causal else "encoder"
        try:
            return block_apply(*args, causal=causal, **kw)
        finally:
            rec.scope = outer

    leaves = {k: v.detach().requires_grad_() for k, v in flatten(params).items()}
    # with early stop (the default) the recompute ends once it has remade
    # the last tensor the backward needs, skipping a block's trailing ops
    with monkeypatch.context() as mp, set_checkpoint_early_stop(False):
        mp.setattr(tf, "block_apply", counted)
        with rec:
            loss, _ = api.loss(unflatten(params, leaves), batch)
        fwd, rec.ops = rec.ops, Counter()
        blocks = {k: Counter(v) for k, v in rec.scoped.items()}
        with rec:
            torch.autograd.grad(loss, list(leaves.values()))
    return fwd, rec.ops, blocks


@pytest.mark.parametrize("family", list(FAMILIES))
def test_dots_backward_recomputes_all_but_the_saved_products(family, monkeypatch):
    """Under "block" the backward reruns every block's forward, products
    included; under "dots" it reruns the decoder blocks but takes their
    ``mm`` / ``addmm`` outputs from what the forward saved, and leaves the
    encoder's blocks (no remat under "dots") alone: its ``aten.mm`` count is
    block's less the blocks' forward count, and its ``aten.bmm`` count
    (attention's einsums, the experts' batched products: recomputed) is
    block's less the encoder's."""
    arch = FAMILIES[family]
    fwd_b, bwd_b, _ = _record(arch, "block", monkeypatch)
    fwd_d, bwd_d, _ = _record(arch, "dots", monkeypatch)
    fwd_n, bwd_n, blocks = _record(arch, "none", monkeypatch)
    dec, enc = blocks["decoder"], blocks["encoder"]
    assert fwd_b == fwd_d == fwd_n
    assert dec["mm"] > 0 and (enc["mm"] > 0) == get_config(arch).is_encdec
    for op in ("mm", "addmm", "bmm"):
        assert bwd_b[op] == bwd_n[op] + dec[op] + enc[op], op
    for op in ("mm", "addmm"):
        assert bwd_d[op] == bwd_b[op] - dec[op] - enc[op], op
    assert bwd_d["bmm"] == bwd_b["bmm"] - enc["bmm"]
