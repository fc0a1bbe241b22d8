"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``repro.models.moe`` on the same numpy inputs and the reference's own
parameters, in fp32: tests/test_moe.py's six invariants, each held to the
reference's numbers too, then the ungated (GELU) experts and the refused
sharding pins.  Router logits are drawn at random, so no two of a token's
probabilities tie and ``torch.topk`` and ``jax.lax.top_k`` pick the same
experts."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes; leave the cores to the other test workers

from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax

TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_moe.py's token-independence limit


def mk_cfgs(E=4, k=2, cf=1.25, d=32, f=64, gated=True):
    """tests/test_moe.py::mk_cfg in both packages."""
    def mk(common):
        return common.ArchConfig(arch_id="t", family="moe", n_layers=2, d_model=d,
                                 n_heads=4, n_kv_heads=4, d_ff=f, vocab_size=64,
                                 moe=common.MoEConfig(n_experts=E, top_k=k, capacity_factor=cf),
                                 gated_mlp=gated, param_dtype="float32",
                                 compute_dtype="float32")
    return mk(jcommon), mk(tcommon)


def _setup(jcfg, shape, seed=0):
    p = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    x = np.random.default_rng(seed + 1).standard_normal(shape).astype(np.float32)
    return p, x


def _both(p, x, jcfg, tcfg):
    """(y, aux) of the reference and of the port on the same inputs."""
    jy, jaux = jmoe.moe_apply(p, jnp.asarray(x), jcfg)
    y, aux = tmoe.moe_apply(params_from_jax(jax.tree.map(np.asarray, p), "cpu"),
                            torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for key in ("moe_aux", "moe_drop_frac"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), rtol=1e-5, atol=1e-7,
                                   err_msg=key)
    return y, aux


def test_capacity_formula():
    for E, k, cf, n, want in ((8, 2, 1.0, 128, 32), (8, 2, 1.25, 128, 40),
                              (8, 2, 1.25, 1, 8), (32, 8, 1.25, 2048, 640),
                              (16, 2, 1.25, 5120, 800)):
        jcfg, tcfg = mk_cfgs(E=E, k=k, cf=cf)
        assert tmoe.capacity(n, tcfg) == jmoe.capacity(n, jcfg) == want


def test_moe_output_finite_and_shaped():
    jcfg, tcfg = mk_cfgs()
    p, x = _setup(jcfg, (2, 16, jcfg.d_model))
    y, aux = _both(p, x, jcfg, tcfg)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert float(aux["moe_aux"]) > 0.0


def test_moe_no_drops_at_high_capacity():
    jcfg, tcfg = mk_cfgs(cf=8.0)
    p, x = _setup(jcfg, (2, 32, jcfg.d_model))
    _, aux = _both(p, x, jcfg, tcfg)
    assert float(aux["moe_drop_frac"]) == 0.0


def test_moe_drops_at_tiny_capacity():
    """Capacity drops follow the token-major queue order: the same slots
    drop, and a dropped slot's zeros added at C - 1 leave the kept token
    there intact (an assignment in place of the add would zero it)."""
    jcfg, tcfg = mk_cfgs(E=4, k=2, cf=0.3)
    p, x = _setup(jcfg, (4, 64, jcfg.d_model))
    y, aux = _both(p, x, jcfg, tcfg)
    assert float(aux["moe_drop_frac"]) > 0.0
    assert torch.isfinite(y).all()


def test_moe_token_independence_at_high_capacity():
    """With no drops, each token's output is independent of the other
    tokens in the batch (routing is per-token)."""
    jcfg, tcfg = mk_cfgs(cf=8.0)
    p, x = _setup(jcfg, (1, 8, jcfg.d_model))
    y_full, _ = _both(p, x, jcfg, tcfg)
    y_tok, _ = _both(p, np.ascontiguousarray(x[:, 3:4]), jcfg, tcfg)
    np.testing.assert_allclose(y_full[:, 3].numpy(), y_tok[:, 0].numpy(), **TOL)


def test_moe_gate_renormalization():
    """Uniform router logits with k = E: every expert is chosen with gate
    1 / E, so the output is the mean of the per-expert FFNs (the order in
    which tied experts come out of top-k does not matter here)."""
    jcfg, tcfg = mk_cfgs(E=4, k=4, cf=8.0)
    p, x = _setup(jcfg, (1, 8, jcfg.d_model))
    p["router"]["w"] = jnp.zeros_like(p["router"]["w"])
    y, _ = _both(p, x, jcfg, tcfg)
    outs = []
    for e in range(4):
        pe = {"router": p["router"], **{n: p[n][e:e + 1].repeat(4, 0) for n in ("wi", "wg", "wo")}}
        ye, _ = tmoe.moe_apply(params_from_jax(jax.tree.map(np.asarray, pe), "cpu"),
                               torch.from_numpy(x), tcfg)
        outs.append(ye.numpy())
    np.testing.assert_allclose(y.numpy(), np.mean(outs, axis=0), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["default_capacity", "drops"])
def test_moe_ungated_experts_match_jax(cf):
    """Non-gated experts: GELU in its tanh form, jax.nn.gelu's default."""
    jcfg, tcfg = mk_cfgs(E=8, k=2, cf=cf, gated=False)
    p, x = _setup(jcfg, (2, 24, jcfg.d_model), seed=3)
    assert "wg" not in p
    _both(p, x, jcfg, tcfg)


def test_moe_grads_match_jax():
    """The gradients of sum(y w) + aux through the scatter, the expert
    products and the gather, for the router and every expert weight."""
    jcfg, tcfg = mk_cfgs(E=4, k=2, cf=0.75)
    p, x = _setup(jcfg, (2, 16, jcfg.d_model), seed=5)
    w = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_apply(p, x, jcfg)
        return jnp.sum(y * w) + aux["moe_aux"]

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    tp = params_from_jax(jax.tree.map(np.asarray, p), "cpu")
    leaves = [tp["router"]["w"], tp["wi"], tp["wg"], tp["wo"], torch.from_numpy(x)]
    for t in leaves:
        t.requires_grad_()
    y, aux = tmoe.moe_apply(tp, leaves[-1], tcfg)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux["moe_aux"], leaves)
    want = [jgp["router"]["w"], jgp["wi"], jgp["wg"], jgp["wo"], jgx]
    for g, jg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("pin", ["expert", "capacity"])
def test_moe_shard_constraints_match_jax(pin):
    """The dispatch-buffer pins, with no sharding rules installed, are the
    identity in both packages: the pinned layer equals JAX's pinned layer,
    drops included (capacity factor 0.75).  Under a 2x2 mesh they are held
    to the unsharded port in tests/test_torch_cells.py."""
    jcfg, tcfg = mk_cfgs(cf=0.75)
    jcfg, tcfg = (dataclasses.replace(c, moe_shard_constraints=pin) for c in (jcfg, tcfg))
    p, x = _setup(jcfg, (2, 16, jcfg.d_model), seed=8)
    _, aux = _both(p, x, jcfg, tcfg)
    assert float(aux["moe_drop_frac"]) > 0
