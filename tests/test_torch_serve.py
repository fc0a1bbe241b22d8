"""Whole-model serving parity: the port's prefill and greedy decode against
``repro.models`` on the reference's own parameters, for three dense
scaled-down configs, rwkv6-7b (the ssm family), the two MoE configs and
jamba (mamba2 and attention, with MoE) in fp32."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes; leave the cores to the other test workers

from repro.configs import get_config as jax_get_config
from repro.models import build as jax_build
from repro_torch.configs import get_config
from repro_torch.models.convert import flatten, params_from_jax
from repro_torch.models.registry import build
from repro_torch.runtime.steps import make_serve_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["h2o-danube-3-4b", "qwen1.5-0.5b", "granite-20b", "rwkv6-7b",
         "granite-moe-1b-a400m", "dbrx-132b", "jamba-1.5-large-398b"]
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, STEPS = 2, 32, 4


def _drop_free(cfg):
    """``cfg`` with MoE capacity to spare: the full pass then drops no token
    that the one-token decode would keep (tests/test_arch_smoke.py)."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def _setup(arch, seed, drop_free=False):
    jcfg = jax_get_config(arch).scaled_down()
    cfg = get_config(arch).scaled_down()
    if drop_free:
        jcfg, cfg = _drop_free(jcfg), _drop_free(cfg)
    japi = jax_build(jcfg)
    jparams = jax.jit(japi.init)(jax.random.PRNGKey(seed))
    api = build(cfg, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return japi, jparams, api, params, tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_jax(arch):
    japi, jparams, api, params, tokens = _setup(arch, seed=0)
    max_seq = S + STEPS
    jlogits, jcache, _ = jax.jit(lambda p, b: japi.prefill(p, b, pad_to=max_seq))(
        jparams, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        logits, cache, pos = api.prefill(params, {"tokens": torch.from_numpy(tokens)},
                                         pad_to=max_seq)
    assert pos == S
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert set(cache) == set(jcache)
    for key in cache:
        assert cache[key].shape == jcache[key].shape, key
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]), **TOL)

    jdecode = jax.jit(japi.decode)
    serve_step = make_serve_step(api, greedy=False)
    tok = np.asarray(jnp.argmax(jlogits[:, -1], -1)).astype(np.int32)[:, None]
    for i in range(STEPS):
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(tok), jnp.int32(S + i))
        with torch.inference_mode():
            logits, cache = serve_step(params, cache, torch.from_numpy(tok), S + i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        jtok = np.asarray(jnp.argmax(jlogits[:, -1], -1)).astype(np.int32)
        np.testing.assert_array_equal(logits[:, -1].argmax(-1).numpy(), jtok)
        tok = jtok[:, None]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """Decode logits after a prefill match a prefill of the extended
    sequence (tests/test_arch_smoke.py::test_prefill_decode_consistency)."""
    _, _, api, params, tokens = _setup(arch, seed=2, drop_free=True)
    tokens = torch.from_numpy(tokens)
    with torch.inference_mode():
        logits_p, cache, pos = api.prefill(params, {"tokens": tokens}, pad_to=S + 4)
        assert logits_p.shape == (B, 1, api.cfg.vocab_size)
        assert torch.isfinite(logits_p).all()
        next_tok = logits_p[:, -1].argmax(-1).to(torch.int32)[:, None]
        logits_d, cache = api.decode(params, cache, next_tok, S)
        assert logits_d.shape == (B, 1, api.cfg.vocab_size)
        assert torch.isfinite(logits_d).all()
        ext = torch.cat([tokens, next_tok], dim=1)
        logits_full, _, _ = api.prefill(params, {"tokens": ext})
    np.testing.assert_allclose(logits_d[:, 0].numpy(), logits_full[:, -1].numpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "rwkv6-7b", "granite-moe-1b-a400m",
                                  "jamba-1.5-large-398b"])
def test_param_tree_layout_matches_jax(arch):
    """Same paths, shapes and dtypes as the reference tree, so weights carry
    across as a byte copy (bf16 included, and the fp32 leaves inside a bf16
    tree: rwkv6's ``u`` and ``decay_bias``, the MoE ``router``, mamba's
    ``A_log``, ``dt_bias`` and ``D``)."""
    jcfg = jax_get_config(arch).scaled_down(param_dtype="bfloat16")
    jparams = jax.jit(jax_build(jcfg).init)(jax.random.PRNGKey(0))
    jflat = {"/".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    ported = flatten(params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"))
    assert list(ported) == list(jflat)
    own = flatten(build(get_config(arch).scaled_down(param_dtype="bfloat16"), "cpu")
                  .init(torch.Generator().manual_seed(0)))
    assert list(own) == list(jflat)
    for path, leaf in jflat.items():
        assert tuple(own[path].shape) == leaf.shape, path
        want_dtype = torch.bfloat16 if leaf.dtype == jnp.bfloat16 else torch.float32
        assert own[path].dtype == ported[path].dtype == want_dtype, path
        np.testing.assert_array_equal(ported[path].reshape(-1).view(torch.uint8).numpy(),
                                      np.asarray(leaf).reshape(-1).view(np.uint8))


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-mistral-7b"])
def test_unported_family_raises(arch):
    """The encoder-decoder and VLM families are not ported yet (ROADMAP A11)."""
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        build(get_config(arch).scaled_down(), "cpu")


def _serve_cli(arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--device", "cpu", "--requests", "2", "--prompt-len", "16", "--gen-len", "4"],
        env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "prefill 2x16" in out.stdout and "decoded 3 steps x 2 seqs" in out.stdout


def test_serve_cli_cpu():
    _serve_cli("h2o-danube-3-4b")


def test_serve_cli_cpu_rwkv6():
    _serve_cli("rwkv6-7b")


def test_serve_cli_cpu_granite_moe():
    _serve_cli("granite-moe-1b-a400m")


def test_serve_cli_cpu_jamba():
    _serve_cli("jamba-1.5-large-398b")
