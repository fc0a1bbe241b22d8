"""Whole-model serving parity: the port's prefill and greedy decode against
``repro.models`` on the reference's own parameters, for three dense
scaled-down configs, rwkv6-7b (the ssm family), the two MoE configs,
jamba (mamba2 and attention, with MoE), whisper (an encoder and
cross-attention, fed audio embeddings) and llava (image embeddings in place
of the first token embeddings) in fp32."""

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
         "granite-moe-1b-a400m", "dbrx-132b", "jamba-1.5-large-398b", "whisper-medium",
         "llava-next-mistral-7b"]
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
    return japi, jparams, api, params, _batch(jcfg, seed)


def _batch(cfg, seed):
    """Prompt tokens and, for whisper and llava, the audio or image embeddings,
    numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.is_encdec:
        batch["audio_embeds"] = rng.standard_normal(
            (B, cfg.encdec.n_audio_ctx, cfg.d_model)).astype(np.float32)
    if cfg.vlm is not None:
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.vlm.n_image_tokens, cfg.vlm.patch_dim)).astype(np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_jax(arch):
    japi, jparams, api, params, batch = _setup(arch, seed=0)
    max_seq = S + STEPS
    jlogits, jcache, _ = jax.jit(lambda p, b: japi.prefill(p, b, pad_to=max_seq))(
        jparams, _jax(batch))
    with torch.inference_mode():
        logits, cache, pos = api.prefill(params, _torch(batch), pad_to=max_seq)
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
    _, _, api, params, batch = _setup(arch, seed=2, drop_free=True)
    batch = _torch(batch)
    with torch.inference_mode():
        logits_p, cache, pos = api.prefill(params, batch, pad_to=S + 4)
        assert logits_p.shape == (B, 1, api.cfg.vocab_size)
        assert torch.isfinite(logits_p).all()
        next_tok = logits_p[:, -1].argmax(-1).to(torch.int32)[:, None]
        logits_d, cache = api.decode(params, cache, next_tok, S)
        assert logits_d.shape == (B, 1, api.cfg.vocab_size)
        assert torch.isfinite(logits_d).all()
        ext = dict(batch, tokens=torch.cat([batch["tokens"], next_tok], dim=1))
        logits_full, _, _ = api.prefill(params, ext)
    np.testing.assert_allclose(logits_d[:, 0].numpy(), logits_full[:, -1].numpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "whisper-medium"])
def test_decode_pos_as_tensor(arch):
    """``pos`` as a 0-d tensor (the decode cell's abstract input) gives the
    int ``pos``'s logits and caches on the CPU, and on ``meta`` decodes
    without reading its value on the host (before, RoPE's ``torch.full``
    and the cache write called ``.item()``)."""
    cfg = get_config(arch).scaled_down()
    api = build(cfg, "cpu")
    params = api.init(torch.Generator().manual_seed(0))
    batch = _torch(_batch(cfg, 3))
    with torch.inference_mode():
        logits, cache, _ = api.prefill(params, batch, pad_to=S + 2)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        twin = {k: v.clone() for k, v in cache.items()}
        by_int, cache = api.decode(params, cache, tok, S)
        by_tensor, twin = api.decode(params, twin, tok, torch.tensor(S, dtype=torch.int32))
    assert torch.equal(by_int, by_tensor)
    assert all(torch.equal(cache[k], twin[k]) for k in cache)
    meta = build(cfg, "meta")
    out, _ = meta.decode(meta.abstract_params(), meta.make_cache(B, S + 2, abstract=True),
                         torch.empty((B, 1), dtype=torch.int32, device="meta"),
                         torch.empty((), dtype=torch.int32, device="meta"))
    assert out.device.type == "meta" and tuple(out.shape) == (B, 1, cfg.vocab_size)


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "rwkv6-7b", "granite-moe-1b-a400m",
                                  "jamba-1.5-large-398b", "whisper-medium",
                                  "llava-next-mistral-7b"])
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


@pytest.mark.parametrize("arch,enc_len", [("whisper-medium", None), ("whisper-medium", 40),
                                          ("jamba-1.5-large-398b", None), ("rwkv6-7b", None)])
def test_decode_cache_matches_jax(arch, enc_len):
    """``make_cache`` gives the reference's keys, shapes and dtypes, the
    cross-attention caches sized by ``enc_len`` (default ``n_audio_ctx``)."""
    jcache = jax_build(jax_get_config(arch).scaled_down()).make_cache(
        B, S, abstract=True, enc_len=enc_len)
    cache = build(get_config(arch).scaled_down(), "cpu").make_cache(B, S, enc_len=enc_len)
    assert set(cache) == set(jcache)
    for key, leaf in jcache.items():
        assert tuple(cache[key].shape) == leaf.shape, key
        assert str(cache[key].dtype).removeprefix("torch.") == str(leaf.dtype), key
        assert not cache[key].any(), key


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


def test_serve_cli_cpu_whisper():
    _serve_cli("whisper-medium")


def test_serve_cli_cpu_llava():
    _serve_cli("llava-next-mistral-7b")
