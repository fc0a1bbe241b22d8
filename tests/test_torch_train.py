"""Whole-model training parity: the port's loss, gradients and train step
against ``repro`` on the reference's own parameters, for three dense
scaled-down configs, rwkv6 (its scan through ``SSMScan``'s plain
backward), the two MoE configs (the load-balance loss in the objective),
jamba, whisper (the encoder and cross-attention under block remat) and
llava (image embeddings spliced in) in fp32; then the port's ports of the runtime tests
(tests/test_runtime.py): AdamW on a quadratic, the loss going down and a
restart after preemption."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes; leave the cores to the other test workers

from repro.configs import get_config as jax_get_config
from repro.models import build as jax_build
from repro.optim import OptimizerConfig as JaxOptimizerConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.runtime.steps import make_train_step as jax_make_train_step
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.connectors import PosixConnector
from repro_torch.data import DataPipelineConfig, ShardedTokenDataset, synthetic_corpus
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.models.convert import flatten, params_from_jax
from repro_torch.models.registry import build
from repro_torch.optim import OptimizerConfig, adamw_init, adamw_update
from repro_torch.runtime.steps import make_train_state, make_train_step, value_and_grad
from repro_torch.runtime.train import TrainLoopConfig, run_training

ARCHS = ["h2o-danube-3-4b", "qwen1.5-0.5b", "granite-20b", "rwkv6-7b",
         "granite-moe-1b-a400m", "dbrx-132b", "jamba-1.5-large-398b", "whisper-medium",
         "llava-next-mistral-7b"]
TOL = dict(rtol=1e-4, atol=1e-4)
S = 128  # two logit chunks and two attention chunks of the scaled-down configs
#: eps sits well above the fp32 noise of vanishing gradient entries: at step 1
#: Adam moves each parameter by lr·g/(|g|+eps), whose slope lr/(4·eps) near
#: |g| = eps would turn a 1e-8 difference in a gradient of 1e-8 into a 1e-4
#: difference in the parameter
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-6,
           state_dtype="float32")


def _setup(arch, seed, batch):
    jcfg = jax_get_config(arch).scaled_down()
    japi = jax_build(jcfg)
    jparams = jax.jit(japi.init)(jax.random.PRNGKey(seed))
    api = build(get_config(arch).scaled_down(), "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab_size, (batch, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((batch, 1), -1, np.int32)], axis=1)
    labels[0, :5] = -1  # some ignored positions inside the sequence too
    data = {"tokens": tokens, "labels": labels}
    if jcfg.is_encdec:
        data["audio_embeds"] = rng.standard_normal(
            (batch, jcfg.encdec.n_audio_ctx, jcfg.d_model)).astype(np.float32)
    if jcfg.vlm is not None:
        data["image_embeds"] = rng.standard_normal(
            (batch, jcfg.vlm.n_image_tokens, jcfg.vlm.patch_dim)).astype(np.float32)
    return japi, jparams, api, params, data


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=what, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    japi, jparams, api, params, batch = _setup(arch, seed=0, batch=2)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    before = fa_kernel.launches
    loss, metrics, grads = value_and_grad(api, params, _torch_batch(batch))
    assert fa_kernel.launches == before  # the CPU path launches no kernel
    _close(loss.numpy(), jloss, "loss")
    _close(metrics["xent"].numpy(), jmetrics["xent"], "xent")
    _close(metrics["moe_aux"].numpy(), jmetrics["moe_aux"], "moe_aux")
    assert (float(metrics["moe_aux"]) > 0) == (api.cfg.moe is not None)
    want = flatten(jax.tree.map(np.asarray, jgrads))
    got = flatten(grads)
    assert set(got) == set(want)
    for path in want:
        assert got[path].dtype == params_from_jax(want[path], "cpu").dtype
        _close(got[path].numpy(), want[path], path)


@pytest.mark.parametrize("arch,accum", [(a, 1) for a in ARCHS] + [("h2o-danube-3-4b", 2)])
def test_train_step_matches_jax(arch, accum):
    japi, jparams, api, params, batch = _setup(arch, seed=1, batch=4)
    jopt = JaxOptimizerConfig(**OPT)
    jstate = {"params": jparams, "opt": jax_adamw_init(jparams, jopt)}
    jstate, jm = jax.jit(jax_make_train_step(japi, jopt, accum_steps=accum))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    opt = OptimizerConfig(**OPT)
    state = {"params": params, "opt": adamw_init(params, opt)}
    state, m = make_train_step(api, opt, accum_steps=accum)(state, _torch_batch(batch))
    for key in ("loss", "grad_norm", "lr"):
        _close(float(m[key]), jm[key], key)
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 1
    want = flatten(jax.tree.map(np.asarray, jstate))
    got = flatten(state)
    assert set(got) == set(want)
    for path in want:
        _close(got[path].numpy(), want[path], path)


def test_adamw_converges_quadratic():
    opt = OptimizerConfig(peak_lr=0.1, warmup_steps=0, total_steps=200,
                          weight_decay=0.0, state_dtype="float32")
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params, opt)

    def loss(p):
        return torch.sum(p["w"] ** 2)

    for _ in range(150):
        w = params["w"].detach().requires_grad_()
        g, = torch.autograd.grad(loss({"w": w}), [w])
        params, state, m = adamw_update(params, {"w": g}, state, opt)
    assert float(loss(params)) < 1e-2
    assert int(state["step"]) == 150


def _runtime_setup(tmp_path, steps=12):
    """tests/test_runtime.py::_setup in the port."""
    cfg = get_config("qwen1.5-0.5b").scaled_down(
        n_layers=2, d_model=64, d_ff=128, vocab_size=256, n_heads=2,
        n_kv_heads=2, d_head=32)
    api = build(cfg, "cpu")
    store = PosixConnector(str(tmp_path))
    synthetic_corpus(store, "corpus", vocab_size=cfg.vocab_size, seq_len=32,
                     n_records=64, records_per_shard=16)
    ds = ShardedTokenDataset(store, "corpus",
                             DataPipelineConfig(seq_len=32, batch_size=4))
    opt = OptimizerConfig(peak_lr=1e-3, warmup_steps=2, total_steps=steps,
                          state_dtype="float32")
    return api, store, ds, opt


def test_loss_decreases(tmp_path):
    api, store, ds, opt = _runtime_setup(tmp_path, steps=30)
    loop = TrainLoopConfig(total_steps=30, log_every=5, ckpt_every=1000)
    res = run_training(api, opt, loop, ds)
    first = res.losses[0][1]
    last = res.losses[-1][1]
    assert last < first, (first, last)
    assert len(res.step_seconds) == 30


def test_preemption_restart_resumes(tmp_path):
    """Kill training mid-run; the restart resumes from the latest
    checkpoint (step AND data cursor), not from scratch, with the state
    the checkpoint holds."""
    api, store, ds, opt = _runtime_setup(tmp_path, steps=12)
    mgr = CheckpointManager(store, "ckpt")
    loop = TrainLoopConfig(total_steps=12, log_every=4, ckpt_every=4,
                           fail_at_step=9)
    state = make_train_state(api, opt)
    with pytest.raises(RuntimeError, match="injected failure"):
        run_training(api, opt, loop, ds, ckpt_mgr=mgr, state=state)
    assert int(state["opt"]["step"]) == 8  # updated in place up to the failure

    # fresh pipeline objects, as after a real preemption
    ds2 = ShardedTokenDataset(store, "corpus",
                              DataPipelineConfig(seq_len=32, batch_size=4))
    mgr2 = CheckpointManager(store, "ckpt")
    restored, step = mgr2.restore_latest(state)
    assert step == 8
    for path, leaf in flatten(state).items():
        assert torch.equal(flatten(restored)[path], leaf), path
    loop2 = TrainLoopConfig(total_steps=12, log_every=4, ckpt_every=4)
    res = run_training(api, opt, loop2, ds2, ckpt_mgr=mgr2)
    assert res.restored_from == 8
    assert res.steps_run == 4  # only steps 9..12 re-run
    # data cursor resumed past the consumed batches
    assert ds2.state()["record"] > 0 or ds2.state()["shard"] > 0
