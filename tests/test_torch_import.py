"""The port stands alone: importing it pulls in neither ``jax``,
``ml_dtypes`` (the machine with the card has no JAX, so no ``ml_dtypes``
either) nor any module of the reference package ``repro``; asked for
``cuda`` without a card, its entry points raise."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes; leave the cores to the other test workers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "ml_dtypes", "repro")
             or m.startswith(("jax.", "jaxlib.", "ml_dtypes.", "repro.")))
print(len(names), bad)
"""


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], env=env, capture_output=True,
                          text=True, timeout=120, cwd=ROOT, **kw)


def test_import_leaves_out_jax_and_reference():
    out = _run(["-c", IMPORT_ALL])
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 90  # the model stack, the transfer planes and the linter
    assert bad == "[]"


def test_serve_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    out = _run(["-m", "repro_torch.launch.serve", "--arch", "h2o-danube-3-4b",
                "--requests", "1", "--prompt-len", "8", "--gen-len", "2"])
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr


def test_train_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    out = _run(["-m", "repro_torch.launch.train", "--arch", "h2o-danube-3-4b",
                "--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr


def test_train_replicate_to_replicates(tmp_path):
    """``--replicate-to s3`` on the CPU mirrors every save through the
    port's transfer service."""
    out = _run(["-m", "repro_torch.launch.train", "--arch", "h2o-danube-3-4b",
                "--device", "cpu", "--steps", "4", "--ckpt-every", "2", "--log-every", "2",
                "--replicate-to", "s3", "--ckpt-dir", str(tmp_path)])
    assert out.returncode == 0, out.stderr
    assert "replicated step 2: SUCCEEDED" in out.stdout
    assert "replicated step 4: SUCCEEDED" in out.stdout


def test_train_replicas_restore(tmp_path):
    """The launcher's replicator at work in-process: each save's task
    succeeds with integrity on, and the mirror restores byte for byte what
    the cluster store holds."""
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.launch import train as launch_train
    from repro_torch.models.convert import flatten
    from repro_torch.runtime.steps import make_train_state
    from repro_torch.runtime.train import run_training

    s = launch_train.setup(launch_train.parse_args(
        ["--arch", "h2o-danube-3-4b", "--device", "cpu", "--steps", "4", "--ckpt-every", "2",
         "--log-every", "4", "--replicate-to", "s3", "--ckpt-dir", str(tmp_path)]))
    assert s.loop.replicate_every == 2
    state = make_train_state(s.api, s.opt, torch.Generator().manual_seed(0))
    try:
        run_training(s.api, s.opt, s.loop, s.data, ckpt_mgr=s.ckpt,
                     replicator=s.replicator, state=state)
    finally:
        s.replicator.service.default_manager().shutdown(wait=True, timeout=60)
    assert [step for step, _, _ in s.replicator.done] == [2, 4]
    for _, task, _ in s.replicator.done:
        assert task.status == task.SUCCEEDED, task.events
        assert task.stats.integrity_failures == 0 and task.stats.files_done > 1
    mirror = s.replicator.mirror
    restored, step = restore_checkpoint(state, mirror.connector, mirror.path, step=4,
                                        credential=s.replicator.service.creds.lookup("mirror"))
    assert step == 4
    for path, want in flatten(state).items():
        got = flatten(restored)[path]
        assert got.dtype == want.dtype and torch.equal(
            got.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8)), path


#: the modules the transfer plane added; each, imported first and alone,
#: leaves the reference out
PLANE_MODULES = [
    "repro_torch.core.clock", "repro_torch.core.integrity", "repro_torch.core.faults",
    "repro_torch.core.perfmodel", "repro_torch.core.health", "repro_torch.core.transfer",
    "repro_torch.core.manager", "repro_torch.obs.trace", "repro_torch.obs.metrics",
    "repro_torch.svc.bus", "repro_torch.connectors.memory", "repro_torch.connectors.cloud",
    "repro_torch.ckpt.replicate", "repro_torch.catalog.replica",
    "repro_torch.connectors.faultproxy", "repro_torch.fed.coordinator",
    "repro_torch.sim.scenarios", "repro_torch.lint.engine",
]


@pytest.mark.parametrize("module", PLANE_MODULES)
def test_plane_module_imports_alone_without_reference(module):
    out = _run(["-c", f"import {module}, sys\n"
                      "print(sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'repro')"
                      " or m.startswith(('jax.', 'jaxlib.', 'repro.'))))"])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_chip_smoke_imports_neither_jax_nor_reference():
    """Every import in chip_smoke.py, those inside its functions included,
    names neither ``jax`` nor the reference package."""
    import ast
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert "repro_torch.launch" in names  # the walk sees the function-local imports
    bad = [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro")]
    assert bad == []
