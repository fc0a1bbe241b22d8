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
    assert int(count) >= 35  # the modules of the serving and training slices
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


def test_train_replicate_to_is_not_silently_ignored(tmp_path):
    out = _run(["-m", "repro_torch.launch.train", "--arch", "h2o-danube-3-4b",
                "--device", "cpu", "--steps", "1", "--replicate-to", "s3",
                "--ckpt-dir", str(tmp_path)])
    assert out.returncode != 0
    assert "not ported yet" in out.stderr
