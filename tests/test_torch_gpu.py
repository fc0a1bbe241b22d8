"""The port's serving path on the card runs its CUDA kernel once per layer.

It needs a CUDA device and skips without one.  It imports no JAX, so it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The kernel's own cases against its plain versions are checked on the card by
``chip_smoke.py`` (``CHECK_CASES``).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.models.registry import build

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_prefill_runs_kernel_per_layer(cuda):
    cfg = get_config("h2o-danube-3-4b").scaled_down(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    api = build(cfg, cuda)
    params = api.init(torch.Generator(api.device).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 96), device=cuda)
    before = fa_kernel.launches
    with torch.inference_mode():
        logits, _, _ = api.prefill(params, {"tokens": tokens})
        assert fa_kernel.launches == before + cfg.n_layers
        plain = build(dataclasses.replace(cfg, attn_impl="full"), cuda)
        want, _, _ = plain.prefill(params, {"tokens": tokens})
    torch.testing.assert_close(logits, want, rtol=5e-2, atol=5e-2)
