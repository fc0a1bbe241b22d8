"""The port's kernels on the card: the serving path runs the flash kernel
once per layer, and the lanesum32 kernel agrees bit for bit with its plain
version.

It needs a CUDA device and skips without one.  It imports no JAX, so it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The flash kernel's own cases against its plain versions are checked on the
card by ``chip_smoke.py`` (``CHECK_CASES``), and so are the checksum kernel's
larger ones (above 2 GiB).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.kernels.checksum import kernel as cs_kernel
from repro_torch.kernels.checksum.ops import checksum_digests
from repro_torch.kernels.checksum.ref import digest_of, lanesum32_torch
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


def test_checksum_kernel_matches_plain(cuda):
    """Bit-exact on tail lengths, bf16, a 0-d tensor, a transposed tensor,
    views at unaligned storage offsets and a buffer of several MB."""
    gen = torch.Generator(cuda).manual_seed(0)
    big = torch.randn(3 * 2**20 + 7, generator=gen, device=cuda)
    b8 = torch.randint(0, 256, (4099,), generator=gen, device=cuda, dtype=torch.uint8)
    xs = [b8[:n] for n in (0, 1, 2, 3, 5, 7)]
    xs += [b8[o:o + 1000] for o in (1, 2, 3, 4, 12)]  # every alignment mod 16
    xs += [big.to(torch.bfloat16)[1:1002], torch.tensor(-7, dtype=torch.int32, device=cuda),
           big[:999 * 37].reshape(999, 37).T, big]
    before = cs_kernel.launches
    got = checksum_digests(xs)
    torch.cuda.synchronize()
    assert cs_kernel.launches == before + len(xs)
    assert got == [digest_of(*lanesum32_torch(x)) for x in xs]
    flipped = big.clone()
    flipped.view(torch.int32)[12345] ^= 1 << 7
    assert checksum_digests([flipped]) != checksum_digests([big])
