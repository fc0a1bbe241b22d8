"""The hybrid kind (``kinds/prefill_hybrid.py``) on the CPU at a tiny size
through the harness: a sound program reads ``correct`` and the fp8 control
does not, under the cell's limits; four planted faults of the hybrid's own
settings do not, under limits set by the same rule at the tiny size, and the
two of the scan show in ``mamba_err`` alone; the program's
configuration comes first in set-up; the weights fit the program's tree at
the published widths; ``counts_hybrid.py`` at the cell's shapes; and the
readers of the new ranges on made-up traces."""

import dataclasses
import math
from types import SimpleNamespace as NS

import pytest
import torch

from portbench import calibrate, counts_hybrid, harness
from portbench.kinds import prefill_hybrid
from portbench.profiling import Trace
from portbench.tiny import ROOT

CELL = "ai21-jamba2-mini.prefill_16k_64k"
SEED = 2**31 + 11
#: the published block at a tiny width: two periods of 8 layers, 4 experts
TINY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, intermediate_size=96,
            vocab_size=256, num_experts=4, mamba_dt_rank=8, param_dtype="float32",
            compute_dtype="float32")
TRAFFIC = dict(lengths=[16, 24, 40], check_requests=6)


def run(limits=None, **traffic):
    """A run of the cell at the tiny size, judged by the cell's limits or
    by ``limits``.  The kind's clock advances a millisecond a read, so the
    window serves the same requests however loaded the machine is."""
    c = harness.Cell(ROOT, CELL, cfg_overrides=TINY, traffic_overrides={**TRAFFIC, **traffic})
    c.limits = limits or c.limits
    real, now = prefill_hybrid.time, iter(range(10**9))
    prefill_hybrid.time = NS(perf_counter=lambda: next(now) * 1e-3)
    try:
        return harness.run(c, SEED, 0.1, False, device="cpu")
    finally:
        prefill_hybrid.time = real


@pytest.fixture(scope="module")
def tiny_limits():
    """The cell's rule for its limits (``calibrate.limit``) applied at the
    tiny size: between the sound program's readings and the fp8 control's.
    The cell's own limits rest on bf16 readings at full width, which a
    fault in a 64-wide fp32 model need not exceed."""
    sound = {k: v["value"] for k, v in run()["check"].items()}
    prefill_hybrid.Bench.stand_in = "fp8"
    try:
        control = {k: v["value"] for k, v in run()["check"].items()}
    finally:
        prefill_hybrid.Bench.stand_in = None
    assert all(control[k] >= 3 * max(sound[k], 1e-6) for k in sound), (sound, control)
    return {k: calibrate.limit(max(sound[k], 1e-6), control[k]) for k in sound}


def test_a_sound_hybrid_run_is_correct():
    out = run()
    assert out["correct"], out["check"]
    assert set(out["check"]) == set(prefill_hybrid.JUDGED)
    assert out["attempted"] >= 3 and out["failed"] == 0
    assert set(out["metrics"]) == {"prefill_tok_s", "ttft_p95_ms", "setup_s"}


def test_logit_gap_is_printed_and_not_judged(capsys):
    """The cell's limits name the judged numbers alone; ``logit_gap``, which
    one request's expert dropped at capacity can dominate, is printed."""
    assert set(harness.Cell(ROOT, CELL).limits) == set(prefill_hybrid.JUDGED)
    assert "logit_gap" not in run()["check"]
    assert "logit_gap " in capsys.readouterr().err


def test_the_control_is_not_correct(monkeypatch):
    monkeypatch.setattr(prefill_hybrid.Bench, "stand_in", "fp8")
    out = run()
    assert not out["correct"], out["check"]


def shared_decay_row(monkeypatch):
    """Every channel scans with channel 0's decays."""
    from repro_torch.kernels.selective_scan import ops

    scan = ops.selective_scan
    monkeypatch.setattr(ops, "selective_scan", lambda u, dt, A, *a, **k: scan(
        u, dt, A[:1].expand_as(A), *a, **k))


def carry_dropped(monkeypatch):
    """The scan starts each chunk of its plain form from a zero state."""
    from repro_torch.kernels.selective_scan import ops

    chunked = ops.selective_scan_chunked

    def no_carry(u, dt, A, B, C, D=None, s0=None, *, chunk=16):
        parts = [chunked(u[:, t:t + chunk], dt[:, t:t + chunk], A, B[:, t:t + chunk],
                         C[:, t:t + chunk], D, s0 if t == 0 else None, chunk=chunk)
                 for t in range(0, u.shape[1], chunk)]
        return torch.cat([y for y, _ in parts], 1), parts[-1][1]

    monkeypatch.setattr(ops, "selective_scan_chunked", no_carry)


def rope_applied(monkeypatch):
    from repro_torch.models import transformer

    attn = transformer.attention_apply
    monkeypatch.setattr(transformer, "attention_apply",
                        lambda *a, use_rope=True, **k: attn(*a, use_rope=True, **k))


def gates_renormalised(monkeypatch):
    from repro_torch.models import transformer

    moe = transformer.moe_apply
    monkeypatch.setattr(transformer, "moe_apply", lambda p, x, cfg: moe(p, x, dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, renormalize=True))))


@pytest.mark.parametrize("fault", [shared_decay_row, carry_dropped, rope_applied,
                                   gates_renormalised])
def test_a_broken_hybrid_is_not_correct(monkeypatch, tiny_limits, fault):
    fault(monkeypatch)
    out = run(tiny_limits)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("fault", [shared_decay_row, carry_dropped])
def test_a_broken_scan_shows_in_mamba_err_alone(monkeypatch, tiny_limits, fault):
    """A fault of the scan moves the first Mamba layer's output beyond its
    limit by itself, whatever the logits read."""
    fault(monkeypatch)
    got = run(tiny_limits)["check"]["mamba_err"]
    assert got["value"] > got["limit"], got


def test_set_up_builds_the_program_config_before_the_weights(monkeypatch):
    """A program that lacks the hybrid's settings fails before any weight
    is drawn (a parent tree: ``TypeError`` from its ``ArchConfig``)."""
    def older(cfg):
        raise TypeError("ArchConfig.__init__() got an unexpected keyword argument 'attn_offset'")

    def no_draw(*a, **k):
        raise AssertionError("weights drawn before the program's configuration")

    monkeypatch.setattr(prefill_hybrid, "port_config", older)
    monkeypatch.setattr(prefill_hybrid, "draw", no_draw)
    with pytest.raises(TypeError):
        run()


def full_cfg():
    return harness.Cell(ROOT, CELL).cfg


def test_the_leaves_fit_the_program_tree_at_the_published_widths():
    from repro_torch.models.convert import flatten
    from repro_torch.models.registry import build

    cfg = full_cfg()
    api = build(prefill_hybrid.port_config(cfg), "meta")
    flat = {p: torch.empty(s, dtype=getattr(torch, dt), device="meta")
            for p, s, dt, _, _ in prefill_hybrid.leaves(cfg)}
    prefill_hybrid.check_layout(flatten(api.abstract_params()), flat)
    assert api.cfg.block_pattern() == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3


def test_the_programs_own_init_draws_as_the_benchmark_does():
    """The program's Mamba-1 init (used by its tests) and the benchmark's
    draw share their ranges: ``dt_range`` and ``a_log_spread``."""
    from repro_torch.models import transformer

    cfg = full_cfg()
    assert transformer.DT_RANGE == tuple(cfg["dt_range"])
    assert transformer.A_LOG_SPREAD == cfg["a_log_spread"]


def test_parameters_by_part_at_the_published_widths():
    """16 of 32 layers: 26.05 B parameters, 52.1 GB in bf16."""
    by = {}
    for path, shape, _, _, _ in prefill_hybrid.leaves(full_cfg()):
        part = next((k for k in ("mamba", "attn", "moe", "mlp") if f"/{k}/" in path), "rest")
        by[part] = by.get(part, 0) + math.prod(shape)
    per_mamba = (4096 * 16384 + 4 * 8192 + 8192 + 8192 * 288 + 256 + 32 + 256 * 8192
                 + 8192 + 8192 * 16 + 8192 + 8192 * 4096)
    assert by["mamba"] == 14 * per_mamba and round(per_mamba / 1e6, 1) == 105.3
    assert by["attn"] == 2 * (4096 * (4096 + 2 * 1024) + 4096 * 4096)
    assert by["mlp"] == 8 * 3 * 4096 * 14336
    assert by["moe"] == 8 * (4096 * 16 + 16 * 3 * 4096 * 14336)
    assert by["rest"] == 2 * 65536 * 4096 + 4096 + 16 * 2 * 4096
    assert round(sum(by.values()) / 1e9, 2) == 26.05


@pytest.mark.parametrize("S", [16384, 32768, 49152, 65536])
def test_prefill_flops_at_the_cells_lengths(S):
    cfg = full_cfg()
    d, di, f = 4096, 8192, 14336
    mamba = d * 2 * di + di * (256 + 32) + 256 * di + di * d
    attn = d * (32 + 16) * 128 + 32 * 128 * d
    active = 14 * mamba + 2 * attn + 8 * 3 * d * f + 8 * (d * 16 + 2 * 3 * d * f)
    pairs = S * (S + 1) // 2
    want = 2 * active * S + 2 * d * 65536 + 2 * 4 * 128 * 32 * pairs
    assert counts_hybrid.prefill_flops(cfg, 1, S) == want
    assert 11.5e9 < 2 * active < 11.7e9           # about 11.6 GFLOP a token, attention aside


def test_the_scan_bound_at_65536():
    cfg = full_cfg()
    nbytes, ops = counts_hybrid.scan_work(cfg, 1, 65536)
    assert nbytes == (65536 * 8192 * (2 + 4 + 2) + 2 * 65536 * 16 * 2 + 4 * 8192 * 16
                      + 4 * 8192 + 4 * 8192 * 16)
    assert ops == 5 * 16 * 8192 * 65536
    # bound by bytes: 1.28 ms at 3.35 TB/s, against 0.64 ms of operations at 67 TFLOP/s
    assert counts_hybrid.scan_bound_s(cfg, 1, 65536) == pytest.approx(nbytes / 3.35e12)
    assert counts_hybrid.n_mamba(cfg) == 14


CPU, CUDA = NS(name="CPU"), NS(name="CUDA")


def ev(name, dev, a, b, ann=False):
    return NS(name=name, device_type=dev, time_range=NS(start=a, end=b), is_user_annotation=ann)


def traced(ranges: bool) -> Trace:
    """Two calls; each mixer's mix, scan and mix again, then an FFN kernel."""
    events = []
    for c0 in (0, 1000):
        events += [ev("portbench/call", CPU, c0, c0 + 900, True),
                   ev("portbench/call", CUDA, c0, c0 + 900, True)]
        spans = [("mamba/mix", c0, c0 + 100), ("mamba/scan", c0 + 100, c0 + 300),
                 ("mamba/mix", c0 + 300, c0 + 400)]
        for name, a, b in spans:
            if ranges:
                events += [ev(name, CPU, a, b, True), ev(name, CUDA, a, b, True)]
            events.append(ev("k", CUDA, a, b))
        events.append(ev("gemm", CUDA, c0 + 400, c0 + 900))
    return Trace.from_events(events, 2e-3)


def test_the_mamba_readers_on_a_made_up_trace():
    cfg = full_cfg()
    bench = NS(cfg=cfg, traced_calls=[(1, 16384), (1, 65536)])
    read = lambda name, tr: harness.load_reader(name).read(bench, tr)
    tr = traced(True)
    assert read("mamba_ms.prefill_hybrid", tr) == pytest.approx(0.4)   # 400 us a call
    assert read("mamba_scan_ms.prefill_hybrid", tr) == pytest.approx(0.2)
    bound = 14 * (counts_hybrid.scan_bound_s(cfg, 1, 16384) + counts_hybrid.scan_bound_s(cfg, 1, 65536))
    assert read("scan_roofline.prefill_hybrid", tr) == pytest.approx(100 * bound / 400e-6)
    # a program without the ranges (the parent) gives the readers nothing
    bare = traced(False)
    for name in ("mamba_ms.prefill_hybrid", "mamba_scan_ms.prefill_hybrid",
                 "scan_roofline.prefill_hybrid"):
        assert read(name, bare) is None
