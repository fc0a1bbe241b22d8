"""The trace's reductions and the per-layer readers on a made-up timeline:
busy time as a union, busy time inside a range, kernels by call, idle
gaps named by the host's work, and the readers built on them."""

from types import SimpleNamespace as NS

import pytest

from portbench import counts, harness, readers
from portbench.profiling import CALL_RANGE, Trace

CPU, CUDA = NS(name="CPU"), NS(name="CUDA")


def ev(name, dev, a, b, ann=False):
    return NS(name=name, device_type=dev, time_range=NS(start=a, end=b), is_user_annotation=ann)


EVENTS = [
    # host: two calls, the second inside moe/dispatch, an op in each
    ev(CALL_RANGE, CPU, 0, 500, True), ev("moe/dispatch", CPU, 100, 300, True),
    ev("aten::nonzero", CPU, 150, 250), ev(CALL_RANGE, CPU, 500, 1000, True),
    # device: the ranges' extents and the kernels
    ev(CALL_RANGE, CUDA, 10, 400, True), ev(CALL_RANGE, CUDA, 600, 900, True),
    ev("moe/dispatch", CUDA, 10, 120, True),
    ev("gemm", CUDA, 10, 60), ev("gemm", CUDA, 50, 100),      # overlap: union 90
    ev("attn_fwd_bf16_tma_kernel", CUDA, 300, 400),           # gap 100-300 (host in nonzero)
    ev("attn_fwd_bf16_tma_kernel", CUDA, 600, 700), ev("gemm", CUDA, 700, 900),
]


def test_busy_union_ranges_and_calls():
    tr = Trace.from_events(EVENTS, wall_s=1e-3)
    assert tr.busy_s == pytest.approx((90 + 100 + 300) / 1e6)
    assert tr.busy_in_s("moe/dispatch") == pytest.approx(100 / 1e6)   # the two gemms
    assert tr.busy_in_s("train_step/adamw") is None
    assert tr.calls == [(10, 400), (600, 900)]
    assert [k[0] for k in tr.kernels_named(("attn_fwd",), call=1)] == [600]
    assert tr.top_ops()[0] == ["gemm", pytest.approx(300 / 1e6)]


def test_idle_gaps_are_named_by_the_host():
    tr = Trace.from_events(EVENTS, wall_s=1e-3)
    gaps = dict(map(tuple, tr.idle_gaps()))
    assert gaps["moe/dispatch > aten::nonzero"] == pytest.approx(200 / 1e6)
    assert gaps[CALL_RANGE] == pytest.approx(200 / 1e6)               # 400-600, no op open


def test_readers_on_the_made_up_trace():
    tr = Trace.from_events(EVENTS, wall_s=1e-3)
    cfg = {"n_heads": 2, "n_kv_heads": 1, "head_dim": 8, "swa_window": None}
    bench = NS(cfg=cfg, traced_calls=[(1, 4), (1, 8)], window_flops=counts.PEAK_BF16_FLOPS,
               window_s=4.0, host_s=[0.001, 0.003])
    bound = counts.flash_launch_bound_s(cfg, 1, 4) + counts.flash_launch_bound_s(cfg, 1, 8)
    want = 100 * bound / 200e-6
    assert harness.load_reader("flash_roofline.prefill").read(bench, tr) == pytest.approx(want)
    assert harness.load_reader("idle_share.prefill").read(bench, tr) == pytest.approx(
        100 * (1 - 490e-6 / 1e-3))
    assert harness.load_reader("mfu.train").read(bench, tr) == pytest.approx(25.0)
    assert harness.load_reader("host_ms.prefill").read(bench, tr) == pytest.approx(2.0)
    assert readers.busy_ms_per_call(bench, tr, ("moe/dispatch",)) == pytest.approx(0.05)
    # a range the trace lacks, or calls the trace lost, read nothing
    assert harness.load_reader("adamw_ms.train").read(bench, tr) is None
    assert readers.flash_roofline(NS(**{**vars(bench), "traced_calls": [(1, 4)]}), tr,
                                  ("attn_fwd",)) is None


def test_a_listed_metric_that_reads_nothing_is_named_on_stderr(monkeypatch, capsys):
    """The made-up trace has no ``train_step/adamw`` range: the traced line
    leaves ``adamw_ms.train`` out and standard error says why."""
    from portbench import tiny

    kind = harness.kind_module("train")

    def profile(self):
        self.traced_calls = [(1, 4), (1, 8)]
        return Trace.from_events(EVENTS, wall_s=1e-3)

    monkeypatch.setattr(kind.Bench, "profile", profile)
    out = harness.run(tiny.cell("granite-moe-1b-a400m.train_4k"), 7, 0.2, True, device="cpu")
    assert "adamw_ms.train" not in out["metrics"] and "flash_roofline.train" in out["metrics"]
    assert "portbench: adamw_ms.train found nothing to read" in capsys.readouterr().err
