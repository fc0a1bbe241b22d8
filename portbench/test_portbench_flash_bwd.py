"""``flash_bwd_roofline.train`` on a made-up timeline: the backward's bound
over the device time of its kernels, and nothing where the backward ran no
kernel of its own."""

from types import SimpleNamespace as NS

import pytest

from portbench import counts, harness
from portbench.profiling import Trace
from portbench.test_portbench_trace import CUDA, EVENTS, ev


def test_flash_bwd_roofline_reads_the_backward_kernels():
    """``flash_bwd_roofline.train``: each call's ``attn_bwd_main`` launches
    times one backward's bound (2.5 x the forward's FLOPs, 2 x its bytes),
    over the device time of every ``attn_bwd_`` kernel in the call (prep,
    main, dQ), the forward's kernels left out; a trace without them (the
    plain backward) reads nothing."""
    bwd = [ev("attn_bwd_prep", CUDA, 20, 30), ev("attn_bwd_main<1>", CUDA, 30, 90),
           ev("attn_bwd_dq", CUDA, 90, 100),
           ev("attn_bwd_prep", CUDA, 610, 620), ev("attn_bwd_main<1>", CUDA, 620, 640),
           ev("attn_bwd_dq", CUDA, 640, 650)]
    tr = Trace.from_events(EVENTS + bwd, wall_s=1e-3)
    cfg = {"n_heads": 2, "n_kv_heads": 1, "head_dim": 8, "swa_window": None}
    bench = NS(cfg=cfg, traced_calls=[(1, 4), (1, 8)])
    reader = harness.load_reader("flash_bwd_roofline.train")
    bound = reader.launch_bound_s(cfg, 1, 4) + reader.launch_bound_s(cfg, 1, 8)
    assert reader.read(bench, tr) == pytest.approx(100 * bound / 120e-6)
    nbytes, flops = counts.attention_work(1, 8, 8, 2, 1, 8, True, None, 2)
    assert reader.launch_bound_s(cfg, 1, 8) == counts.bound_s(2.5 * flops, 2 * nbytes)
    assert reader.read(bench, Trace.from_events(EVENTS, wall_s=1e-3)) is None
    assert reader.read(NS(cfg=cfg, traced_calls=[(1, 4)]), tr) is None
