"""The reductions over the program's own ranges (``spans.py``) and the
readers built on them, on made-up traces in the profiler's own booking: a
kernel belongs to the innermost range open where it was launched, and a
range's device extent runs from the first to the last of its own kernels."""

from types import SimpleNamespace as NS

import pytest

from portbench import harness, readers, spans
from portbench.profiling import CALL_RANGE, Trace

CPU, CUDA = NS(name="CPU"), NS(name="CUDA")
NEW = {"moe_experts_ms.train", "ffn_bwd_ms.train", "mixer_bwd_ms.train", "recompute_ms.train",
       "head_loss_ms.train", "embed_ms.train", "untraced_share.train",
       "program_idle_ms.train", "mixer_ms.prefill", "ffn_ms.prefill",
       "untraced_share.prefill", "program_idle_ms.prefill", "block_slices_bwd_ms.train"}
ONE_STEP = NS(traced_calls=[(2, 4096)])


def ev(name, dev, a, b, ann=False):
    return NS(name=name, device_type=dev, time_range=NS(start=a, end=b), is_user_annotation=ann)


def rng(name, a, b, dev=CUDA):
    return ev(name, dev, a, b, True)


def kernels(*spans_):
    return [ev("k", CUDA, a, b) for a, b in spans_]


# One training step.  Forward: layer/ffn's own kernels around moe/dispatch.
# Backward, from the head's to the embedding's: layer/ffn/backward's own
# kernels around the block's recompute, whose range owns its first kernels
# and the recomputed mixer, while the recomputed ffn, the recompute's tail,
# lies past its extent; then layer/mixer/backward's own kernels around
# flash_attention/plain_backward; then the block's parameter slices'
# gradients, the embedding's backward, AdamW and a kernel in no layer.
STEP = [
    rng(CALL_RANGE, 0, 1000, CPU), rng("train_step/loss_and_grad", 5, 700, CPU),
    rng("train_step/adamw", 700, 800, CPU),
    rng(CALL_RANGE, 100, 460), rng("train_step/loss_and_grad", 350, 360),
    rng("layer/ffn", 100, 150), rng("moe/dispatch", 110, 130),
    *kernels((100, 110), (110, 130), (130, 150)),
    rng("model/head_loss/backward", 190, 199), *kernels((190, 199)),
    rng("layer/ffn/backward", 200, 260), *kernels((200, 210), (241, 260)),
    rng("block/recompute", 212, 220), *kernels((212, 214), (218, 220)),
    rng("layer/mixer", 214, 218), *kernels((214, 218)),
    rng("layer/ffn", 221, 240), *kernels((221, 240)),
    rng("layer/mixer/backward", 270, 310), *kernels((270, 280), (301, 310)),
    rng("flash_attention/plain_backward", 281, 300), *kernels((281, 300)),
    rng("model/block_slices/backward", 311, 318), *kernels((311, 318)),
    rng("model/embed/backward", 320, 330), *kernels((320, 330)),
    *kernels((350, 360)),
    rng("train_step/adamw", 400, 450), *kernels((400, 450)),
]


def test_self_time_leaves_out_the_ranges_nested_in_the_extent():
    tr = Trace.from_events(STEP, wall_s=1e-3)
    # layer/ffn/backward's own 10 + 19 us, not the recompute's 27 inside it
    assert spans.self_ms_per_call(ONE_STEP, tr, "layer/ffn/backward") == pytest.approx(0.029)
    assert readers.busy_ms_per_call(ONE_STEP, tr, ("layer/ffn/backward",)) == pytest.approx(0.056)
    assert spans.self_ms_per_call(ONE_STEP, tr, "layer/mixer/backward") == pytest.approx(0.019)
    # a leaf's self time is its busy time; an absent range reads nothing
    assert spans.self_ms_per_call(ONE_STEP, tr, "moe/dispatch") == pytest.approx(0.020)
    assert spans.self_ms_per_call(ONE_STEP, tr, "moe/experts") is None
    assert spans.self_ms_per_call(NS(traced_calls=[]), tr, "moe/dispatch") is None


def test_the_recompute_holds_its_tail_past_its_own_extent():
    tr = Trace.from_events(STEP, wall_s=1e-3)
    assert spans.backward_windows(tr) == [(190, 330)]
    # own 2 + 2, the recomputed mixer 4 and ffn 19; the forward's ffn is not in it
    assert spans.recompute_ms_per_call(ONE_STEP, tr) == pytest.approx(0.027)
    assert readers.busy_ms_per_call(ONE_STEP, tr, ("block/recompute",)) == pytest.approx(0.008)
    assert harness.load_reader("recompute_ms.train").read(ONE_STEP, tr) == pytest.approx(0.027)
    assert harness.load_reader("ffn_bwd_ms.train").read(ONE_STEP, tr) == pytest.approx(0.029)
    assert harness.load_reader("mixer_bwd_ms.train").read(ONE_STEP, tr) == pytest.approx(0.019)
    # the slices' gradients: a backward range, not part of the recompute
    assert harness.load_reader("block_slices_bwd_ms.train").read(ONE_STEP, tr) == (
        pytest.approx(0.007))


def test_untraced_share_whole_half_and_a_trace_without_the_layers():
    tr = Trace.from_events(STEP, wall_s=1e-3)
    total = sum(b - a for a, b, _ in tr.kernels)
    assert spans.untraced_share(tr) == pytest.approx(100 * 10 / total)   # the kernel at 350
    whole = [rng("layer/mixer", 0, 10), rng("layer/ffn", 10, 20), *kernels((0, 10), (10, 20))]
    assert spans.untraced_share(Trace.from_events(whole, 1e-3)) == 0.0
    half = [rng("layer/mixer", 0, 10), rng("layer/ffn", 10, 20), rng(CALL_RANGE, 0, 40),
            rng("runtime/prefill_step", 20, 40), *kernels((0, 10), (10, 20), (20, 40))]
    assert spans.untraced_share(Trace.from_events(half, 1e-3)) == pytest.approx(50.0)
    # a program without the layer ranges reads nothing
    old = [rng("moe/dispatch", 0, 10), *kernels((0, 10), (10, 20))]
    assert spans.untraced_share(Trace.from_events(old, 1e-3)) is None


def test_idle_gaps_inside_and_outside_the_hosts_program_ranges():
    events = [*kernels((0, 10), (30, 40), (60, 70), (90, 100)),
              rng(CALL_RANGE, 0, 120, CPU),
              ev("runtime/prefill_step", CPU, 15, 35),          # a host range alone
              rng("train_step/loss_and_grad", 75, 200, CPU), rng("layer/mixer", 78, 79, CPU)]
    tr = Trace.from_events(events, wall_s=1e-3)
    calls = NS(traced_calls=[(1, 8), (1, 8)])
    assert [g for g in spans.idle_gaps(tr)] == [(10, 30), (40, 60), (70, 90)]
    # the gap at 20 falls in the prefill step; the one at 50 in the call alone
    assert spans.idle_ms_per_call_in(calls, tr, ("runtime/prefill_step",)) == pytest.approx(0.01)
    # the gap at 80 falls in the step, past the end of a range nested in it
    assert spans.idle_ms_per_call_in(calls, tr, ("train_step/loss_and_grad", "layer/mixer")) == (
        pytest.approx(0.01))
    assert spans.idle_ms_per_call_in(calls, tr, ("train_step/adamw",)) is None
    assert harness.load_reader("program_idle_ms.prefill").read(calls, tr) == pytest.approx(0.01)


def test_new_readers_read_nothing_from_a_program_without_their_ranges():
    """The parent program opens only the step's and the kernels' ranges:
    every new reader of a range this program adds returns None, and
    ``program_idle_ms.train``, which reads the step's own, a number."""
    old = [rng(CALL_RANGE, 0, 100, CPU), rng("train_step/loss_and_grad", 0, 60, CPU),
           rng("train_step/adamw", 60, 90, CPU), rng(CALL_RANGE, 0, 100),
           rng("moe/dispatch", 0, 10), rng("flash_attention/plain_backward", 20, 40),
           rng("train_step/adamw", 70, 90), *kernels((0, 10), (20, 40), (70, 90))]
    tr = Trace.from_events(old, wall_s=1e-3)
    read = {m: harness.load_reader(m).read(ONE_STEP, tr) for m in NEW}
    assert read.pop("program_idle_ms.train") == pytest.approx(0.04)
    assert all(v is None for v in read.values()), read


def test_the_new_metrics_are_listed_with_their_cells_and_read_program_spans():
    man = harness.manifest(harness.HERE.parent)
    listed = {m["name"]: m for m in man["per_layer"]}
    assert NEW <= listed.keys()
    for name in NEW:
        m, reader = listed[name], harness.load_reader(name)
        assert (reader.LAYER, reader.UNIT, reader.MOVES, reader.SOURCE) == (
            m["layer"], m["unit"], m["moves"], m["source"]) and m["source"] == "program_span"
        kind = "train" if name.endswith(".train") else "prefill"
        assert m["workloads"] and all(harness.Cell(harness.HERE.parent, w).traffic["kind"] == kind
                                      for w in m["workloads"])


# The step before and after the layer ranges: the same kernels, some of
# them booked to the new ranges (innermost booking), around the old ranges,
# whose extents stay.
OLD = [rng(CALL_RANGE, 0, 1000, CPU), rng(CALL_RANGE, 0, 500),
       rng("train_step/loss_and_grad", 0, 320), rng("moe/dispatch", 100, 130),
       rng("moe/combine", 150, 170), rng("flash_attention/plain_backward", 280, 300),
       rng("train_step/adamw", 400, 450), ev("attn_fwd_bf16_tma_kernel", CUDA, 60, 90),
       *kernels((0, 60), (90, 100), (100, 130), (130, 150), (150, 170), (170, 180),
                (200, 210), (270, 280), (280, 300), (300, 310), (310, 320), (400, 450),
                (490, 500))]
AROUND = [rng("layer/ffn", 90, 180), rng("moe/experts", 130, 150),
          rng("layer/mixer/backward", 270, 310), rng("model/block_slices/backward", 310, 320),
          rng("layer/ffn", 90, 180, CPU), rng("layer/mixer/backward", 270, 310, CPU)]


@pytest.mark.parametrize("metric", ["moe_ms.train", "attn_bwd_ms.train", "adamw_ms.train",
                                    "loss_grad_ms.train", "flash_roofline.train"])
def test_existing_readings_stay_with_the_new_ranges_around_the_old(metric):
    reader = harness.load_reader(metric)
    bench = NS(cfg={"n_heads": 2, "n_kv_heads": 1, "head_dim": 8, "swa_window": None},
               traced_calls=[(1, 8)])
    before = reader.read(bench, Trace.from_events(OLD, wall_s=1e-3))
    after = reader.read(bench, Trace.from_events(OLD + AROUND, wall_s=1e-3))
    assert after == before
