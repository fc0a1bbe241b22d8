"""The card path's profiler ranges (``repro_torch/obs/ranges.py``) on the
CPU, on a scaled-down granite-moe (MoE, tied head, remat "block") and a
scaled-down dense Llama (h2o-danube-3-4b):

* under ``torch.profiler`` a train step and a prefill step open every
  range of the layers, forward and backward, and each ``*/backward``
  range closes on the thread it opened on;
* the recompute of a block nests in its ffn's backward, the plain
  attention backward in the mixer's; the stacked parameters' slice
  gradients lie in a range of each block's own, apart from every layer's;
* every op of the step's forward and backward that does work lies in a
  layer range, but for the step's own few (the MoE losses' sum over blocks,
  the loss's sum, autograd's seed);
* the prefill call's first op in no program range comes before its
  attention, so the benchmark's call range has a device extent from then;
* the loss, every gradient and a prefill's logits are bit-equal with and
  without an active profiler, under "block" and "dots";
* with no profiler active, the loss's graph holds no marker node and no
  range is entered.
"""

import dataclasses
import threading
from collections import Counter

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes; leave the cores to the other test workers

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.convert import flatten, unflatten  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.obs import ranges  # noqa: E402
from repro_torch.optim import OptimizerConfig, adamw_init  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402

ARCHS = {"moe": "granite-moe-1b-a400m", "dense": "h2o-danube-3-4b"}
S = 64
#: ranges that hold a whole step, not a layer
STEP_RANGES = {"train_step/loss_and_grad", "runtime/prefill_step"}
LAYER_RANGES = {"model/embed", "layer/mixer", "layer/ffn", "model/final_norm"}
SLICES = "model/block_slices/backward"
TRAIN_RANGES = ({"train_step/loss_and_grad", "train_step/adamw", "model/head_loss",
                 "block/recompute", "flash_attention/plain_backward", SLICES}
                | LAYER_RANGES | {r + "/backward" for r in LAYER_RANGES | {"model/head_loss"}})
PREFILL_RANGES = LAYER_RANGES | {"model/cache", "model/head"}
MOE_RANGES = {"moe/dispatch", "moe/experts", "moe/combine"}
#: ops that launch no kernel: views and metadata
VIEWS = {"aten::detach", "aten::select", "aten::view", "aten::view_as", "aten::t",
         "aten::numpy_T",
         "aten::permute", "aten::transpose", "aten::expand", "aten::alias", "aten::slice",
         "aten::reshape", "aten::unsqueeze", "aten::as_strided"}


def _model(family, remat="block"):
    cfg = dataclasses.replace(get_config(ARCHS[family]).scaled_down(), remat=remat)
    api = build(cfg, "cpu")
    gen = torch.Generator("cpu").manual_seed(0)
    params = api.init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, S), generator=gen)
    labels = torch.cat([tokens[:, 1:], torch.full((2, 1), -1)], dim=1)
    return api, params, {"tokens": tokens, "labels": labels}


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _ranges(events, names):
    """(start, end, thread) of each host occurrence of the ranges ``names``."""
    return sorted((e.time_range.start, e.time_range.end, e.thread)
                  for e in events if e.name in names)


def _inside(span, outer) -> bool:
    return any(a <= span[0] and span[1] <= b and t == span[2] for a, b, t in outer)


def _overlaps(span, others) -> bool:
    return any(a < span[1] and span[0] < b and t == span[2] for a, b, t in others)


def _train_step(api, params):
    opt = OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    state = {"params": params, "opt": adamw_init(params, opt)}
    return lambda batch: steps.make_train_step(api, opt)(state, batch)


@pytest.mark.parametrize("family", list(ARCHS))
def test_every_range_opens_and_each_backward_closes_on_its_thread(family, monkeypatch):
    api, params, batch = _model(family)
    opened, closed = {}, []
    open_bwd, close_bwd = ranges._Open.backward, ranges._Close.backward
    open_slices, close_pending = ranges._OpenSlices.backward, ranges._close_pending

    def opening(ctx, g):
        opened[id(ctx.marks)] = threading.get_ident()
        return open_bwd(ctx, g)

    def closing(ctx, g):
        closed.append(opened.pop(id(ctx.marks)) == threading.get_ident())
        return close_bwd(ctx, g)

    def opening_slices(ctx, *gs):
        out = open_slices(ctx, *gs)
        opened[id(ranges._pending.rf)] = threading.get_ident()
        return out

    def closing_pending():
        rf = getattr(ranges._pending, "rf", None)
        if rf is not None:
            closed.append(opened.pop(id(rf)) == threading.get_ident())
        close_pending()

    monkeypatch.setattr(ranges._Open, "backward", staticmethod(opening))
    monkeypatch.setattr(ranges._Close, "backward", staticmethod(closing))
    monkeypatch.setattr(ranges._OpenSlices, "backward", staticmethod(opening_slices))
    monkeypatch.setattr(ranges, "_close_pending", closing_pending)
    moe = MOE_RANGES if family == "moe" else set()
    _, events = _profiled(lambda: _train_step(api, params)(batch))
    user = {e.name for e in events if e.is_user_annotation}
    assert TRAIN_RANGES | moe <= user, sorted(TRAIN_RANGES | moe - user)
    n_backward = sum(1 for e in events if e.name.endswith("/backward")
                     and e.is_user_annotation)
    # embedding, final norm, head; each sublayer; each block's slices
    assert len(closed) == n_backward == 3 + 2 * api.cfg.n_layers + api.cfg.n_blocks
    assert all(closed) and not opened

    with torch.no_grad():
        _, events = _profiled(lambda: steps.make_prefill_step(api)(params, batch))
    user = {e.name for e in events if e.is_user_annotation}
    assert PREFILL_RANGES | moe <= user, sorted(PREFILL_RANGES | moe - user)
    assert not {n for n in user if n.endswith("backward") or n == "block/recompute"}
    # the prefill step's own range is on the host alone
    step = [e for e in events if e.name == "runtime/prefill_step"]
    assert len(step) == 1 and not step[0].is_user_annotation


@pytest.mark.parametrize("family", list(ARCHS))
def test_recompute_and_plain_backward_nest_in_the_layers_backward(family):
    api, params, batch = _model(family)
    _, events = _profiled(lambda: steps.value_and_grad(api, params, batch))
    ffn_bwd = _ranges(events, {"layer/ffn/backward"})
    mixer_bwd = _ranges(events, {"layer/mixer/backward"})
    recompute = _ranges(events, {"block/recompute"})
    plain = _ranges(events, {"flash_attention/plain_backward"})
    assert len(recompute) == len(plain) == api.cfg.n_blocks
    assert all(_inside(r, ffn_bwd) for r in recompute)
    assert all(_inside(r, mixer_bwd) for r in plain)
    # the recompute's forward ranges run inside it
    assert all(_inside(r, recompute) for r in _ranges(events, {"layer/mixer"})[api.cfg.n_layers:])
    # each block's slice gradients after its layers' backwards, apart from every layer range
    slices = _ranges(events, {SLICES})
    assert len(slices) == api.cfg.n_blocks
    layers = _ranges(events, {r for r in {e.name for e in events if e.is_user_annotation}
                              if r not in STEP_RANGES and r != SLICES})
    assert not any(_overlaps(r, layers) for r in slices)


def _unranged_ops(events, within: str) -> list:
    """(start, name) of the top-level ops (in no other op) that lie inside
    the ranges ``within`` and in no layer range (any user range but the
    step's and ``within``), in order."""
    outer = _ranges(events, {within})
    layers = [(e.time_range.start, e.time_range.end, e.thread) for e in events
              if e.is_user_annotation and e.name not in STEP_RANGES and e.name != within]
    out = []
    for e in events:
        if e.is_user_annotation or not e.name.startswith("aten::"):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("aten::"):
            parent = parent.cpu_parent
        at = (e.time_range.start, e.time_range.end, e.thread)
        if parent is None and _inside(at, outer) and not _inside(at, layers):
            out.append((e.time_range.start, e.name))
    return sorted(out)


def _outside_layers(events) -> Counter:
    """The train step's top-level ops that lie in no layer range, by name."""
    return Counter(name for _, name in _unranged_ops(events, "train_step/loss_and_grad"))


@pytest.mark.parametrize("family", list(ARCHS))
def test_every_op_of_the_forward_and_backward_lies_in_a_layer_range(family):
    """Outside every layer: views, the MoE losses' zero starts (the model's
    and each block's) and their sum over blocks, the loss's sum ``xent +
    aux_weight * aux`` (and its backward's product, with MoE), autograd's
    seed gradient and, with a tied head, the sum of the table's two
    gradients."""
    api, params, batch = _model(family)
    _, events = _profiled(lambda: _train_step(api, params)(batch))
    glue = Counter({k: n for k, n in _outside_layers(events).items() if k not in VIEWS})
    n = api.cfg.n_blocks
    want = ({"aten::zeros": 1 + n, "aten::mul": 2, "aten::add": 2 + n, "aten::ones_like": 1}
            if family == "moe" else
            {"aten::zeros": 1 + n, "aten::mul": 1, "aten::add": 1 + n, "aten::ones_like": 1})
    assert glue == Counter(want)


@pytest.mark.parametrize("family", list(ARCHS))
def test_the_prefill_calls_first_unranged_op_comes_before_its_attention(family):
    """A range's device extent runs from the first to the last kernel booked
    to it, and a kernel is booked to the innermost range open where it was
    launched.  So the benchmark's own range around a prefill call
    (``portbench/call``) has a device extent from the first kernel the step
    launches in no program range, the MoE losses' zero start before the
    blocks, to the argmax after the step: the call's attention lies in it
    only while that kernel comes before the first ``layer/mixer``."""
    api, params, batch = _model(family)
    prefill = steps.make_prefill_step(api)

    def call():
        with torch.profiler.record_function("portbench/call"):
            logits, _ = prefill(params, batch)
            return torch.argmax(logits[:, -1], dim=-1)

    with torch.no_grad():
        _, events = _profiled(call)
    unranged = [(at, name) for at, name in _unranged_ops(events, "portbench/call")
                if name not in VIEWS]
    mixer = _ranges(events, {"layer/mixer"})
    assert unranged[0] == (unranged[0][0], "aten::zeros") and unranged[0][0] < mixer[0][0]
    assert unranged[-1][1] == "aten::argmax" and unranged[-1][0] > mixer[-1][1]


def _loss_and_grads(api, params, batch):
    loss, _, grads = steps.value_and_grad(api, params, batch)
    return loss, flatten(grads)


@pytest.mark.parametrize("remat", ["block", "dots"])
@pytest.mark.parametrize("family", list(ARCHS))
def test_loss_grads_and_logits_are_bit_equal_under_the_profiler(family, remat):
    api, params, batch = _model(family, remat)
    loss, grads = _loss_and_grads(api, params, batch)
    (loss_p, grads_p), events = _profiled(lambda: _loss_and_grads(api, params, batch))
    assert {"block/recompute", "layer/ffn/backward"} <= {e.name for e in events}
    assert torch.equal(loss, loss_p)
    assert grads.keys() == grads_p.keys()
    assert all(torch.equal(grads[k], grads_p[k]) for k in grads)
    prefill = steps.make_prefill_step(api)
    with torch.no_grad():
        logits, cache = prefill(params, batch)
        (logits_p, cache_p), _ = _profiled(lambda: prefill(params, batch))
    assert torch.equal(logits, logits_p)
    assert all(torch.equal(cache[k], cache_p[k]) for k in cache)


def _graph_nodes(loss) -> list:
    seen, todo = set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(fn for fn, _ in node.next_functions)
    return [n.name() for n in seen]


@pytest.mark.parametrize("family", list(ARCHS))
def test_without_a_profiler_no_marker_node_and_no_range(family, monkeypatch):
    api, params, batch = _model(family)
    entered = Counter()
    rf_enter = torch.autograd.profiler.record_function.__enter__

    def counting(self):
        entered[self.name] += 1
        return rf_enter(self)

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", counting)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name, *a: entered.update([name]) or pytest.fail(name))

    def graph():
        leaves = {k: v.detach().requires_grad_() for k, v in flatten(params).items()}
        loss, _ = api.loss(unflatten(params, leaves), batch)
        return _graph_nodes(loss)

    nodes = graph()
    assert not [n for n in nodes if any(m in n for m in ("_Open", "_Close", "_Flush"))]
    _train_step(api, params)(batch)
    with torch.no_grad():
        steps.make_prefill_step(api)(params, batch)
    assert not entered
    # under the profiler the same graph gains the markers: two per sublayer, one
    # per block's slices, one on the stacked parameters
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        marked = graph()
    assert entered["layer/ffn"] == entered["layer/mixer"] == api.cfg.n_layers
    markers = [n for n in marked if n in ("_OpenBackward", "_CloseBackward",
                                          "_OpenSlicesBackward", "_FlushBackward")]
    assert markers and len(marked) - len(nodes) == len(markers)
