"""Profiler ranges of the card path: the steps, the model's layers, forward
and backward, and the kernels' backwards (``flash_attention/plain_backward``
holds the flash backward kernel's launches as well as the plain form's).

The ranges are ``torch.profiler`` ones, on the clock of the device trace,
and exist only while a profiler is active: with none, ``span`` is a no-op
and ``backward_span`` adds no autograd node, so the step runs the graph it
runs unprofiled.

``torch.profiler`` books a kernel to the innermost user range open on the
launching thread, and a range's device extent runs from the first to the
last kernel booked to it: an outer range's extent leaves out the kernels
of the ranges nested in it, and holds them only where its own kernels come
before and after.  ``host_span`` is a range on the host alone: the kernels
launched inside it stay with the enclosing range on the device.

A sublayer's backward runs on autograd's device thread, outside any range
the forward opened.  ``backward_span`` wraps the sublayer's input and
output in identity ``torch.autograd.Function``s that save no tensor: the
output's backward opens ``<name>/backward`` on that thread and the last of
the inputs' closes it, so everything autograd runs between them, the
sublayer's backward and a remat's recompute of the block, lies in the
range.  ``residual_span`` does so for a sublayer and its residual add.

A stacked parameter's slice takes its gradient apart from any layer: autograd
scatters each slice's gradient into the stacked shape and sums them over the
blocks.  ``sliced`` puts that work of one block under ``<name>/backward``,
opened once the block's slices have their gradients and left open until the
next marked backward on the thread begins, so that the sums, which autograd
adds after the scatter has returned, lie inside it.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.autograd.profiler as _profiler
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils._python_dispatch import _disable_current_modes

_OFF = contextlib.nullcontext()


def active() -> bool:
    """Whether a profiler is recording."""
    return _profiler._is_profiler_enabled


def in_backward() -> bool:
    """Whether autograd's engine is running this code: a backward, or a
    remat's recompute inside one."""
    return torch._C._current_graph_task_id() != -1


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records,
    else a no-op."""
    return torch.profiler.record_function(name) if active() else _OFF


def host_span(name: str):
    """A range ``name`` on the host while a profiler records, else a no-op.
    It is not a user range: on the device, the kernels launched inside it
    and in no nested range belong to the range that encloses it."""
    return torch._C._profiler._RecordFunctionFast(name) if active() else _OFF


@contextlib.contextmanager
def recompute_span(name: str):
    """``span(name)`` around a remat's recompute, entered and left outside
    the dispatch modes active there: a selective checkpoint replays the
    forward's ops in order, and ``record_function`` is an op its forward
    never ran."""
    if not active():
        yield
        return
    rf = torch.profiler.record_function(name)
    with _disable_current_modes():
        rf.__enter__()
    try:
        yield
    finally:
        with _disable_current_modes():
            rf.__exit__(None, None, None)


_pending = threading.local()


def _enter(name: str):
    return torch.ops.profiler._record_function_enter_new(name, None)


def _exit(rf) -> None:
    torch.ops.profiler._record_function_exit._RecordFunction(rf)


def _close_pending():
    """Closes the slices' range ``sliced`` left open on this thread, if any."""
    rf = getattr(_pending, "rf", None)
    if rf is not None:
        _pending.rf = None
        _exit(rf)


class _Marks:
    """The range ``name`` of one backward: opened by the output's marker,
    closed by the input's."""

    def __init__(self, name: str):
        self.name, self.opened = name, None


class _Close(torch.autograd.Function):
    """The identity on a sublayer's input; its backward closes the range."""

    @staticmethod
    def forward(ctx, x, marks: _Marks):
        ctx.marks = marks
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _close_pending()
        marks = ctx.marks
        if marks.opened is not None:
            _exit(marks.opened)
            marks.opened = None
        return g, None


class _Open(torch.autograd.Function):
    """The identity on a sublayer's output; its backward opens the range."""

    @staticmethod
    def forward(ctx, y, marks: _Marks):
        ctx.marks = marks
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        _close_pending()
        ctx.marks.opened = _enter(ctx.marks.name)
        return g, None


class _OpenSlices(torch.autograd.Function):
    """The identity on one block's slices of stacked tensors; its backward,
    run once they all have their gradients, opens the slices' range."""

    @staticmethod
    def forward(ctx, name: str, *ts):
        ctx.set_materialize_grads(False)
        ctx.range = name
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        _close_pending()
        _pending.rf = _enter(ctx.range)
        return (None, *gs)


class _Flush(torch.autograd.Function):
    """The identity on stacked tensors; its backward, run once every slice's
    gradient is summed in, closes the last block's slices' range."""

    @staticmethod
    def forward(ctx, *ts):
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        _close_pending()
        return gs


def _needs_grad(t) -> bool:
    return isinstance(t, torch.Tensor) and t.requires_grad


def _marking() -> bool:
    """Whether a profiler records and autograd records this forward (grad
    enabled, not a recompute inside a backward)."""
    return active() and torch.is_grad_enabled() and not in_backward()


def backward_span(name: str, fn, x):
    """``fn(x)`` under ``span(name)``.  While a profiler records and
    autograd records this forward (grad enabled, not a recompute inside a
    backward), the backward from ``fn``'s output (its first element if a
    tuple) to ``x`` runs under ``<name>/backward``."""
    with span(name):
        if not (_marking() and x.requires_grad):
            return fn(x)
        marks = _Marks(name + "/backward")
        out = fn(_Close.apply(x, marks))
        y = out[0] if isinstance(out, tuple) else out
        if not y.requires_grad:
            return out
        y = _Open.apply(y, marks)
        return (y, *out[1:]) if isinstance(out, tuple) else y


def residual_span(name: str, fn, x):
    """A sublayer and its residual, ``x + y`` with y ``fn(x)`` (its first
    element, the rest returned beside the sum, if a tuple), under
    ``backward_span(name)``: the backward range so holds the sum of the
    gradients of x's two uses, taken in the order autograd takes it without
    the range."""
    def sublayer(x):
        out = fn(x)
        return (x + out[0], *out[1:]) if isinstance(out, tuple) else x + out

    return backward_span(name, sublayer, x)


def _replace(tree, new):
    """``tree`` with its tensors that require grad replaced, in order, by
    those of ``new``."""
    new = iter(new)
    return tree_map(lambda t: next(new) if _needs_grad(t) else t, tree)


def sliced(name: str, tree, take):
    """``i -> take(tree, i)``: block i's slices of the stacked ``tree``.
    While a profiler records and autograd records this forward, the
    gradients of block i's slices, from the scatter of each into its stacked
    tensor's shape to their sum with the other blocks', run under
    ``<name>/backward``.  Autograd takes them once the block's backward is
    done, before the block that ran before it; the range opens then and is
    closed by the next marked backward to begin on the thread, the last
    block's by the stacked tensors' own marker once every sum is in."""
    stacked = [t for t in tree_leaves(tree) if _needs_grad(t)] if _marking() else []
    if not stacked:
        return lambda i: take(tree, i)
    tree = _replace(tree, _Flush.apply(*stacked))

    def block(i):
        part = take(tree, i)
        return _replace(part, _OpenSlices.apply(
            name + "/backward", *[t for t in tree_leaves(part) if _needs_grad(t)]))

    return block
