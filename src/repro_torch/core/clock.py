"""Charge attribution across threads, from ``repro/core/clock.py``.

Only the part the Connector layer reads is copied: ``bind_charge_owner``
and the thread-local charge owner and span context it carries
(``repro/core/clock.py:61-139``).  The port has no scaled clock, so no
owner is ever set and ``bind_charge_owner`` returns ``fn`` unchanged; it
stays so that ``core/connector.py`` and ``connectors/posix.py`` read as
their reference copies do.
"""

from __future__ import annotations

import functools
import threading
from contextlib import contextmanager

#: thread-local charge owner and span context
_attribution = threading.local()


def current_charge_owner() -> str | None:
    """The owner (task id) the current thread charges model time to."""
    return getattr(_attribution, "owner", None)


def current_trace_context():
    """The observability span context active on this thread, or ``None``."""
    return getattr(_attribution, "trace", None)


@contextmanager
def charge_to(owner: str | None):
    """Attribute this thread's charges to ``owner`` for the block; nests."""
    prev = getattr(_attribution, "owner", None)
    _attribution.owner = owner
    try:
        yield
    finally:
        _attribution.owner = prev


@contextmanager
def trace_context(ctx):
    """Make ``ctx`` the thread's active span context for the block; nests."""
    prev = getattr(_attribution, "trace", None)
    _attribution.trace = ctx
    try:
        yield
    finally:
        _attribution.trace = prev


def bind_charge_owner(fn):
    """Capture the calling thread's charge owner and span context, and
    re-establish both in whichever thread eventually runs ``fn``."""
    owner = current_charge_owner()
    trace = current_trace_context()
    if owner is None and trace is None:
        return fn

    @functools.wraps(fn)
    def bound(*args, **kwargs):
        with charge_to(owner), trace_context(trace):
            return fn(*args, **kwargs)

    return bound
