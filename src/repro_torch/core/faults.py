"""Composable, seed-deterministic fault-injection schedules.

A copy of ``repro/core/faults.py``: the port imports nothing of ``repro``.

The paper's claim for the Connector abstraction is *managed* transfer —
"error handling and end-to-end integrity" (§2, §4) — which is only
credible if the retry/backoff, marker-resume, and integrity-repair
machinery is exercised systematically rather than by a handful of
hand-written failure cases.  A :class:`FaultSchedule` is a declarative
plan of failures that a :class:`~repro_torch.connectors.faultproxy.FaultProxyConnector`
(or an emulated :class:`~repro_torch.connectors.cloud.CloudStorage`) replays
against live traffic:

* ``transient``     — retryable :class:`FaultInjected` on matching ops
* ``rate_limit``    — :class:`RateLimitError` storms with ``retry_after``
* ``session_drop``  — :class:`SessionClosed` mid-op (connection died)
* ``latency``       — injected delay on the model :class:`Clock` (never
  the wall clock: ``REPRO_TIME_SCALE=0`` keeps it pure accounting)
* ``bit_flip``      — corrupt one byte of a data block flowing into
  storage, which only end-to-end integrity checking (§7) can catch
* ``truncate``      — cut a data stream after K bytes, so the file lands
  short and the service must detect + re-send the hole
* ``error``         — any custom exception factory

Determinism
-----------
Every decision is a pure function of ``(seed, rule, op, path, k)`` where
``k`` is the per-stream match counter, so the injected fault *set* is
reproducible run-to-run even when the transfer service drives files from
a thread pool: each file's op sequence is deterministic, and counters
default to ``scope="path"`` (one stream per ``(rule, op, path)``).
``scope="global"`` counts across all paths — deterministic only under
``concurrency=1``.  Probabilistic rules draw from a hash, not a shared
RNG stream, for the same reason.

Every firing is recorded as a :class:`FaultEvent`, so tests can assert
``task.stats.faults_retried`` against ``schedule.count("transient")``.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass
from fnmatch import fnmatchcase
from typing import Callable

from .clock import Clock, DEFAULT_CLOCK
from .errors import FaultInjected, RateLimitError, SessionClosed

#: rule kinds applied at op admission (may raise / sleep)
CONTROL_KINDS = ("transient", "rate_limit", "session_drop", "latency", "error")
#: rule kinds applied inside a data stream (mutate / cut blocks)
DATA_KINDS = ("bit_flip", "truncate")


@dataclass(frozen=True)
class FaultEvent:
    """One injected fault, as it actually fired."""

    kind: str
    op: str
    path: str
    index: int          # the match counter value that fired (1-based)
    detail: str = ""

    def signature(self) -> tuple:
        return (self.kind, self.op, self.path, self.index, self.detail)


@dataclass
class FaultRule:
    """One line of a schedule.  Matching ops are counted per stream
    (``scope="path"``: one counter per ``(rule, op, path)``); the rule
    fires on counter values inside its window:

      ``at``     first 1-based match index that fires
      ``times``  how many firings (None = unlimited)
      ``every``  fire every k-th match at/after ``at`` (storms/beats)
      ``prob``   seeded per-match probability gate on top of the window
    """

    kind: str
    op: str = "*"
    path: str = "*"
    at: int = 1
    times: int | None = 1
    every: int | None = None
    prob: float | None = None
    scope: str = "path"           # "path" | "global"
    delay: float = 0.0            # latency: model seconds
    retry_after: float = 0.0      # rate_limit hint
    after_bytes: int = 0          # truncate: bytes delivered before cut
    flip_offset: int | None = None  # bit_flip: absolute byte offset (None
    #                                 = midpoint of the first block)
    error: Callable[[str, str], Exception] | None = None  # kind="error"

    def matches(self, op: str, path: str) -> bool:
        return fnmatchcase(op, self.op) and fnmatchcase(path, self.path)

    def in_window(self, k: int) -> bool:
        if k < self.at:
            return False
        if self.every:
            if (k - self.at) % self.every != 0:
                return False
            return self.times is None or (k - self.at) // self.every < self.times
        return self.times is None or k < self.at + self.times


class StreamFaults:
    """Per-attempt data-plane directives for one file stream.

    Handed out by :meth:`FaultSchedule.data_plan` when a connector opens
    a data stream; :meth:`filter` is applied to every block flowing into
    storage and implements ``truncate`` (returns ``b""`` = end of
    stream) and ``bit_flip`` (corrupts one byte)."""

    def __init__(self, schedule: "FaultSchedule", op: str, path: str,
                 truncate_after: int | None, flips: list[FaultRule]):
        self._schedule = schedule
        self._op = op
        self._path = path
        self._truncate_after = truncate_after
        self._flips = list(flips)
        self._delivered = 0
        self._cut_logged = False
        self._lock = threading.Lock()

    @property
    def active(self) -> bool:
        return self._truncate_after is not None or bool(self._flips)

    def filter(self, offset: int, data: bytes) -> bytes:
        """Apply this attempt's directives to one block (may shorten it,
        corrupt one byte, or end the stream by returning ``b""``)."""
        if not data or not self.active:
            return data
        with self._lock:
            if self._truncate_after is not None:
                remaining = self._truncate_after - self._delivered
                if remaining <= 0:
                    self._log_cut()
                    return b""
                if len(data) > remaining:
                    data = data[:remaining]
                    self._log_cut()
            if self._flips and data:
                rule = self._flips[0]
                pos = None
                if rule.flip_offset is None:
                    pos = len(data) // 2
                elif offset <= rule.flip_offset < offset + len(data):
                    pos = rule.flip_offset - offset
                if pos is not None:
                    self._flips.pop(0)
                    mutated = bytearray(data)
                    mutated[pos] ^= 0xFF
                    data = bytes(mutated)
                    self._schedule._log(FaultEvent(
                        "bit_flip", self._op, self._path, 1,
                        f"offset={offset + pos}"))
            self._delivered += len(data)
        return data

    def _log_cut(self) -> None:
        if not self._cut_logged:
            self._cut_logged = True
            self._schedule._log(FaultEvent(
                "truncate", self._op, self._path, 1,
                f"after={self._truncate_after}"))


class FaultSchedule:
    """A composable plan of failures.  Its rule methods append rules and
    return ``self``::

        sched = (FaultSchedule(seed=7)
                 .transient(op="send", at=2)               # 2nd send fails
                 .rate_limit(op="put*", at=3, times=5,     # quota storm
                             retry_after=0.25)
                 .bit_flip(path="*.bin")                   # needs integrity
                 .session_drop(op="recv_batch")            # drop mid-batch
                 .truncate(after_bytes=4096, op="recv")    # short write
                 .latency(op="stat", delay=0.5, times=None))
    """

    def __init__(self, rules: list[FaultRule] | None = None, seed: int = 0,
                 clock: Clock | None = None):
        self.rules: list[FaultRule] = list(rules or [])
        self.seed = seed
        self.clock = clock
        self.events: list[FaultEvent] = []
        self._counts: dict[tuple, int] = {}
        self._lock = threading.Lock()

    # -- rules -----------------------------------------------------------
    def add(self, rule: FaultRule) -> "FaultSchedule":
        self.rules.append(rule)
        return self

    def transient(self, op: str = "*", path: str = "*", **kw) -> "FaultSchedule":
        return self.add(FaultRule("transient", op=op, path=path, **kw))

    def rate_limit(self, op: str = "*", path: str = "*",
                   retry_after: float = 0.1, **kw) -> "FaultSchedule":
        return self.add(FaultRule("rate_limit", op=op, path=path,
                                  retry_after=retry_after, **kw))

    def session_drop(self, op: str = "*", path: str = "*", **kw) -> "FaultSchedule":
        return self.add(FaultRule("session_drop", op=op, path=path, **kw))

    def latency(self, op: str = "*", path: str = "*", delay: float = 0.05,
                **kw) -> "FaultSchedule":
        return self.add(FaultRule("latency", op=op, path=path, delay=delay, **kw))

    def bit_flip(self, op: str = "recv*", path: str = "*",
                 flip_offset: int | None = None, **kw) -> "FaultSchedule":
        return self.add(FaultRule("bit_flip", op=op, path=path,
                                  flip_offset=flip_offset, **kw))

    def truncate(self, after_bytes: int, op: str = "recv*", path: str = "*",
                 **kw) -> "FaultSchedule":
        return self.add(FaultRule("truncate", op=op, path=path,
                                  after_bytes=after_bytes, **kw))

    def fail_with(self, error: Callable[[str, str], Exception],
                  op: str = "*", path: str = "*", **kw) -> "FaultSchedule":
        return self.add(FaultRule("error", op=op, path=path, error=error, **kw))

    # -- endpoint-degradation profiles (health-plane scenarios) ----------
    def dead_endpoint(self, op: str = "*", path: str = "*",
                      **kw) -> "FaultSchedule":
        """Permanent endpoint death: every matching op fails transiently,
        forever.  Each firing is one attempt that actually *reached* the
        endpoint, so ``count("transient")`` measures the aggregate
        attempt pressure a retry policy (or a circuit breaker's retry
        budget) allowed through."""
        return self.transient(op=op, path=path, times=None, **kw)

    def brownout(self, times: int, op: str = "*", path: str = "*",
                 **kw) -> "FaultSchedule":
        """A bounded degradation window: the first ``times`` matching
        ops — counted globally across all paths — fail transiently, then
        the endpoint recovers.  The *total* number of injected failures
        is exactly ``times`` under any thread schedule (the counter is
        locked); which paths absorb them may vary, so assert on breaker
        transitions and outcome totals, not per-path event order."""
        return self.transient(op=op, path=path, times=times,
                              scope="global", **kw)

    # -- engine ----------------------------------------------------------
    def _bump(self, i: int, rule: FaultRule, op: str, path: str) -> int:
        key = (i,) if rule.scope == "global" else (i, op, path)
        with self._lock:
            k = self._counts.get(key, 0) + 1
            self._counts[key] = k
        return k

    def _draw(self, i: int, op: str, path: str, k: int) -> float:
        """Deterministic uniform [0,1) from (seed, rule, stream, k) —
        thread-schedule independent, unlike a shared RNG stream."""
        basis = f"{self.seed}|{i}|{op}|{path}|{k}".encode()
        h = hashlib.sha1(basis).digest()
        return int.from_bytes(h[:8], "big") / 2.0 ** 64

    def _fires(self, i: int, rule: FaultRule, op: str, path: str, k: int) -> bool:
        if not rule.in_window(k):
            return False
        if rule.prob is not None:
            return self._draw(i, op, path, k) < rule.prob
        return True

    def _log(self, event: FaultEvent) -> None:
        with self._lock:
            self.events.append(event)

    def check(self, op: str, path: str = "") -> None:
        """Admit one control-plane op.  May sleep (latency, on the model
        clock) or raise (transient / rate-limit / session-drop / custom).
        Data-plane kinds are ignored here — see :meth:`data_plan`."""
        for i, rule in enumerate(self.rules):
            if rule.kind in DATA_KINDS or not rule.matches(op, path):
                continue
            k = self._bump(i, rule, op, path)
            if not self._fires(i, rule, op, path, k):
                continue
            if rule.kind == "latency":
                self._log(FaultEvent("latency", op, path, k,
                                     f"delay={rule.delay}"))
                (self.clock or DEFAULT_CLOCK).sleep(rule.delay)
                continue
            if rule.kind == "transient":
                self._log(FaultEvent("transient", op, path, k))
                raise FaultInjected(f"injected transient on {op} {path}#{k}",
                                    retry_after=rule.retry_after)
            if rule.kind == "rate_limit":
                self._log(FaultEvent("rate_limit", op, path, k,
                                     f"retry_after={rule.retry_after}"))
                raise RateLimitError(
                    f"injected rate limit on {op} {path}#{k}",
                    retry_after=rule.retry_after)
            if rule.kind == "session_drop":
                self._log(FaultEvent("session_drop", op, path, k))
                raise SessionClosed(f"injected session drop on {op} {path}#{k}")
            if rule.kind == "error":
                self._log(FaultEvent("error", op, path, k))
                raise rule.error(op, path)

    def data_plan(self, op: str, path: str) -> StreamFaults:
        """Open one data stream (= one transfer attempt for one file):
        consumes a match from every data rule and returns the attempt's
        :class:`StreamFaults`.  A rule with ``at=1, times=1`` therefore
        faults the *first* attempt per file and lets the retry pass."""
        truncate_after: int | None = None
        flips: list[FaultRule] = []
        for i, rule in enumerate(self.rules):
            if rule.kind not in DATA_KINDS or not rule.matches(op, path):
                continue
            k = self._bump(i, rule, op, path)
            if not self._fires(i, rule, op, path, k):
                continue
            if rule.kind == "truncate":
                ta = rule.after_bytes
                truncate_after = ta if truncate_after is None \
                    else min(truncate_after, ta)
            else:
                flips.append(rule)
        return StreamFaults(self, op, path, truncate_after, flips)

    # -- observability ---------------------------------------------------
    def count(self, kind: str | None = None, op: str | None = None) -> int:
        with self._lock:
            return sum(1 for e in self.events
                       if (kind is None or e.kind == kind)
                       and (op is None or fnmatchcase(e.op, op)))

    def sorted_events(self) -> list[tuple]:
        """Thread-order-independent event log (for run-to-run compares)."""
        with self._lock:
            return sorted(e.signature() for e in self.events)

    def reset(self) -> None:
        """Clear counters + events so the same schedule replays fresh."""
        with self._lock:
            self.events.clear()
            self._counts.clear()

    def __repr__(self) -> str:  # pragma: no cover
        kinds = ",".join(r.kind for r in self.rules) or "empty"
        return f"<FaultSchedule seed={self.seed} [{kinds}] " \
               f"{len(self.events)} fired>"
