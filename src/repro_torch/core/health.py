"""Shared endpoint-health plane: circuit breakers + retry budgets.

A copy of ``repro/core/health.py``: the port imports nothing of ``repro``.

The paper's managed-transfer story (§4, "automatic retries and
fault-tolerant capabilities") retries each file independently, which is
correct for isolated faults but pathological when an *endpoint* is sick:
a fleet of N tasks each burns ``max_retries`` exponential-backoff
attempts against the same dying storage — an O(N·max_retries) retry
storm against infrastructure that production transfer fabrics detect
and route around automatically (Globus service enhancements,
arXiv:2503.22981).  :class:`EndpointHealth` is the shared registry that
makes endpoint sickness a first-class, fleet-wide signal:

* **EWMA error rate** per endpoint over the model clock: every attempt
  outcome (success or blamed failure) folds into an exponentially
  weighted moving average, so the signal tracks recent behaviour and
  ages out history.

* **Three-state circuit breaker** per endpoint, driven by that EWMA:

  - ``closed``    — normal operation; failures accumulate evidence.
  - ``open``      — error rate crossed ``error_threshold`` (with at
    least ``min_samples`` observations): every attempt is denied
    *locally* with :class:`~repro_torch.core.errors.EndpointUnavailable`
    (a fast-fail — no storage op, no exponential backoff sleep) until
    ``cooldown`` model seconds elapse.
  - ``half-open`` — cooldown elapsed: exactly ONE probe attempt at a
    time is admitted (and charged to the retry budget, so probing a
    dead endpoint is budget-bounded too).  ``probe_successes``
    consecutive successful probes close the breaker with a fresh
    evidence window; a failed probe re-opens it with a fresh cooldown.

* **Token-bucket retry budget** per endpoint, shared across *all*
  tasks: a retry (attempt > 1) or a half-open probe must take a token
  from the blamed endpoint's bucket before it may touch storage.  The
  bucket refills at ``retry_budget_rate`` tokens per model second up to
  ``retry_budget_capacity``, so aggregate retries against a sick
  endpoint are O(budget) regardless of fleet size — not
  O(N·max_retries).

Everything is timed on the model :class:`~repro_torch.core.clock.Clock`
(``virtual_elapsed`` advances under every ``time_scale``, including the
pure-accounting 0), so breaker transitions and budget refills are
wall-clock-free and reproducible; :attr:`EndpointHealth.transitions`
records ``(model_time, endpoint, old_state, new_state)`` for tests to
assert exact sequences.

The plane is **opt-in**: a :class:`~repro_torch.core.transfer.TransferService`
built without ``health=`` behaves exactly as before.  When present it is
consulted at three layers — the data plane's per-attempt retry loop
(:meth:`admit` / :meth:`settle`), the control plane's dispatch and
advisor routing (:meth:`available`), and the federation plane's digest
stream (:meth:`unavailable`, exported through
``TransferManager.digest()``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from .clock import Clock, DEFAULT_CLOCK
from .errors import EndpointUnavailable
from ..obs.trace import NULL_TRACER

#: breaker states
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"


@dataclass
class HealthConfig:
    """Knobs for the health plane.  Defaults suit chaos-test scale
    (model seconds are small); production-shaped sweeps tune them via
    benchmarks/bench_resilience.py."""

    #: EWMA error rate at/above which a closed breaker opens
    error_threshold: float = 0.5
    #: EWMA smoothing: weight of the newest observation
    ewma_alpha: float = 0.4
    #: observations required before the threshold can trip (a single
    #: unlucky first attempt must not open a fresh endpoint)
    min_samples: int = 3
    #: model seconds an open breaker denies everything before half-open
    cooldown: float = 1.0
    #: consecutive successful probes that close a half-open breaker
    probe_successes: int = 1
    #: retry-budget refill, tokens per model second (0 = no refill:
    #: the capacity is the hard lifetime budget)
    retry_budget_rate: float = 1.0
    #: retry-budget burst size, tokens
    retry_budget_capacity: float = 8.0


class _EpState:
    """Per-endpoint mutable state; guarded by the registry lock."""

    __slots__ = ("ep", "state", "ewma", "samples", "opened_at", "probing",
                 "probe_ok", "tokens", "vlast", "entered_at")

    def __init__(self, ep: str, capacity: float):
        self.ep = ep
        self.state = CLOSED
        self.ewma = 0.0
        self.samples = 0
        self.opened_at = 0.0
        self.probing = 0       # probe attempts currently in flight (≤ 1)
        self.probe_ok = 0      # consecutive successful probes
        self.tokens = capacity
        self.vlast = 0.0
        self.entered_at = 0.0  # model time the current breaker state began


class _Ticket:
    """One admitted attempt: which endpoints it touches and which
    half-open probes it holds.  ``settle``/``release`` are idempotent
    through the flags, so the data plane can release probe slots in a
    ``finally`` without double-counting outcomes."""

    __slots__ = ("eps", "probe_eps", "settled", "released")

    def __init__(self, eps: tuple[str, ...], probe_eps: tuple[str, ...]):
        self.eps = eps
        self.probe_eps = probe_eps
        self.settled = False
        self.released = False

    @property
    def probe(self) -> bool:
        return bool(self.probe_eps)


class EndpointHealth:
    """Fleet-shared endpoint breaker + retry-budget registry.

    One instance is shared by a :class:`TransferService`, its
    :class:`TransferManager`, and (via digests) a federation
    coordinator; all methods are thread-safe under one registry lock.
    Endpoints are keyed by resolved endpoint id
    (:meth:`Endpoint.resolved_id`)."""

    def __init__(self, config: HealthConfig | None = None,
                 clock: Clock | None = None, tracer=None):
        self.config = config or HealthConfig()
        self.clock = clock or DEFAULT_CLOCK
        #: observability: breaker state windows are recorded as
        #: retroactive (charge-free) trace spans; the TransferManager
        #: swaps in its live tracer when it shares this registry
        self.tracer = tracer or NULL_TRACER
        #: (model_time, endpoint, old_state, new_state) in commit order
        self.transitions: list[tuple[float, str, str, str]] = []
        #: fast-fails denied per endpoint (observability)
        self.denials: dict[str, int] = {}
        self._eps: dict[str, _EpState] = {}
        self._lock = threading.Lock()

    # ---- internals (call under self._lock) -------------------------------
    def _ep(self, ep: str) -> _EpState:
        s = self._eps.get(ep)
        if s is None:
            s = _EpState(ep, self.config.retry_budget_capacity)
            self._eps[ep] = s
        return s

    def _refill(self, s: _EpState, now: float) -> None:
        cfg = self.config
        if cfg.retry_budget_rate > 0 and now > s.vlast:
            s.tokens = min(cfg.retry_budget_capacity,
                           s.tokens + (now - s.vlast) * cfg.retry_budget_rate)
        s.vlast = max(s.vlast, now)

    def _move(self, s: _EpState, new: str, now: float) -> None:
        self.transitions.append((now, s.ep, s.state, new))
        # the window just closed (e.g. the whole "open" cooldown) becomes
        # a retroactive span: visible in trace exports, charges nothing
        self.tracer.record(f"breaker-{s.state}", "health",
                           s.entered_at, now, endpoint=s.ep, to=new)
        s.entered_at = now
        s.state = new

    def _deny(self, ep: str, retry_after: float, reason: str,
              msg: str) -> EndpointUnavailable:
        self.denials[ep] = self.denials.get(ep, 0) + 1
        return EndpointUnavailable(msg, retry_after=max(retry_after, 1e-3),
                                   endpoint_id=ep, reason=reason)

    def _open_denial(self, s: _EpState, now: float) -> EndpointUnavailable | None:
        """Denial for an endpoint whose breaker is open and cooling."""
        if s.state != OPEN:
            return None
        remaining = s.opened_at + self.config.cooldown - now
        if remaining <= 0:
            return None
        return self._deny(s.ep, remaining, "breaker-open",
                          f"endpoint {s.ep!r} breaker open "
                          f"({remaining:.3f}s model cooldown remaining)")

    # ---- data-plane gate -------------------------------------------------
    def admit(self, *eps: str, retrying: bool = False,
              blame: tuple[str, ...] | None = None) -> _Ticket:
        """Gate one transfer attempt touching ``eps``.

        Checks every endpoint's breaker and (for retries and probes) its
        retry budget, then commits atomically: either the attempt is
        admitted on ALL endpoints and a :class:`_Ticket` is returned, or
        nothing is mutated and :class:`EndpointUnavailable` is raised —
        the fast-fail that replaces sleeping through exponential
        backoff.  ``blame`` restricts whose budget a retry charges (the
        endpoint the previous failure was attributed to); ``None``
        charges every endpoint of the attempt."""
        cfg = self.config
        with self._lock:
            now = self.clock.virtual_elapsed
            states = [self._ep(e) for e in eps]
            need: dict[str, tuple[bool, float]] = {}  # ep -> (probe, tokens)
            for s in states:
                self._refill(s, now)
                probe = False
                denial = self._open_denial(s, now)
                if denial is not None:
                    raise denial
                if s.state == OPEN:
                    # cooldown elapsed: this attempt becomes the probe
                    probe = True
                elif s.state == HALF_OPEN:
                    if s.probing >= 1:
                        raise self._deny(
                            s.ep, cfg.cooldown, "probe-in-flight",
                            f"endpoint {s.ep!r} half-open with a probe "
                            f"already in flight")
                    probe = True
                charged = probe or (retrying
                                    and (blame is None or s.ep in blame))
                need[s.ep] = (probe, 1.0 if charged else 0.0)
            for s in states:
                _, tokens = need[s.ep]
                if tokens > s.tokens:
                    wait = ((tokens - s.tokens) / cfg.retry_budget_rate
                            if cfg.retry_budget_rate > 0 else cfg.cooldown)
                    raise self._deny(
                        s.ep, wait, "retry-budget",
                        f"endpoint {s.ep!r} retry budget exhausted "
                        f"({s.tokens:.2f} tokens)")
            # all gates passed: commit
            probe_eps = []
            for s in states:
                probe, tokens = need[s.ep]
                s.tokens -= tokens
                if probe:
                    if s.state == OPEN:
                        self._move(s, HALF_OPEN, now)
                    s.probing += 1
                    probe_eps.append(s.ep)
            return _Ticket(tuple(eps), tuple(probe_eps))

    def settle(self, ticket: _Ticket | None, error: Exception | None = None
               ) -> None:
        """Report one admitted attempt's outcome.  Success folds into
        every endpoint's EWMA; a failure is charged to the blamed
        endpoint (``error.endpoint_id`` when it names one of the
        ticket's endpoints, else all of them).  Idempotent per ticket."""
        if ticket is None or ticket.settled:
            return
        with self._lock:
            ticket.settled = True
            now = self.clock.virtual_elapsed
            if not ticket.released:
                ticket.released = True
                for ep in ticket.probe_eps:
                    st = self._eps.get(ep)
                    if st is not None:
                        st.probing = max(0, st.probing - 1)
            if error is None:
                self._record_locked(ticket.eps, False, now)
            else:
                self._record_locked(self._blamed(ticket.eps, error),
                                    True, now)

    def release(self, ticket: _Ticket | None) -> None:
        """Free a ticket's probe slots without judging the outcome —
        the data plane's ``finally`` backstop for attempts that exit
        through a non-transient path (interrupt, permanent error)."""
        if ticket is None or ticket.settled or ticket.released:
            return
        with self._lock:
            if ticket.released:
                return
            ticket.released = True
            for ep in ticket.probe_eps:
                st = self._eps.get(ep)
                if st is not None:
                    st.probing = max(0, st.probing - 1)

    # ---- ticket-free outcome reporting (batch path, external probes) -----
    def record_success(self, *eps: str) -> None:
        with self._lock:
            self._record_locked(tuple(eps), False, self.clock.virtual_elapsed)

    def record_failure(self, *eps: str, error: Exception | None = None
                       ) -> None:
        with self._lock:
            blamed = self._blamed(tuple(eps), error)
            self._record_locked(blamed, True, self.clock.virtual_elapsed)

    @staticmethod
    def _blamed(eps: tuple[str, ...],
                error: Exception | None) -> tuple[str, ...]:
        ep = getattr(error, "endpoint_id", "")
        return (ep,) if ep and ep in eps else eps

    def _record_locked(self, eps: tuple[str, ...], failed: bool,
                       now: float) -> None:
        cfg = self.config
        for ep in eps:
            s = self._ep(ep)
            s.samples += 1
            s.ewma = (1.0 - cfg.ewma_alpha) * s.ewma \
                + (cfg.ewma_alpha if failed else 0.0)
            if failed:
                if s.state == HALF_OPEN:
                    # the probe failed: back to open, fresh cooldown
                    s.probe_ok = 0
                    s.opened_at = now
                    self._move(s, OPEN, now)
                elif s.state == CLOSED and s.samples >= cfg.min_samples \
                        and s.ewma >= cfg.error_threshold:
                    s.opened_at = now
                    self._move(s, OPEN, now)
            else:
                if s.state == HALF_OPEN:
                    s.probe_ok += 1
                    if s.probe_ok >= cfg.probe_successes:
                        # recovered: fresh evidence window, so the next
                        # open again requires min_samples of new proof
                        s.ewma = 0.0
                        s.samples = 0
                        s.probe_ok = 0
                        self._move(s, CLOSED, now)

    # ---- control-plane queries (never mutate breaker state) --------------
    def available(self, ep: str) -> bool:
        """True when an attempt against ``ep`` would not be denied by
        its breaker: closed, half-open with a free probe slot, or open
        with the cooldown elapsed (the attempt would be the probe).
        Used by dispatch/routing; never transitions state."""
        with self._lock:
            s = self._eps.get(ep)
            if s is None:
                return True
            now = self.clock.virtual_elapsed
            if self._open_would_deny(s, now):
                return False
            if s.state == HALF_OPEN and s.probing >= 1:
                return False
            return True

    def _open_would_deny(self, s: _EpState, now: float) -> bool:
        return s.state == OPEN \
            and (s.opened_at + self.config.cooldown - now) > 0

    def denied(self, *eps: str) -> EndpointUnavailable | None:
        """Non-mutating breaker check over several endpoints: the
        denial an :meth:`admit` would raise right now on breaker state
        alone (budget excluded — a denied caller is expected to route
        to the per-attempt path, which does the budgeted admit)."""
        with self._lock:
            now = self.clock.virtual_elapsed
            for ep in eps:
                s = self._eps.get(ep)
                if s is None:
                    continue
                denial = self._open_denial(s, now)
                if denial is not None:
                    return denial
        return None

    def state(self, ep: str) -> str:
        with self._lock:
            s = self._eps.get(ep)
            return s.state if s is not None else CLOSED

    def error_rate(self, ep: str) -> float:
        with self._lock:
            s = self._eps.get(ep)
            return s.ewma if s is not None else 0.0

    def unavailable(self) -> list[str]:
        """Endpoint ids an attempt would currently be denied on — the
        health summary a site exports in its federation digest."""
        with self._lock:
            now = self.clock.virtual_elapsed
            return sorted(
                s.ep for s in self._eps.values()
                if self._open_would_deny(s, now)
                or (s.state == HALF_OPEN and s.probing >= 1))

    def transition_names(self, ep: str) -> list[str]:
        """This endpoint's breaker transitions as ``"old->new"`` strings
        in commit order — the deterministic sequence tests assert."""
        with self._lock:
            return [f"{old}->{new}" for _, e, old, new in self.transitions
                    if e == ep]

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            now = self.clock.virtual_elapsed
            out = {}
            for ep, s in self._eps.items():
                self._refill(s, now)
                out[ep] = {"state": s.state, "error_rate": round(s.ewma, 6),
                           "samples": s.samples,
                           "tokens": round(s.tokens, 6),
                           "denials": self.denials.get(ep, 0)}
            return out
