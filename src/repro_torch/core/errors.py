"""Error taxonomy for the Connector data interface.

A copy of ``repro/core/errors.py``: the port imports nothing of ``repro``.

The paper (§2.2, §4) distinguishes transient storage-API failures (rate
limits / call quotas on Google Drive and Box, flaky WAN links) that the
managed transfer service must retry automatically, from permanent errors
(missing object, bad credential) that must surface to the client on the
control channel.

Breaker / fast-fail taxonomy (health plane, :mod:`repro.core.health`)
---------------------------------------------------------------------
Per-endpoint circuit breakers add a third failure mode: an attempt can
be denied *locally*, before any storage op, because the endpoint's
recent error rate opened its breaker or its shared retry budget ran
dry.  That denial is :class:`EndpointUnavailable` — still a
:class:`TransientError` (the retry loop handles it), but with fast-fail
semantics: no storage was touched, so the loop sleeps only the breaker's
``retry_after`` hint (model seconds until the breaker may half-open or
the budget refills) instead of exponential backoff.  It is counted
distinctly in ``TaskStats.retries_by_kind``, alongside the
``"HalfOpenProbe"`` pseudo-kind for attempts admitted as half-open
probes — so a fault schedule, the breaker's denials, and its probes are
all separately observable on a task.
"""

from __future__ import annotations


class ConnectorError(Exception):
    """Base class for all connector-layer errors."""


class PermanentError(ConnectorError):
    """Non-retryable: surfaced to the control channel immediately."""


class TransientError(ConnectorError):
    """Retryable: the transfer service retries with backoff (paper §4,
    'automatic retries and fault-tolerant capabilities')."""

    def __init__(self, msg: str = "", retry_after: float = 0.0):
        super().__init__(msg)
        self.retry_after = retry_after


class RateLimitError(TransientError):
    """Storage API call-quota exceeded (Google Drive / Box, paper §4)."""


class EndpointUnavailable(TransientError):
    """Fast-fail from the health plane: the endpoint's circuit breaker
    is open (``reason="breaker-open"``), a half-open probe is already in
    flight (``"probe-in-flight"``), or the endpoint's shared retry
    budget is exhausted (``"retry-budget"``).  The attempt was denied
    locally — no storage op happened.  ``retry_after`` carries the model
    seconds until the condition may clear."""

    def __init__(self, msg: str = "", retry_after: float = 0.0,
                 endpoint_id: str = "", reason: str = ""):
        super().__init__(msg, retry_after)
        self.endpoint_id = endpoint_id
        self.reason = reason


class FaultInjected(TransientError):
    """Deterministic fault injected by a test/benchmark profile."""


class TruncatedStream(TransientError):
    """A data stream ended before the planned byte count and the source
    still reports the full size: the stream was cut (connection died,
    proxy fault, ...), not the file shrunk.  Retryable — the next
    attempt re-claims the remaining holes."""


class NotFound(PermanentError):
    pass


class AlreadyExists(PermanentError):
    pass


class AuthError(PermanentError):
    """Credential missing/invalid (paper Fig. 3 auth flow)."""


class IntegrityError(ConnectorError):
    """End-to-end checksum mismatch (paper §7). Retryable at file scope:
    the transfer service re-sends the file a bounded number of times."""


class SessionClosed(PermanentError):
    pass
