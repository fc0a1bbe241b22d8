"""The paper's transfer stack, copied from ``repro/core``: the Connector
interface and its error taxonomy, the model clock, fault schedules,
integrity hashers and the performance model.

The transfer service (``core/transfer.py``), its manager
(``core/manager.py``) and the health plane (``core/health.py``) import
``repro_torch.obs`` and ``repro_torch.svc``, which import
``core/clock.py``; they are imported by their module path, so that
``obs`` and ``svc`` import cleanly whichever of the three packages comes
first (the reference's package re-exports them and cycles, ROADMAP C2).
"""

from .clock import Clock, Link, TokenBucket, loopback
from .connector import (AppChannel, ByteRange, Connector, Credential,
                        Session, StatInfo, iter_files)
from .errors import (AuthError, ConnectorError, EndpointUnavailable,
                     FaultInjected, IntegrityError, NotFound, PermanentError,
                     RateLimitError, TransientError, TruncatedStream)
from .faults import FaultEvent, FaultRule, FaultSchedule
from .integrity import checksum_bytes, hasher
from .perfmodel import (Advisor, PerfModel, Route, fit_linear, fit_perf_model,
                        fit_startup_cost, pearson)

__all__ = [
    "AppChannel", "ByteRange", "Connector", "Credential", "Session",
    "StatInfo", "iter_files",
    "AuthError", "ConnectorError", "EndpointUnavailable", "FaultInjected",
    "IntegrityError", "NotFound", "PermanentError", "RateLimitError",
    "TransientError", "TruncatedStream",
    "FaultEvent", "FaultRule", "FaultSchedule",
    "Advisor", "PerfModel", "Route", "fit_linear", "fit_perf_model",
    "fit_startup_cost", "pearson",
    "checksum_bytes", "hasher",
    "Clock", "Link", "TokenBucket", "loopback",
]
