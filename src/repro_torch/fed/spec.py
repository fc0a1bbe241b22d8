"""Serializable transfer submission spec — the unit of federation.

A copy of ``repro/fed/spec.py``: the port imports nothing of ``repro``.

The paper's third-party model (§2.1) works because a transfer is fully
described by *references*: endpoints, paths, options, identity — never
file bytes, never live connector state.  :class:`TransferSpec` makes
that description a first-class, JSON-round-trippable value, so a task
can move between control planes: a client submits one to a
:class:`~repro_torch.fed.coordinator.FederatedCoordinator`, a site manager
adopts it via :meth:`~repro_torch.core.manager.TransferManager.import_state`,
and an overloaded or failed site re-serializes it (hole map and
per-range digests riding along in ``markers``) for a peer to resume
re-sending only the missing bytes.

Connectors themselves cannot travel; endpoints are referenced by id and
each site resolves them against its own endpoint-ownership map.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field, fields

from ..core.transfer import TransferOptions

#: lifecycle states a spec can be serialized in.  "queued" has no
#: partial progress; "paused" travels with its hole map (markers);
#: "cancelled" is terminal and only registered on arrival.
SPEC_STATES = ("queued", "paused", "cancelled")


@dataclass
class TransferSpec:
    """One submission, fully described by value (JSON-clean).

    ``markers`` is the traveled restart state — exactly what
    :class:`~repro_torch.core.transfer.MarkerStore` persists: per-file
    completed ranges, per-range digests, and recorded checksums — so a
    paused task's holes (and its §7 checksum fold) survive the hop.
    ``stats`` carries the charge-accounted model seconds and resume
    count accrued on previous sites, keeping attribution exact.
    """

    task_id: str
    src_endpoint: str
    src_path: str
    dst_endpoint: str
    dst_path: str
    tenant: str = ""
    priority: int = 0
    state: str = "queued"
    options: dict = field(default_factory=dict)
    #: advisor hints: route name + workload estimate, so placement can
    #: predict without walking the source tree
    route: str = ""
    n_files: int = 0
    nbytes: int = 0
    origin_site: str = ""
    #: observability: the task's trace id travels with the spec, so a
    #: handed-off task's spans on the adopting site stitch into the
    #: same timeline as the spans it accrued at the origin
    trace_id: str = ""
    stats: dict = field(default_factory=dict)
    markers: dict = field(default_factory=lambda: {"files": {}})
    #: replica hints: JSON-clean catalog entry dicts naming verified
    #: copies of the source that already exist (see
    #: :mod:`repro_torch.catalog`) — the adopting site merges and
    #: re-validates them, so a handed-off fan-out member can still be
    #: served by a replica read instead of a source read
    replicas: list = field(default_factory=list)
    version: int = 1

    # ---- construction ----------------------------------------------------
    @classmethod
    def new(cls, task_id: str, src_endpoint: str, src_path: str,
            dst_endpoint: str, dst_path: str, *, tenant: str = "",
            priority: int = 0,
            options: TransferOptions | dict | None = None,
            route: str = "", n_files: int = 0, nbytes: int = 0,
            origin_site: str = "") -> "TransferSpec":
        """Build a fresh (queued, no-progress) submission spec."""
        if isinstance(options, TransferOptions):
            options = asdict(options)
        return cls(task_id=task_id, src_endpoint=src_endpoint,
                   src_path=src_path, dst_endpoint=dst_endpoint,
                   dst_path=dst_path, tenant=tenant, priority=priority,
                   options=dict(options or {}), route=route,
                   n_files=n_files, nbytes=nbytes, origin_site=origin_site)

    def validate(self) -> None:
        if not self.task_id:
            raise ValueError("spec needs a task_id")
        if not self.src_endpoint or not self.dst_endpoint:
            raise ValueError("spec needs src and dst endpoint ids")
        if self.state not in SPEC_STATES:
            raise ValueError(f"unknown spec state {self.state!r} "
                             f"(expected one of {SPEC_STATES})")
        if not isinstance(self.markers, dict) \
                or not isinstance(self.markers.get("files", None), dict):
            raise ValueError("markers must be a {'files': {...}} mapping")

    # ---- manager payload shape ------------------------------------------
    def to_payload(self) -> dict:
        """The dict shape
        :meth:`~repro_torch.core.manager.TransferManager.import_state`
        consumes (and :meth:`export_state` produces)."""
        return {
            "version": self.version,
            "task_id": self.task_id,
            "state": self.state,
            "tenant": self.tenant,
            "priority": self.priority,
            "origin_site": self.origin_site,
            "trace_id": self.trace_id,
            "src": {"endpoint_id": self.src_endpoint,
                    "path": self.src_path},
            "dst": {"endpoint_id": self.dst_endpoint,
                    "path": self.dst_path},
            "options": dict(self.options),
            "route": self.route,
            "n_files": self.n_files,
            "nbytes": self.nbytes,
            "stats": dict(self.stats),
            "markers": self.markers,
            "replicas": list(self.replicas),
        }

    @classmethod
    def from_payload(cls, payload: dict) -> "TransferSpec":
        spec = cls(
            task_id=payload["task_id"],
            src_endpoint=payload["src"]["endpoint_id"],
            src_path=payload["src"]["path"],
            dst_endpoint=payload["dst"]["endpoint_id"],
            dst_path=payload["dst"]["path"],
            tenant=payload.get("tenant", ""),
            priority=payload.get("priority", 0),
            state=payload.get("state", "queued"),
            options=dict(payload.get("options", {})),
            route=payload.get("route", ""),
            n_files=payload.get("n_files", 0),
            nbytes=payload.get("nbytes", 0),
            origin_site=payload.get("origin_site", ""),
            trace_id=payload.get("trace_id", ""),
            stats=dict(payload.get("stats", {})),
            markers=payload.get("markers") or {"files": {}},
            replicas=list(payload.get("replicas", []) or []),
            version=payload.get("version", 1),
        )
        spec.validate()
        return spec

    # ---- JSON travel -----------------------------------------------------
    def to_json(self) -> str:
        """Canonical wire form (sorted keys: byte-stable for a given
        spec, so digests/logs of specs are comparable)."""
        self.validate()
        return json.dumps(asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, data: str) -> "TransferSpec":
        raw = json.loads(data)
        known = {f.name for f in fields(cls)}
        spec = cls(**{k: v for k, v in raw.items() if k in known})
        spec.validate()
        return spec

    # ---- introspection ---------------------------------------------------
    def pending_bytes(self) -> int | None:
        """Bytes a resume would still have to move — the workload hint
        minus what the traveled hole maps say already landed.  ``None``
        when the spec carries no ``nbytes`` hint."""
        if not self.nbytes:
            return None
        return max(0, self.nbytes - self.done_bytes())

    def done_bytes(self) -> int:
        """Bytes the traveled markers say already landed (complete files
        count only when the spec knows per-file sizes via ``done``)."""
        total = 0
        for st in self.markers.get("files", {}).values():
            total += sum(ln for _, ln in st.get("done", []))
        return total
