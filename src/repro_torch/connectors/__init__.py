"""Connector implementations of the port, copied from ``repro/connectors``:
POSIX, the in-memory store, the six emulated cloud storage services
(AWS-S3, Wasabi, Google-Cloud, Google-Drive, Box, Ceph), and a fault-proxy
wrapper that replays a :class:`~repro_torch.core.faults.FaultSchedule`
against any of them."""

from .posix import PosixConnector
from .memory import MemoryConnector
from .cloud import (
    CloudStorage,
    ObjectStoreConnector,
    NativeClient,
    make_cloud,
    PROFILES,
)
from .faultproxy import FaultProxyConnector

__all__ = [
    "PosixConnector",
    "MemoryConnector",
    "CloudStorage",
    "ObjectStoreConnector",
    "NativeClient",
    "make_cloud",
    "PROFILES",
    "FaultProxyConnector",
]
