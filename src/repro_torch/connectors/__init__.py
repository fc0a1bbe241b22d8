"""Connector implementations of the port, copied from ``repro/connectors``:
POSIX, the in-memory store and the six emulated cloud storage services
(AWS-S3, Wasabi, Google-Cloud, Google-Drive, Box, Ceph)."""

from .posix import PosixConnector
from .memory import MemoryConnector
from .cloud import (
    CloudStorage,
    ObjectStoreConnector,
    NativeClient,
    make_cloud,
    PROFILES,
)

__all__ = [
    "PosixConnector",
    "MemoryConnector",
    "CloudStorage",
    "ObjectStoreConnector",
    "NativeClient",
    "make_cloud",
    "PROFILES",
]
