"""Connector implementations of the port: POSIX, copied from
``repro/connectors/posix.py``."""

from .posix import PosixConnector

__all__ = ["PosixConnector"]
