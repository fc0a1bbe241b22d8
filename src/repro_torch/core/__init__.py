"""The Connector interface (paper §3) and its error taxonomy, copied from
``repro/core`` as far as the port's checkpoint and data paths need them."""

from .connector import (AppChannel, ByteRange, Connector, Credential,
                        Session, StatInfo, iter_files)
from .errors import IntegrityError, NotFound, PermanentError, TransientError

__all__ = ["AppChannel", "ByteRange", "Connector", "Credential", "Session",
           "StatInfo", "iter_files", "IntegrityError", "NotFound",
           "PermanentError", "TransientError"]
