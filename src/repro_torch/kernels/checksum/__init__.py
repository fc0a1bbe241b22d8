from .ops import checksum_digest, checksum_digests

__all__ = ["checksum_digest", "checksum_digests"]
