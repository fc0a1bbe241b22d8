from .ops import selective_scan

__all__ = ["selective_scan"]
