from .common import ArchConfig
from .registry import ModelApi, build

__all__ = ["ArchConfig", "ModelApi", "build"]
