from .backbone import ClassificationModel
from .lru import LRU
from .registry import build_models

__all__ = ["ClassificationModel", "LRU", "build_models"]
