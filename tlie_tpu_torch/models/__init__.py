from .backbone import ClassificationModel
from .lru import LRU
from .mamba2 import Mamba
from .registry import build_models

__all__ = ["ClassificationModel", "LRU", "Mamba", "build_models"]
