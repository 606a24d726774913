from .backbone import ClassificationModel
from .lru import LRU
from .mamba2 import Mamba
from .registry import build_models
from .transformer import Transformer

__all__ = ["ClassificationModel", "LRU", "Mamba", "Transformer", "build_models"]
