from .decode import Decoder

__all__ = ["Decoder"]
