from .schema import MQAR_LRU_FULL, derive_runtime_fields, load_yaml

__all__ = ["MQAR_LRU_FULL", "derive_runtime_fields", "load_yaml"]
