from .schema import (
    MQAR_LRU_FULL, checkpoint_name, derive_runtime_fields, lang_model, load_yaml,
    step_driven, train_fields,
)

__all__ = [
    "MQAR_LRU_FULL", "checkpoint_name", "derive_runtime_fields", "lang_model", "load_yaml",
    "step_driven", "train_fields",
]
