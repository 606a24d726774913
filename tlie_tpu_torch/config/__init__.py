from .schema import (
    MQAR_LRU_FULL, MQAR_MAMBA2_FULL, MQAR_SM_ATTENTION_FULL, WIKITEXT_LRU_SHORT, checkpoint_name,
    derive_runtime_fields, lang_model, load_yaml, step_driven, train_fields,
)

__all__ = [
    "MQAR_LRU_FULL", "MQAR_MAMBA2_FULL", "MQAR_SM_ATTENTION_FULL", "WIKITEXT_LRU_SHORT",
    "checkpoint_name", "derive_runtime_fields", "lang_model", "load_yaml", "step_driven",
    "train_fields",
]
