from .schema import (
    AAN_TRANSFORMER_FULL, CIFAR_LRU_FULL, CIFAR_MAMBA2_FULL, CIFAR_MAMBA2_LTI_FULL,
    CIFAR_NORM_ATTENTION_GATING_FULL, CIFAR_S4_FULL, CIFAR_S5_FULL, CIFAR_SM_ATTENTION_FULL,
    IMDB_MAMBA2_FULL, LISTOPS_MAMBA2_FULL, LISTOPS_S4_FULL, LISTOPS_S5_FULL,
    MQAR_LIN_ATTENTION_FULL, MQAR_LRU_FULL, MQAR_MAMBA2_FULL, MQAR_NORM_ATTENTION_CONV_FULL,
    MQAR_MAMBA1_SMALL, MQAR_S4_FULL, MQAR_S5_FULL, MQAR_SM_ATTENTION_FULL, PATHFINDER_S4_FULL,
    SC_S5_MFCC_FULL, WIKITEXT_LRU_SHORT, WIKITEXT_NORM_ATTENTION_SHORT, ExperimentConfig,
    apply_sweep_point, checkpoint_name, derive_runtime_fields, expand_sweep, iter_sweep,
    lang_model, load_experiment, load_sweep, load_yaml, model_parallel_of, step_driven,
    train_fields,
)

__all__ = [
    "AAN_TRANSFORMER_FULL", "CIFAR_LRU_FULL", "CIFAR_MAMBA2_FULL", "CIFAR_MAMBA2_LTI_FULL",
    "CIFAR_NORM_ATTENTION_GATING_FULL", "CIFAR_S4_FULL", "CIFAR_S5_FULL",
    "CIFAR_SM_ATTENTION_FULL", "IMDB_MAMBA2_FULL", "LISTOPS_MAMBA2_FULL", "LISTOPS_S4_FULL",
    "LISTOPS_S5_FULL",
    "MQAR_LIN_ATTENTION_FULL", "MQAR_LRU_FULL", "MQAR_MAMBA2_FULL",
    "MQAR_MAMBA1_SMALL", "MQAR_NORM_ATTENTION_CONV_FULL", "MQAR_S4_FULL", "MQAR_S5_FULL",
    "MQAR_SM_ATTENTION_FULL", "PATHFINDER_S4_FULL", "SC_S5_MFCC_FULL", "WIKITEXT_LRU_SHORT",
    "WIKITEXT_NORM_ATTENTION_SHORT",
    "ExperimentConfig", "apply_sweep_point", "checkpoint_name", "derive_runtime_fields",
    "expand_sweep", "iter_sweep", "lang_model", "load_experiment", "load_sweep", "load_yaml",
    "model_parallel_of", "step_driven", "train_fields",
]
