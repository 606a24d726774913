from .steps import compute_accuracy, prep_batch

__all__ = ["compute_accuracy", "prep_batch"]
