from .mqar import MQAR, masked_accuracy, multiquery_ar

__all__ = ["MQAR", "masked_accuracy", "multiquery_ar"]
