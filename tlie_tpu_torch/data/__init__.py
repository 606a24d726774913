from .base import masked_accuracy, perplexity
from .mqar import MQAR, multiquery_ar
from .wikitext import WikiText

# the datasets the port loads, by the config's ``dataset._name_``
DATASETS = {"mqar": MQAR, "wikitext": WikiText}

__all__ = ["DATASETS", "MQAR", "WikiText", "masked_accuracy", "multiquery_ar", "perplexity"]
