from .base import SequenceDataset, masked_accuracy, perplexity
from .mqar import MQAR, multiquery_ar
from .wikitext import WikiText

# the datasets the port loads, by the config's ``dataset._name_``: the
# registry each subclass of SequenceDataset enters on definition
DATASETS = SequenceDataset.registry

__all__ = ["DATASETS", "MQAR", "SequenceDataset", "WikiText", "masked_accuracy",
           "multiquery_ar", "perplexity"]
