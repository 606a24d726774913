from .aan import AAN
from .base import SequenceDataset, argmax_accuracy, masked_accuracy, perplexity
from .cifar import CIFAR10, MNIST
from .imdb import IMDB
from .listops import ListOps
from .mqar import MQAR, multiquery_ar
from .pathfinder import PathFinder
from .speechcommands import SpeechCommands
from .wikitext import WikiText

# the datasets the port loads, by the config's ``dataset._name_``: the
# registry each subclass of SequenceDataset enters on definition
DATASETS = SequenceDataset.registry

__all__ = ["AAN", "CIFAR10", "DATASETS", "IMDB", "ListOps", "MNIST", "MQAR", "PathFinder",
           "SequenceDataset", "SpeechCommands", "WikiText", "argmax_accuracy",
           "masked_accuracy", "multiquery_ar", "perplexity"]
