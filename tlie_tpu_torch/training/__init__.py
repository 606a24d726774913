from .checkpoint import restore_checkpoint, save_checkpoint
from .loop import TrainResult, train
from .steps import compute_accuracy, cross_entropy_loss, prep_batch, train_step

__all__ = [
    "TrainResult", "compute_accuracy", "cross_entropy_loss", "prep_batch",
    "restore_checkpoint", "save_checkpoint", "train", "train_step",
]
