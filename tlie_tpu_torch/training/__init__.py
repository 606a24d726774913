from .checkpoint import restore_checkpoint, restore_resume, save_checkpoint, save_resume
from .loop import TrainResult, train
from .steps import compute_accuracy, cross_entropy_loss, prep_batch, train_step

__all__ = [
    "TrainResult", "compute_accuracy", "cross_entropy_loss", "prep_batch",
    "restore_checkpoint", "restore_resume", "save_checkpoint", "save_resume", "train",
    "train_step",
]
