"""Training of the port: losses in ``heads/losses.py``; here the
optimizer and schedules, the train state, the steps, checkpoints, early
stopping and the epoch loop."""
from adfmsl_torch.train.checkpoint import CheckpointManager
from adfmsl_torch.train.early_stop import EarlyStopper
from adfmsl_torch.train.fewshot import FewshotConfig, FewshotTrainer
from adfmsl_torch.train.loop import EpochMetrics, Trainer, make_dataset_and_loader
from adfmsl_torch.train.optim import Optimizer, PlateauTracker, make_schedule, param_labels
from adfmsl_torch.train.state import TrainState
from adfmsl_torch.train.steps import make_eval_step, make_train_step

__all__ = ["CheckpointManager", "EarlyStopper", "EpochMetrics", "FewshotConfig",
           "FewshotTrainer", "Optimizer",
           "PlateauTracker", "TrainState", "Trainer", "make_dataset_and_loader",
           "make_eval_step", "make_schedule", "make_train_step", "param_labels"]
