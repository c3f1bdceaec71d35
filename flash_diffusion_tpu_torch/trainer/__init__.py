"""Training of the PyTorch port: the Flash training run."""

from .checkpoint import adapt_state_dict, latest_step, rename_keys, restore_state, save_state
from .loggers import CheckpointCallback, MetricLogger, QualityValidator, SampleLogger, make_grid, save_png
from .trainer import TrainingPipeline, export_lora
from .training_config import OPTIMIZERS, SCHEDULES, Optimizer, TrainingConfig

__all__ = [
    "OPTIMIZERS",
    "SCHEDULES",
    "CheckpointCallback",
    "MetricLogger",
    "Optimizer",
    "QualityValidator",
    "SampleLogger",
    "TrainingConfig",
    "TrainingPipeline",
    "adapt_state_dict",
    "export_lora",
    "latest_step",
    "make_grid",
    "rename_keys",
    "restore_state",
    "save_png",
    "save_state",
]
