"""Training of the PyTorch port: the simultaneous Flash step."""

from .trainer import TrainingPipeline
from .training_config import AdamW, TrainingConfig

__all__ = ["AdamW", "TrainingConfig", "TrainingPipeline"]
