"""Training (port of ``multimodal_mtrssm_tpu.train``): the weight bridge, the
optimizer and schedulers, the train step, checkpoints, metric logging,
``Trainer``, and the ``train-*`` commands (``train.entry``)."""

from multimodal_mtrssm_tpu_torch.train.checkpoint import CheckpointManager
from multimodal_mtrssm_tpu_torch.train.metrics import MetricLogger
from multimodal_mtrssm_tpu_torch.train.optim import (
    AdamW,
    EarlyStopping,
    PlateauScheduler,
    make_scheduler,
    scheduler_from_state_dict,
    set_learning_rate,
)
from multimodal_mtrssm_tpu_torch.train.steps import (
    make_train_chunk,
    make_train_step,
    make_val_chunk,
    one_update,
)
from multimodal_mtrssm_tpu_torch.train.trainer import Trainer, TrainerConfig
from multimodal_mtrssm_tpu_torch.train.weights import (
    load_lightning_checkpoint,
    load_reference_state_dict,
)

__all__ = [
    "AdamW",
    "CheckpointManager",
    "EarlyStopping",
    "MetricLogger",
    "PlateauScheduler",
    "Trainer",
    "TrainerConfig",
    "load_lightning_checkpoint",
    "load_reference_state_dict",
    "make_scheduler",
    "make_train_chunk",
    "make_train_step",
    "make_val_chunk",
    "scheduler_from_state_dict",
    "one_update",
    "set_learning_rate",
]
