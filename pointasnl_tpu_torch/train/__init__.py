"""Training: schedules, optimizer and state, the train/eval/predict steps,
checkpoints, metrics, metric writers and profiling."""

from pointasnl_tpu_torch.train.checkpoint import (
    CheckpointManager,
    checkpoint_exists,
    list_epochs,
    restore_checkpoint,
    save_checkpoint,
)
from pointasnl_tpu_torch.train.metrics import DeviceIouEval, IoU_from_confusions, IouEval
from pointasnl_tpu_torch.train.schedules import bn_momentum_schedule, staircase_lr_schedule
from pointasnl_tpu_torch.train.state import TrainState, create_train_state, make_optimizer
from pointasnl_tpu_torch.train.steps import make_eval_step, make_predict_step, make_train_step

__all__ = [
    "CheckpointManager",
    "DeviceIouEval",
    "IoU_from_confusions",
    "IouEval",
    "TrainState",
    "bn_momentum_schedule",
    "checkpoint_exists",
    "create_train_state",
    "make_eval_step",
    "make_optimizer",
    "make_predict_step",
    "make_train_step",
    "list_epochs",
    "restore_checkpoint",
    "save_checkpoint",
    "staircase_lr_schedule",
]
