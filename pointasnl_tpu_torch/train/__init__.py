"""Training: schedules, optimizer and state, and the train/eval/predict steps."""

from pointasnl_tpu_torch.train.schedules import bn_momentum_schedule, staircase_lr_schedule
from pointasnl_tpu_torch.train.state import TrainState, make_optimizer
from pointasnl_tpu_torch.train.steps import make_eval_step, make_predict_step, make_train_step

__all__ = [
    "TrainState",
    "bn_momentum_schedule",
    "make_eval_step",
    "make_optimizer",
    "make_predict_step",
    "make_train_step",
    "staircase_lr_schedule",
]
