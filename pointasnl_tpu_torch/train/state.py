"""Train state: the model, its optimizer and the global step
(``pointasnl_tpu/train/state.py``).

The optimizer's learning rate follows a schedule of its own update count,
read before the count moves on, as optax's ``scale_by_schedule`` does. The
count lives in the optimizer's parameter group, so it is saved with its
``state_dict``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

import torch
from torch import nn


def make_optimizer(name: str, lr_schedule: Callable[[int], float],
                   params: Iterable[torch.nn.Parameter], *,
                   momentum: float = 0.9) -> torch.optim.Optimizer:
    """adam | momentum, the two reference options (train.py:150-154). Adam
    has TF's defaults: b1 .9, b2 .999, eps 1e-8."""
    group = {"params": list(params), "update_count": 0}
    if name == "adam":
        opt = torch.optim.Adam([group], lr=lr_schedule(0), betas=(0.9, 0.999), eps=1e-8)
    elif name == "momentum":
        opt = torch.optim.SGD([group], lr=lr_schedule(0), momentum=momentum)
    else:
        raise ValueError(f"unknown optimizer {name!r}")

    def set_lr(optimizer, args, kwargs):
        for g in optimizer.param_groups:
            g["lr"] = float(lr_schedule(g["update_count"]))
            g["update_count"] += 1

    opt.register_step_pre_hook(set_lr)
    return opt


@dataclass
class TrainState:
    """What a train step reads and advances: the model (parameters and BN
    statistics), its optimizer, and the global step of the schedules."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(model: nn.Module, *, optimizer: str = "adam",
                       lr_schedule: Callable[[int], float], momentum: float = 0.9) -> TrainState:
    """A TrainState at step 0 around `model`, whose parameters were
    initialised when it was built (where the JAX package's counterpart runs
    flax's init), with the optimizer `optimizer` of make_optimizer."""
    return TrainState(model, make_optimizer(optimizer, lr_schedule, model.parameters(),
                                            momentum=momentum))
