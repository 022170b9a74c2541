"""Train, eval and predict steps for classification and segmentation
(``pointasnl_tpu/train/steps.py``).

A train step is the reference's one sess.run (train.py:246-248): forward in
train mode with the scheduled BN momentum, loss, backward, optimizer update
and BN statistics update. It runs on the model's device; the batch lies
there too. The gradients stay in each parameter's ``.grad`` after the step.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from pointasnl_tpu_torch.nn.losses import classification_loss, segmentation_loss
from pointasnl_tpu_torch.train.state import TrainState


def make_train_step(*, bn_schedule: Callable[[int], float], task: str = "cls",
                    uniform_weight: float = 0.0, weights_decay: float = 1e-4,
                    repulsion_radius: float = 0.07):
    """Build a train step: (state, batch) -> metrics, advancing `state`.

    task='cls': batch = {'points': (B,N,C), 'labels': (B,)}
    task='seg': batch = {'points': (B,N,C), 'labels': (B,N), 'smpw': (B,N)}

    The metrics are 0-d tensors on the device (no synchronisation): loss,
    classify_loss, uniform_loss, reg_loss and accuracy.
    """
    if task not in ("cls", "seg"):
        raise ValueError(f"unknown task {task!r}")

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits, end_points = model(batch["points"], bn_momentum=bn_schedule(state.step))
        if task == "cls":
            loss, aux = classification_loss(
                logits, batch["labels"], model, l1_xyz=end_points["l1_xyz"],
                uniform_weight=uniform_weight, weights_decay=weights_decay)
        else:
            loss, aux = segmentation_loss(
                logits, batch["labels"], batch["smpw"], model, l1_xyz=end_points["l1_xyz"],
                uniform_weight=uniform_weight, weights_decay=weights_decay,
                radius=repulsion_radius)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in aux.items()}
        metrics["loss"] = loss.detach()
        metrics["accuracy"] = _accuracy(logits.detach(), batch["labels"])
        return metrics

    return train_step


def _accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).float().mean()


def make_eval_step():
    """Eval step: (state, batch) -> (logits, {'accuracy'}), eval mode, no grad."""

    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits = predict_step(state, batch["points"])
        return logits, {"accuracy": _accuracy(logits, batch["labels"])}

    return eval_step


def predict_step(state: TrainState, points: torch.Tensor) -> torch.Tensor:
    """Eval-mode forward returning logits only (test-time voting loops)."""
    state.model.eval()
    with torch.inference_mode():
        logits, _ = state.model(points)
    return logits


def make_predict_step():
    """The predict step, (state, points) -> logits."""
    return predict_step
