"""Train, eval and predict steps for classification and segmentation
(``pointasnl_tpu/train/steps.py``).

A train step is the reference's one sess.run (train.py:246-248): forward in
train mode with the scheduled BN momentum, loss, backward, optimizer update
and BN statistics update. It runs on the model's device; the batch lies
there too. The gradients stay in each parameter's ``.grad`` after the step.

Dropout draws from the generator the caller passes, folded with the step as
JAX folds its ``dropout_rng`` (``fold_in(dropout_rng, state.step)``): the
masks of a step depend only on the generator's seed and the global step, so
a run restored from a checkpoint draws the masks the uninterrupted run drew.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

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
    _check_task(task)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   dropout_rng: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """`dropout_rng`: the generator whose seed, folded with the step,
        draws the dropout masks (``fold_in``), on its own device; a model
        with an active dropout raises without it."""
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        gen = None if dropout_rng is None else fold_in(dropout_rng, state.step)
        logits, end_points = model(batch["points"], bn_momentum=bn_schedule(state.step),
                                   dropout_generator=gen)
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


def _check_task(task: str) -> None:
    if task not in ("cls", "seg"):
        raise ValueError(f"unknown task {task!r}")


_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """splitmix64's finaliser: a bijection of 64-bit integers."""
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(generator: torch.Generator, data: int) -> torch.Generator:
    """A new generator on `generator`'s device, seeded from its seed
    (``initial_seed``) and `data`, as ``jax.random.fold_in`` derives a key
    from a key and an integer: a function of the two only, not of what the
    generator has drawn since it was seeded."""
    seed = _mix64((_mix64(generator.initial_seed() & _MASK64) + data) & _MASK64)
    return torch.Generator(device=generator.device).manual_seed(seed >> 1)


def _accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).float().mean()


def make_eval_step(*, task: str = "cls"):
    """Eval step: (state, batch) -> (logits, {'accuracy'}), eval mode, no
    grad. `task` ('cls' or 'seg') is checked as make_train_step checks it;
    the step is the same for both."""
    _check_task(task)

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
