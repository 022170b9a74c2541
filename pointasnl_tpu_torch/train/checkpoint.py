"""Checkpoint / resume with epoch retention, the counterpart of
``pointasnl_tpu/train/checkpoint.py``.

The reference saves a "latest" checkpoint per epoch plus a "best" on metric
improvement (train.py:197-203), and the grid trainers keep per-epoch
numbered snapshots that the testers restore by epoch with max_to_keep=100
(SemanticKITTI/test_semantic_kitti_grid.py:~36).

A checkpoint is a directory holding one ``torch.save`` file, ``state.pt``:
the global step, the model's ``state_dict`` (parameters and BN statistics)
and the optimizer's ``state_dict`` (its moments, and the LR schedule's
``update_count`` in its parameter group). Epoch-numbered saves live at
``epoch_00012/``; ``latest`` and ``best`` are relative symlink aliases onto
numbered saves, so each epoch is written once. The LR and BN-momentum
schedules, and the dropout masks (``train.steps.fold_in``), are functions
of the step, so a restored run continues the uninterrupted one to the bit.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import List, Optional, Union

import torch

from pointasnl_tpu_torch.train.state import TrainState

_EPOCH_RE = re.compile(r"^epoch_(\d+)$")
STATE_FILE = "state.pt"


def _epoch_name(epoch: int) -> str:
    return f"epoch_{epoch:05d}"


def _resolve(ckpt_dir: str, name: Union[str, int], *, for_save: bool = False) -> str:
    """Map a checkpoint name ('latest'/'best'/'epoch_00007'/7/'7') to a path.

    The 'latest'-falls-back-to-newest-epoch rule applies only when reading:
    a save through the fallback would overwrite the newest numbered epoch
    instead of writing a literal 'latest'.
    """
    ckpt_dir = os.path.abspath(ckpt_dir)
    if isinstance(name, int) or (isinstance(name, str) and name.isdigit()):
        name = _epoch_name(int(name))
    path = os.path.join(ckpt_dir, str(name))
    if not for_save and name == "latest" and not os.path.isdir(path):
        epochs = list_epochs(ckpt_dir)
        if epochs:
            path = os.path.join(ckpt_dir, _epoch_name(epochs[-1]))
    return path


def list_epochs(ckpt_dir: str) -> List[int]:
    """Sorted epoch numbers of the numbered checkpoints present."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for entry in os.listdir(ckpt_dir):
        m = _EPOCH_RE.match(entry)
        if m and os.path.isdir(os.path.join(ckpt_dir, entry)):
            out.append(int(m.group(1)))
    return sorted(out)


def save_checkpoint(state: TrainState, ckpt_dir: str, name: Union[str, int] = "latest") -> str:
    """Save the step, the model and the optimizer; returns the directory."""
    path = _resolve(ckpt_dir, name, for_save=True)
    # Never write through an alias symlink: that would clobber its target.
    if os.path.islink(path):
        os.unlink(path)
    os.makedirs(path, exist_ok=True)
    tree = {"step": int(state.step), "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict()}
    tmp = os.path.join(path, f"{STATE_FILE}.tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))  # a reader sees the old file or the new
    return path


def restore_checkpoint(state: TrainState, ckpt_dir: str, name: Union[str, int] = "latest"
                       ) -> TrainState:
    """Load a checkpoint into `state` in place (its model and optimizer must
    have the saved structure) and return it. The tensors go to the model's
    device.

    ``name`` may be 'latest', 'best', an epoch number (int or digit string),
    or an explicit directory name like 'epoch_00042'.
    """
    path = os.path.join(_resolve(ckpt_dir, name), STATE_FILE)
    device = next(state.model.parameters()).device
    tree = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(tree["model"], strict=True)
    state.optimizer.load_state_dict(tree["optimizer"])
    state.step = int(tree["step"])
    return state


def checkpoint_exists(ckpt_dir: str, name: Union[str, int] = "latest") -> bool:
    return os.path.isdir(_resolve(ckpt_dir, name))


class CheckpointManager:
    """Per-epoch numbered checkpoints with retention + best/latest aliases.

    ``save(state, epoch, is_best=...)`` writes ``epoch_{epoch:05d}`` once and
    re-points the ``latest`` (and optionally ``best``) symlink at it. At most
    ``max_to_keep`` numbered checkpoints are retained (the reference keeps
    100); the targets of ``latest``/``best`` are never pruned, as the
    reference's separate best-saver survives the Saver's rotation.
    """

    def __init__(self, ckpt_dir: str, max_to_keep: Optional[int] = 100):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def _alias_path(self, alias: str) -> str:
        return os.path.join(self.ckpt_dir, alias)

    def _point_alias(self, alias: str, epoch: int) -> None:
        """Atomically re-point a relative symlink alias at a numbered save."""
        link = self._alias_path(alias)
        tmp = link + ".tmp"
        if os.path.islink(tmp) or os.path.exists(tmp):
            os.unlink(tmp)
        os.symlink(_epoch_name(epoch), tmp)
        if os.path.isdir(link) and not os.path.islink(link):
            shutil.rmtree(link)  # a literal alias written by save_checkpoint
        os.replace(tmp, link)

    def _alias_epoch(self, alias: str) -> Optional[int]:
        link = self._alias_path(alias)
        if os.path.islink(link):
            m = _EPOCH_RE.match(os.path.basename(os.readlink(link)))
            if m:
                return int(m.group(1))
        return None

    def save(self, state: TrainState, epoch: int, is_best: bool = False) -> str:
        path = save_checkpoint(state, self.ckpt_dir, _epoch_name(epoch))
        self._point_alias("latest", epoch)
        if is_best:
            self._point_alias("best", epoch)
        self._prune()
        return path

    def restore(self, state: TrainState, name: Union[str, int] = "latest") -> TrainState:
        return restore_checkpoint(state, self.ckpt_dir, name)

    def epochs(self) -> List[int]:
        return list_epochs(self.ckpt_dir)

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def best_epoch(self) -> Optional[int]:
        return self._alias_epoch("best")

    def _prune(self) -> None:
        if self.max_to_keep is None:
            return
        keep = {self._alias_epoch("latest"), self._alias_epoch("best")}
        epochs = self.epochs()
        excess = len(epochs) - self.max_to_keep
        for epoch in epochs:
            if excess <= 0:
                break
            if epoch in keep:
                continue
            shutil.rmtree(os.path.join(self.ckpt_dir, _epoch_name(epoch)))
            excess -= 1
