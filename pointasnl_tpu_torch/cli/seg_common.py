"""Shared helpers for the segmentation train and test CLIs, the port's
copy of ``pointasnl_tpu/cli/seg_common.py``.

The metric conventions here are part of the behavioral contract: point
accuracy and per-class IoU are computed only where smpw > 0, class 0
(unannotated) is excluded from the mIoU mean
(ScanNet/train_scannet.py:312-326), and whole-scene vote pooling accumulates
argmax-over-classes-1: votes per original point (test_scannet.py:96-163).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class SegEvalAccumulator:
    """Streaming seg metrics: masked accuracy + per-class IoU counters."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.total_correct = 0
        self.total_seen = 0
        self.seen_class = np.zeros(num_classes, np.int64)
        self.correct_class = np.zeros(num_classes, np.int64)
        self.iou_deno_class = np.zeros(num_classes, np.int64)

    def update(self, pred: np.ndarray, label: np.ndarray, smpw: Optional[np.ndarray] = None):
        if smpw is None:
            smpw = np.ones_like(label, np.float32)
        valid = smpw > 0
        self.total_correct += int(np.sum((pred == label) & (label > 0) & valid))
        self.total_seen += int(np.sum((label > 0) & valid))
        for c in range(self.num_classes):
            self.seen_class[c] += int(np.sum((label == c) & valid))
            self.correct_class[c] += int(np.sum((pred == c) & (label == c) & valid))
            self.iou_deno_class[c] += int(np.sum(((pred == c) | (label == c)) & valid))

    def miou(self) -> float:
        """mIoU over classes 1..C-1 (class 0 = unannotated is excluded)."""
        return float(np.mean(
            self.correct_class[1:] / (self.iou_deno_class[1:].astype(np.float64) + 1e-6)))

    def accuracy(self) -> float:
        return self.total_correct / max(float(self.total_seen), 1.0)

    def avg_class_accuracy(self) -> float:
        return float(np.mean(self.correct_class[1:] / (self.seen_class[1:].astype(np.float64)
                                                       + 1e-6)))

    def per_class_iou(self) -> np.ndarray:
        return self.correct_class / (self.iou_deno_class.astype(np.float64) + 1e-6)


def add_vote(vote_label_pool, point_idx, pred_label, weight):
    """Accumulate block predictions into the per-original-point vote pool
    (ScanNet/test_scannet.py:96-103, with np.add.at in place of the double
    loop)."""
    mask = np.asarray(weight) > 0
    pts = np.asarray(point_idx)[mask].astype(np.int64)
    preds = np.asarray(pred_label)[mask].astype(np.int64)
    np.add.at(vote_label_pool, (pts, preds), 1)
    return vote_label_pool


def pad_seg_batch(batch_data, batch_label, batch_smpw, batch_size):
    """Pad a short block batch to the batch size (repeat row 0)."""
    bsize = batch_data.shape[0]
    if bsize == batch_size:
        return batch_data, batch_label, batch_smpw, bsize
    pad = batch_size - bsize
    batch_data = np.concatenate([batch_data, np.repeat(batch_data[:1], pad, 0)], 0)
    batch_label = np.concatenate([batch_label, np.repeat(batch_label[:1], pad, 0)], 0)
    batch_smpw = np.concatenate([batch_smpw, np.repeat(batch_smpw[:1], pad, 0)], 0)
    return batch_data, batch_label, batch_smpw, bsize


def str2bool(v) -> bool:
    """The reference passes booleans as strings ('--with_rgb True')."""
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("true", "1", "yes")


def add_dp_arg(p) -> None:
    """The data-parallel flag, kept for the JAX CLIs' surface; the port
    has no data parallelism yet (``check_dp``)."""
    p.add_argument(
        "--dp", action="store_true",
        help="data-parallel over all local cards: not ported yet (raises)")


def check_dp(flags) -> None:
    """Raise where ``--dp`` is asked for: the port runs one card, and never
    runs a data-parallel request on one card in its stead."""
    if getattr(flags, "dp", False):
        raise NotImplementedError("--dp: data parallelism is not ported yet (ROADMAP.md, "
                                  "Open items §1 item 6)")


def add_device_arg(p) -> None:
    """--device: the card unless the caller asks for the CPU."""
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda (the default; raises without a card) "
                   "or cpu")


def device(flags) -> torch.device:
    """The device of `flags`; a CUDA device with no card raises (it never
    falls back to the CPU)."""
    dev = torch.device(flags.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {flags.device}: no CUDA card is available; pass "
                           f"--device cpu to run on the CPU")
    return dev


def add_nl_args(p) -> None:
    """The whole-scene non-local attention flags."""
    p.add_argument(
        "--nl_block_size", type=int, default=0,
        help="chunk the non-local K/V axis with an online softmax "
        "(0 = dense attention map; >0 enables whole-scene-scale memory)",
    )
    p.add_argument(
        "--nl_flash", type=str2bool, default=False,
        help="use the flash-attention kernels in the non-local cells",
    )


def nl_kwargs(args_or_flags) -> dict:
    """Model kwargs for the non-local attention controls, from flags or an
    args.txt dict (so testers rebuild exactly what was trained)."""
    if isinstance(args_or_flags, dict):
        get = args_or_flags.get
    else:
        def get(k, d=None):
            return getattr(args_or_flags, k, d)
    blk = int(get("nl_block_size", 0) or 0)
    return {
        "nl_kv_block_size": blk if blk > 0 else None,
        "nl_use_flash": bool(get("nl_flash", False)),
    }
