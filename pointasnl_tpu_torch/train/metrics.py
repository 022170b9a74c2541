"""Metrics: confusion matrices, IoU and the per-class evaluators, the
counterparts of ``pointasnl_tpu/train/metrics.py``.

The metric definitions are part of the behavioural contract:
- IoU_from_confusions with absent-class mIoU backfill  <- utils/metrics.py:119-145
- iouEval (ignore-column zeroing, include-mean)        <- SemanticKITTI/auxiliary/np_ioueval.py:8-72
- the confusion is counted on the tensors' device (``torch.bincount``), as
  the JAX package counts it with ``jnp.bincount``; the evaluators' readouts
  are host-side numpy, like the reference's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def confusion_matrix(preds: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Dense (C, C) int64 confusion matrix on the tensors' device, rows =
    truth, cols = prediction."""
    idx = labels.reshape(-1).long() * num_classes + preds.reshape(-1).long()
    counts = torch.bincount(idx, minlength=num_classes * num_classes)
    return counts.reshape(num_classes, num_classes)


def IoU_from_confusions(confusions: np.ndarray) -> np.ndarray:
    """Per-class IoU with absent-class backfill (utils/metrics.py:119-145).

    confusions: (..., C, C), second-to-last axis = truth, last = prediction.
    Absent classes (no true points) get the mean IoU of present classes so a
    later flat mean equals the mean over present classes.
    """
    confusions = np.asarray(confusions, dtype=np.float64)
    TP = np.diagonal(confusions, axis1=-2, axis2=-1)
    TP_plus_FN = np.sum(confusions, axis=-1)
    TP_plus_FP = np.sum(confusions, axis=-2)
    IoU = TP / (TP_plus_FP + TP_plus_FN - TP + 1e-6)
    mask = TP_plus_FN < 1e-3
    counts = np.sum(1 - mask, axis=-1, keepdims=True)
    mIoU = np.sum(IoU, axis=-1, keepdims=True) / (counts + 1e-6)
    IoU += mask * mIoU
    return IoU.astype(np.float32)


class IouEval:
    """Streaming confusion-matrix IoU evaluator (np_ioueval.py:8-72), in numpy.

    Convention kept for parity: addBatch indexes the matrix as [pred, target]
    (rows = predictions), and getStats zeros the *columns* of the ignored
    classes before computing tp/fp/fn.
    """

    def __init__(self, n_classes: int, ignore: Optional[Sequence[int]] = None):
        self.n_classes = n_classes
        self.ignore = np.array(ignore if ignore is not None else [], dtype=np.int64)
        self.include = np.array(
            [n for n in range(n_classes) if n not in self.ignore], dtype=np.int64)
        self.reset()

    def reset(self):
        self.conf_matrix = np.zeros((self.n_classes, self.n_classes), dtype=np.int64)

    def addBatch(self, x, y):  # x=preds, y=targets
        x_row = np.asarray(x).reshape(-1)
        y_row = np.asarray(y).reshape(-1)
        idxs = tuple(np.stack((x_row, y_row), axis=0))
        np.add.at(self.conf_matrix, idxs, 1)

    def _conf(self) -> np.ndarray:
        return self.conf_matrix.copy()

    def getStats(self):
        conf = self._conf()
        conf[:, self.ignore] = 0
        tp = np.diag(conf)
        fp = conf.sum(axis=1) - tp
        fn = conf.sum(axis=0) - tp
        return tp, fp, fn

    def getIoU(self):
        tp, fp, fn = self.getStats()
        union = tp + fp + fn + 1e-15
        iou = tp / union
        iou_mean = (tp[self.include] / union[self.include]).mean()
        return iou_mean, iou

    def getacc(self):
        tp, fp, fn = self.getStats()
        total_tp = tp.sum()
        total = tp[self.include].sum() + fp[self.include].sum() + 1e-15
        return total_tp / total


class DeviceIouEval(IouEval):
    """IouEval with the confusion counted on the device of the predictions
    (the counterpart of the JAX package's ``JaxIouEval``): one
    ``torch.bincount`` and an add a batch, in int64, conf[pred, target]; the
    matrix comes to the host only at readout. ``device`` is where it starts;
    a batch on another device moves it there."""

    def __init__(self, n_classes: int, ignore: Optional[Sequence[int]] = None,
                 device: torch.device = torch.device("cpu")):
        self.device = torch.device(device)
        super().__init__(n_classes, ignore)

    def reset(self):
        self.conf_matrix = torch.zeros((self.n_classes, self.n_classes), dtype=torch.int64,
                                       device=self.device)

    def addBatch(self, x, y):  # x=preds, y=targets; conf[pred, target] convention
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        conf = confusion_matrix(x, y.to(x.device), self.n_classes).T
        self.conf_matrix = self.conf_matrix.to(conf.device) + conf

    def _conf(self) -> np.ndarray:
        return self.conf_matrix.cpu().numpy().copy()


def metrics_from_confusion(conf: np.ndarray):
    """(PRE, REC, F1, IoU, ACC) from a (…, C, C) confusion (utils/metrics.py:36-71)."""
    conf = np.asarray(conf, dtype=np.float64)
    TP = np.diagonal(conf, axis1=-2, axis2=-1)
    TP_plus_FN = np.sum(conf, axis=-1)
    TP_plus_FP = np.sum(conf, axis=-2)
    PRE = TP / (TP_plus_FN + 1e-6)
    REC = TP / (TP_plus_FP + 1e-6)
    ACC = np.sum(TP, axis=-1) / (np.sum(conf, axis=(-2, -1)) + 1e-6)
    F1 = 2 * TP / (TP_plus_FP + TP_plus_FN + 1e-6)
    IoU = F1 / (2 - F1)
    return PRE, REC, F1, IoU, ACC


def smooth_metrics(confusions: np.ndarray, smooth_n: int = 0, ignore_unclassified: bool = False):
    """Metrics over an epoch axis with +-smooth_n confusion smoothing
    (utils/metrics.py:73-117)."""
    confusions = np.asarray(confusions, dtype=np.float64).copy()
    if ignore_unclassified:
        confusions[..., 0, :] = 0
        confusions[..., :, 0] = 0
    smoothed = confusions.copy()
    if confusions.ndim > 2 and smooth_n > 0:
        for epoch in range(confusions.shape[-3]):
            i0 = max(epoch - smooth_n, 0)
            i1 = min(epoch + smooth_n + 1, confusions.shape[-3])
            smoothed[..., epoch, :, :] = np.sum(confusions[..., i0:i1, :, :], axis=-3)
    return metrics_from_confusion(smoothed)
