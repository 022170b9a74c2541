"""Metric writers, the counterparts of ``pointasnl_tpu/train/summary.py``.

The reference logs scalars (loss/accuracy/lr/bn_decay) through tf.summary
FileWriters per split (train.py:125-170). Here:

- `CsvMetricWriter`: dependency-free per-split csv files (step, name, value),
  the JAX package's file line for line;
- `TensorBoardMetricWriter`: ``torch.utils.tensorboard`` (same scalars,
  viewable in TensorBoard) where the ``tensorboard`` package is installed;
- `MetricWriter.create`: picks TensorBoard when it can be made, else CSV.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional, Union

import numpy as np

Number = Union[int, float]


class CsvMetricWriter:
    def __init__(self, logdir: str, split: str = "train"):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, f"metrics_{split}.csv")
        new = not os.path.exists(self.path)
        self._fh = open(self.path, "a", newline="")
        self._writer = csv.writer(self._fh)
        if new:
            self._writer.writerow(["step", "name", "value"])

    def scalar(self, name: str, value: Number, step: int):
        self._writer.writerow([int(step), name, float(value)])

    def scalars(self, metrics: Dict[str, Number], step: int):
        for k, v in metrics.items():
            self.scalar(k, v, step)

    def histogram(self, name: str, values, step: int, bins: int = 30):
        """Summarised as quantile scalars (csv has no histogram type)."""
        v = np.asarray(values).ravel()
        for q in (0, 25, 50, 75, 100):
            self.scalar(f"{name}_p{q}", float(np.percentile(v, q)), step)

    def flush(self):
        self._fh.flush()

    def close(self):
        self._fh.close()


class TensorBoardMetricWriter:
    def __init__(self, logdir: str, split: str = "train"):
        from torch.utils.tensorboard import SummaryWriter

        self._w = SummaryWriter(os.path.join(logdir, split))

    def scalar(self, name: str, value: Number, step: int):
        self._w.add_scalar(name, float(value), int(step))

    def scalars(self, metrics: Dict[str, Number], step: int):
        for k, v in metrics.items():
            self.scalar(k, v, step)

    def histogram(self, name: str, values, step: int, bins: int = 30):
        """Full histograms (e.g. the reference's ball-query count histogram,
        pointasnl_util.py:364)."""
        self._w.add_histogram(name, np.asarray(values), int(step), bins=bins)

    def flush(self):
        self._w.flush()

    def close(self):
        self._w.close()


class MetricWriter:
    @staticmethod
    def create(logdir: str, split: str = "train", backend: Optional[str] = None):
        """backend 'csv', 'tensorboard', or None: TensorBoard where it can be
        made, else CSV. A named 'tensorboard' that cannot be made raises."""
        if backend == "csv":
            return CsvMetricWriter(logdir, split)
        if backend in (None, "tensorboard"):
            try:
                return TensorBoardMetricWriter(logdir, split)
            except Exception:
                if backend == "tensorboard":
                    raise
        return CsvMetricWriter(logdir, split)
