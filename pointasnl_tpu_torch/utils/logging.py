"""Tee logging (stdout + log file), the reference's log_string
(train.py:90-93); the port's copy of ``pointasnl_tpu/utils/logging.py``."""

from __future__ import annotations

import os
import sys
from typing import Optional


class Logger:
    def __init__(self, log_dir: Optional[str] = None, filename: str = "log_train.txt"):
        self.fout = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self.fout = open(os.path.join(log_dir, filename), "a")

    def log(self, msg: str):
        if self.fout is not None:
            self.fout.write(msg + "\n")
            self.fout.flush()
        print(msg)
        sys.stdout.flush()

    __call__ = log

    def close(self):
        if self.fout is not None:
            self.fout.close()
            self.fout = None
