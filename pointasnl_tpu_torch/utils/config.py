"""Config persistence: the args.txt JSON round-trip and the source snapshot
of a run, the port's copy of ``pointasnl_tpu/utils/config.py``.

The reference persists train-time argparse flags as JSON (``args.txt``,
ScanNet/train_scannet_grid.py:94-95) and the testers reload them to rebuild
the model (test_scannet_grid.py:37-39).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
from typing import Any, Dict, Union

# Model name -> its module under pointasnl_tpu_torch/models.
MODEL_MODULES = {"pointasnl_cls": "cls", "pointasnl_sem_seg": "sem_seg",
                 "pointasnl_sem_seg_res": "sem_seg_res"}


def save_args(args: Union[argparse.Namespace, Dict[str, Any]], log_dir: str,
              name: str = "args.txt") -> str:
    d = vars(args) if isinstance(args, argparse.Namespace) else dict(args)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, name)
    with open(path, "w") as f:
        json.dump(d, f, indent=2, sort_keys=True)
    return path


def load_args(log_dir: str, name: str = "args.txt") -> Dict[str, Any]:
    with open(os.path.join(log_dir, name)) as f:
        return json.load(f)


def snapshot_sources(log_dir: str, model_name: str, extra_modules=()) -> str:
    """Copy the run's defining source files into ``<log_dir>/src_snapshot/``,
    as the reference copies the model file and the trainer next to its logs
    (train.py:67-70): the port's model module, its cell and layer modules,
    and `extra_modules` (module objects or file paths). Returns the
    directory."""
    dst = os.path.join(log_dir, "src_snapshot")
    os.makedirs(dst, exist_ok=True)
    modules = ["pointasnl_tpu_torch.nn.pointasnl", "pointasnl_tpu_torch.nn.layers"]
    if model_name in MODEL_MODULES:
        modules.insert(0, f"pointasnl_tpu_torch.models.{MODEL_MODULES[model_name]}")
    files = [importlib.import_module(m).__file__ for m in modules]
    files += [extra if isinstance(extra, str) else extra.__file__ for extra in extra_modules]
    for f in files:
        if f and os.path.isfile(f):
            shutil.copy2(f, os.path.join(dst, os.path.basename(f)))
    return dst
