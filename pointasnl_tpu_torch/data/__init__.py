"""Data for the port's CLIs and checks (numpy only): synthetic scenes, the
ScanNet datasets and the augmentations the ScanNet CLIs call."""

from pointasnl_tpu_torch.data.scannet import (
    ScannetDataset,
    ScannetDatasetWholeScene,
    ScannetDatasetWholeSceneSlidingWindow,
)
from pointasnl_tpu_torch.data.synthetic import surface_scene

__all__ = [
    "ScannetDataset",
    "ScannetDatasetWholeScene",
    "ScannetDatasetWholeSceneSlidingWindow",
    "surface_scene",
]
