"""Data for the port's CLIs and checks (numpy, and scipy's KD-tree for the
grid pipelines): synthetic scenes, the ScanNet datasets and the
augmentations the ScanNet CLIs call; the grid-sampled pipelines are the
modules ``grid_pipeline``, ``scannet_grid`` and ``semantic_kitti_grid``."""

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
