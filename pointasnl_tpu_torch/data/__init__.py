"""Data for the port's CLIs and checks (numpy, and scipy's KD-tree for the
grid pipelines): synthetic scenes, the ScanNet datasets and the host
augmentations (``provider``); the grid-sampled pipelines are the modules
``grid_pipeline``, ``scannet_grid`` and ``semantic_kitti_grid``; the
SemanticKITTI block datasets ``semantic_kitti`` (over ``laserscan``), the
ModelNet40 dataset ``modelnet``, the device-side augmentations ``augment``
(torch), and the host tools ``pc_util``, ``laserscan_vis`` and
``prepare_scannet``. None imports h5py or matplotlib when it is imported."""

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
