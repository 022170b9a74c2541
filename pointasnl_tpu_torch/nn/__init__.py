"""PyTorch module library: TF-layer equivalents + the PointASNL / PointNet++ cells."""

from pointasnl_tpu_torch.nn.layers import BatchNorm, Dense, Dropout, FullyConnected, PointConv
from pointasnl_tpu_torch.nn.pointasnl import (
    AdaptiveSampling,
    PointASNLSetAbstraction,
    PointNonLocalCell,
    SampleWeights,
    WeightNetHidden,
)
from pointasnl_tpu_torch.nn.pointnet import PointNetFPModule, PointNetSAModule, sample_and_group_all

__all__ = [
    "AdaptiveSampling",
    "BatchNorm",
    "Dense",
    "Dropout",
    "FullyConnected",
    "PointASNLSetAbstraction",
    "PointConv",
    "PointNetFPModule",
    "PointNetSAModule",
    "PointNonLocalCell",
    "SampleWeights",
    "WeightNetHidden",
    "sample_and_group_all",
]
