"""PyTorch module library: TF-layer equivalents + the PointASNL / PointNet++ cells."""

from pointasnl_tpu_torch.nn import precision
from pointasnl_tpu_torch.nn.layers import MLP, BatchNorm, Dense, Dropout, FullyConnected, PointConv
from pointasnl_tpu_torch.nn.losses import (
    l2_regularization,
    softmax_cross_entropy,
    weighted_softmax_cross_entropy,
)
from pointasnl_tpu_torch.nn.pointasnl import (
    AdaptiveSampling,
    PointASNLDecodingLayer,
    PointASNLSetAbstraction,
    PointNonLocalCell,
    SampleWeights,
    WeightNetHidden,
)
from pointasnl_tpu_torch.nn.pointnet import (
    PointNetFPModule,
    PointNetSAModule,
    sample_and_group,
    sample_and_group_all,
)

__all__ = [
    "AdaptiveSampling",
    "BatchNorm",
    "Dense",
    "Dropout",
    "FullyConnected",
    "MLP",
    "PointASNLDecodingLayer",
    "PointASNLSetAbstraction",
    "PointConv",
    "PointNetFPModule",
    "PointNetSAModule",
    "PointNonLocalCell",
    "SampleWeights",
    "WeightNetHidden",
    "l2_regularization",
    "precision",
    "sample_and_group",
    "sample_and_group_all",
    "softmax_cross_entropy",
    "weighted_softmax_cross_entropy",
]
