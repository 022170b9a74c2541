"""PointNet++ set abstraction, the PyTorch counterpart of
``pointasnl_tpu/nn/pointnet.py``.

Ported: set abstraction (utils/pointnet_util.py:22-154) over the whole
cloud, as the classifier's two heads run it, or over FPS samples with ball
or kNN grouping (``sample_and_group``), with every pooling mode; and feature
propagation (``PointNetFPModule``), the decoder of ``pointasnl_sem_seg_res``.
The multi-scale ``PointNetSAModuleMSG`` is not ported: no model uses it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from pointasnl_tpu_torch import ops
from pointasnl_tpu_torch.nn.layers import PointConv


def sample_and_group(npoint: int, radius: Optional[float], nsample: int, xyz: torch.Tensor,
                     points: Optional[torch.Tensor], knn: bool = False, use_xyz: bool = True):
    """FPS, then ball or kNN grouping (utils/pointnet_util.py:22-56). Unlike
    the PointASNL grouping, the grouped xyz is normalised to its centre
    BEFORE the feature concat. Returns (new_xyz, new_points, idx,
    grouped_xyz)."""
    new_xyz = ops.gather_point(xyz, ops.farthest_point_sample(npoint, xyz))
    if knn:
        _, idx = ops.knn_point(nsample, xyz, new_xyz)
    else:
        idx, _ = ops.query_ball_point(radius, nsample, xyz, new_xyz)
    grouped_xyz = ops.group_point(xyz, idx) - new_xyz[:, :, None, :]
    if points is None:
        new_points = grouped_xyz
    elif use_xyz:
        new_points = torch.cat([grouped_xyz, ops.group_point(points, idx)], dim=-1)
    else:
        new_points = ops.group_point(points, idx)
    return new_xyz, new_points, idx, grouped_xyz


def sample_and_group_all(xyz: torch.Tensor, points: Optional[torch.Tensor],
                         use_xyz: bool = True):
    """Group the whole cloud into one region centred at the origin
    (utils/pointnet_util.py:59-84)."""
    B, N, _ = xyz.shape
    new_xyz = torch.zeros((B, 1, 3), dtype=xyz.dtype, device=xyz.device)
    idx = torch.arange(N, dtype=torch.int32, device=xyz.device).expand(B, 1, N)
    grouped_xyz = xyz.reshape(B, 1, N, 3)
    if points is not None:
        new_points = torch.cat([xyz, points], dim=-1) if use_xyz else points
        new_points = new_points[:, None, :, :]
    else:
        new_points = grouped_xyz
    return new_xyz, new_points, idx, grouped_xyz


class PointNetSAModule(nn.Module):
    """PointNet++ set abstraction (utils/pointnet_util.py:87-154): over the
    whole cloud (``group_all``), or over ``npoint`` FPS samples, each
    grouping ``nsample`` points within ``radius`` (or its ``knn``
    nearest); then ``conv{i}``, the pooling (max, avg, weighted_avg or
    max_and_avg) and ``conv_post_{i}``.

    ``in_channels`` is C of the (B, N, C) input features, 0 for none.
    """

    def __init__(self, in_channels: int, mlp: Sequence[int], *,
                 npoint: Optional[int] = None, radius: Optional[float] = None,
                 nsample: Optional[int] = None, mlp2: Optional[Sequence[int]] = None,
                 group_all: bool = False, bn: bool = True, pooling: str = "max",
                 knn: bool = False, use_xyz: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pooling not in ("max", "avg", "weighted_avg", "max_and_avg"):
            raise ValueError(f"unknown pooling: {pooling!r}")
        if not group_all and (npoint is None or nsample is None
                              or (radius is None and not knn)):
            raise ValueError("a sampled set abstraction takes npoint, nsample and a radius "
                             "(or knn=True); or pass group_all=True")
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.group_all = group_all
        self.knn = knn
        self.pooling = pooling
        self.use_xyz = use_xyz
        self.convs = []
        width = in_channels + 3 if (use_xyz or not in_channels) else in_channels
        for i, c in enumerate(mlp):
            conv = PointConv(width, c, bn=bn, generator=generator)
            self.add_module(f"conv{i}", conv)
            self.convs.append(conv)
            width = c
        if pooling == "max_and_avg":
            width *= 2
        self.post_convs = []
        for i, c in enumerate(mlp2 or ()):
            conv = PointConv(width, c, bn=bn, generator=generator)
            self.add_module(f"conv_post_{i}", conv)
            self.post_convs.append(conv)
            width = c

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor],
                bn_momentum=0.9) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if self.group_all:
            new_xyz, new_points, idx, grouped_xyz = sample_and_group_all(xyz, points,
                                                                         self.use_xyz)
        else:
            new_xyz, new_points, idx, grouped_xyz = sample_and_group(
                self.npoint, self.radius, self.nsample, xyz, points, self.knn, self.use_xyz)
        for conv in self.convs:
            new_points = conv(new_points, bn_momentum=bn_momentum)

        if self.pooling == "max":
            new_points = new_points.amax(dim=2, keepdim=True)
        elif self.pooling == "avg":
            new_points = new_points.mean(dim=2, keepdim=True)
        elif self.pooling == "weighted_avg":
            dists = torch.linalg.vector_norm(grouped_xyz, dim=-1, keepdim=True)
            exp_dists = torch.exp(-dists * 5.0)
            weights = exp_dists / exp_dists.sum(dim=2, keepdim=True)
            new_points = (new_points * weights).sum(dim=2, keepdim=True)
        else:  # max_and_avg
            mx = new_points.amax(dim=2, keepdim=True)
            av = new_points.mean(dim=2, keepdim=True)
            new_points = torch.cat([av, mx], dim=-1)

        for conv in self.post_convs:
            new_points = conv(new_points, bn_momentum=bn_momentum)
        return new_xyz, new_points.squeeze(2), idx


class PointNetFPModule(nn.Module):
    """PointNet++ feature propagation (utils/pointnet_util.py:199-229):
    inverse-distance interpolation of the sparse features points2 at the
    3 nearest of xyz2 to each point of xyz1, concatenated with the dense
    features points1, then 1x1 convs ``conv_{i}``.

    ``in_channels`` is C2 + C1, the interpolated width plus that of points1
    (C2 alone when points1 is None).
    """

    def __init__(self, in_channels: int, mlp: Sequence[int], *, bn: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convs = []
        width = in_channels
        for i, c in enumerate(mlp):
            conv = PointConv(width, c, bn=bn, generator=generator)
            self.add_module(f"conv_{i}", conv)
            self.convs.append(conv)
            width = c

    def forward(self, xyz1: torch.Tensor, xyz2: torch.Tensor, points1: Optional[torch.Tensor],
                points2: torch.Tensor, bn_momentum=0.9) -> torch.Tensor:
        new_points = ops.three_interpolate_idw(xyz1, xyz2, points2)
        if points1 is not None:
            new_points = torch.cat([new_points, points1], dim=-1)
        for conv in self.convs:
            new_points = conv(new_points, bn_momentum=bn_momentum)
        return new_points
