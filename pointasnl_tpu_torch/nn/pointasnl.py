"""PointASNL core modules (adaptive sampling + local-nonlocal set abstraction).

The PyTorch counterparts of ``pointasnl_tpu/nn/pointasnl.py``, with the same
module names and the same reference quirks:
  - ``grouping`` returns [raw grouped_xyz ‖ feature], and the SA cell then
    prepends the normalised grouped xyz again (the double xyz concat);
  - ``SampleWeights`` normalises xyz to the group's FIRST neighbour, uses a
    bottleneck of max(32, C // 2) and ends in a softmax over the neighbours;
  - ``AdaptiveSampling`` reads only the first ``num_neighbor`` neighbours, so
    the kNN order matters;
  - the ``bmkc,bmkw->bmcw`` product is flattened channel-major before
    ``after_conv``.

Ported so far: the ``mode="dot"`` non-local cell, dense, with K/V streamed
in blocks (``kv_block_size``) or through the flash kernels (``use_flash``),
and the SA cell on both its paths (down-sampling, N != npoint, and
same-resolution, N == npoint), with kNN or ball grouping and the
``fps_idx`` / ``knn_idx`` hints. The concat mode, the ``support_*``
decoupling of sharded whole-scene inference and the decoding layer wait.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pointasnl_tpu_torch import ops
from pointasnl_tpu_torch.nn.blockwise import attention_scale, blockwise_attention
from pointasnl_tpu_torch.nn.layers import PointConv
from pointasnl_tpu_torch.ops.flash_attention import flash_attention


class WeightNetHidden(nn.Module):
    """MLP on relative xyz producing PointConv-style kernel weights
    (utils/pointasnl_util.py:78-88)."""

    def __init__(self, in_features: int = 3, hidden_units: Sequence[int] = (32,), *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        width = in_features
        for i, h in enumerate(hidden_units):
            self.add_module(f"wconv{i}", PointConv(width, h, bn=True, generator=generator))
            width = h

    def forward(self, xyz: torch.Tensor, bn_momentum=0.9) -> torch.Tensor:
        net = xyz
        for conv in self.children():
            net = conv(net, bn_momentum=bn_momentum)
        return net


class SampleWeights(nn.Module):
    """Group self-attention producing per-neighbour reweighting distributions
    (utils/pointasnl_util.py:112-156). ``in_channels`` is C of the (B, M, K, C)
    group features."""

    def __init__(self, in_channels: int, mlps: Sequence[int], *, scaled: bool = True,
                 bn: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scaled = scaled
        self.bottleneck = max(32, in_channels // 2)
        self.scale = attention_scale(self.bottleneck)
        feats = 3 + in_channels
        self.conv_kv_ds = PointConv(feats, self.bottleneck * 2, bn=bn, activation=None,
                                    generator=generator)
        self.conv_query_ds = PointConv(feats, self.bottleneck, bn=bn, activation=None,
                                       generator=generator)
        self.mlp2 = []
        width = self.bottleneck
        for i, c in enumerate(mlps):
            act = F.relu if i < len(mlps) - 1 else None
            conv = PointConv(width, c, bn=bn, activation=act, generator=generator)
            self.add_module(f"mlp2_{i}", conv)
            self.mlp2.append(conv)
            width = c

    def forward(self, new_point: torch.Tensor, grouped_xyz: torch.Tensor,
                bn_momentum=0.9) -> torch.Tensor:
        normalized_xyz = grouped_xyz - grouped_xyz[:, :, :1, :]
        feats = torch.cat([normalized_xyz, new_point], dim=-1)
        kv = self.conv_kv_ds(feats, bn_momentum=bn_momentum)
        q = self.conv_query_ds(feats, bn_momentum=bn_momentum)
        k = kv[..., : self.bottleneck]
        v = kv[..., self.bottleneck:]

        attn = torch.einsum("bmkc,bmlc->bmkl", q, k)  # (B, M, K, K)
        if self.scaled:
            attn = attn / self.scale
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bmkl,bmlc->bmkc", attn, v)
        for conv in self.mlp2:
            out = conv(out, bn_momentum=bn_momentum)
        return torch.softmax(out, dim=2)  # convex weights over neighbours


class AdaptiveSampling(nn.Module):
    """Shift sampled points (xyz and features) by attention over neighbours
    (utils/pointasnl_util.py:158-173). ``num_neighbor == 0`` takes the group's
    first (self) neighbour and holds no parameters."""

    def __init__(self, in_channels: int, num_neighbor: int, *, bn: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_neighbor = num_neighbor
        if num_neighbor:
            self.sample_weights = SampleWeights(in_channels, [32, 1 + in_channels], bn=bn,
                                                generator=generator)

    def forward(self, group_xyz: torch.Tensor, group_feature: torch.Tensor,
                bn_momentum=0.9) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.num_neighbor == 0:
            return group_xyz[:, :, 0, :], group_feature[:, :, 0, :]
        shift_xyz = group_xyz[:, :, : self.num_neighbor, :]
        shift_feat = group_feature[:, :, : self.num_neighbor, :]
        weights = self.sample_weights(shift_feat, shift_xyz, bn_momentum=bn_momentum)
        new_xyz = torch.sum(shift_xyz * weights[..., :1], dim=2)
        new_feature = torch.sum(shift_feat * weights[..., 1:], dim=2)
        return new_xyz, new_feature


class PointNonLocalCell(nn.Module):
    """Non-local attention from sampled queries over all input points
    (utils/pointasnl_util.py:175-219), dense ``mode="dot"``: K/V from the
    ``in_channels`` features of all points, Q from the ``query_channels``
    features of the sampled set, softmax(QK^T / sqrt(bottleneck)) V, then the
    output projection. With ``kv_block_size`` the attention streams K/V in
    blocks of that size (``blockwise_attention``): O(M * block) memory
    instead of the (M, N) map, for whole scenes. Otherwise ``use_flash``
    takes the fused flash attention (``ops.flash_attention``), whose scale
    multiplies by float32(1 / sqrt(bottleneck)) as JAX's flash path does.
    The order is JAX's: ``kv_block_size``, then ``use_flash``, then dense.
    Unlike JAX, ``use_flash`` is never rerouted to blockwise past a VMEM
    envelope (``fits_vmem``): the CUDA kernels stream K/V from device memory
    at any N, and the two paths agree to rounding."""

    def __init__(self, in_channels: int, query_channels: int, bottleneck: int,
                 out_channels: int, *, bn: bool = True, scaled: bool = True,
                 kv_block_size: Optional[int] = None, use_flash: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bottleneck = bottleneck
        self.scaled = scaled
        self.kv_block_size = kv_block_size
        self.use_flash = use_flash
        self.scale = attention_scale(bottleneck)
        self.conv_kv = PointConv(in_channels, bottleneck * 2, bn=bn, activation=None,
                                 generator=generator)
        self.conv_query = PointConv(query_channels, bottleneck, bn=bn, activation=None,
                                    generator=generator)
        self.conv_back_project = PointConv(bottleneck, out_channels, bn=bn,
                                           generator=generator)

    def forward(self, feature: torch.Tensor, query_feature: torch.Tensor,
                bn_momentum=0.9) -> torch.Tensor:
        kv = self.conv_kv(feature, bn_momentum=bn_momentum)
        q = self.conv_query(query_feature, bn_momentum=bn_momentum)
        k = kv[..., : self.bottleneck]  # (B, N, bc)
        v = kv[..., self.bottleneck:]
        if self.kv_block_size is not None:
            out = blockwise_attention(q, k, v, block_size=self.kv_block_size, scaled=self.scaled)
            return self.conv_back_project(out, bn_momentum=bn_momentum)
        if self.use_flash:
            out = flash_attention(q, k, v, self.scaled)
            return self.conv_back_project(out, bn_momentum=bn_momentum)
        attn = torch.einsum("bmc,bnc->bmn", q, k)
        if self.scaled:
            attn = attn / self.scale
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bmn,bnc->bmc", attn, v)
        return self.conv_back_project(out, bn_momentum=bn_momentum)


class PointASNLSetAbstraction(nn.Module):
    """The PointASNL SA cell: FPS -> group -> AS -> (NL ‖ local conv) -> fuse
    (utils/pointasnl_util.py:221-292). ``in_channels`` is C of the (B, N, C)
    input features.

    ``npoint`` may be left None at construction and given at call time (the
    segmentation model derives it from N). ``downsample=False`` builds the
    same-resolution cell (N == npoint): no FPS and no adaptive sampling, and
    the non-local queries are the input features. Flax creates the
    parameters at the first call, where N is known; the port creates them at
    construction, so it has to be told which of the two cells it is.
    ``nl_kv_block_size`` streams the non-local cell's K/V in blocks;
    ``nl_use_flash`` sends its attention through the flash kernels.
    """

    def __init__(self, in_channels: int, npoint: Optional[int], nsample: int,
                 mlp: Sequence[int], *, as_neighbor: int = 8, NL: bool = True,
                 bn: bool = True, use_knn: bool = True, radius: Optional[float] = None,
                 downsample: bool = True, nl_kv_block_size: Optional[int] = None,
                 nl_use_flash: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.npoint = npoint
        self.nsample = nsample
        self.NL = NL
        self.use_knn = use_knn
        self.radius = radius if radius is not None else 0.2
        self.downsample = downsample
        group_channels = 3 + in_channels  # grouping prepends the raw xyz
        point_channels = 3 + group_channels  # the cell prepends normalised xyz
        out = mlp[-1]
        g = generator
        if downsample:
            self.adaptive_sampling = AdaptiveSampling(group_channels, as_neighbor, bn=bn,
                                                      generator=g)
        if NL:
            query_channels = group_channels if downsample else in_channels
            self.add_module("nonlocal", PointNonLocalCell(
                in_channels, query_channels, max(32, in_channels // 2), out, bn=bn,
                kv_block_size=nl_kv_block_size, use_flash=nl_use_flash, generator=g))
        self.skip = PointConv(point_channels, out, bn=bn, generator=g)
        self.local_convs = []
        width = point_channels
        for i, c in enumerate(mlp[:-1]):
            conv = PointConv(width, c, bn=bn, generator=g)
            self.add_module(f"conv{i}", conv)
            self.local_convs.append(conv)
            width = c
        self.weight_net = WeightNetHidden(3, (32,), generator=g)
        self.after_conv = PointConv(width * 32, out, bn=bn, generator=g)
        self.aggregation = PointConv(out, out, bn=bn, generator=g)

    def forward(self, xyz: torch.Tensor, feature: torch.Tensor, bn_momentum=0.9, *,
                npoint: Optional[int] = None, fps_idx: Optional[torch.Tensor] = None,
                knn_idx: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """`fps_idx` / `knn_idx` are exact precomputed-geometry hints: FPS
        indices of xyz and the neighbour rows of the sampled queries, which
        the segmentation model gathers from the stem's self-kNN graph. The
        result is the unhinted one: a kNN row depends only on its query, and
        FPS only on xyz."""
        N = feature.shape[1]
        npoint = npoint if npoint is not None else self.npoint
        if (npoint in (None, N)) == self.downsample:
            raise ValueError(f"SA cell built with downsample={self.downsample} called with "
                             f"N={N}, npoint={npoint}")

        if not self.downsample:
            new_xyz, new_feature = xyz, feature
        elif fps_idx is not None:
            new_xyz = ops.gather_point(xyz, fps_idx)
        else:
            new_xyz = ops.sampling(npoint, xyz)
        grouped_xyz, new_point, _ = ops.grouping(feature, self.nsample, xyz, new_xyz,
                                                 use_knn=self.use_knn, radius=self.radius,
                                                 idx=knn_idx)
        if self.downsample:
            new_xyz, new_feature = self.adaptive_sampling(grouped_xyz, new_point,
                                                          bn_momentum=bn_momentum)

        grouped_xyz = grouped_xyz - new_xyz[:, :, None, :]  # translation normalisation
        new_point = torch.cat([grouped_xyz, new_point], dim=-1)

        if self.NL:
            new_nonlocal_point = getattr(self, "nonlocal")(feature, new_feature,
                                                           bn_momentum=bn_momentum)

        # Skip connection: max over neighbours of the raw group tensor.
        skip_spatial = self.skip(new_point.amax(dim=2), bn_momentum=bn_momentum)

        for conv in self.local_convs:
            new_point = conv(new_point, bn_momentum=bn_momentum)

        # PointConv-style aggregation over the learned xyz kernel.
        weight = self.weight_net(grouped_xyz, bn_momentum=bn_momentum)  # (B, M, K, 32)
        new_point = torch.einsum("bmkc,bmkw->bmcw", new_point, weight)  # (B, M, C', 32)
        new_point = new_point.reshape(*new_point.shape[:2], -1)
        new_point = self.after_conv(new_point, bn_momentum=bn_momentum)

        new_point = new_point + skip_spatial
        if self.NL:
            new_point = new_point + new_nonlocal_point
        new_point = self.aggregation(new_point, bn_momentum=bn_momentum)
        return new_xyz, new_point
