"""PointASNL residual semantic segmentation model (the ScanNet-grid flagship),
the PyTorch counterpart of ``pointasnl_tpu/models/sem_seg_res.py``.

Architecture parity with models/pointasnl_sem_seg_res.py:19-68:
  stem SA at full N (mlp [16,16,32], NL=False);
  4 residual levels: a down-sampling NL branch + a same-resolution local-only
  branch summed (the level 2-4 local branches consume the *_1 outputs,
  :46,:51 -- kept verbatim);
  decoder: 4x plain PointNet++ FP modules;
  head conv1d 128 (leaky ReLU) -> dropout(keep 0.5) -> conv1d num_class.

The sample counts follow N at call time: N/8, N/32, N/128, N/256.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pointasnl_tpu_torch import ops
from pointasnl_tpu_torch.models.registry import place, register_model
from pointasnl_tpu_torch.nn.layers import Dropout, PointConv
from pointasnl_tpu_torch.nn.pointasnl import PointASNLSetAbstraction
from pointasnl_tpu_torch.nn.pointnet import PointNetFPModule


@register_model("pointasnl_sem_seg_res")
class PointASNLSemSegRes(nn.Module):
    """Initialised from `generator` (Xavier-uniform kernels, zero biases, BN
    1/0/0/1) on the CPU, then moved to `device`: the card unless the caller
    passes ``device="cpu"``.

    ``reuse_geometry`` hoists the stem's self-kNN graph and the level-1 FPS,
    and hands level 1 the graph's rows at its samples: the same neighbours
    the level-1 search would find, without that search. ``dropout_keep`` is
    the head dropout's keep probability (1.0 turns it off).
    ``nl_kv_block_size`` streams every non-local cell's K/V in blocks of
    that size (whole-scene inference); ``nl_use_flash`` sends every
    non-local attention through the flash kernels (``--nl_flash true``).
    Neither adds parameters.
    """

    def __init__(self, num_class: int = 21, feature_channel: int = 0, *,
                 nl_kv_block_size: Optional[int] = None, nl_use_flash: bool = False,
                 reuse_geometry: bool = True,
                 dropout_keep: float = 0.5,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device = torch.device("cuda")):
        super().__init__()
        self.feature_channel = feature_channel
        self.reuse_geometry = reuse_geometry
        g = generator

        def sa(in_channels, mlp, as_neighbor, NL=True, downsample=True):
            return PointASNLSetAbstraction(in_channels, None, 32, mlp, as_neighbor=as_neighbor,
                                           NL=NL, downsample=downsample,
                                           nl_kv_block_size=nl_kv_block_size,
                                           nl_use_flash=nl_use_flash, generator=g)

        c0 = feature_channel if feature_channel > 0 else 3
        self.layer0 = sa(c0, (16, 16, 32), 0, NL=False, downsample=False)
        self.layer1_1 = sa(32, (32, 32, 64), 8)
        self.layer1_2 = sa(32, (64, 64), 0, NL=False)
        self.layer2_1 = sa(64, (64, 64, 128), 4)
        self.layer2_2 = sa(128, (128, 128), 0, NL=False, downsample=False)
        self.layer3_1 = sa(128, (128, 128, 256), 0)
        self.layer3_2 = sa(256, (256, 256), 0, NL=False, downsample=False)
        self.layer4_1 = sa(256, (256, 256, 512), 0)
        self.layer4_2 = sa(512, (512, 512), 0, NL=False, downsample=False)
        self.fa_layer1 = PointNetFPModule(512 + 256, (512, 512), generator=g)
        self.fa_layer2 = PointNetFPModule(512 + 128, (256, 256), generator=g)
        self.fa_layer3 = PointNetFPModule(256 + 64, (256, 128), generator=g)
        self.fa_layer4 = PointNetFPModule(128 + 32, (128, 128, 128), generator=g)
        self.fc1 = PointConv(128, 128, bn=True, activation=F.leaky_relu, generator=g)
        self.dp = Dropout(keep_prob=dropout_keep)
        self.fc0 = PointConv(128, num_class, bn=False, activation=None, generator=g)
        place(self, device)

    def forward(self, point_cloud: torch.Tensor, bn_momentum=0.9
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        end_points: Dict[str, torch.Tensor] = {}
        num_point = point_cloud.shape[1]
        if self.feature_channel > 0:
            l0_xyz = point_cloud[..., :3]
            l0_points = point_cloud[..., 3: 3 + self.feature_channel]
        else:
            l0_xyz = point_cloud
            l0_points = point_cloud
        end_points["l0_xyz"] = l0_xyz
        n1, n2, n3, n4 = num_point // 8, num_point // 32, num_point // 128, num_point // 256
        m = bn_momentum

        # Stem self-kNN graph, hoisted so level 1 can gather its rows.
        if self.reuse_geometry:
            _, knn0_idx = ops.knn_point(32, l0_xyz, l0_xyz)
            fps1_idx = ops.farthest_point_sample(n1, l0_xyz)
            l1_knn_idx = ops.gather_point(knn0_idx, fps1_idx)
        else:
            knn0_idx = fps1_idx = l1_knn_idx = None

        _, l0_points = self.layer0(l0_xyz, l0_points, m, knn_idx=knn0_idx)

        # 1st residual level
        l1_xyz, l1_1_points = self.layer1_1(l0_xyz, l0_points, m, npoint=n1,
                                            fps_idx=fps1_idx, knn_idx=l1_knn_idx)
        _, l1_2_points = self.layer1_2(l0_xyz, l0_points, m, npoint=n1,
                                       fps_idx=fps1_idx, knn_idx=l1_knn_idx)
        l1_2_points = l1_2_points + l1_1_points

        # 2nd residual level
        l2_xyz, l2_1_points = self.layer2_1(l1_xyz, l1_2_points, m, npoint=n2)
        _, l2_2_points = self.layer2_2(l2_xyz, l2_1_points, m)
        l2_2_points = l2_2_points + l2_1_points

        # 3rd residual level
        l3_xyz, l3_1_points = self.layer3_1(l2_xyz, l2_2_points, m, npoint=n3)
        _, l3_2_points = self.layer3_2(l3_xyz, l3_1_points, m)
        l3_2_points = l3_2_points + l3_1_points

        # 4th residual level
        l4_xyz, l4_1_points = self.layer4_1(l3_xyz, l3_2_points, m, npoint=n4)
        _, l4_2_points = self.layer4_2(l4_xyz, l4_1_points, m)
        l4_2_points = l4_2_points + l4_1_points

        end_points["l1_xyz"] = l1_xyz

        l3_points = self.fa_layer1(l3_xyz, l4_xyz, l3_2_points, l4_2_points, m)
        l2_points = self.fa_layer2(l2_xyz, l3_xyz, l2_2_points, l3_points, m)
        l1_points = self.fa_layer3(l1_xyz, l2_xyz, l1_2_points, l2_points, m)
        l0_points = self.fa_layer4(l0_xyz, l1_xyz, l0_points, l1_points, m)

        net = self.fc1(l0_points, bn_momentum=m)
        end_points["feats"] = net
        net = self.dp(net)
        net = self.fc0(net, bn_momentum=m)
        return net, end_points
