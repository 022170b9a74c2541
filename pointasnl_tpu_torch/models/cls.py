"""PointASNL classification model (ModelNet40), the PyTorch counterpart of
``pointasnl_tpu/models/cls.py``.

Architecture parity with models/pointasnl_cls.py:17-52:
  input B x N x 3 (+3 normals when use_normal);
  SA1 (npoint 512, ns 32, mlp [64,64,128]), SA2 (128, 64, [128,128,256]),
  AS neighbours [12,12] iff adaptive_sample else [0,0];
  two group-all PointNet SA heads [128,256,512] on l1 and [256,512,1024] on l2;
  concat [l3, l3_res] 1536 -> FC512 -> drop(keep 0.4) -> FC256 -> drop(keep 0.4)
  -> FC num_class.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from pointasnl_tpu_torch.models.registry import place, register_model
from pointasnl_tpu_torch.nn.layers import Dropout, FullyConnected
from pointasnl_tpu_torch.nn.pointasnl import PointASNLSetAbstraction
from pointasnl_tpu_torch.nn.pointnet import PointNetSAModule


@register_model("pointasnl_cls")
class PointASNLCls(nn.Module):
    """Initialised from `generator` (Xavier-uniform kernels, zero biases, BN
    1/0/0/1) on the CPU, then moved to `device`: the card unless the caller
    passes ``device="cpu"``. ``nl_kv_block_size`` and ``nl_use_flash`` go to
    both non-local cells, as in the JAX model; they add no parameters."""

    def __init__(self, num_class: int = 40, use_normal: bool = False,
                 adaptive_sample: bool = False, *, nl_kv_block_size: Optional[int] = None,
                 nl_use_flash: bool = False, generator: Optional[torch.Generator] = None,
                 device: torch.device = torch.device("cuda")):
        super().__init__()
        self.use_normal = use_normal
        g = generator
        as_neighbor = (12, 12) if adaptive_sample else (0, 0)
        nl = {"nl_kv_block_size": nl_kv_block_size, "nl_use_flash": nl_use_flash}
        self.layer1 = PointASNLSetAbstraction(3, 512, 32, (64, 64, 128),
                                              as_neighbor=as_neighbor[0], generator=g, **nl)
        self.layer2 = PointASNLSetAbstraction(128, 128, 64, (128, 128, 256),
                                              as_neighbor=as_neighbor[1], generator=g, **nl)
        self.layer3_1 = PointNetSAModule(128, (128, 256, 512), group_all=True, generator=g)
        self.layer3_2 = PointNetSAModule(256, (256, 512, 1024), group_all=True, generator=g)
        self.fc1 = FullyConnected(1024 + 512, 512, bn=True, generator=g)
        self.dp1 = Dropout(keep_prob=0.4)
        self.fc2 = FullyConnected(512, 256, bn=True, generator=g)
        self.dp2 = Dropout(keep_prob=0.4)
        self.fc3 = FullyConnected(256, num_class, bn=False, activation=None, generator=g)
        place(self, device)

    def forward(self, point_cloud: torch.Tensor, bn_momentum=0.9, *,
                dropout_generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """In train mode the two dropouts draw their masks from
        `dropout_generator`, dp1's first (flax's ``dropout`` key)."""
        end_points: Dict[str, torch.Tensor] = {}
        if self.use_normal:
            l0_xyz = point_cloud[..., :3]
            l0_points = point_cloud[..., 3:6]
        else:
            l0_xyz = point_cloud
            l0_points = point_cloud
        end_points["l0_xyz"] = l0_xyz

        l1_xyz, l1_points = self.layer1(l0_xyz, l0_points, bn_momentum=bn_momentum)
        end_points["l1_xyz"] = l1_xyz
        l2_xyz, l2_points = self.layer2(l1_xyz, l1_points, bn_momentum=bn_momentum)

        _, l3_points_res, _ = self.layer3_1(l1_xyz, l1_points, bn_momentum=bn_momentum)
        _, l3_points, _ = self.layer3_2(l2_xyz, l2_points, bn_momentum=bn_momentum)

        B = point_cloud.shape[0]
        net = torch.cat([l3_points.reshape(B, -1), l3_points_res.reshape(B, -1)], dim=-1)
        net = self.dp1(self.fc1(net, bn_momentum=bn_momentum), dropout_generator)
        net = self.dp2(self.fc2(net, bn_momentum=bn_momentum), dropout_generator)
        net = self.fc3(net, bn_momentum=bn_momentum)
        return net, end_points
