"""PointASNL semantic segmentation model, the encoder-decoder variant, the
PyTorch counterpart of ``pointasnl_tpu/models/sem_seg.py``.

Architecture parity with models/pointasnl_sem_seg.py:18-50:
  encoder: 4 SA cells at N/8, N/32, N/128, N/256 points (ns 32, as_neighbor
  8/4/0/0, mlps [32,32,64]/[64,64,128]/[128,128,256]/[256,256,512]);
  decoder: 4 PointASNLDecodingLayers (nsample 16, mlps [512,512]/[256,256]/
  [256,128]/[128,128,128]);
  head conv1d 128 (BN, ReLU) -> dropout(keep 0.5) -> conv1d num_class.

The sample counts follow N at call time. It is the default model of the
ScanNet and SemanticKITTI CLIs (recipe B6 x 8192).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from pointasnl_tpu_torch.models.registry import place, register_model
from pointasnl_tpu_torch.nn.layers import Dropout, PointConv
from pointasnl_tpu_torch.nn.pointasnl import PointASNLDecodingLayer, PointASNLSetAbstraction


@register_model("pointasnl_sem_seg")
class PointASNLSemSeg(nn.Module):
    """Initialised from `generator` (Xavier-uniform kernels, zero biases, BN
    1/0/0/1) on the CPU, then moved to `device`: the card unless the caller
    passes ``device="cpu"``. ``dropout_keep`` is the head dropout's keep
    probability (1.0 turns it off). ``nl_kv_block_size`` and
    ``nl_use_flash`` go to the four SA cells' non-local attention, as in the
    JAX model; neither adds parameters."""

    def __init__(self, num_class: int = 21, feature_channel: int = 0, *,
                 dropout_keep: float = 0.5, nl_kv_block_size: Optional[int] = None,
                 nl_use_flash: bool = False, generator: Optional[torch.Generator] = None,
                 device: torch.device = torch.device("cuda")):
        super().__init__()
        self.feature_channel = feature_channel
        g = generator
        nl = {"nl_kv_block_size": nl_kv_block_size, "nl_use_flash": nl_use_flash}
        c0 = feature_channel if feature_channel > 0 else 3
        self.layer1 = PointASNLSetAbstraction(c0, None, 32, (32, 32, 64), as_neighbor=8,
                                              generator=g, **nl)
        self.layer2 = PointASNLSetAbstraction(64, None, 32, (64, 64, 128), as_neighbor=4,
                                              generator=g, **nl)
        self.layer3 = PointASNLSetAbstraction(128, None, 32, (128, 128, 256), as_neighbor=0,
                                              generator=g, **nl)
        self.layer4 = PointASNLSetAbstraction(256, None, 32, (256, 256, 512), as_neighbor=0,
                                              generator=g, **nl)
        self.fa_layer1 = PointASNLDecodingLayer(256, 512, 16, (512, 512), generator=g)
        self.fa_layer2 = PointASNLDecodingLayer(128, 512, 16, (256, 256), generator=g)
        self.fa_layer3 = PointASNLDecodingLayer(64, 256, 16, (256, 128), generator=g)
        self.fa_layer4 = PointASNLDecodingLayer(c0, 128, 16, (128, 128, 128), generator=g)
        self.fc1 = PointConv(128, 128, bn=True, generator=g)
        self.dp1 = Dropout(keep_prob=dropout_keep)
        self.fc2 = PointConv(128, num_class, bn=False, activation=None, generator=g)
        place(self, device)

    def forward(self, point_cloud: torch.Tensor, bn_momentum=0.9, *,
                dropout_generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """In train mode the head dropout draws its mask from
        `dropout_generator` (flax's ``dropout`` key)."""
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

        l1_xyz, l1_points = self.layer1(l0_xyz, l0_points, m, npoint=n1)
        l2_xyz, l2_points = self.layer2(l1_xyz, l1_points, m, npoint=n2)
        l3_xyz, l3_points = self.layer3(l2_xyz, l2_points, m, npoint=n3)
        l4_xyz, l4_points = self.layer4(l3_xyz, l3_points, m, npoint=n4)
        end_points["l1_xyz"] = l1_xyz

        l3_points = self.fa_layer1(l3_xyz, l4_xyz, l3_points, l4_points, m)
        l2_points = self.fa_layer2(l2_xyz, l3_xyz, l2_points, l3_points, m)
        l1_points = self.fa_layer3(l1_xyz, l2_xyz, l1_points, l2_points, m)
        l0_points = self.fa_layer4(l0_xyz, l1_xyz, l0_points, l1_points, m)

        net = self.fc1(l0_points, bn_momentum=m)
        end_points["feats"] = net
        net = self.dp1(net, dropout_generator)
        net = self.fc2(net, bn_momentum=m)
        return net, end_points
