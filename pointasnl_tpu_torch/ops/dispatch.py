"""Routing of the geometry ops by the device of their input.

  - A CPU tensor goes to the plain PyTorch version (``ops.geometry``).
  - A CUDA tensor goes to the hand-written kernel (``ops.cuda``), or the call
    raises. No switch, environment variable or failed build sends a CUDA
    tensor to the plain version.
  - Any other device raises.

The gathers are plain index gathers on every device (the forward needs no
kernel for them), and ``sampling`` / ``grouping`` reach the kernels through
the routed FPS and kNN.
"""

from __future__ import annotations

import torch

from pointasnl_tpu_torch.ops import geometry as _g
from pointasnl_tpu_torch.ops.cuda import fps as _cuda_fps
from pointasnl_tpu_torch.ops.cuda import knn as _cuda_knn

pairwise_sqdist = _g.pairwise_sqdist
gather_point = _g.gather_point
group_point = _g.group_point


def _on_cuda(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no implementation for device {t.device}")


def farthest_point_sample(npoint, xyz):
    if _on_cuda(xyz, "farthest_point_sample"):
        return _cuda_fps.farthest_point_sample(npoint, xyz)
    return _g.farthest_point_sample(npoint, xyz)


farthest_point_sample.__doc__ = _g.farthest_point_sample.__doc__


def knn_point(k, support, query):
    if _on_cuda(support, "knn_point"):
        return _cuda_knn.knn_point(k, support, query)
    return _g.knn_point(k, support, query)


knn_point.__doc__ = _g.knn_point.__doc__


def sampling(npoint, pts, feature=None):
    """FPS + gather (see geometry.sampling); FPS goes through dispatch."""
    return _g.sampling(npoint, pts, feature, fps=farthest_point_sample)


def grouping(feature, k, src_xyz, q_xyz, *, use_xyz=True):
    """kNN grouping (see geometry.grouping); the search goes through dispatch."""
    return _g.grouping(feature, k, src_xyz, q_xyz, use_xyz=use_xyz, knn=knn_point)
