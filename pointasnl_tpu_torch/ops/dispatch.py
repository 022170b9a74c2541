"""Routing of the geometry ops by the device of their input.

  - A CPU tensor goes to the plain PyTorch version (``ops.geometry``).
  - A CUDA tensor goes to the hand-written kernel (``ops.cuda``), or the call
    raises. No switch, environment variable or failed build sends a CUDA
    tensor to the plain version. The kNN picks its kernel by shape, as
    ``pointasnl_tpu/ops/pallas/knn.py:knn_point`` does: the resident kernel up
    to N = 12288, the spatially-pruned one past it up to N = 2^21 with
    k <= 128, and an error for the rest (the streaming kernel that takes it
    is not ported yet).
  - Any other device raises.

The gathers are plain index gathers on every device: their backward is
autograd's scatter-add, which uses atomics on the card, so gradients there
vary in their last bits from run to run. ``sampling``, ``grouping``,
``three_nn``, ``three_interpolate_idw`` and ``repulsion_loss`` reach the
kernels through the routed FPS, kNN and ball query; ``three_nn`` is the kNN
kernel with k = 3 (its padding for fewer than 3 points stays in
``geometry.three_nn``, on the kernel's output).
"""

from __future__ import annotations

import torch

from pointasnl_tpu_torch.ops import geometry as _g
from pointasnl_tpu_torch.ops.cuda import ball_query as _cuda_ball
from pointasnl_tpu_torch.ops.cuda import fps as _cuda_fps
from pointasnl_tpu_torch.ops.cuda import knn as _cuda_knn
from pointasnl_tpu_torch.ops.cuda import knn_spatial as _cuda_spatial

# The resident kernel's largest N (knn.py:RESIDENT_MAX_N); past it the
# spatial kernel.
RESIDENT_MAX_N = 12288

pairwise_sqdist = _g.pairwise_sqdist
gather_point = _g.gather_point
group_point = _g.group_point
three_interpolate = _g.three_interpolate


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
    if not _on_cuda(support, "knn_point"):
        return _g.knn_point(k, support, query)
    N = support.shape[1]
    if N <= RESIDENT_MAX_N:
        return _cuda_knn.knn_point(k, support, query)
    if N <= _cuda_spatial.MAX_N and k <= _cuda_spatial.MAX_K:
        # The same tensor twice is a self-query: the wrapper sees `query is support`.
        return _cuda_spatial.knn_point(k, support, query)
    raise ValueError(f"knn_point on the card: N={N}, k={k} needs the streaming kNN kernel "
                     f"(pointasnl_tpu/ops/pallas/knn.py:_knn_kernel), which is not ported yet")


knn_point.__doc__ = _g.knn_point.__doc__


def query_ball_point(radius, nsample, xyz, new_xyz):
    if _on_cuda(xyz, "query_ball_point"):
        return _cuda_ball.query_ball_point(radius, nsample, xyz, new_xyz)
    return _g.query_ball_point(radius, nsample, xyz, new_xyz)


query_ball_point.__doc__ = _g.query_ball_point.__doc__


def three_nn(xyz1, xyz2):
    """3-NN with squared distances (see geometry.three_nn); the search goes
    through dispatch."""
    return _g.three_nn(xyz1, xyz2, knn=knn_point)


def three_interpolate_idw(xyz1, xyz2, points2):
    """IDW interpolation (see geometry.three_interpolate_idw); the search
    goes through dispatch."""
    return _g.three_interpolate_idw(xyz1, xyz2, points2, three_nn_fn=three_nn)


def repulsion_loss(pred, nsample=20, radius=0.07, h=0.03):
    """Repulsion loss (see geometry.repulsion_loss); the ball query goes
    through dispatch."""
    return _g.repulsion_loss(pred, nsample, radius, h, ball_query=query_ball_point)


def sampling(npoint, pts, feature=None):
    """FPS + gather (see geometry.sampling); FPS goes through dispatch."""
    return _g.sampling(npoint, pts, feature, fps=farthest_point_sample)


def grouping(feature, k, src_xyz, q_xyz, *, use_xyz=True, use_knn=True, radius=0.2, idx=None):
    """Grouping (see geometry.grouping); the search goes through dispatch."""
    return _g.grouping(feature, k, src_xyz, q_xyz, use_xyz=use_xyz, use_knn=use_knn,
                       radius=radius, idx=idx, knn=knn_point, ball_query=query_ball_point)
