"""Geometry op layer: plain PyTorch versions + hand-written CUDA kernels.

The public API routes by device (``ops.dispatch``): CPU tensors take the plain
versions of ``ops.geometry``, CUDA tensors the kernels of ``ops.cuda``.
"""

from pointasnl_tpu_torch.ops.dispatch import (
    farthest_point_sample,
    gather_point,
    group_point,
    grouping,
    knn_point,
    pairwise_sqdist,
    query_ball_point,
    repulsion_loss,
    sampling,
    three_interpolate,
    three_interpolate_idw,
    three_nn,
)

__all__ = [
    "farthest_point_sample",
    "gather_point",
    "group_point",
    "grouping",
    "knn_point",
    "pairwise_sqdist",
    "query_ball_point",
    "repulsion_loss",
    "sampling",
    "three_interpolate",
    "three_interpolate_idw",
    "three_nn",
]
