"""Routing of the geometry ops by the device of their input.

  - A CPU tensor goes to the plain PyTorch version (``ops.geometry``).
  - A CUDA tensor goes to the hand-written kernel (``ops.cuda``), or the call
    raises. No switch, environment variable or failed build sends a CUDA
    tensor to the plain version. The kNN picks its kernel by (N, k)
    (``knn_route``), in the order of
    ``pointasnl_tpu/ops/pallas/knn.py:knn_point``: the resident kernel up to
    N = 12288 with k <= 128, the spatially-pruned one past it up to N = 2^21
    with k <= 128, and the streaming kernel for the rest.
  - Any other device raises.

The gathers' forward is the plain index gather on every device, as JAX
computes it outside any kernel. A CUDA tensor that needs a gradient takes
``GatherPoint``, whose backward is the deterministic gather-backward kernel
(``ops.cuda.gather_backward``), in place of autograd's scatter-add, whose
atomics add in an order that changes from run to run. An integer gather, or
one outside autograd, stays plain. ``sampling``, ``grouping``, ``three_nn``,
``three_interpolate``, ``three_interpolate_idw`` and ``repulsion_loss`` reach
the kernels through the routed FPS, kNN, ball query and gathers, passed to
the plain helpers as the JAX package passes ``group_point_fn``; ``three_nn``
is the kNN kernel with k = 3 (its padding for fewer than 3 points stays in
``geometry.three_nn``, on the kernel's output).

The searches (FPS, the kNNs, the ball query) take float32 xyz, as the JAX
package casts it (``ops/geometry.py``): on the card another dtype is cast
before the kernel, as the plain versions cast it on the CPU. The gathers
keep the points' dtype, and their backward sums float32 or bfloat16
cotangents (the bfloat16 step's) on the card.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from pointasnl_tpu_torch.ops import geometry as _g
from pointasnl_tpu_torch.ops.cuda import ball_query as _cuda_ball
from pointasnl_tpu_torch.ops.cuda import fps as _cuda_fps
from pointasnl_tpu_torch.ops.cuda import gather_backward as _cuda_gather
from pointasnl_tpu_torch.ops.cuda import knn as _cuda_knn
from pointasnl_tpu_torch.ops.cuda import knn_spatial as _cuda_spatial
from pointasnl_tpu_torch.ops.cuda import knn_streaming as _cuda_streaming

# The resident kernel's largest N (knn.py:RESIDENT_MAX_N) and its largest k;
# past that N the spatial kernel.
RESIDENT_MAX_N, RESIDENT_MAX_K = 12288, 128

pairwise_sqdist = _g.pairwise_sqdist


def _on_cuda(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no implementation for device {t.device}")


class GatherPoint(torch.autograd.Function):
    """gather_point with the gather-backward kernel as its backward: the
    cotangent, float32 or bfloat16, goes to the kernel, and the gradient
    comes back in its dtype, the points'."""

    @staticmethod
    def forward(ctx, points, idx):
        ctx.save_for_backward(idx)
        ctx.n = points.shape[1]
        return _g.gather_point(points, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        (idx,) = ctx.saved_tensors
        return _cuda_gather.gather_backward(dout, idx, ctx.n), None


def gather_point(points, idx):
    if (_on_cuda(points, "gather_point") and points.requires_grad
            and torch.is_grad_enabled()):
        return GatherPoint.apply(points, idx)
    return _g.gather_point(points, idx)


gather_point.__doc__ = _g.gather_point.__doc__


def group_point(points, idx):
    return _g.group_point(points, idx, gather_point_fn=gather_point)


group_point.__doc__ = _g.group_point.__doc__


def three_interpolate(points, idx, weight):
    """Weighted sum of 3 neighbours (see geometry.three_interpolate); the
    gather goes through dispatch."""
    return _g.three_interpolate(points, idx, weight, group_point_fn=group_point)


def farthest_point_sample(npoint, xyz):
    if _on_cuda(xyz, "farthest_point_sample"):
        return _cuda_fps.farthest_point_sample(npoint, xyz.float())
    return _g.farthest_point_sample(npoint, xyz)


farthest_point_sample.__doc__ = _g.farthest_point_sample.__doc__


def knn_route(n: int, k: int) -> str:
    """The kernel that takes a search of k neighbours over n support points
    on the card: "resident", "spatial" or "streaming".

    | Search                                    | Kernel    |
    |-------------------------------------------|-----------|
    | n <= 12288 and k <= 128                   | resident  |
    | 12288 < n <= 2^21 and k <= 128            | spatial   |
    | n > 2^21, or k > 128 at any n             | streaming |

    The JAX package's order (knn.py:knn_point). Where JAX sends k > 128 at
    n <= 65536 to its resident scan, and k > n to its plain oracle, the port
    takes the streaming and the resident kernel: the contract, and so the
    result, is the same. Raises past the streaming kernel's caps, naming them.
    """
    if not 1 <= n <= _cuda_streaming.MAX_N or not 1 <= k <= _cuda_streaming.MAX_K:
        raise ValueError(f"knn_point on the card takes 1 <= N <= {_cuda_streaming.MAX_N} and "
                         f"1 <= k <= {_cuda_streaming.MAX_K} (the streaming kNN kernel's "
                         f"caps), got N={n}, k={k}")
    if k <= RESIDENT_MAX_K and n <= RESIDENT_MAX_N:
        return "resident"
    if k <= _cuda_spatial.MAX_K and n <= _cuda_spatial.MAX_N:
        return "spatial"
    return "streaming"


def knn_point(k, support, query):
    if not _on_cuda(support, "knn_point"):
        return _g.knn_point(k, support, query)
    # A self-query stays one tensor: the spatial wrapper sees `query is support`.
    same = query is support
    support = support.float()
    query = support if same else query.float()
    route = knn_route(support.shape[1], k)
    if route == "resident":
        return _cuda_knn.knn_point(k, support, query)
    if route == "spatial":
        # The same tensor twice is a self-query: the wrapper sees `query is support`.
        return _cuda_spatial.knn_point(k, support, query)
    return _cuda_streaming.knn_point(k, support, query)


knn_point.__doc__ = _g.knn_point.__doc__


def query_ball_point(radius, nsample, xyz, new_xyz):
    if _on_cuda(xyz, "query_ball_point"):
        return _cuda_ball.query_ball_point(radius, nsample, xyz.float(), new_xyz.float())
    return _g.query_ball_point(radius, nsample, xyz, new_xyz)


query_ball_point.__doc__ = _g.query_ball_point.__doc__


def three_nn(xyz1, xyz2):
    """3-NN with squared distances (see geometry.three_nn); the search goes
    through dispatch."""
    return _g.three_nn(xyz1, xyz2, knn=knn_point)


def three_interpolate_idw(xyz1, xyz2, points2):
    """IDW interpolation (see geometry.three_interpolate_idw); the search
    and the gather go through dispatch."""
    return _g.three_interpolate_idw(xyz1, xyz2, points2, three_nn_fn=three_nn,
                                    group_point_fn=group_point)


def repulsion_loss(pred, nsample=20, radius=0.07, h=0.03):
    """Repulsion loss (see geometry.repulsion_loss); the ball query and the
    gather go through dispatch."""
    return _g.repulsion_loss(pred, nsample, radius, h, ball_query=query_ball_point,
                             group_point_fn=group_point)


def sampling(npoint, pts, feature=None):
    """FPS + gather (see geometry.sampling); FPS and the gathers go through
    dispatch."""
    return _g.sampling(npoint, pts, feature, fps=farthest_point_sample,
                       gather_point_fn=gather_point)


def grouping(feature, k, src_xyz, q_xyz, *, use_xyz=True, use_knn=True, radius=0.2, idx=None):
    """Grouping (see geometry.grouping); the search and the gathers go
    through dispatch."""
    return _g.grouping(feature, k, src_xyz, q_xyz, use_xyz=use_xyz, use_knn=use_knn,
                       radius=radius, idx=idx, knn=knn_point, ball_query=query_ball_point,
                       group_point_fn=group_point)
