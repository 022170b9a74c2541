"""Geometry primitives as plain PyTorch functions.

The plain versions of the geometry ops of ``pointasnl_tpu.ops.geometry``.
They run on any device, but ``ops.dispatch`` sends only CPU tensors here: a
CUDA tensor goes to the hand-written kernels of ``ops.cuda``, which are held
against these functions on the card.

Distances are DIRECT squared differences summed in x, y, z order,
``(dx*dx + dy*dy) + dz*dz``, each step a separate rounded float32 operation.
That is the formula of the JAX oracle and of the CUDA kernels, so all three
give the same bits and the same neighbour and sample order.

Tie rules, as in the JAX package:
  - FPS picks index 0 first, then the argmax of the running minimum squared
    distance; ``torch.argmax`` returns the first maximum, like ``jnp.argmax``.
  - kNN breaks equal distances toward the lower support index. ``torch.topk``
    does not promise that order, so the plain kNN sorts stably.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Initial running minimum distance of FPS (tf_sampling_g.cu:121 sets 1e38).
_FPS_INF = 1e38


def _sqdist_xyz(d: torch.Tensor) -> torch.Tensor:
    """Sum of squares over a last axis of size 3, in x, y, z order."""
    sq = d * d
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def pairwise_sqdist(query: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances between two batched point sets.

    Args:
      query:   (B, M, 3) float tensor.
      support: (B, N, 3) float tensor.

    Returns:
      (B, M, N) float32 squared distances, as direct differences.
    """
    query = query.float()
    support = support.float()
    return _sqdist_xyz(query[:, :, None, :] - support[:, None, :, :])


def farthest_point_sample(npoint: int, xyz: torch.Tensor) -> torch.Tensor:
    """Iterative farthest point sampling, (B, N, 3) -> (B, npoint) int32.

    The first index is 0; each later pick maximises the running minimum
    squared distance to the picked set, with ties to the lowest index.
    """
    xyz = xyz.detach().float()
    B, N, _ = xyz.shape
    idxs = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    min_dist = torch.full((B, N), _FPS_INF, dtype=torch.float32, device=xyz.device)
    last = torch.zeros((B,), dtype=torch.long, device=xyz.device)
    batch = torch.arange(B, device=xyz.device)
    for j in range(1, npoint):
        p = xyz[batch, last]  # (B, 3)
        min_dist = torch.minimum(min_dist, _sqdist_xyz(xyz - p[:, None, :]))
        last = torch.argmax(min_dist, dim=-1)
        idxs[:, j] = last.to(torch.int32)
    return idxs


def gather_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather points (B, N, C) by per-batch indices (B, M) -> (B, M, C)."""
    index = idx.long()[..., None].expand(-1, -1, points.shape[-1])
    return torch.gather(points, 1, index)


def group_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather neighbourhoods: points (B, N, C), idx (B, M, K) -> (B, M, K, C)."""
    B, M, K = idx.shape
    return gather_point(points, idx.reshape(B, M * K)).reshape(B, M, K, points.shape[-1])


def knn_point(k: int, support: torch.Tensor, query: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest neighbours by brute force.

    Args:
      k: number of neighbours.
      support: (B, N, 3) points searched over.
      query:   (B, M, 3) query points.

    Returns:
      (dist2, idx): (B, M, k) float32 squared distances in ascending order,
      clamped at >= 0, and int32 support indices. Ties go to the lower support
      index, so a query that lies in the support is its own first neighbour.
      When k > N, the last valid neighbour is repeated to fill k slots.
    """
    N = support.shape[1]
    d2 = pairwise_sqdist(query.detach(), support.detach())
    k_eff = min(k, N)
    dist, idx = torch.sort(d2, dim=-1, stable=True)
    dist = dist[..., :k_eff].clamp_min(0.0)
    idx = idx[..., :k_eff].to(torch.int32)
    if k_eff < k:
        pad = k - k_eff
        dist = torch.cat([dist, dist[..., -1:].expand(*dist.shape[:-1], pad)], dim=-1)
        idx = torch.cat([idx, idx[..., -1:].expand(*idx.shape[:-1], pad)], dim=-1)
    return dist, idx


def sampling(npoint: int, pts: torch.Tensor, feature: Optional[torch.Tensor] = None,
             fps=farthest_point_sample):
    """FPS + gather, the reference's `sampling` (utils/pointasnl_util.py:33-49).

    `fps` lets ops.dispatch substitute the FPS kernel.
    """
    fps_idx = fps(npoint, pts)
    if feature is None:
        return gather_point(pts, fps_idx)
    return gather_point(pts, fps_idx), gather_point(feature, fps_idx)


def grouping(
    feature: torch.Tensor,
    k: int,
    src_xyz: torch.Tensor,
    q_xyz: torch.Tensor,
    *,
    use_xyz: bool = True,
    knn=knn_point,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """kNN neighbourhood grouping, the reference's `grouping`
    (utils/pointasnl_util.py:51-76).

    Returns (grouped_xyz, grouped_feature, idx) with shapes (B, M, K, 3),
    (B, M, K, [3+]C) and (B, M, K); with `use_xyz` the RAW grouped xyz is
    prepended to the features. `knn` lets ops.dispatch substitute the kNN
    kernel. The ball-query branch is not ported yet.
    """
    _, idx = knn(k, src_xyz, q_xyz)
    grouped_xyz = group_point(src_xyz, idx)
    grouped_feature = group_point(feature, idx)
    if use_xyz:
        grouped_feature = torch.cat([grouped_xyz, grouped_feature], dim=-1)
    return grouped_xyz, grouped_feature, idx
