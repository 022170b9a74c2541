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
  - The ball query keeps the first in-ball points in index order; the
    repulsion loss's top-5 sorts stably, so ties go to the lower slot, as
    ``lax.top_k`` does.
"""

from __future__ import annotations

import struct
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


def group_point(points: torch.Tensor, idx: torch.Tensor, *,
                gather_point_fn=gather_point) -> torch.Tensor:
    """Gather neighbourhoods: points (B, N, C), idx (B, M, K) -> (B, M, K, C),
    one gather over the flattened (M, K). `gather_point_fn` lets ops.dispatch
    substitute the gather whose backward is the kernel."""
    B, M, K = idx.shape
    return gather_point_fn(points, idx.reshape(B, M * K)).reshape(B, M, K, points.shape[-1])


# Above this many (B * M * N) distance-matrix elements (1 GiB of float32),
# knn_point switches to knn_point_chunked, which never builds the matrix:
# whole-scene shapes would otherwise need tens of GB.
DENSE_KNN_MAX_ELEMENTS = 2 ** 28


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
      Past DENSE_KNN_MAX_ELEMENTS distances the search is knn_point_chunked,
      with the same result.
    """
    B, N, _ = support.shape
    M = query.shape[1]
    if B * M * N > DENSE_KNN_MAX_ELEMENTS and N >= k:
        return knn_point_chunked(k, support, query)
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


def knn_point_chunked(k: int, support: torch.Tensor, query: torch.Tensor, *,
                      query_block: int = 4096, support_block: int = 8192
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN with O(B * query_block * support_block) transient memory.

    The contract of knn_point, but the (M, N) distance matrix never exists:
    each block of queries scans the support in chunks of support_block and
    merges each chunk into a running top-k. The running list comes before the
    chunk's candidates, chunks arrive in index order and the sort is stable,
    so equal distances go to the lower index.
    """
    B, N, _ = support.shape
    M = query.shape[1]
    if N < k:
        return knn_point(k, support, query)  # degenerate: the dense path pads
    support = support.detach().float()
    query = query.detach().float()
    sb = min(support_block, N)
    dists, idxs = [], []
    for q0 in range(0, M, query_block):
        q_blk = query[:, q0:q0 + query_block]
        best_d = q_blk.new_full((B, q_blk.shape[1], k), _FPS_INF)
        best_i = torch.zeros((B, q_blk.shape[1], k), dtype=torch.long, device=query.device)
        for s0 in range(0, N, sb):
            d2 = pairwise_sqdist(q_blk, support[:, s0:s0 + sb])
            gidx = torch.arange(s0, s0 + d2.shape[-1], device=query.device)
            cand_d = torch.cat([best_d, d2], dim=-1)
            cand_i = torch.cat([best_i, gidx.expand(*d2.shape)], dim=-1)
            best_d, sel = torch.sort(cand_d, dim=-1, stable=True)
            best_d = best_d[..., :k]
            best_i = torch.gather(cand_i, -1, sel[..., :k])
        dists.append(best_d.clamp_min(0.0))
        idxs.append(best_i.to(torch.int32))
    return torch.cat(dists, dim=1), torch.cat(idxs, dim=1)


def _radius_sq(radius: float) -> float:
    """r^2 rounded to float32 from the double ``radius * radius``, the value
    both JAX paths compare float32 distances against."""
    return struct.unpack("f", struct.pack("f", radius * radius))[0]


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-radius neighbourhood query with the reference's padding rule.

    A support point is in the ball iff its squared distance is < r^2
    (strict). The first `nsample` in-ball points in index order are kept;
    empty slots repeat the first in-ball index; an empty ball gives index 0.

    Args:
      radius: ball radius.
      nsample: slots per query.
      xyz:     (B, N, 3) support points.
      new_xyz: (B, M, 3) query points.

    Returns:
      (idx, cnt): (B, M, nsample) int32 indices and (B, M) int32 in-ball
      counts, capped at nsample. No gradient.
    """
    N = xyz.shape[1]
    d2 = pairwise_sqdist(new_xyz.detach(), xyz.detach())
    mask = d2 < _radius_sq(radius)
    arange = torch.arange(N, device=xyz.device)
    cand = torch.where(mask, arange, N)  # out of the ball -> sentinel N
    # The k smallest candidates are the first in-ball points in index order.
    k = min(nsample, N)
    sel = torch.sort(cand, dim=-1, stable=True).values[..., :k]
    if k < nsample:  # more slots than support points: the rest is padding
        sel = torch.cat([sel, sel.new_full((*sel.shape[:-1], nsample - k), N)], dim=-1)
    first = sel[..., :1]
    pad = torch.where(first < N, first, 0)
    idx = torch.where(sel < N, sel, pad).to(torch.int32)
    cnt = mask.sum(dim=-1).clamp_max(nsample).to(torch.int32)
    return idx, cnt


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor, *,
             knn=knn_point) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3 nearest neighbours of xyz1 (B, M1, 3) in xyz2 (B, M2, 3), with
    SQUARED distances: (dist2, idx), each (B, M1, 3), dist2 ascending. No
    gradient flows through dist2, as in the reference.

    With M2 < 3 the missing slots hold distance 1e38 and index 0, so their
    inverse-distance weight is ~0. `knn` lets ops.dispatch substitute the
    kNN kernel.
    """
    N = xyz2.shape[1]
    if N < 3:
        d2, idx = knn(N, xyz2, xyz1)
        pad = 3 - N
        d2 = torch.cat([d2, d2.new_full((*d2.shape[:-1], pad), 1e38)], dim=-1)
        idx = torch.cat([idx, idx.new_zeros((*idx.shape[:-1], pad))], dim=-1)
    else:
        d2, idx = knn(3, xyz2, xyz1)
    return d2.detach(), idx


def three_interpolate(points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor, *,
                      group_point_fn=group_point) -> torch.Tensor:
    """Weighted sum of 3 neighbours: points (B, M2, C), idx and weight
    (B, M1, 3) -> (B, M1, C). `group_point_fn` lets ops.dispatch substitute
    the gather whose backward is the kernel."""
    return torch.sum(group_point_fn(points, idx) * weight[..., None], dim=2)


def three_interpolate_idw(xyz1: torch.Tensor, xyz2: torch.Tensor, points2: torch.Tensor,
                          *, three_nn_fn=three_nn, group_point_fn=group_point) -> torch.Tensor:
    """three_nn + inverse-distance weights + three_interpolate: the weights
    are 1 / d^2 with d^2 clamped at >= 1e-10, normalised over the 3
    neighbours. `three_nn_fn` and `group_point_fn` let ops.dispatch
    substitute the kernel search and the gather."""
    dist2, idx = three_nn_fn(xyz1, xyz2)
    inv = 1.0 / dist2.clamp_min(1e-10)
    weight = inv / inv.sum(dim=2, keepdim=True)
    return three_interpolate(points2, idx, weight, group_point_fn=group_point_fn)


def repulsion_loss(pred: torch.Tensor, nsample: int = 20, radius: float = 0.07,
                   h: float = 0.03, *, ball_query=query_ball_point,
                   group_point_fn=group_point) -> torch.Tensor:
    """Uniformity (repulsion) penalty on sampled positions pred (B, M, 3)
    (utils/pointasnl_util.py:361-378): ball-query `nsample` neighbours in
    `radius`, keep the 5 nearest, drop the nearest (the point itself), and
    return mean(radius - d * exp(-d^2 / h^2)). `ball_query` and
    `group_point_fn` let ops.dispatch substitute the kernel and the gather."""
    idx, _ = ball_query(radius, nsample, pred, pred)
    grouped = group_point_fn(pred, idx) - pred[:, :, None, :]
    dist2 = torch.sum(grouped * grouped, dim=-1)  # (B, M, nsample)
    dist2 = torch.sort(dist2, dim=-1, stable=True).values[..., 1:5]
    dist2 = dist2.clamp_min(1e-12)
    weight = torch.exp(-dist2 / (h * h))
    return torch.mean(radius - torch.sqrt(dist2) * weight)


def sampling(npoint: int, pts: torch.Tensor, feature: Optional[torch.Tensor] = None,
             fps=farthest_point_sample, gather_point_fn=gather_point):
    """FPS + gather, the reference's `sampling` (utils/pointasnl_util.py:33-49).

    `fps` and `gather_point_fn` let ops.dispatch substitute the FPS kernel
    and the gather.
    """
    fps_idx = fps(npoint, pts)
    if feature is None:
        return gather_point_fn(pts, fps_idx)
    return gather_point_fn(pts, fps_idx), gather_point_fn(feature, fps_idx)


def grouping(
    feature: torch.Tensor,
    k: int,
    src_xyz: torch.Tensor,
    q_xyz: torch.Tensor,
    *,
    use_xyz: bool = True,
    use_knn: bool = True,
    radius: float = 0.2,
    idx: Optional[torch.Tensor] = None,
    knn=knn_point,
    ball_query=query_ball_point,
    group_point_fn=group_point,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Neighbourhood grouping, the reference's `grouping`
    (utils/pointasnl_util.py:51-76): the `k` nearest neighbours, or with
    `use_knn=False` the first `k` points within `radius`.

    Returns (grouped_xyz, grouped_feature, idx) with shapes (B, M, K, 3),
    (B, M, K, [3+]C) and (B, M, K); with `use_xyz` the RAW grouped xyz is
    prepended to the features. `idx` skips the search with precomputed
    neighbour rows (exact: a row depends only on its query). `knn`,
    `ball_query` and `group_point_fn` let ops.dispatch substitute the
    kernels and the gather.
    """
    if idx is None:
        if use_knn:
            _, idx = knn(k, src_xyz, q_xyz)
        else:
            idx, _ = ball_query(radius, k, src_xyz, q_xyz)
    grouped_xyz = group_point_fn(src_xyz, idx)
    grouped_feature = group_point_fn(feature, idx)
    if use_xyz:
        grouped_feature = torch.cat([grouped_xyz, grouped_feature], dim=-1)
    return grouped_xyz, grouped_feature, idx
