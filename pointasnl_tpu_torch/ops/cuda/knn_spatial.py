"""Spatially-pruned exact kNN on the card: the plan around ``csrc/knn_spatial.cu``
and the kernel's wrapper.

Replaces ``pointasnl_tpu/ops/pallas/knn_spatial.py`` (``_knn_spatial_kernel``,
wrapper ``_knn_spatial``), the kNN of whole scenes (12288 < N <= 2^21). The
plain version it is held against is ``ops.geometry.knn_point``, which is
``knn_point_chunked`` at that size.

``make_plan`` is the JAX wrapper's preprocessing in plain tensor ops, run on
the device around the kernel: Morton codes, the stable Morton sort of the
support (and of the queries, unless they are the support), the segments'
and tiles' bounding spheres with the absolute slack, and the (tile, segment)
lower bounds with their ascending order, the visit order. JAX pads the
order with a +inf bound so that its loop may read one past the end; the
kernel's loop stops at the last segment instead. The output does not depend
on the permutation, so only the plan's logic follows JAX, not its sort order.

``pack_points`` packs the sorted support as (x, y, z, original id) in one
16-byte word a point, the kernel's one load a candidate.

``emulate`` runs the kernel's visit rule (gates, early stop, (d2, id) merge)
in plain PyTorch on the plan, so that the pruning logic is tested where the
kernel cannot run: with the queries of a warp walking together, the rule of
this kernel, or with a whole tile, the rule of the streaming kernel. Only
the tests use it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from pointasnl_tpu_torch.ops.cuda import _build
from pointasnl_tpu_torch.ops.geometry import _sqdist_xyz, gather_point, pairwise_sqdist

TILE_M = 128  # queries a tile of the plan, csrc/knn_spatial.cu:kTile
# Support points a segment: 64, widened by powers of two so that a tile's
# visit order holds at most MAX_SEGMENTS segments (csrc/knn_spatial.cu).
MIN_SEG_W, MAX_SEGMENTS = 64, 2048
MAX_K = 128
MAX_N = 1 << 21  # segments of 1024
LANE_MAX_K = 4  # k up to which a lane takes a query of its own
# Absolute slack on the segment radii, as a fraction of the scene's extent:
# the float32 error of |q - c| - r is a few ulps of the coordinates, not of
# the (small) difference (knn_spatial.py:_EPS_FRAC).
EPS_FRAC = 1e-5
_INT_MAX = 2 ** 31 - 1

launches = 0  # kernel launches made by this process


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread the 10 low bits of v to every third bit (int64, exact)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def morton_codes(xyz: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int32) of xyz (..., 3) on a 1024^3 grid over [lo, hi]."""
    # A tensor numerator: `1023.0 / t` is 1023.0 * (1 / t) in PyTorch, rounded twice.
    scale = hi.new_tensor(1023.0) / torch.clamp_min(hi - lo, 1e-9)
    q = torch.clamp((xyz - lo) * scale, 0.0, 1023.0).to(torch.int32).long()
    return (_spread3(q[..., 0]) | (_spread3(q[..., 1]) << 1)
            | (_spread3(q[..., 2]) << 2)).to(torch.int32)


def sphere(points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bounding sphere (centre, radius) over axis -2 of (..., W, 3) points:
    the box's centre and the largest distance from it."""
    c = 0.5 * (points.amin(dim=-2) + points.amax(dim=-2))
    return c, torch.sqrt(_sqdist_xyz(points - c[..., None, :]).amax(dim=-1))


def _edge_pad(x: torch.Tensor, n: int) -> torch.Tensor:
    """Pad (B, N, 3) to (B, n, 3) by repeating the last point."""
    if n == x.shape[1]:
        return x
    return torch.cat([x, x[:, -1:].expand(x.shape[0], n - x.shape[1], 3)], dim=1)


class Plan(NamedTuple):
    q_sorted: torch.Tensor  # (B, M, 3) queries in Morton order
    qperm: torch.Tensor  # (B, M) int64: sorted row -> caller's row
    s_sorted: torch.Tensor  # (B, N, 3) support in Morton order
    ids: torch.Tensor  # (B, N) int32: sorted point -> original index
    spheres: torch.Tensor  # (B, S, 4) segment centre and radius (with slack)
    order: torch.Tensor  # (B, T, S) int32: a tile's segments, nearest first
    lower: torch.Tensor  # (B, T, S) float32: their squared lower bounds, ascending


def segment_width(n: int) -> int:
    """Support points a segment for a support of n points."""
    seg_w = MIN_SEG_W
    while -(-n // seg_w) > MAX_SEGMENTS:
        seg_w *= 2
    return seg_w


def make_plan(support: torch.Tensor, query: torch.Tensor, self_query: bool,
              seg_w: int, tile_m: int = TILE_M) -> Plan:
    """The kernel's plan (knn_spatial.py:291-386, single level) for float32
    support (B, N, 3) and query (B, M, 3), in segments of seg_w points. With
    `self_query` the queries are the support and share its sort."""
    B, N, _ = support.shape
    lo = support.amin(dim=1, keepdim=True)
    hi = support.amax(dim=1, keepdim=True)
    perm = torch.argsort(morton_codes(support, lo, hi), dim=1, stable=True)
    s_sorted = gather_point(support, perm)
    n_seg = -(-N // seg_w)
    seg_c, seg_r = sphere(_edge_pad(s_sorted, n_seg * seg_w).view(B, n_seg, seg_w, 3))
    seg_r = seg_r + EPS_FRAC * (hi - lo).amax(dim=-1)
    if self_query:
        q_sorted, qperm = s_sorted, perm
    else:
        qperm = torch.argsort(morton_codes(query, lo, hi), dim=1, stable=True)
        q_sorted = gather_point(query, qperm)
    n_tile = -(-q_sorted.shape[1] // tile_m)
    tile_c, tile_r = sphere(_edge_pad(q_sorted, n_tile * tile_m).view(B, n_tile, tile_m, 3))
    ccd = torch.sqrt(torch.clamp_min(_sqdist_xyz(tile_c[:, :, None] - seg_c[:, None]), 0.0))
    lb = torch.clamp_min(ccd - tile_r[:, :, None] - seg_r[:, None, :], 0.0)
    lb2 = lb * lb  # (B, T, S)
    order = torch.argsort(lb2, dim=2, stable=True)
    return Plan(q_sorted, qperm, s_sorted, perm.to(torch.int32),
                torch.cat([seg_c, seg_r[..., None]], dim=-1), order.to(torch.int32),
                torch.gather(lb2, 2, order))


def walk_rows(k: int) -> int:
    """Queries that walk a tile's order together in the kernel: one, a warp
    each with its list across the lanes, or 32, a lane each, for
    k <= LANE_MAX_K (csrc/knn_select.cuh:kLaneK)."""
    return 32 if k <= LANE_MAX_K else 1


def pack_points(s_sorted: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) float32 points and (B, N) int32 ids -> (B, N, 4) float32
    (x, y, z, id), the id's bits stored as they are in the fourth float."""
    return torch.cat([s_sorted, ids.view(torch.float32)[..., None]], dim=-1)


def _unsort(rows: torch.Tensor, qperm: torch.Tensor) -> torch.Tensor:
    """Rows (B, M, k) in sorted order -> the caller's order."""
    out = torch.empty_like(rows)
    return out.scatter_(1, qperm[..., None].expand_as(rows), rows)


def _check_points(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 3:
        raise ValueError(f"spatial knn kernel takes {name} as a (B, *, 3) float32 CUDA "
                         f"tensor, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _launch(k: int, support: torch.Tensor, query: torch.Tensor, tested):
    global launches
    self_query = query is support
    _check_points("support", support)
    _check_points("query", query)
    B, N, _ = support.shape
    M = query.shape[1]
    if query.shape[0] != B or query.device != support.device:
        raise ValueError("spatial knn kernel: support and query differ in batch or device")
    if not 1 <= k <= MAX_K or not k <= N <= MAX_N:
        raise ValueError(f"spatial knn kernel takes 1 <= k <= {MAX_K} and k <= N <= {MAX_N}, "
                         f"got N={N}, k={k}")
    support = support.detach().contiguous()
    query = support if self_query else query.detach().contiguous()
    dist = torch.empty((B, M, k), dtype=torch.float32, device=support.device)
    idx = torch.empty((B, M, k), dtype=torch.int32, device=support.device)
    if B == 0 or M == 0:
        return dist, idx
    lib = _build.library()
    if lib.pasnl_knn_spatial_tile() != TILE_M:
        raise RuntimeError(f"spatial knn kernel: the library's tile is not the plan's {TILE_M}")
    seg_w = segment_width(N)
    plan = make_plan(support, query, self_query, seg_w)
    points = pack_points(plan.s_sorted, plan.ids)
    n_seg, n_tile = plan.spheres.shape[1], plan.order.shape[1]
    with torch.cuda.device(support.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.pasnl_knn_spatial(
            plan.q_sorted.data_ptr(), points.data_ptr(), plan.spheres.data_ptr(),
            plan.order.data_ptr(), plan.lower.data_ptr(), dist.data_ptr(), idx.data_ptr(),
            tested, B, N, M, k, seg_w, n_seg, n_tile, walk_rows(k), stream),
            "spatial knn kernel")
    launches += 1
    return _unsort(dist, plan.qperm), _unsort(idx, plan.qperm)


def knn_point(k: int, support: torch.Tensor, query: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spatial kNN kernel: support (B, N, 3), query (B, M, 3) -> (dist2, idx),
    each (B, M, k). Pass the same tensor twice for a self-query: the queries
    then share the support's sort."""
    return _launch(k, support, query, None)


def pairs_tested(k: int, support: torch.Tensor, query: torch.Tensor) -> int:
    """The (query, support point) pairs whose distance the kernel computes
    for this search, from one launch that counts them."""
    count = torch.zeros(1, dtype=torch.int64, device=support.device)
    _launch(k, support, query, count.data_ptr())
    return int(count.item())


def emulate(k: int, support: torch.Tensor, query: torch.Tensor, *, seg_w: int = None,
            tile_m: int = TILE_M, walk: int = None) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The kernel's visit rule in plain PyTorch: (dist2, idx, pairs tested).

    The queries of a tile go in groups of `walk` (the kernel's,
    ``walk_rows(k)``, by default; `tile_m` for the streaming
    kernel's tile-wide walk). A group walks its tile's segments nearest
    first and stops when the next lower bound exceeds the largest kth d2 of
    its rows; a row tests a segment only if max(0, |q - c| - r)^2 <= its kth
    d2, and keeps the k least (d2, original id) of its list and the
    candidates. For tests.
    """
    self_query = query is support
    B, N, _ = support.shape
    seg_w = seg_w or segment_width(N)
    walk = walk or walk_rows(k)
    if tile_m % walk:
        raise ValueError(f"a walk of {walk} rows does not divide the tile of {tile_m}")
    plan = make_plan(support.detach().float(), query.detach().float(), self_query, seg_w,
                     tile_m)
    M = plan.q_sorted.shape[1]
    dist = torch.empty((B, M, k), dtype=torch.float32)
    idx = torch.empty((B, M, k), dtype=torch.int64)
    tested = 0
    for b in range(B):
        for t in range(plan.order.shape[1]):
            q = plan.q_sorted[b, t * tile_m:(t + 1) * tile_m]
            run_d = torch.full((q.shape[0], k), float("inf"))
            run_i = torch.full((q.shape[0], k), _INT_MAX, dtype=torch.int64)
            group = torch.arange(q.shape[0]) // walk
            bound = torch.full((int(group[-1]) + 1,), float("inf"))  # a group's largest kth
            for v in range(plan.order.shape[2]):
                walking = plan.lower[b, t, v] <= bound
                if not bool(walking.any()):
                    break
                seg = int(plan.order[b, t, v])
                c, r = plan.spheres[b, seg, :3], plan.spheres[b, seg, 3]
                gap = torch.clamp_min(torch.sqrt(_sqdist_xyz(q - c)) - r, 0.0)
                rows = (gap * gap <= run_d[:, -1]) & walking[group]
                if not bool(rows.any()):
                    continue
                lo, hi = seg * seg_w, min(N, (seg + 1) * seg_w)
                d2 = pairwise_sqdist(q[rows][None], plan.s_sorted[b, lo:hi][None])[0]
                ids = plan.ids[b, lo:hi].long().expand_as(d2)
                cd = torch.cat([run_d[rows], d2], dim=1)
                ci = torch.cat([run_i[rows], ids], dim=1)
                by_id = torch.argsort(ci, dim=1, stable=True)  # then by d2: (d2, id) order
                cd, ci = torch.gather(cd, 1, by_id), torch.gather(ci, 1, by_id)
                by_d = torch.argsort(cd, dim=1, stable=True)[:, :k]
                run_d[rows] = torch.gather(cd, 1, by_d)
                run_i[rows] = torch.gather(ci, 1, by_d)
                tested += int(rows.sum()) * (hi - lo)
                bound = bound.scatter_reduce(0, group, run_d[:, -1], "amax", include_self=False)
            dist[b, t * tile_m:t * tile_m + q.shape[0]] = run_d.clamp_min(0.0)
            idx[b, t * tile_m:t * tile_m + q.shape[0]] = run_i
    return _unsort(dist, plan.qperm), _unsort(idx, plan.qperm).to(torch.int32), tested
