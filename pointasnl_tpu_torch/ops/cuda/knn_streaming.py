"""Exact kNN with the support streamed and pruned, on the card: the plan
around ``csrc/knn_streaming.cu`` and the kernel's wrapper.

Replaces ``pointasnl_tpu/ops/pallas/knn.py`` (``_knn_kernel``, the streaming
kernel, reached through ``_knn_scan``): the searches the resident and spatial
kernels do not take, N > 2^21 or k > 128 at any N (``ops.dispatch.knn_route``).
The plain version it is held against is ``ops.geometry.knn_point``, which is
``knn_point_chunked`` at scene sizes.

The kernel walks segments of the Morton-sorted support nearest first and
skips those that cannot hold a neighbour, on the spatial kernel's plan
(``knn_spatial.make_plan``, plain tensor ops on the device). What differs
from the spatial kernel is what this one must take: k up to 512 (the query
tile shrinks with k, ``tile_for``), any N up to 2^28 (segments widen until
the plan stays within PLAN_ELEMENTS entries, ``segment_width``, and are
staged in chunks), and k > N (the last neighbour repeated).

``emulate`` runs the kernel's visit rule in plain PyTorch on the same plan,
so that the CPU tests hold it to the plain kNN; only the tests use it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pointasnl_tpu_torch.ops.cuda import _build
from pointasnl_tpu_torch.ops.cuda import knn_spatial as _spatial

MAX_N = 1 << 28  # csrc/knn_streaming.cu:kMaxN
MAX_K = 512  # csrc/knn_streaming.cu:kMaxK
MAX_B = 65535  # the launch grid's y extent
MIN_SEG_W = 64
# (batch, tile, segment) entries of a plan at most: 2^26 keeps the order and
# the bounds within 512 MB, and 2228224 self-queries at segments of 1024.
PLAN_ELEMENTS = 1 << 26

launches = 0  # kernel launches made by this process


def tile_for(k: int) -> int:
    """Queries a tile (a block, a thread each): the lists, tile * k * 8
    bytes, stay within 128 KB of shared memory."""
    return 128 if k <= 128 else 64 if k <= 256 else 32


def segment_width(n: int, m: int, k: int, b: int = 1) -> int:
    """Support points a segment: 64, widened by powers of two until the plan
    of b clouds of m queries over n points holds at most PLAN_ELEMENTS
    (tile, segment) entries."""
    tiles = b * -(-m // tile_for(k))
    seg_w = MIN_SEG_W
    while seg_w < n and tiles * -(-n // seg_w) > PLAN_ELEMENTS:
        seg_w *= 2
    return seg_w


def _check_points(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 3:
        raise ValueError(f"streaming knn kernel takes {name} as a (B, *, 3) float32 CUDA "
                         f"tensor, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _launch(k: int, support: torch.Tensor, query: torch.Tensor, tested):
    global launches
    self_query = query is support
    _check_points("support", support)
    _check_points("query", query)
    B, N, _ = support.shape
    M = query.shape[1]
    if query.shape[0] != B or query.device != support.device:
        raise ValueError("streaming knn kernel: support and query differ in batch or device")
    if not 1 <= N <= MAX_N or not 1 <= k <= MAX_K or B > MAX_B:
        raise ValueError(f"streaming knn kernel takes 1 <= N <= {MAX_N}, 1 <= k <= {MAX_K} "
                         f"and B <= {MAX_B}, got N={N}, k={k}, B={B}")
    lib = _build.library()
    if (lib.pasnl_knn_streaming_max_n(), lib.pasnl_knn_streaming_max_k()) != (MAX_N, MAX_K):
        raise RuntimeError("streaming knn kernel: the library's caps are not the wrapper's")
    support = support.detach().contiguous()
    query = support if self_query else query.detach().contiguous()
    dist = torch.empty((B, M, k), dtype=torch.float32, device=support.device)
    idx = torch.empty((B, M, k), dtype=torch.int32, device=support.device)
    if B == 0 or M == 0:
        return dist, idx
    tile, seg_w = tile_for(k), segment_width(N, M, k, B)
    plan = _spatial.make_plan(support, query, self_query, seg_w, tile)
    n_seg, n_tile = plan.spheres.shape[1], plan.order.shape[1]
    with torch.cuda.device(support.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.pasnl_knn_streaming(
            plan.q_sorted.data_ptr(), plan.s_sorted.data_ptr(), plan.ids.data_ptr(),
            plan.spheres.data_ptr(), plan.order.data_ptr(), plan.lower.data_ptr(),
            dist.data_ptr(), idx.data_ptr(), tested, B, N, M, k, seg_w, n_seg, n_tile, tile,
            stream), "streaming knn kernel")
    launches += 1
    return _spatial._unsort(dist, plan.qperm), _spatial._unsort(idx, plan.qperm)


def knn_point(k: int, support: torch.Tensor, query: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming kNN kernel: support (B, N, 3), query (B, M, 3) -> (dist2, idx),
    each (B, M, k). k > N repeats the last valid neighbour. Pass the same
    tensor twice for a self-query: the queries then share the support's sort."""
    return _launch(k, support, query, None)


def pairs_tested(k: int, support: torch.Tensor, query: torch.Tensor) -> int:
    """The (query, support point) pairs whose distance the kernel computes
    for this search, from one launch that counts them."""
    count = torch.zeros(1, dtype=torch.int64, device=support.device)
    _launch(k, support, query, count.data_ptr())
    return int(count.item())


def emulate(k: int, support: torch.Tensor, query: torch.Tensor, *, seg_w: int = None,
            tile_m: int = None) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The kernel's visit rule in plain PyTorch: (dist2, idx, pairs tested).
    ``knn_spatial.emulate`` with the whole tile walking together, at this
    kernel's tile and segment width, with k > N filled by the last valid
    neighbour. For tests."""
    B, N, _ = support.shape
    tile_m = tile_m or tile_for(k)
    seg_w = seg_w or segment_width(N, query.shape[1], k, B)
    dist, idx, tested = _spatial.emulate(k, support, query, seg_w=seg_w, tile_m=tile_m,
                                         walk=tile_m)
    if k > N:
        dist = torch.cat([dist[..., :N], dist[..., N - 1:N].expand(-1, -1, k - N)], dim=-1)
        idx = torch.cat([idx[..., :N], idx[..., N - 1:N].expand(-1, -1, k - N)], dim=-1)
    return dist, idx, tested
