"""Exact kNN on the card: the wrapper of ``csrc/knn.cu``.

Replaces ``pointasnl_tpu/ops/pallas/knn.py`` (``_knn_kernel_resident``, reached
through ``_knn_scan``). The plain version it is held against is
``ops.geometry.knn_point``. ``queries_a_warp`` sizes its warps.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pointasnl_tpu_torch.ops.cuda import _build

launches = 0  # kernel launches made by this process
# Warps that fill the H100: 132 SMs x 31.
FILL_WARPS = 4096


def queries_a_warp(queries: int) -> int:
    """Queries a warp of the resident kNN kernel takes for a search of
    `queries` rows in all (B * M): 4, so that one candidate a lane serves 4
    pairs, where that still leaves FILL_WARPS warps; else 1, so that a small
    search spreads over more warps (on the H100, 2 was never the best:
    PERF.md, section 6)."""
    return 4 if queries >= 4 * FILL_WARPS else 1


def _check_points(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 3:
        raise ValueError(f"knn kernel takes {name} as a (B, *, 3) float32 CUDA tensor, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def knn_point(k: int, support: torch.Tensor, query: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN kernel: support (B, N, 3), query (B, M, 3) -> (dist2, idx), each (B, M, k).

    k > N repeats the last valid neighbour, as the plain version does.
    """
    global launches
    _check_points("support", support)
    _check_points("query", query)
    B, N, _ = support.shape
    M = query.shape[1]
    if query.shape[0] != B or query.device != support.device:
        raise ValueError("knn kernel: support and query differ in batch or device")
    lib = _build.library()
    max_n, max_k = lib.pasnl_knn_max_n(), lib.pasnl_knn_max_k()
    if not 1 <= N <= max_n or not 1 <= k <= max_k:
        raise ValueError(f"knn kernel takes 1 <= N <= {max_n} and 1 <= k <= {max_k}, "
                         f"got N={N}, k={k}")
    support = support.detach().contiguous()
    query = query.detach().contiguous()
    dist = torch.empty((B, M, k), dtype=torch.float32, device=support.device)
    idx = torch.empty((B, M, k), dtype=torch.int32, device=support.device)
    if B == 0 or M == 0:
        return dist, idx
    with torch.cuda.device(support.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.pasnl_knn(support.data_ptr(), query.data_ptr(), dist.data_ptr(),
                                   idx.data_ptr(), B, N, M, k, queries_a_warp(B * M), stream),
                     "knn kernel")
    launches += 1
    return dist, idx
