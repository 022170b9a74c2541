"""Exact kNN with the support streamed, on the card: the wrapper of
``csrc/knn_streaming.cu``.

Replaces ``pointasnl_tpu/ops/pallas/knn.py`` (``_knn_kernel``, the streaming
kernel, reached through ``_knn_scan``): the searches the resident and spatial
kernels do not take, N > 2^21 or k > 128 at any N (``ops.dispatch.knn_route``).
The plain version it is held against is ``ops.geometry.knn_point``, which is
``knn_point_chunked`` at scene sizes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pointasnl_tpu_torch.ops.cuda import _build

MAX_N = 1 << 28  # csrc/knn_streaming.cu:kMaxN
MAX_K = 512  # csrc/knn_streaming.cu:kMaxK
MAX_B = 65535  # the launch grid's y extent

launches = 0  # kernel launches made by this process


def _check_points(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 3:
        raise ValueError(f"streaming knn kernel takes {name} as a (B, *, 3) float32 CUDA "
                         f"tensor, got {tuple(t.shape)} {t.dtype} on {t.device}")


def knn_point(k: int, support: torch.Tensor, query: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming kNN kernel: support (B, N, 3), query (B, M, 3) -> (dist2, idx),
    each (B, M, k). k > N repeats the last valid neighbour."""
    global launches
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
    query = query.detach().contiguous()
    dist = torch.empty((B, M, k), dtype=torch.float32, device=support.device)
    idx = torch.empty((B, M, k), dtype=torch.int32, device=support.device)
    if B == 0 or M == 0:
        return dist, idx
    with torch.cuda.device(support.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.pasnl_knn_streaming(support.data_ptr(), query.data_ptr(),
                                             dist.data_ptr(), idx.data_ptr(), B, N, M, k,
                                             stream), "streaming knn kernel")
    launches += 1
    return dist, idx
