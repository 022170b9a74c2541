"""Ball query on the card: the wrapper of ``csrc/ball_query.cu``.

Replaces ``pointasnl_tpu/ops/pallas/ball_query.py`` (``_ball_kernel``). The
plain version it is held against is ``ops.geometry.query_ball_point``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pointasnl_tpu_torch.ops.cuda import _build
from pointasnl_tpu_torch.ops.geometry import _radius_sq

launches = 0  # kernel launches made by this process


def _check_points(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 3:
        raise ValueError(f"ball query kernel takes {name} as a (B, *, 3) float32 CUDA tensor, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ball-query kernel: xyz (B, N, 3), new_xyz (B, M, 3) ->
    (idx (B, M, nsample) int32, cnt (B, M) int32)."""
    global launches
    _check_points("xyz", xyz)
    _check_points("new_xyz", new_xyz)
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    if new_xyz.shape[0] != B or new_xyz.device != xyz.device:
        raise ValueError("ball query kernel: xyz and new_xyz differ in batch or device")
    lib = _build.library()
    max_n, max_ns = lib.pasnl_ball_query_max_n(), lib.pasnl_ball_query_max_nsample()
    if not 1 <= N <= max_n or not 1 <= nsample <= max_ns:
        raise ValueError(f"ball query kernel takes 1 <= N <= {max_n} and 1 <= nsample <= "
                         f"{max_ns}, got N={N}, nsample={nsample}")
    xyz = xyz.detach().contiguous()
    new_xyz = new_xyz.detach().contiguous()
    idx = torch.empty((B, M, nsample), dtype=torch.int32, device=xyz.device)
    cnt = torch.empty((B, M), dtype=torch.int32, device=xyz.device)
    if B == 0 or M == 0:
        return idx, cnt
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.pasnl_ball_query(xyz.data_ptr(), new_xyz.data_ptr(), idx.data_ptr(),
                                          cnt.data_ptr(), B, N, M, nsample, _radius_sq(radius),
                                          stream), "ball query kernel")
    launches += 1
    return idx, cnt
