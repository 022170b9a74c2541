"""Farthest point sampling on the card: the wrapper of ``csrc/fps.cu``.

Replaces ``pointasnl_tpu/ops/pallas/fps.py`` (``_fps_kernel``). The plain
version it is held against is ``ops.geometry.farthest_point_sample``. Two
designs, routed by N: one block a cloud up to N = 10240, a cluster of 8
blocks a cloud up to N = 131072 (whole scenes).
"""

from __future__ import annotations

import torch

from pointasnl_tpu_torch.ops.cuda import _build

launches = 0  # kernel launches made by this process, of either design


def farthest_point_sample(npoint: int, xyz: torch.Tensor) -> torch.Tensor:
    """FPS kernel: xyz (B, N, 3) float32 on a CUDA device -> (B, npoint) int32."""
    global launches
    if not xyz.is_cuda or xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"fps kernel takes a (B, N, 3) float32 CUDA tensor, got "
                         f"{tuple(xyz.shape)} {xyz.dtype} on {xyz.device}")
    B, N, _ = xyz.shape
    lib = _build.library()
    max_n = lib.pasnl_fps_cluster_max_n()
    if not 1 <= N <= max_n or npoint < 1:
        raise ValueError(f"fps kernel takes 1 <= N <= {max_n} and npoint >= 1, "
                         f"got N={N}, npoint={npoint}")
    launch = lib.pasnl_fps if N <= lib.pasnl_fps_max_n() else lib.pasnl_fps_cluster
    xyz = xyz.detach().contiguous()
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    if B == 0:
        return out
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(launch(xyz.data_ptr(), out.data_ptr(), B, N, npoint, stream), "fps kernel")
    launches += 1
    return out
