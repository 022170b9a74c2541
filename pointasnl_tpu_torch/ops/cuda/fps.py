"""Farthest point sampling on the card: the wrapper of ``csrc/fps.cu``.

Replaces ``pointasnl_tpu/ops/pallas/fps.py`` (``_fps_kernel``). The plain
version it is held against is ``ops.geometry.farthest_point_sample``. Three
designs, routed by N (``design``): one block a cloud up to N = 10240, a
cluster of 8 blocks a cloud up to N = 131072 (whole scenes), and past that a
cooperative grid of one block per SM, whose largest N the card's SM count and
shared memory decide (``pasnl_fps_grid_max_n``).
"""

from __future__ import annotations

import torch

from pointasnl_tpu_torch.ops.cuda import _build

BLOCK_MAX_N = 10240  # csrc/fps.cu:kBlockMaxN
CLUSTER_MAX_N = 131072  # csrc/fps.cu:kClusterMaxN
DESIGNS = ("block", "cluster", "grid")

launches = 0  # kernel launches made by this process, of any design


def design(n: int) -> str:
    """The design that takes a cloud of n points: the smallest that holds it."""
    if n <= BLOCK_MAX_N:
        return "block"
    return "cluster" if n <= CLUSTER_MAX_N else "grid"


def _max_n(lib, name: str) -> int:
    """The largest N that design `name` takes, as the library states it; the
    routing constants above must be the library's own."""
    if (lib.pasnl_fps_max_n(), lib.pasnl_fps_cluster_max_n()) != (BLOCK_MAX_N, CLUSTER_MAX_N):
        raise RuntimeError("fps kernel: the library's caps are not the wrapper's")
    if name == "block":
        return BLOCK_MAX_N
    if name == "cluster":
        return CLUSTER_MAX_N
    max_n = lib.pasnl_fps_grid_max_n()
    if max_n < 0:
        _build.check(-max_n, "fps kernel (grid design)")
    return max_n


def farthest_point_sample(npoint: int, xyz: torch.Tensor) -> torch.Tensor:
    """FPS kernel: xyz (B, N, 3) float32 on a CUDA device -> (B, npoint) int32,
    in the design that N routes to (``design``)."""
    return _sample(design(xyz.shape[1]) if xyz.dim() == 3 else "block", npoint, xyz)


def _sample(name: str, npoint: int, xyz: torch.Tensor) -> torch.Tensor:
    """The FPS kernel in design `name`, one of DESIGNS; the kernel checks call
    it to hold two designs against each other where both take N."""
    global launches
    if not xyz.is_cuda or xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"fps kernel takes a (B, N, 3) float32 CUDA tensor, got "
                         f"{tuple(xyz.shape)} {xyz.dtype} on {xyz.device}")
    B, N, _ = xyz.shape
    if name not in DESIGNS:
        raise ValueError(f"fps kernel: no design {name!r}; the designs are {DESIGNS}")
    lib = _build.library()
    with torch.cuda.device(xyz.device):
        max_n = _max_n(lib, name)
        if not 1 <= N <= max_n or npoint < 1:
            raise ValueError(f"fps kernel ({name} design) takes 1 <= N <= {max_n} and "
                             f"npoint >= 1, got N={N}, npoint={npoint}")
        xyz = xyz.detach().contiguous()
        out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
        if B == 0:
            return out
        stream = torch.cuda.current_stream().cuda_stream
        if name == "grid":
            slots = torch.empty(2 * lib.pasnl_fps_grid_blocks() * lib.pasnl_fps_grid_slot_bytes(),
                                dtype=torch.uint8, device=xyz.device)
            err = lib.pasnl_fps_grid(xyz.data_ptr(), out.data_ptr(), slots.data_ptr(), B, N,
                                     npoint, stream)
        else:
            launch = lib.pasnl_fps if name == "block" else lib.pasnl_fps_cluster
            err = launch(xyz.data_ptr(), out.data_ptr(), B, N, npoint, stream)
        _build.check(err, f"fps kernel ({name} design)")
    launches += 1
    return out
