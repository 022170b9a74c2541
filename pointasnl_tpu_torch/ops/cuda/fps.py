"""Farthest point sampling on the card: the wrapper of ``csrc/fps.cu``.

Replaces ``pointasnl_tpu/ops/pallas/fps.py`` (``_fps_kernel``). The plain
version it is held against is ``ops.geometry.farthest_point_sample``. Three
designs, routed by N (``design``): one block a cloud up to N = 10240, a
cluster of 16 blocks a cloud up to N = 278528 (whole scenes), and past that a
cooperative grid of one block per SM, whose largest N the card's SM count and
shared memory decide (``pasnl_fps_grid_max_n``). The two multi-block designs
exchange each pick's candidates without a cluster or grid barrier: the
cluster's blocks push them into each other's shared memory, the grid's blocks
publish tagged words in device memory and poll them. The library states each
cap before any launch. A card that cannot co-schedule the cluster's 16 blocks
states none for it, and the grid design then takes every N past 10240
(``stated_cluster_max_n``); a design called by name that the card cannot run
raises, and so does a failed build or launch.
"""

from __future__ import annotations

import torch

from pointasnl_tpu_torch.ops.cuda import _build

BLOCK_MAX_N = 10240  # csrc/fps.cu:kBlockMaxN
CLUSTER_MAX_N = 278528  # csrc/fps.cu:kClusterMaxN, 16 blocks of 1024 threads, 17 points each
DESIGNS = ("block", "cluster", "grid")

launches = 0  # kernel launches made by this process, of any design
_cluster_caps: dict[int, int] = {}  # device index -> stated_cluster_max_n's answer


def design(n: int, cluster_max_n: int = CLUSTER_MAX_N) -> str:
    """The design that takes a cloud of n points: the smallest that holds it,
    where the cluster design takes N up to `cluster_max_n` (0: none)."""
    if n <= BLOCK_MAX_N:
        return "block"
    return "cluster" if n <= cluster_max_n else "grid"


def stated_cluster_max_n(lib=None, device: int | None = None) -> int:
    """The cluster design's largest N on a card (the current one by default),
    as the library states it before any launch: CLUSTER_MAX_N, or 0 where
    the card has no room for a cluster of 16 blocks of 204 KB each. Read once
    a card."""
    device = torch.cuda.current_device() if device is None else device
    if device not in _cluster_caps:
        cap = (lib or _build.library()).pasnl_fps_cluster_max_n()
        if cap > 0 and cap != CLUSTER_MAX_N:
            raise RuntimeError("fps kernel: the library's caps are not the wrapper's")
        _cluster_caps[device] = max(cap, 0)
    return _cluster_caps[device]


def _max_n(lib, name: str) -> int:
    """The largest N that design `name` takes, as the library states it; the
    routing constants above must be the library's own, and a design the card
    cannot run raises (the cluster's 16 blocks, the grid's residency)."""
    cap = {"block": lib.pasnl_fps_max_n, "cluster": lib.pasnl_fps_cluster_max_n,
           "grid": lib.pasnl_fps_grid_max_n}[name]()
    if cap < 0:
        _build.check(-cap, f"fps kernel ({name} design)")
    if cap != {"block": BLOCK_MAX_N, "cluster": CLUSTER_MAX_N}.get(name, cap):
        raise RuntimeError("fps kernel: the library's caps are not the wrapper's")
    return cap


def _check(xyz: torch.Tensor) -> None:
    if not xyz.is_cuda or xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"fps kernel takes a (B, N, 3) float32 CUDA tensor, got "
                         f"{tuple(xyz.shape)} {xyz.dtype} on {xyz.device}")


def farthest_point_sample(npoint: int, xyz: torch.Tensor) -> torch.Tensor:
    """FPS kernel: xyz (B, N, 3) float32 on a CUDA device -> (B, npoint) int32,
    in the design that N routes to on this card (``design`` under
    ``stated_cluster_max_n``)."""
    _check(xyz)
    with torch.cuda.device(xyz.device):
        return _sample(design(xyz.shape[1], stated_cluster_max_n()), npoint, xyz)


def _sample(name: str, npoint: int, xyz: torch.Tensor) -> torch.Tensor:
    """The FPS kernel in design `name`, one of DESIGNS; the kernel checks call
    it to hold two designs against each other where both take N."""
    global launches
    _check(xyz)
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
        if name == "grid":  # zeroed: tag 0, which no pick carries
            scratch = torch.zeros(lib.pasnl_fps_grid_scratch_bytes(), dtype=torch.uint8,
                                  device=xyz.device)
            err = lib.pasnl_fps_grid(xyz.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, N,
                                     npoint, stream)
        else:
            launch = lib.pasnl_fps if name == "block" else lib.pasnl_fps_cluster
            err = launch(xyz.data_ptr(), out.data_ptr(), B, N, npoint, stream)
        _build.check(err, f"fps kernel ({name} design)")
    launches += 1
    return out
