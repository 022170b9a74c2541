"""Farthest point sampling on the card: the wrapper of ``csrc/fps.cu``.

Replaces ``pointasnl_tpu/ops/pallas/fps.py`` (``_fps_kernel``). The plain
version it is held against is ``ops.geometry.farthest_point_sample``. Three
designs, routed by B and N (``design``): one block a cloud up to N = 10240
(its points in registers, warps by N: ``block_plan``; a small batch of
clouds near that size takes the cluster design where the card runs all its
clusters at once), a cluster of 16 blocks a cloud up to N = 278528 (whole
scenes), and past that a cooperative grid of one block per SM, whose
largest N the card's SM count and shared memory decide
(``pasnl_fps_grid_max_n``). The two multi-block designs
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
# The block design's plan (csrc/fps.cu:kBlockPlanN, kBlockPlanPPT): N up to
# the first entry's bound takes its points a thread, in the fewest warps that
# hold N: one warp up to 256 points, then 5 to 20.
BLOCK_PLAN = ((32, 1), (64, 2), (128, 4), (256, 8), (512, 1), (2048, 4), (BLOCK_MAX_N, 16))
CLUSTER_MAX_N = 278528  # csrc/fps.cu:kClusterMaxN, 16 blocks of 1024 threads, 17 points each
# A batch of clouds of CLUSTER_FROM_N to BLOCK_MAX_N points takes the cluster
# design where the card runs all its clusters at once (stated_cluster_slots):
# one cloud then works on 16 SMs, not on one. On the H100 (7 slots) the two
# designs tie at 8192 points, and the cluster design takes 10240 -> 1280 in
# 1.025 ms against 1.215 (scripts/torch_kernel_turns.py --plans, PERF.md).
CLUSTER_FROM_N = 8192
DESIGNS = ("block", "cluster", "grid")

launches = 0  # kernel launches made by this process, of any design
_cluster_caps: dict[int, int] = {}  # device index -> stated_cluster_max_n's answer
_cluster_slots: dict[int, int] = {}  # device index -> stated_cluster_slots's answer
_caps: dict[tuple, int] = {}  # (device index, design) -> _max_n's answer
_plans_checked: set[int] = set()  # the Ns whose block plan the library has stated


def design(n: int, cluster_max_n: int = CLUSTER_MAX_N, batch: int = 0,
           cluster_slots: int = 0) -> str:
    """The design that takes a batch of `batch` clouds of n points: the
    smallest that holds a cloud, where the cluster design takes N up to
    `cluster_max_n` (0: none); but a batch of at most `cluster_slots` clouds
    (the clusters the card runs at once) of CLUSTER_FROM_N points or more
    takes the cluster design."""
    if n <= BLOCK_MAX_N:
        fits = CLUSTER_FROM_N <= n <= cluster_max_n and 1 <= batch <= cluster_slots
        return "cluster" if fits else "block"
    return "cluster" if n <= cluster_max_n else "grid"


def block_plan(n: int) -> tuple:
    """(points a thread, warps) of the block design for a cloud of n points:
    the first BLOCK_PLAN entry that holds n, in the fewest warps."""
    for max_n, ppt in BLOCK_PLAN:
        if 1 <= n <= max_n:
            return ppt, -(-n // (32 * ppt))
    raise ValueError(f"fps kernel (block design) takes 1 <= N <= {BLOCK_MAX_N}, got N={n}")


def block_plan_edges() -> list:
    """N on each side of every boundary of the block plan (where the points
    a thread change, and where another warp is added), and the sizes the
    block design takes whatever its plan: the Ns its checks run at."""
    ns, low = {1, 2, 31, 32, 33, 1024, 1025, 4096, BLOCK_MAX_N - 1, BLOCK_MAX_N}, 0
    for max_n, ppt in BLOCK_PLAN:
        ns |= {e + d for e in [*range(32 * ppt, max_n, 32 * ppt), max_n] if e > low for d in (0, 1)}
        low = max_n
    return sorted(n for n in ns if n <= BLOCK_MAX_N)


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


def stated_cluster_slots(lib=None, device: int | None = None) -> int:
    """The clusters of the cluster design the card runs at once at a
    block-design N, as the library states it (0 where it runs none). Read
    once a card."""
    device = torch.cuda.current_device() if device is None else device
    if device not in _cluster_slots:
        _cluster_slots[device] = max((lib or _build.library()).pasnl_fps_cluster_slots(), 0)
    return _cluster_slots[device]


def _max_n(lib, name: str) -> int:
    """The largest N that design `name` takes, as the library states it (read
    once a card); the routing constants above must be the library's own, and
    a design the card cannot run raises (the cluster's 16 blocks, the grid's
    residency)."""
    key = (torch.cuda.current_device(), name)
    if key not in _caps:
        cap = {"block": lib.pasnl_fps_max_n, "cluster": lib.pasnl_fps_cluster_max_n,
               "grid": lib.pasnl_fps_grid_max_n}[name]()
        if cap < 0:
            _build.check(-cap, f"fps kernel ({name} design)")
        if cap != {"block": BLOCK_MAX_N, "cluster": CLUSTER_MAX_N}.get(name, cap):
            raise RuntimeError("fps kernel: the library's caps are not the wrapper's")
        _caps[key] = cap
    return _caps[key]


def _check(xyz: torch.Tensor) -> None:
    if not xyz.is_cuda or xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"fps kernel takes a (B, N, 3) float32 CUDA tensor, got "
                         f"{tuple(xyz.shape)} {xyz.dtype} on {xyz.device}")


def farthest_point_sample(npoint: int, xyz: torch.Tensor) -> torch.Tensor:
    """FPS kernel: xyz (B, N, 3) float32 on a CUDA device -> (B, npoint) int32,
    in the design that B and N route to on this card (``design`` under
    ``stated_cluster_max_n`` and ``stated_cluster_slots``)."""
    _check(xyz)
    B, N, _ = xyz.shape
    with torch.cuda.device(xyz.device):
        return _sample(design(N, stated_cluster_max_n(), B, stated_cluster_slots()), npoint, xyz)


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
        if name == "block":
            if N not in _plans_checked:
                if (lib.pasnl_fps_block_ppt(N), lib.pasnl_fps_block_warps(N)) != block_plan(N):
                    raise RuntimeError("fps kernel: the library's block plan is not the wrapper's")
                _plans_checked.add(N)
            err = lib.pasnl_fps(xyz.data_ptr(), out.data_ptr(), B, N, npoint, stream)
        elif name == "grid":  # zeroed: tag 0, which no pick carries
            scratch = torch.zeros(lib.pasnl_fps_grid_scratch_bytes(), dtype=torch.uint8,
                                  device=xyz.device)
            err = lib.pasnl_fps_grid(xyz.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, N,
                                     npoint, stream)
        else:
            err = lib.pasnl_fps_cluster(xyz.data_ptr(), out.data_ptr(), B, N, npoint, stream)
        _build.check(err, f"fps kernel ({name} design)")
    launches += 1
    return out
