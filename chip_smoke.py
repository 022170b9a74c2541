"""Drive the PyTorch/CUDA port of PointASNL once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero with no result):
  1. Require a CUDA card; print it as nvidia-smi gives it (name, power limit),
     the torch and CUDA versions and the TF32 switches (both off); build the
     kernels from ``pointasnl_tpu_torch/csrc`` and print the build seconds.
  2. FPS kernel against its plain PyTorch version on the card: indices exact
     at both slices' shapes and at the edge cases.
  3. kNN kernel against its plain version on the card: indices exact and
     squared distances within 1e-6 relative, at both slices' shapes (the
     10240 x 10240 stem one cloud at a time) and the edge cases.
  4. Ball-query kernel against its plain version on the card: indices and
     counts exact at the repulsion loss's shape and the edge cases.
  5. Slice 1: ``PointASNLCls(40, adaptive_sample=True)`` from a seeded
     generator answers 3 requests of random B8 x 1024 clouds through
     ``serve.make_inference_fn``. FPS and kNN must launch 2 times a request.
     The logits must be finite and agree with the same weights' forward on
     the CPU (plain versions): layer-1 indices exact, logits within
     1e-4 * max(|cpu|, 1) with the same argmax.
  6. Slice 2: ``PointASNLSemSegRes(21)`` from a seeded generator takes 3
     train steps at B4 x 10240 (Adam, staircase LR, BN-momentum schedule,
     weight decay 1e-4, uniform weight 0.01, dropout keep 0.5) on points
     uniform in a 0.5 m cube, then answers 2 requests through
     ``serve.make_inference_fn``. A step must launch FPS 4, kNN 11 and the
     ball query 1 time, a request FPS 4, kNN 11 and no ball query. Losses
     finite, logits (4, 10240, 21) finite, and the mean in-ball count on the
     steps' l1_xyz above 1 (the repulsion term is not degenerate).
  7. Card against CPU, one seg train step at B2 x 2048 from the same weights
     (dropout off): layer-1 FPS and kNN indices exact; loss terms, gradients
     per parameter and BN statistics within the float32 yardstick (below).
  8. Slice 3, whole-scene serving: scene-scale FPS (the cluster design)
     and the spatially-pruned kNN against their plain versions on the card,
     indices exact (kNN d2 within 1e-6 relative), at the whole-scene path's
     shapes on a 131072-point surface scene and at edge cases; then
     ``PointASNLSemSegRes(21, nl_kv_block_size=4096)`` answers 3 requests
     of B1 x 131072 surface scenes (the first is bench.py's input) through
     ``serve.make_inference_fn``: a request must launch FPS 4, the spatial
     kNN 3, the resident kNN 8 and no ball query, and return finite
     (1, 131072, 21) logits; peak memory is printed.
  9. Card against CPU, the whole-scene model's forward at B1 x 24576 on two
     scenes (the stem's self-kNN then takes the spatial kernel): level-1 FPS
     and kNN indices exact; logits within SCENE_LOGIT_RTOL (below).
 10. Timing with CUDA events after warm-up (medians): each kernel and its
     plain version at all slices' shapes, in turns, and the share of pairs
     the spatial kernel tests; the B8 x 1024 cls forward; the B4 x 10240
     train step (p50, p90, points/s) and serve forward; one torch.profiler
     window over 3 train steps (device-busy share, device time by kernel,
     the kernels' share of the step); the whole-scene request (p50, p90,
     points/s) and a profiler window over 2 requests.

The line before the last is one JSON object with a record per kernel; the
last line is ``{"ok": true, "device": {...}}``. TF32 is off for every number.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
BATCH, NUM_POINT, NUM_CLASS = 8, 1024, 40
REQUESTS = 3
# Card vs CPU logits: float32 rounding of cuBLAS vs CPU matmuls over ~20
# layers. Layer 2 runs FPS and kNN on l1_xyz, a float output of adaptive
# sampling that differs by ~5e-7 between the two, so a near tie there may
# flip (the count is printed). A flip trades a point for one almost as far,
# which moves the logits by about as much as the rounding; layer-1 indices
# are compared exactly.
LOGIT_RTOL = 1e-4
KERNELS = {  # "symbol": what the kernel's name holds in a profiler trace
    "fps": {"source": "pointasnl_tpu_torch/csrc/fps.cu",
            "replaces": "pointasnl_tpu/ops/pallas/fps.py:45", "symbol": "fps_kernel"},
    "knn_resident": {"source": "pointasnl_tpu_torch/csrc/knn.cu",
                     "replaces": "pointasnl_tpu/ops/pallas/knn.py:64", "symbol": "knn_kernel"},
    "ball_query": {"source": "pointasnl_tpu_torch/csrc/ball_query.cu",
                   "replaces": "pointasnl_tpu/ops/pallas/ball_query.py:32",
                   "symbol": "ball_query_kernel"},
    "knn_spatial": {"source": "pointasnl_tpu_torch/csrc/knn_spatial.cu",
                    "replaces": "pointasnl_tpu/ops/pallas/knn_spatial.py:122",
                    "symbol": "knn_spatial_kernel"},
}
FPS_CLUSTER_SYMBOL = "fps_cluster_kernel"  # the scene-scale design of csrc/fps.cu
# (B, N, npoint) and (B, N support, M query, k) of slice 1's two SA layers.
FPS_SHAPES = [(8, 1024, 512), (8, 512, 128)]
KNN_SHAPES = [(8, 1024, 512, 32), (8, 512, 128, 64)]

# Slice 2: the seg train step at B4 x 10240, levels of 1280, 320, 80, 40.
SEG_B, SEG_N, SEG_CLASSES, SEG_SIDE = 4, 10240, 21, 0.5
SEG_STEPS, SEG_REQUESTS = 3, 2
SEG_LEVELS = [SEG_N, SEG_N // 8, SEG_N // 32, SEG_N // 128, SEG_N // 256]
# kNN searches of a step as (support level, query level, k): the stem
# self-kNN, the six SA searches of levels 2-4, the four three_nn.
SEG_KNN = [(0, 0, 32), (1, 2, 32), (2, 2, 32), (2, 3, 32), (3, 3, 32), (3, 4, 32),
           (4, 4, 32), (4, 3, 3), (3, 2, 3), (2, 1, 3), (1, 0, 3)]
REPULSION_RADIUS, REPULSION_NSAMPLE = 0.07, 20
# Card vs CPU train step (phase 7): B2 x 2048 in a 0.4 m cube, so that the
# 256 points of l1_xyz hold a few neighbours within 0.07.
CMP_B, CMP_N, CMP_SIDE = 2, 2048, 0.4
# The float32 yardstick: per quantity, |card - cpu| may be at most
# YARDSTICK * |cpu - cpu64| (how far float32 rounding puts the CPU step from
# the same step in float64) plus FLOOR_RTOL of the quantity's scale. Train
# mode normalises BN over as few as 16 values at level 4, which makes either
# float32 step ~1e-3 off float64 in places; a fault is off by O(1).
YARDSTICK, FLOOR_RTOL = 10.0, 1e-4

# Slice 3: whole-scene serving (bench.py:bench_whole_scene): one surface
# scene of 131072 points, extent 6.0, K/V blocks of 4096. Its searches are
# SEG_KNN's; the three whose support exceeds 12288 points take the spatial
# kernel.
SCENE_N, SCENE_EXTENT, SCENE_BLOCK, SCENE_REQUESTS = 131072, 6.0, 4096, 3
SCENE_LEVELS = [SCENE_N, SCENE_N // 8, SCENE_N // 32, SCENE_N // 128, SCENE_N // 256]
# Card vs CPU (phase 9): B1 x 24576 at the same density, on two scenes
# (SCENE_CMP_SEEDS). The logits must agree within SCENE_LOGIT_RTOL *
# max(|cpu|, 1) at every point, as in phase 5, when the level-2 FPS and kNN
# indices agree. Level 2 searches l1_xyz, an output of adaptive sampling
# that differs by ~1e-7 between card and CPU, so a near tie among 3072
# points may flip (the count is printed); a flipped sample moves the few
# points that interpolate from it, so with flips the bound must hold at
# 99.9 % of the points and every point within SCENE_FLIP_CAP times it.
# Wherever the CPU's top two logits are further apart than twice the bound,
# the argmax must agree.
SCENE_CMP_N, SCENE_CMP_SEEDS, SCENE_LOGIT_RTOL = 24576, (20, 21), 1e-4
SCENE_FLIP_SHARE, SCENE_FLIP_CAP = 0.999, 10.0

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores and
# HBM bandwidth, for each kernel's bound.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
OUT_DIR = Path(__file__).resolve().parent / "build"  # gitignored


def cloud(seed: int, B: int, N: int, dev, dup: int = 0) -> torch.Tensor:
    x = np.random.RandomState(seed).randn(B, N, 3).astype(np.float32)
    if dup:  # the last `dup` points copy the first ones: distances tie
        x[:, N - dup:] = x[:, :dup]
    return torch.from_numpy(x).to(dev)


def cube(seed: int, B: int, N: int, side: float, dev) -> torch.Tensor:
    """B x N points uniform in a cube of the given side."""
    x = np.random.RandomState(seed).rand(B, N, 3) * side
    return torch.from_numpy(x.astype(np.float32)).to(dev)


def time_ms(fn, reps: int = 20, calls: int = 1, warmup: int = 3) -> list:
    """`reps` samples of the device time (ms) a call of fn takes on the
    current stream, by CUDA events around `calls` back-to-back calls. With
    one call a sample times a request; with several, the host enqueues ahead
    of the device, so a short kernel's sample is its device time and not the
    host's launch latency."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return out


# (samples, calls a sample) for time_ms: a kernel of microseconds, one of
# milliseconds, and a plain version that takes seconds.
LIGHT, HEAVY, SLOW = (20, 10), (6, 2), (2, 1)


def in_turns(plain, kernel, timing=LIGHT, plain_timing=None):
    """Median ms a call of plain and of kernel, timed in the order plain,
    kernel, kernel, plain, each with its (samples, calls a sample)."""
    (reps, calls), (pr, pc) = timing, plain_timing or timing
    p = time_ms(plain, pr // 2, pc, warmup=1)
    k = time_ms(kernel, reps // 2, calls) + time_ms(kernel, reps // 2, calls)
    p += time_ms(plain, pr // 2, pc, warmup=1)
    return statistics.median(k), statistics.median(p)


def device_ms(fn, kernel: str, calls: int = 10):
    """Median device time (ms) of one launch of `kernel` (a substring of its
    name) over `calls` calls of fn, from torch.profiler; None where the
    profiler records no such launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    if 0 < len(times) < calls:
        print(f"profiler: {len(times)} of {calls} launches of {kernel} recorded")
    return statistics.median(times) / 1e3 if times else None


def bound(nbytes: float, ops: float):
    """(ms, 'bytes' or 'operations'): the least time the card could take to
    move `nbytes` through device memory and do `ops` float32 operations."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def fps_bound(B, N, npoint):
    # Each pick updates every point: 3 sub, 3 mul, 2 add, 1 min, 1 compare.
    return bound(B * N * 12 + B * npoint * 4, B * (npoint - 1) * N * 10)


def knn_bound(B, N, M, k):
    # Every pair's distance (8 operations) and one compare to select.
    return bound(B * (N + M) * 12 + B * M * k * 8, B * M * N * 9)


def ball_bound(N, M, B, nsample, idx, cnt):
    # A query must test the support up to its nsample-th hit (all of it when
    # the ball holds fewer): 8 operations and one compare a point.
    tested = torch.where(cnt == nsample, idx[..., -1].long() + 1, N)
    return bound(B * (N + M) * 12 + B * M * (nsample + 1) * 4, float(tested.sum()) * 9)


def smi(query: str) -> str:
    """One nvidia-smi reading of the card, as csv without header."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        sys.exit(1)
    from pointasnl_tpu_torch.ops.cuda import _build

    card = smi("name,power.limit")
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    _build.library()
    built = _build.build_seconds
    print(f"kernels: {'built' if built is not None else 'loaded'} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {built if built is not None else 0:.2f} s)")
    return card, torch.device("cuda", 0)


def seg_levels(dev, seed: int = 21):
    """The xyz of the seg step's five levels, FPS of FPS of a cube cloud."""
    from pointasnl_tpu_torch.ops import geometry
    from pointasnl_tpu_torch.ops.cuda import fps

    levels = [cube(seed, SEG_B, SEG_N, SEG_SIDE, dev)]
    for n in SEG_LEVELS[1:]:
        levels.append(geometry.gather_point(levels[-1], fps.farthest_point_sample(n, levels[-1])))
    return levels


def phase_fps(dev) -> float:
    from pointasnl_tpu_torch.ops import geometry
    from pointasnl_tpu_torch.ops.cuda import fps

    cases = [(f"B{B} N{N} -> {m}", cloud(N + m, B, N, dev), m) for B, N, m in FPS_SHAPES] + [
        ("npoint == 1", cloud(1, 2, 300, dev), 1),
        ("N not a multiple of 32", cloud(2, 2, 1000, dev), 100),
        ("duplicate points", cloud(3, 2, 512, dev, dup=256), 200),
    ]
    levels = seg_levels(dev)
    for a, n in zip(levels, SEG_LEVELS[1:]):  # the seg step's four, 10240 -> 1280 first
        cases.append((f"B{SEG_B} N{a.shape[1]} -> {n} (seg)", a, n))
    worst = 0
    for name, x, npoint in cases:
        got = fps.farthest_point_sample(npoint, x)
        want = geometry.farthest_point_sample(npoint, x)
        torch.cuda.synchronize()
        if got.shape != (x.shape[0], npoint) or not torch.equal(got, want):
            raise RuntimeError(f"fps {name}: kernel and plain differ")
        worst = max(worst, int((got - want).abs().max()))
        print(f"fps {name}: indices exact")
    return float(worst)


def phase_knn(dev) -> float:
    from pointasnl_tpu_torch.ops import geometry
    from pointasnl_tpu_torch.ops.cuda import fps, knn

    cases = []
    for B, N, M, k in KNN_SHAPES:  # queries = the FPS samples, as in the slice
        s = cloud(N + k, B, N, dev)
        cases.append((f"B{B} {M}q/{N} k{k} (FPS queries)", s,
                      geometry.gather_point(s, fps.farthest_point_sample(M, s)), k))
    s = cloud(1, 2, 1024, dev)
    cases.append(("query in support (self first)", s, s[:, ::4].contiguous(), 32))
    d = cloud(2, 2, 600, dev, dup=300)
    cases.append(("duplicate points", d, d[:, 100:400].contiguous(), 16))
    cases.append(("k > N", cloud(3, 2, 10, dev), cloud(4, 2, 7, dev), 16))
    cases.append(("disjoint B8 512q/1024 k32", cloud(6, 8, 1024, dev), cloud(7, 8, 512, dev), 32))
    levels = seg_levels(dev)
    for si, qi, k in SEG_KNN:
        s, q = levels[si], levels[qi]
        name = f"{q.shape[1]}q/{s.shape[1]} k{k} (seg)"
        if si == 0 and qi == 0:  # the stem: its plain version one cloud at a time
            cases += [(f"cloud {b} {name}", s[b:b + 1], q[b:b + 1], k) for b in range(SEG_B)]
        else:
            cases.append((f"B{SEG_B} {name}", s, q, k))

    worst = 0.0
    for name, support, query, k in cases:
        got_d, got_i = knn.knn_point(k, support, query)
        want_d, want_i = geometry.knn_point(k, support, query)
        torch.cuda.synchronize()
        if not torch.equal(got_i, want_i):
            raise RuntimeError(f"knn {name}: {int((got_i != want_i).sum())} indices differ")
        err = (got_d - want_d).abs()
        if bool((err > 1e-6 * want_d.abs()).any()):
            raise RuntimeError(f"knn {name}: dist2 beyond 1e-6 relative (max abs {float(err.max()):.3e})")
        if "self first" in name and not torch.equal(
                got_i[..., 0].long(), torch.arange(0, 1024, 4, device=dev).expand(2, -1)):
            raise RuntimeError("knn: a query in the support is not its own first neighbour")
        worst = max(worst, float(err.max()))
        print(f"knn {name}: indices exact, max |d2 err| {float(err.max()):.3e}")
        del got_d, got_i, want_d, want_i
    return worst


def ball_cases(dev):
    """(name, xyz, new_xyz, radius, nsample) of the ball-query checks."""
    rng = np.random.RandomState(5)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    l1 = seg_levels(dev)[1]  # FPS samples of the cube cloud, like l1_xyz
    cases = [(f"B{SEG_B} {l1.shape[1]}q/{l1.shape[1]} ns20 r0.07 (repulsion, l1_xyz-like)",
              l1, l1, REPULSION_RADIUS, REPULSION_NSAMPLE)]
    x = rng.rand(2, 500, 3) * 0.5
    x[:, 100:200] = 0.25 + 0.01 * rng.rand(2, 100, 3)
    cases.append(("dense cluster (count capped)", t(x), t(x[:, 90:210]), 0.07, 20))
    cases.append(("empty balls", t(rng.rand(2, 300, 3)), t(np.full((2, 8, 3), 100.0)), 0.1, 8))
    x = np.zeros((1, 40, 3))
    x[0, :, 0] = np.linspace(0.2, 1.0, 40)
    x[0, 12] = (0.5, 0.0, 0.0)
    cases.append(("a point at exactly r", t(x), t(np.zeros((1, 1, 3))), 0.5, 16))
    x = rng.rand(2, 1000, 3) * 0.5
    cases.append(("N not a multiple of 32", t(x), t(x[:, ::7]), 0.08, 32))
    x = rng.rand(2, 600, 3) * 0.5
    x[:, 300:] = x[:, :300]
    cases.append(("duplicate points", t(x), t(x[:, 250:350]), 0.06, 24))
    x = rng.rand(1, 10240, 3) * 0.5
    cases.append(("N 10240", t(x), t(x[:, ::8]), 0.07, 20))
    return cases


def phase_ball(dev) -> float:
    from pointasnl_tpu_torch.ops import geometry
    from pointasnl_tpu_torch.ops.cuda import ball_query

    for name, xyz, new_xyz, radius, nsample in ball_cases(dev):
        got_i, got_c = ball_query.query_ball_point(radius, nsample, xyz, new_xyz)
        want_i, want_c = geometry.query_ball_point(radius, nsample, xyz, new_xyz)
        torch.cuda.synchronize()
        if not (torch.equal(got_i, want_i) and torch.equal(got_c, want_c)):
            raise RuntimeError(f"ball query {name}: {int((got_i != want_i).sum())} indices, "
                               f"{int((got_c != want_c).sum())} counts differ")
        if name == "a point at exactly r" and 12 in got_i.flatten().tolist():
            raise RuntimeError("ball query: a point at distance exactly r is in the ball")
        print(f"ball query {name}: indices and counts exact; mean count "
              f"{float(got_c.float().mean()):.2f}, max {int(got_c.max())} of {nsample}")
    return 0.0


def layer_indices(xyz: torch.Tensor, npoint: int, k: int):
    """FPS and kNN indices of one SA layer on xyz, through ops.dispatch."""
    from pointasnl_tpu_torch import ops

    fps_idx = ops.farthest_point_sample(npoint, xyz)
    _, knn_idx = ops.knn_point(k, xyz, ops.gather_point(xyz, fps_idx))
    return fps_idx.cpu(), knn_idx.cpu()


def counts():
    from pointasnl_tpu_torch.ops.cuda import ball_query, fps, knn, knn_spatial

    return {"fps": fps.launches, "knn_resident": knn.launches, "ball_query": ball_query.launches,
            "knn_spatial": knn_spatial.launches}


def reset_counts():
    from pointasnl_tpu_torch.ops.cuda import ball_query, fps, knn, knn_spatial

    fps.launches = knn.launches = ball_query.launches = knn_spatial.launches = 0


def phase_cls(dev):
    from pointasnl_tpu_torch.models import PointASNLCls
    from pointasnl_tpu_torch.serve import make_inference_fn

    model = PointASNLCls(NUM_CLASS, adaptive_sample=True,
                         generator=torch.Generator().manual_seed(SEED), device=dev)
    cpu_model = PointASNLCls(NUM_CLASS, adaptive_sample=True, device="cpu").eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    infer = make_inference_fn(model)
    clouds = [cloud(100 + r, BATCH, NUM_POINT, dev) for r in range(REQUESTS)]

    reset_counts()
    logits = [infer(x) for x in clouds]
    torch.cuda.synchronize()
    launches = counts()
    print(f"cls slice: {REQUESTS} requests of B{BATCH}x{NUM_POINT}; launches {launches}")
    if launches != {"fps": 2 * REQUESTS, "knn_resident": 2 * REQUESTS, "ball_query": 0,
                    "knn_spatial": 0}:
        raise RuntimeError(f"cls launches {launches}, expected 2 FPS and 2 kNN a request")

    for r, (x, out) in enumerate(zip(clouds, logits)):
        if out.shape != (BATCH, NUM_CLASS) or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"request {r}: logits of shape {tuple(out.shape)} not all finite")
        out = out.cpu()
        with torch.inference_mode():
            ref, ref_points = cpu_model(x.cpu())
            l1_xyz_card = model(x)[1]["l1_xyz"]  # outside the counted requests
        l1_card, l1_cpu = layer_indices(x, 512, 32), layer_indices(x.cpu(), 512, 32)
        for what, a, b in zip(("fps", "knn"), l1_card, l1_cpu):
            if not torch.equal(a, b):
                raise RuntimeError(f"request {r}: layer-1 {what} indices differ between card and CPU")
        l1_xyz_cpu = ref_points["l1_xyz"]
        l2_card = layer_indices(l1_xyz_card, 128, 64)
        l2_cpu = layer_indices(l1_xyz_cpu, 128, 64)
        l2_diff = [int((a != b).sum()) for a, b in zip(l2_card, l2_cpu)]
        scale = max(float(ref.abs().max()), 1.0)
        err = float((out - ref).abs().max())
        same_argmax = bool(torch.equal(out.argmax(-1), ref.argmax(-1)))
        print(f"request {r}: logits finite; |card - cpu| max {err:.3e} (scale {scale:.3e}, "
              f"tol {LOGIT_RTOL * scale:.1e}); argmax equal {same_argmax}; layer-1 indices "
              f"exact; layer-2 indices differing: fps {l2_diff[0]}, knn {l2_diff[1]}; "
              f"l1_xyz max diff {float((l1_xyz_card.cpu() - l1_xyz_cpu).abs().max()):.3e}")
        if err > LOGIT_RTOL * scale or not same_argmax:
            raise RuntimeError(f"request {r}: card logits disagree with the CPU forward")
    return infer, launches


def seg_trainer(model, batch_size: int):
    """A train state and step with the ScanNet recipe's optimizer and losses."""
    from pointasnl_tpu_torch.train import (
        TrainState,
        bn_momentum_schedule,
        make_optimizer,
        make_train_step,
        staircase_lr_schedule,
    )

    state = TrainState(model, make_optimizer(
        "adam", staircase_lr_schedule(1e-3, batch_size, 200000, 0.7), model.parameters()))
    step = make_train_step(bn_schedule=bn_momentum_schedule(batch_size, 200000), task="seg",
                           uniform_weight=0.01, weights_decay=1e-4)
    return state, step


def seg_batch(seed: int, B: int, N: int, side: float, dev):
    rng = np.random.RandomState(seed)
    return {"points": cube(seed, B, N, side, dev),
            "labels": torch.from_numpy(rng.randint(0, SEG_CLASSES, (B, N))).to(dev),
            "smpw": torch.ones(B, N, device=dev)}


def capture_l1_xyz(model, store: list):
    """Keep each forward's l1_xyz (layer1_1's output xyz)."""
    return model.layer1_1.register_forward_hook(lambda m, a, out: store.append(out[0].detach()))


def phase_seg(dev):
    from pointasnl_tpu_torch import ops
    from pointasnl_tpu_torch.models import PointASNLSemSegRes
    from pointasnl_tpu_torch.serve import make_inference_fn

    model = PointASNLSemSegRes(SEG_CLASSES, generator=torch.Generator().manual_seed(SEED),
                               device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    state, step = seg_trainer(model, SEG_B)
    batches = [seg_batch(200 + s, SEG_B, SEG_N, SEG_SIDE, dev) for s in range(SEG_STEPS)]
    l1 = []
    hook = capture_l1_xyz(model, l1)

    reset_counts()
    metrics = [step(state, b) for b in batches]
    torch.cuda.synchronize()
    launches = counts()
    hook.remove()
    print(f"seg slice: PointASNLSemSegRes({SEG_CLASSES}), {n_params} parameters; "
          f"{SEG_STEPS} train steps of B{SEG_B}x{SEG_N}; launches {launches}")
    if launches != {"fps": 4 * SEG_STEPS, "knn_resident": 11 * SEG_STEPS,
                    "ball_query": SEG_STEPS, "knn_spatial": 0}:
        raise RuntimeError(f"seg train launches {launches}, expected FPS 4, kNN 11 and "
                           f"ball query 1 a step")
    for s, m in enumerate(metrics):
        m = {k: float(v) for k, v in m.items()}
        print(f"step {s}: " + ", ".join(f"{k} {v:.6f}" for k, v in m.items()))
        if not all(np.isfinite(v) for v in m.values()):
            raise RuntimeError(f"step {s}: a loss is not finite")
    mean_cnt = statistics.mean(
        float(ops.query_ball_point(REPULSION_RADIUS, REPULSION_NSAMPLE, x, x)[1].float().mean())
        for x in l1)
    print(f"seg slice: mean in-ball count on l1_xyz {mean_cnt:.3f} (r {REPULSION_RADIUS}, "
          f"nsample {REPULSION_NSAMPLE})")
    if not mean_cnt > 1.0:
        raise RuntimeError("the repulsion term is degenerate: the balls hold only their point")

    infer = make_inference_fn(model)
    clouds = [cube(300 + r, SEG_B, SEG_N, SEG_SIDE, dev) for r in range(SEG_REQUESTS)]
    reset_counts()
    logits = [infer(x) for x in clouds]
    torch.cuda.synchronize()
    serve_launches = counts()
    print(f"seg serve: {SEG_REQUESTS} requests of B{SEG_B}x{SEG_N}; launches {serve_launches}")
    if serve_launches != {"fps": 4 * SEG_REQUESTS, "knn_resident": 11 * SEG_REQUESTS,
                          "ball_query": 0, "knn_spatial": 0}:
        raise RuntimeError(f"seg serve launches {serve_launches}, expected FPS 4, kNN 11 and "
                           f"no ball query a request")
    for r, out in enumerate(logits):
        if out.shape != (SEG_B, SEG_N, SEG_CLASSES) or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"seg request {r}: logits {tuple(out.shape)} not all finite")
    print(f"seg serve: logits {tuple(logits[0].shape)} finite")
    return state, step, infer, launches, serve_launches


def _yardstick(what: str, card, cpu, cpu64, scale: float) -> float:
    """Check |card - cpu| against the float32 yardstick; return the ratio of
    the error to its limit."""
    err = float((card.double() - cpu.double()).abs().max())
    f32 = float((cpu.double() - cpu64.double()).abs().max())
    limit = YARDSTICK * f32 + FLOOR_RTOL * scale
    if not err <= limit:
        raise RuntimeError(f"card vs cpu {what}: {err:.3e} over its limit {limit:.3e} "
                           f"(cpu vs float64 {f32:.3e}, scale {scale:.3e})")
    return err / limit


def phase_card_vs_cpu(dev):
    from pointasnl_tpu_torch.models import PointASNLSemSegRes

    card = PointASNLSemSegRes(SEG_CLASSES, dropout_keep=1.0,
                              generator=torch.Generator().manual_seed(SEED + 1), device=dev)
    sd = {k: v.cpu() for k, v in card.state_dict().items()}
    cpus = {}
    for dtype in (torch.float32, torch.float64):
        m = PointASNLSemSegRes(SEG_CLASSES, dropout_keep=1.0, device="cpu")
        m.load_state_dict(sd)
        cpus[dtype] = m.to(dtype)
    batch = seg_batch(400, CMP_B, CMP_N, CMP_SIDE, dev)
    runs = {}
    for name, model, to in (("card", card, lambda t: t),
                            ("cpu", cpus[torch.float32], lambda t: t.cpu()),
                            ("cpu64", cpus[torch.float64],
                             lambda t: t.cpu().double() if t.is_floating_point() else t.cpu())):
        state, step = seg_trainer(model, CMP_B)
        l1 = []
        hook = capture_l1_xyz(model, l1)
        t0 = time.perf_counter()
        metrics = step(state, {k: to(v) for k, v in batch.items()})
        torch.cuda.synchronize()
        hook.remove()
        runs[name] = {"metrics": {k: v.cpu() for k, v in metrics.items()},
                      "grads": {k: p.grad.cpu() for k, p in model.named_parameters()},
                      "state": {k: v.cpu() for k, v in model.state_dict().items()},
                      "l1_xyz": l1[0]}
        print(f"card vs cpu: {name} step in {time.perf_counter() - t0:.2f} s")

    x = batch["points"]
    for what, a, b in zip(("fps", "knn"), layer_indices(x, CMP_N // 8, 32),
                          layer_indices(x.cpu(), CMP_N // 8, 32)):
        if not torch.equal(a, b):
            raise RuntimeError(f"card vs cpu: layer-1 {what} indices differ")
    l2 = [int((a != b).sum()) for a, b in zip(layer_indices(runs["card"]["l1_xyz"], CMP_N // 32, 32),
                                               layer_indices(runs["cpu"]["l1_xyz"], CMP_N // 32, 32))]
    c, p, p64 = runs["card"], runs["cpu"], runs["cpu64"]
    worst = {}
    for k in c["metrics"]:
        if k == "accuracy":  # a count of argmax hits: one near-tie flip moves it a quantum
            continue
        worst[f"metric {k}"] = _yardstick(k, c["metrics"][k], p["metrics"][k], p64["metrics"][k],
                                          abs(float(p64["metrics"][k])))
    gmax = max(float(g.abs().max()) for g in p64["grads"].values())
    g_ratios = sorted(((_yardstick(f"grad {k}", c["grads"][k], p["grads"][k], p64["grads"][k],
                                   max(float(p64["grads"][k].abs().max()), 1e-6 * gmax)), k)
                       for k in c["grads"]), reverse=True)
    g_ratio = g_ratios[0][0]
    print("card vs cpu: worst gradients (error / limit): " +
          ", ".join(f"{k} {r:.3f}" for r, k in g_ratios[:3]))
    bn_ratio = max(_yardstick(f"BN {k}", c["state"][k], p["state"][k], p64["state"][k],
                              max(float(p64["state"][k].abs().max()), 1.0))
                   for k in c["state"] if k.endswith((".mean", ".var")))
    print("card vs cpu, B2x2048 train step: " + ", ".join(
        f"{k} card {float(c['metrics'][k]):.7f} cpu {float(p['metrics'][k]):.7f} "
        f"cpu64 {float(p64['metrics'][k]):.7f}" for k in c["metrics"]))
    print(f"card vs cpu: layer-1 FPS and kNN indices exact; level-2 indices differing: "
          f"fps {l2[0]}, knn {l2[1]}; worst error / limit: loss terms "
          f"{max(worst.values()):.3f}, gradients {g_ratio:.3f}, BN stats {bn_ratio:.3f} "
          f"(limit {YARDSTICK:g} x |cpu - cpu64| + {FLOOR_RTOL:g} x scale)")


def scene(seed: int, N: int, dev) -> torch.Tensor:
    """A B1 surface scene of N points at the whole scene's density (extent
    6.0 at 131072); seed 0 at 131072 is bench.py's whole-scene input."""
    from pointasnl_tpu_torch.data import surface_scene

    extent = SCENE_EXTENT * (N / SCENE_N) ** 0.5
    return torch.from_numpy(surface_scene(np.random.RandomState(seed), 1, N, extent=extent)).to(dev)


def scene_levels(dev, seed: int = 0):
    """The xyz of a whole-scene request's five levels, FPS of FPS of the scene."""
    from pointasnl_tpu_torch.ops import geometry
    from pointasnl_tpu_torch.ops.cuda import fps

    levels = [scene(seed, SCENE_N, dev)]
    for n in SCENE_LEVELS[1:]:
        levels.append(geometry.gather_point(levels[-1], fps.farthest_point_sample(n, levels[-1])))
    return levels


def scene_spatial_shapes(levels):
    """(name, support, query, k) of the request's three spatial searches; the
    stem passes the scene twice, a self-query."""
    return [(f"{q.shape[1]}q/{s.shape[1]} k{k}", s, s if si == qi else q, k)
            for si, qi, k in SEG_KNN for s, q in [(levels[si], levels[qi])]
            if s.shape[1] > 12288]


def phase_scene_fps(dev) -> float:
    from pointasnl_tpu_torch.ops import geometry
    from pointasnl_tpu_torch.ops.cuda import fps

    levels = scene_levels(dev)
    cases = [(f"B1 N{SCENE_N} -> {SCENE_LEVELS[1]} (scene level 1)", levels[0], SCENE_LEVELS[1]),
             (f"B1 N{SCENE_LEVELS[1]} -> {SCENE_LEVELS[2]} (scene level 2)", levels[1],
              SCENE_LEVELS[2]),
             ("duplicate points B2 N20000 -> 2000", cloud(8, 2, 20000, dev, dup=10000), 2000),
             ("N 10241, the cluster design's smallest", cloud(9, 2, 10241, dev), 500)]
    for name, x, npoint in cases:
        got = fps.farthest_point_sample(npoint, x)
        want = geometry.farthest_point_sample(npoint, x)
        torch.cuda.synchronize()
        if got.shape != (x.shape[0], npoint) or not torch.equal(got, want):
            raise RuntimeError(f"fps {name}: kernel and plain differ")
        print(f"fps {name}: indices exact")
    return 0.0


def spatial_cases(dev):
    """(name, support, query, k) of the spatial kNN's checks: the request's
    three searches, then edge cases."""
    rng = np.random.RandomState(10)
    cases = scene_spatial_shapes(scene_levels(dev))
    d = cloud(11, 1, 20000, dev, dup=10000)
    cases.append(("duplicates 20000 k16 (self)", d, d, 16))
    far = torch.from_numpy((rng.randn(1, 16484, 3) * 0.05 + 1e3).astype(np.float32)).to(dev)
    cases.append(("1e3 from the origin 16484 k32 (self)", far, far, 32))
    r = scene(12, 13001, dev)
    cases.append(("N 13001, not a multiple of the segment (self)", r, r, 32))
    g = cloud(13, 1, 32768, dev)
    cases.append(("Gaussian 32768 k32 (self)", g, g, 32))
    b2 = torch.cat([scene(14, 20000, dev), scene(15, 20000, dev)])
    cases.append(("B2 20000 k32 (self)", b2, b2, 32))
    cases.append(("disjoint 5000q/30000 k32", scene(16, 30000, dev), scene(17, 5000, dev), 32))
    return cases


def phase_spatial(dev) -> float:
    from pointasnl_tpu_torch.ops import geometry
    from pointasnl_tpu_torch.ops.cuda import knn_spatial

    worst = 0.0
    for name, support, query, k in spatial_cases(dev):
        got_d, got_i = knn_spatial.knn_point(k, support, query)
        want_d, want_i = geometry.knn_point(k, support, query)
        torch.cuda.synchronize()
        if not torch.equal(got_i, want_i):
            raise RuntimeError(f"spatial knn {name}: {int((got_i != want_i).sum())} indices differ")
        err = (got_d - want_d).abs()
        if bool((err > 1e-6 * want_d.abs()).any()):
            raise RuntimeError(f"spatial knn {name}: dist2 beyond 1e-6 relative "
                               f"(max abs {float(err.max()):.3e})")
        worst = max(worst, float(err.max()))
        print(f"spatial knn {name}: indices exact, max |d2 err| {float(err.max()):.3e}")
        del got_d, got_i, want_d, want_i
    return worst


def phase_scene(dev):
    from pointasnl_tpu_torch.models import PointASNLSemSegRes
    from pointasnl_tpu_torch.serve import make_inference_fn

    model = PointASNLSemSegRes(SEG_CLASSES, nl_kv_block_size=SCENE_BLOCK,
                               generator=torch.Generator().manual_seed(SEED), device=dev)
    infer = make_inference_fn(model)
    scenes = [scene(r, SCENE_N, dev) for r in range(SCENE_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    logits = [infer(x) for x in scenes]
    torch.cuda.synchronize()
    launches = counts()
    print(f"whole scene: {SCENE_REQUESTS} requests of B1x{SCENE_N} (nl_kv_block_size "
          f"{SCENE_BLOCK}); launches {launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    want = {"fps": 4 * SCENE_REQUESTS, "knn_resident": 8 * SCENE_REQUESTS, "ball_query": 0,
            "knn_spatial": 3 * SCENE_REQUESTS}
    if launches != want:
        raise RuntimeError(f"whole-scene launches {launches}, expected FPS 4, spatial kNN 3, "
                           f"resident kNN 8 and no ball query a request")
    for r, out in enumerate(logits):
        if out.shape != (1, SCENE_N, SEG_CLASSES) or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"whole-scene request {r}: logits {tuple(out.shape)} not all finite")
    print(f"whole scene: logits {tuple(logits[0].shape)} finite")
    return infer, scenes[0], launches


def phase_scene_card_vs_cpu(dev):
    from pointasnl_tpu_torch import ops
    from pointasnl_tpu_torch.models import PointASNLSemSegRes
    from pointasnl_tpu_torch.serve import make_inference_fn

    card = PointASNLSemSegRes(SEG_CLASSES, nl_kv_block_size=SCENE_BLOCK,
                              generator=torch.Generator().manual_seed(SEED + 2), device=dev)
    cpu = PointASNLSemSegRes(SEG_CLASSES, nl_kv_block_size=SCENE_BLOCK, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    models = {"card": (card, make_inference_fn(card)), "cpu": (cpu, make_inference_fn(cpu))}
    n1, n2 = SCENE_CMP_N // 8, SCENE_CMP_N // 32
    failed = []
    for seed in SCENE_CMP_SEEDS:
        x = scene(seed, SCENE_CMP_N, dev)
        l1, outs = {}, {}
        for name, (model, infer) in models.items():
            store = []
            hook = capture_l1_xyz(model, store)
            t0 = time.perf_counter()
            outs[name] = infer(x if name == "card" else x.cpu()).cpu()
            torch.cuda.synchronize()
            hook.remove()
            l1[name] = store[0]
            print(f"scene card vs cpu, seed {seed}: {name} forward in "
                  f"{time.perf_counter() - t0:.2f} s")
        # Level 1 from the input alone: the stem's self-kNN and the FPS.
        xc = x.cpu()
        for what, a, b in (("stem kNN", ops.knn_point(32, x, x)[1], ops.knn_point(32, xc, xc)[1]),
                           ("level-1 FPS", ops.farthest_point_sample(n1, x),
                            ops.farthest_point_sample(n1, xc))):
            if not torch.equal(a.cpu(), b):
                raise RuntimeError(f"scene card vs cpu, seed {seed}: {what} indices differ")
        flips = [int((a != b).sum()) for a, b in zip(layer_indices(l1["card"], n2, 32),
                                                      layer_indices(l1["cpu"], n2, 32))]
        out, ref = outs["card"][0], outs["cpu"][0]
        scale = max(float(ref.abs().max()), 1.0)
        tol = SCENE_LOGIT_RTOL * scale
        err = (out - ref).abs().amax(dim=-1)
        share = float((err <= tol).float().mean())
        top2 = ref.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
        argmax_off = int((out.argmax(-1) != ref.argmax(-1))[clear].sum())
        need, cap = (1.0, 1.0) if flips == [0, 0] else (SCENE_FLIP_SHARE, SCENE_FLIP_CAP)
        outside = int((err > tol).sum())
        print(f"scene card vs cpu, seed {seed}, B1x{SCENE_CMP_N}: stem kNN and level-1 FPS "
              f"indices exact; level-2 indices differing: fps {flips[0]}, knn {flips[1]}; "
              f"|card - cpu| max {float(err.max()):.3e} = {float(err.max()) / tol:.3f} x tol "
              f"(scale {scale:.3e}, tol {tol:.1e}, cap {cap:g} x tol); points within tol "
              f"{100 * share:.3f} % (need {100 * need:g} %), {outside} outside, margin "
              f"{int(len(err) * (1 - need)) - outside} points; argmax differing at "
              f"{argmax_off} of {int(clear.sum())} points with a clear top class")
        if share < need or float(err.max()) > cap * tol or argmax_off:
            failed.append(seed)
    if failed:
        raise RuntimeError(f"scene card vs cpu: card logits disagree with the CPU forward "
                           f"on the scenes of seeds {failed}")


def spatial_bound(B, N, M, k):
    # Bytes: the clouds in and the rows out, each once. The operations the
    # function needs are its M * k pairs' distances, far below the bytes'
    # time; the pairs a kernel tests depend on how it prunes, so they are
    # reported beside the bound (pairs_tested), not counted in it.
    return bound(B * (N + M) * 12 + B * M * k * 8, B * M * k * 9)


def time_kernels(dev, card):
    """Kernel vs plain times, and bounds, at every slice's shapes."""
    from pointasnl_tpu_torch.ops import geometry
    from pointasnl_tpu_torch.ops.cuda import ball_query, fps, knn, knn_spatial

    rows = {name: [] for name in KERNELS}

    def add(name, path, shape, plain, kernel, bnd, timing=LIGHT, plain_timing=None,
            symbol=None, **extra):
        call_ms, p_ms = in_turns(plain, kernel, timing, plain_timing)
        dev_ms = device_ms(kernel, symbol or KERNELS[name]["symbol"])
        if dev_ms is None:
            print(f"time {name} {shape}: the profiler saw no launch; ms is the call time")
        rows[name].append({"path": path, "shape": shape,
                           "ms": call_ms if dev_ms is None else dev_ms, "call_ms": call_ms,
                           "plain_ms": p_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                           "library_ms": None, **extra})

    for B, N, npoint in FPS_SHAPES:
        x = cloud(11, B, N, dev)
        add("fps", "cls", f"B{B} N{N}->{npoint}", lambda: geometry.farthest_point_sample(npoint, x),
            lambda: fps.farthest_point_sample(npoint, x), fps_bound(B, N, npoint))
    for B, N, M, k in KNN_SHAPES:
        s = cloud(12, B, N, dev)
        q = geometry.gather_point(s, fps.farthest_point_sample(M, s))
        add("knn_resident", "cls", f"B{B} {M}q/{N} k{k}", lambda: geometry.knn_point(k, s, q),
            lambda: knn.knn_point(k, s, q), knn_bound(B, N, M, k))
    levels = seg_levels(dev, seed=22)
    for a, n in zip(levels, SEG_LEVELS[1:]):
        add("fps", "seg", f"B{SEG_B} N{a.shape[1]}->{n}",
            lambda: geometry.farthest_point_sample(n, a), lambda: fps.farthest_point_sample(n, a),
            fps_bound(SEG_B, a.shape[1], n), timing=HEAVY if n >= 320 else LIGHT)
    for si, qi, k in SEG_KNN:
        s, q = levels[si], levels[qi]
        N, M = s.shape[1], q.shape[1]
        add("knn_resident", "seg", f"B{SEG_B} {M}q/{N} k{k}", lambda: geometry.knn_point(k, s, q),
            lambda: knn.knn_point(k, s, q), knn_bound(SEG_B, N, M, k),
            timing=HEAVY if N * M >= 10**7 else LIGHT)
    l1 = levels[1]
    idx, cnt = ball_query.query_ball_point(REPULSION_RADIUS, REPULSION_NSAMPLE, l1, l1)
    n1 = l1.shape[1]
    add("ball_query", "seg", f"B{SEG_B} {n1}q/{n1} ns{REPULSION_NSAMPLE} r{REPULSION_RADIUS}",
        lambda: geometry.query_ball_point(REPULSION_RADIUS, REPULSION_NSAMPLE, l1, l1),
        lambda: ball_query.query_ball_point(REPULSION_RADIUS, REPULSION_NSAMPLE, l1, l1),
        ball_bound(n1, n1, SEG_B, REPULSION_NSAMPLE, idx, cnt))

    # The whole-scene request's shapes, on a scene of bench.py's density.
    levels = scene_levels(dev, seed=23)
    for a, n in zip(levels, SCENE_LEVELS[1:]):
        N = a.shape[1]
        add("fps", "scene", f"B1 N{N}->{n}", lambda: geometry.farthest_point_sample(n, a),
            lambda: fps.farthest_point_sample(n, a), fps_bound(1, N, n),
            timing=(10, 2) if N == SCENE_N else HEAVY if N > 1024 else LIGHT,
            plain_timing=SLOW if N == SCENE_N else None,
            symbol=FPS_CLUSTER_SYMBOL if N > 10240 else None)
    for name, s, q, k in scene_spatial_shapes(levels):
        N, M = s.shape[1], q.shape[1]
        tested = knn_spatial.pairs_tested(k, s, q)  # one untimed call that counts
        add("knn_spatial", "scene", f"B1 {name}", lambda: geometry.knn_point(k, s, q),
            lambda: knn_spatial.knn_point(k, s, q), spatial_bound(1, N, M, k), (10, 2), SLOW,
            pairs_tested=tested, pairs_tested_share=tested / (N * M))
    for si, qi, k in SEG_KNN:
        s, q = levels[si], levels[qi]
        N, M = s.shape[1], q.shape[1]
        if N <= 12288:
            add("knn_resident", "scene", f"B1 {M}q/{N} k{k}", lambda: geometry.knn_point(k, s, q),
                lambda: knn.knn_point(k, s, q), knn_bound(1, N, M, k),
                timing=HEAVY if N * M >= 10**7 else LIGHT)
    for name, rs in rows.items():
        for r in rs:
            tested = (f", pairs tested {r['pairs_tested']} ({100 * r['pairs_tested_share']:.3f} % "
                      f"of M x N)" if "pairs_tested" in r else "")
            print(f"time {name} [{r['path']}] {r['shape']}: kernel {r['ms']:.4f} ms on the "
                  f"device, {r['call_ms']:.4f} ms a call back to back, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})"
                  f"{tested}  [{card}]")
    return rows


def percentiles(samples):
    s = sorted(samples)
    return statistics.median(s), s[max(int(0.9 * len(s)) - 1, 0)]


def time_paths(dev, card, cls_infer, seg_state, seg_step, seg_infer, scene_infer, scene_x):
    x = cloud(13, BATCH, NUM_POINT, dev)
    fwd, p90 = percentiles(time_ms(lambda: cls_infer(x), reps=50))
    print(f"time cls forward B{BATCH}x{NUM_POINT}: p50 {fwd:.3f} ms, p90 {p90:.3f} ms of 50 "
          f"(CUDA events); {BATCH * NUM_POINT / fwd * 1e3:.0f} points/s at p50  [{card}]")

    batch = seg_batch(500, SEG_B, SEG_N, SEG_SIDE, dev)
    torch.cuda.reset_peak_memory_stats()
    step_samples = time_ms(lambda: seg_step(seg_state, batch), reps=10, warmup=2)
    t0 = time.perf_counter()
    for _ in range(5):
        seg_step(seg_state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 5 * 1e3
    step_p50, step_p90 = percentiles(step_samples)
    print(f"time seg train step B{SEG_B}x{SEG_N}: p50 {step_p50:.3f} ms, p90 {step_p90:.3f} ms "
          f"of 10 (CUDA events); {wall:.3f} ms host wall; "
          f"{SEG_B * SEG_N / step_p50 * 1e3:.0f} points/s at p50; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    pts = batch["points"]
    serve_p50, serve_p90 = percentiles(time_ms(lambda: seg_infer(pts), reps=10, warmup=2))
    print(f"time seg serve forward B{SEG_B}x{SEG_N}: p50 {serve_p50:.3f} ms, p90 "
          f"{serve_p90:.3f} ms of 10 (CUDA events); {SEG_B * SEG_N / serve_p50 * 1e3:.0f} "
          f"points/s at p50  [{card}]")
    profile_window(lambda: seg_step(seg_state, batch), 3,
                   {"fps": 4, "knn": 11, "knn_spatial": 0, "ball_query": 1}, card,
                   "seg train steps", "profile_seg_step.json")

    torch.cuda.reset_peak_memory_stats()
    scene_p50, scene_p90 = percentiles(time_ms(lambda: scene_infer(scene_x), reps=10, warmup=1))
    print(f"time whole-scene request B1x{SCENE_N}: p50 {scene_p50:.3f} ms, p90 {scene_p90:.3f} "
          f"ms of 10 (CUDA events); {SCENE_N / scene_p50 * 1e3:.0f} points/s at p50; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    profile_window(lambda: scene_infer(scene_x), 2,
                   {"fps": 4, "knn": 8, "knn_spatial": 3, "ball_query": 0}, card,
                   "whole-scene requests", "profile_whole_scene.json")
    return {"cls_forward_ms": fwd, "seg_step_ms": step_p50, "seg_serve_ms": serve_p50,
            "scene_ms": scene_p50}


# Each ported kernel's launches in a profiler trace, by the names they hold.
PROFILE_SYMBOLS = {"fps": ("fps_kernel", FPS_CLUSTER_SYMBOL), "knn": ("knn_kernel",),
                   "knn_spatial": ("knn_spatial_kernel",), "ball_query": ("ball_query_kernel",)}


def profile_window(fn, n: int, per_call: dict, card, label: str, out_name: str):
    """One torch.profiler window over n calls of fn, after one traced and
    dropped warm-up call: device-busy share and device time by kernel name,
    the ported kernels picked out with the launches recorded (`per_call`
    launches expected a call)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    traces = []  # the active calls' events, handed over when the cycle ends
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n),
                 on_trace_ready=lambda prof: traces.append(prof.events())) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for i in range(n):
            fn()
            if i == n - 1:
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            prof.step()
    events = [e for e in (traces[0] if traces else [])
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    if not events:
        print(f"profile, {label}: the profiler recorded no device time; see the CUDA-event times")
        return
    spans, by_name = [], {}
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        by_name[e.name] = by_name.get(e.name, 0.0) + (end - start)
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])

    def ours(name):  # no symbol is a part of another
        return next((k for k, syms in PROFILE_SYMBOLS.items() if any(s in name for s in syms)),
                    None)

    mine = {k: 0.0 for k in PROFILE_SYMBOLS}
    seen = {k: 0 for k in PROFILE_SYMBOLS}
    for e in events:
        k = ours(e.name)
        if k:
            mine[k] += e.time_range.end - e.time_range.start
            seen[k] += 1
    expected = {k: v * n for k, v in per_call.items()}
    print(f"profile, {label}: launches recorded {seen} of {expected}" +
          ("" if seen == expected else "; the profiler dropped some: shares are lower bounds"))
    print(f"profile, {n} {label}: wall {wall_us / n / 1e3:.3f} ms a call under the profiler; "
          f"device busy {busy / n / 1e3:.3f} ms a call ({100 * busy / wall_us:.1f} % of the "
          f"wall); {len(spans) // n} device activities a call  [{card}]")
    print(f"profile, {label}, device ms a call: " + "; ".join(
        f"{k} {v / n / 1e3:.3f} ({100 * v / total:.1f} %)" for k, v in mine.items()))
    for name, us in top[:12]:
        print(f"profile top: {us / n / 1e3:8.3f} ms {100 * us / total:5.1f} %  {name[:110]}")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / out_name).write_text(json.dumps(
        {"card": card, "calls": n, "wall_us": wall_us, "busy_us": busy,
         "device_us_by_name": dict(top)}, indent=1))


def main() -> int:
    t_start = time.perf_counter()

    def mark(what):
        print(f"[{time.perf_counter() - t_start:.1f} s] {what} done")

    card, dev = phase_device()
    errs = {"fps": phase_fps(dev), "knn_resident": phase_knn(dev), "ball_query": phase_ball(dev)}
    mark("kernel checks of slices 1-2")
    cls_infer, cls_launches = phase_cls(dev)
    seg_state, seg_step, seg_infer, seg_launches, serve_launches = phase_seg(dev)
    phase_card_vs_cpu(dev)
    mark("slices 1-2")
    errs["fps"] = max(errs["fps"], phase_scene_fps(dev))
    errs["knn_spatial"] = phase_spatial(dev)
    scene_infer, scene_x, scene_launches = phase_scene(dev)
    phase_scene_card_vs_cpu(dev)
    mark("slice 3")
    clocks = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"
    print(f"card before timing: {clocks} = {smi(clocks)}")
    rows = time_kernels(dev, card)
    mark("kernel timing")
    time_paths(dev, card, cls_infer, seg_state, seg_step, seg_infer, scene_infer, scene_x)
    print(f"card after timing: {clocks} = {smi(clocks)}")
    mark("path timing")
    records = []
    for name, meta in KERNELS.items():
        # ms, call_ms, plain_ms and bound_ms sum the shapes of one call of a
        # path: the seg train step's, or for the spatial kernel (which that
        # step never launches) the whole-scene request's.
        path = "scene" if name == "knn_spatial" else "seg"
        shapes = [r for r in rows[name] if r["path"] == path]
        top = max(shapes, key=lambda r: r["bound_ms"])
        by_path = {"cls_serve": cls_launches[name], "seg_train": seg_launches[name],
                   "seg_serve": serve_launches[name], "whole_scene": scene_launches[name]}
        records.append({
            "name": name, "route": "cuda", "source": meta["source"], "replaces": meta["replaces"],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": errs[name],
            "ms_path": {"seg": "seg_train", "scene": "whole_scene"}[path],
            "ms": sum(r["ms"] for r in shapes),
            "call_ms": sum(r["call_ms"] for r in shapes),
            "plain_ms": sum(r["plain_ms"] for r in shapes),
            "bound_ms": sum(r["bound_ms"] for r in shapes),
            "bound_by": top["bound_by"],
            "library_ms": None,
            "by_shape": rows[name],
        })
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    line = json.dumps({"kernels": records})
    (OUT_DIR / "kernels.json").write_text(line)
    print(line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
