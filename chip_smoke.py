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
  8. Timing with CUDA events after warm-up (medians): each kernel and its
     plain version at both slices' shapes, in turns; the B8 x 1024 cls
     forward; the B4 x 10240 train step (p50, p90, points/s) and serve
     forward; one torch.profiler window over 3 train steps (device-busy
     share, device time by kernel, the three kernels' share of the step).

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
}
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


def in_turns(plain, kernel, reps: int = 20, calls: int = 10):
    """Median ms a call of plain and of kernel, timed in the order plain,
    kernel, kernel, plain."""
    p = time_ms(plain, reps // 2, calls, warmup=1)
    k = time_ms(kernel, reps // 2, calls) + time_ms(kernel, reps // 2, calls)
    p += time_ms(plain, reps // 2, calls, warmup=1)
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
    from pointasnl_tpu_torch.ops.cuda import ball_query, fps, knn

    return {"fps": fps.launches, "knn_resident": knn.launches, "ball_query": ball_query.launches}


def reset_counts():
    from pointasnl_tpu_torch.ops.cuda import ball_query, fps, knn

    fps.launches = knn.launches = ball_query.launches = 0


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
    if launches != {"fps": 2 * REQUESTS, "knn_resident": 2 * REQUESTS, "ball_query": 0}:
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
                    "ball_query": SEG_STEPS}:
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
                          "ball_query": 0}:
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


def time_kernels(dev, card):
    """Kernel vs plain times, and bounds, at both slices' shapes."""
    from pointasnl_tpu_torch.ops import geometry
    from pointasnl_tpu_torch.ops.cuda import ball_query, fps, knn

    rows = {name: [] for name in KERNELS}

    def add(name, path, shape, plain, kernel, bnd, heavy=False):
        reps, calls = (6, 2) if heavy else (20, 10)
        call_ms, p_ms = in_turns(plain, kernel, reps, calls)
        dev_ms = device_ms(kernel, KERNELS[name]["symbol"])
        if dev_ms is None:
            print(f"time {name} {shape}: the profiler saw no launch; ms is the call time")
        rows[name].append({"path": path, "shape": shape,
                           "ms": call_ms if dev_ms is None else dev_ms, "call_ms": call_ms,
                           "plain_ms": p_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                           "library_ms": None})

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
            fps_bound(SEG_B, a.shape[1], n), heavy=n >= 320)
    for si, qi, k in SEG_KNN:
        s, q = levels[si], levels[qi]
        N, M = s.shape[1], q.shape[1]
        add("knn_resident", "seg", f"B{SEG_B} {M}q/{N} k{k}", lambda: geometry.knn_point(k, s, q),
            lambda: knn.knn_point(k, s, q), knn_bound(SEG_B, N, M, k), heavy=N * M >= 10**7)
    l1 = levels[1]
    idx, cnt = ball_query.query_ball_point(REPULSION_RADIUS, REPULSION_NSAMPLE, l1, l1)
    n1 = l1.shape[1]
    add("ball_query", "seg", f"B{SEG_B} {n1}q/{n1} ns{REPULSION_NSAMPLE} r{REPULSION_RADIUS}",
        lambda: geometry.query_ball_point(REPULSION_RADIUS, REPULSION_NSAMPLE, l1, l1),
        lambda: ball_query.query_ball_point(REPULSION_RADIUS, REPULSION_NSAMPLE, l1, l1),
        ball_bound(n1, n1, SEG_B, REPULSION_NSAMPLE, idx, cnt))
    for name, rs in rows.items():
        for r in rs:
            print(f"time {name} [{r['path']}] {r['shape']}: kernel {r['ms']:.4f} ms on the "
                  f"device, {r['call_ms']:.4f} ms a call back to back, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})  [{card}]")
    return rows


def percentiles(samples):
    s = sorted(samples)
    return statistics.median(s), s[max(int(0.9 * len(s)) - 1, 0)]


def time_paths(dev, card, cls_infer, seg_state, seg_step, seg_infer):
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
    profile_steps(seg_state, seg_step, batch, card)
    return {"cls_forward_ms": fwd, "seg_step_ms": step_p50, "seg_serve_ms": serve_p50}


def profile_steps(state, step, batch, card, n: int = 3):
    """One torch.profiler window over n train steps, after one traced and
    dropped warm-up step: device-busy share and device time by kernel name,
    the three ported kernels picked out with the launches recorded."""
    from torch.profiler import ProfilerActivity, profile, schedule

    traces = []  # the active steps' events, handed over when the cycle ends
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n),
                 on_trace_ready=lambda prof: traces.append(prof.events())) as prof:
        step(state, batch)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for i in range(n):
            step(state, batch)
            if i == n - 1:
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            prof.step()
    events = traces[0] if traces else []
    spans, by_name = [], {}
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            start, end = e.time_range.start, e.time_range.end
            spans.append((start, end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (end - start)
    if not spans:
        print("profile: the profiler recorded no device time; see the CUDA-event times")
        return
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
    ours = {k: sum(v for name, v in by_name.items() if f"{k}_kernel" in name)
            for k in ("fps", "knn", "ball_query")}
    seen = {k: sum(1 for e in events if f"{k}_kernel" in e.name
                   and e.device_type == torch.autograd.DeviceType.CUDA) for k in ours}
    expected = {"fps": 4 * n, "knn": 11 * n, "ball_query": n}
    print(f"profile: launches recorded {seen} of {expected}" +
          ("" if seen == expected else "; the profiler dropped some: shares are lower bounds"))
    print(f"profile, {n} seg train steps: wall {wall_us / n / 1e3:.3f} ms a step under the "
          f"profiler; device busy {busy / n / 1e3:.3f} ms a step ({100 * busy / wall_us:.1f} % "
          f"of the wall); {len(spans) // n} device activities a step  [{card}]")
    print("profile, device ms a step: " + "; ".join(
        f"{k} {v / n / 1e3:.3f} ({100 * v / total:.1f} %)" for k, v in ours.items()))
    for name, us in top[:12]:
        print(f"profile top: {us / n / 1e3:8.3f} ms {100 * us / total:5.1f} %  {name[:110]}")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "profile_seg_step.json").write_text(json.dumps(
        {"card": card, "steps": n, "wall_us": wall_us, "busy_us": busy,
         "device_us_by_name": dict(top)}, indent=1))


def main() -> int:
    card, dev = phase_device()
    errs = {"fps": phase_fps(dev), "knn_resident": phase_knn(dev), "ball_query": phase_ball(dev)}
    cls_infer, cls_launches = phase_cls(dev)
    seg_state, seg_step, seg_infer, seg_launches, serve_launches = phase_seg(dev)
    phase_card_vs_cpu(dev)
    clocks = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"
    print(f"card before timing: {clocks} = {smi(clocks)}")
    rows = time_kernels(dev, card)
    time_paths(dev, card, cls_infer, seg_state, seg_step, seg_infer)
    print(f"card after timing: {clocks} = {smi(clocks)}")
    records = []
    for name, meta in KERNELS.items():
        seg = [r for r in rows[name] if r["path"] == "seg"]  # one train step's shapes
        top = max(seg, key=lambda r: r["bound_ms"])
        records.append({
            "name": name, "route": "cuda", "source": meta["source"], "replaces": meta["replaces"],
            "launches": cls_launches[name] + seg_launches[name] + serve_launches[name],
            "launches_by_path": {"cls_serve": cls_launches[name], "seg_train": seg_launches[name],
                                 "seg_serve": serve_launches[name]},
            "max_abs_err": errs[name],
            "ms": sum(r["ms"] for r in seg),
            "call_ms": sum(r["call_ms"] for r in seg),
            "plain_ms": sum(r["plain_ms"] for r in seg),
            "bound_ms": sum(r["bound_ms"] for r in seg),
            "bound_by": top["bound_by"],
            "library_ms": None,
            "by_shape": rows[name],
        })
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
