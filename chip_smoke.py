"""Drive the PyTorch/CUDA port of PointASNL once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero with no result):
  1. Require a CUDA card; print it as nvidia-smi gives it (name, power limit),
     the torch and CUDA versions and the TF32 switches (both off); build the
     kernels from ``pointasnl_tpu_torch/csrc`` and print the build seconds.
  2. FPS kernel against its plain PyTorch version on the card: indices exact
     at the slice's shapes and at the edge cases.
  3. kNN kernel against its plain version on the card: indices exact and
     squared distances within 1e-6 relative, at the slice's shapes and the
     edge cases.
  4. The slice: ``PointASNLCls(40, adaptive_sample=True)`` from a seeded
     generator answers 3 requests of random B8 x 1024 clouds through
     ``serve.make_inference_fn``. Each kernel must launch 2 times a request.
     The logits must be finite and agree with the same weights' forward on
     the CPU (plain versions): layer-1 indices exact, logits within
     1e-4 * max(|cpu|, 1) with the same argmax.
  5. Timing with CUDA events after warm-up (medians): each kernel and its
     plain version at the slice's shapes (a sample is 10 back-to-back calls),
     and the B8 x 1024 forward (a sample is one request).

The line before the last is one JSON object with a record per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

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
KERNELS = {
    "fps": {"source": "pointasnl_tpu_torch/csrc/fps.cu",
            "replaces": "pointasnl_tpu/ops/pallas/fps.py:45"},
    "knn_resident": {"source": "pointasnl_tpu_torch/csrc/knn.cu",
                     "replaces": "pointasnl_tpu/ops/pallas/knn.py:64"},
}
# (B, N, npoint) and (B, N query, M, k) of the slice's two SA layers.
FPS_SHAPES = [(8, 1024, 512), (8, 512, 128)]
KNN_SHAPES = [(8, 1024, 512, 32), (8, 512, 128, 64)]


def cloud(seed: int, B: int, N: int, dev, dup: int = 0) -> torch.Tensor:
    x = np.random.RandomState(seed).randn(B, N, 3).astype(np.float32)
    if dup:  # the last `dup` points copy the first ones: distances tie
        x[:, N - dup:] = x[:, :dup]
    return torch.from_numpy(x).to(dev)


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
    p = time_ms(plain, reps // 2, calls)
    k = time_ms(kernel, reps // 2, calls) + time_ms(kernel, reps // 2, calls)
    p += time_ms(plain, reps // 2, calls)
    return statistics.median(k), statistics.median(p)


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        sys.exit(1)
    from pointasnl_tpu_torch.ops.cuda import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
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


def phase_fps(dev) -> float:
    from pointasnl_tpu_torch.ops import geometry
    from pointasnl_tpu_torch.ops.cuda import fps

    cases = [(B, N, m, 0) for B, N, m in FPS_SHAPES] + [
        (2, 300, 1, 0),       # npoint == 1
        (2, 1000, 100, 0),    # N not a multiple of 32
        (2, 512, 200, 256),   # duplicate points: ties
        (1, 10240, 1280, 0),  # the largest N the kernel takes
    ]
    worst = 0
    for B, N, npoint, dup in cases:
        x = cloud(N + npoint, B, N, dev, dup)
        got = fps.farthest_point_sample(npoint, x)
        want = geometry.farthest_point_sample(npoint, x)
        torch.cuda.synchronize()
        if got.shape != (B, npoint) or not torch.equal(got, want):
            raise RuntimeError(f"fps B{B} N{N} -> {npoint} dup{dup}: kernel and plain differ")
        worst = max(worst, int((got - want).abs().max()))
        print(f"fps B{B} N{N} -> {npoint} dup{dup}: indices exact")
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
    s = cloud(5, 1, 10240, dev)
    cases.append(("N10240 M2560 k32", s, s[:, ::4].contiguous(), 32))
    cases.append(("disjoint B8 512q/1024 k32", cloud(6, 8, 1024, dev), cloud(7, 8, 512, dev), 32))

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
    return worst


def layer_indices(xyz: torch.Tensor, npoint: int, k: int):
    """FPS and kNN indices of one SA layer on xyz, through ops.dispatch."""
    from pointasnl_tpu_torch import ops

    fps_idx = ops.farthest_point_sample(npoint, xyz)
    _, knn_idx = ops.knn_point(k, xyz, ops.gather_point(xyz, fps_idx))
    return fps_idx.cpu(), knn_idx.cpu()


def phase_slice(dev):
    from pointasnl_tpu_torch.models import PointASNLCls
    from pointasnl_tpu_torch.ops.cuda import fps, knn
    from pointasnl_tpu_torch.serve import make_inference_fn

    model = PointASNLCls(NUM_CLASS, adaptive_sample=True,
                         generator=torch.Generator().manual_seed(SEED), device=dev)
    cpu_model = PointASNLCls(NUM_CLASS, adaptive_sample=True).eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    infer = make_inference_fn(model)
    clouds = [cloud(100 + r, BATCH, NUM_POINT, dev) for r in range(REQUESTS)]

    fps.launches = 0
    knn.launches = 0
    logits = [infer(x) for x in clouds]
    torch.cuda.synchronize()
    launches = {"fps": fps.launches, "knn_resident": knn.launches}
    print(f"slice: {REQUESTS} requests of B{BATCH}x{NUM_POINT}; launches {launches}")
    for name, n in launches.items():
        if n != 2 * REQUESTS:
            raise RuntimeError(f"{name} launched {n} times in {REQUESTS} requests, expected {2 * REQUESTS}")

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


def phase_timing(dev, card, infer):
    from pointasnl_tpu_torch.ops import geometry
    from pointasnl_tpu_torch.ops.cuda import fps, knn

    times = {"fps": [], "knn_resident": []}
    for B, N, npoint in FPS_SHAPES:
        x = cloud(11, B, N, dev)
        k_ms, p_ms = in_turns(lambda: geometry.farthest_point_sample(npoint, x),
                              lambda: fps.farthest_point_sample(npoint, x))
        times["fps"].append({"shape": f"B{B} N{N}->{npoint}", "ms": k_ms, "plain_ms": p_ms})
    for B, N, M, k in KNN_SHAPES:
        s = cloud(12, B, N, dev)
        q = geometry.gather_point(s, fps.farthest_point_sample(M, s))
        k_ms, p_ms = in_turns(lambda: geometry.knn_point(k, s, q), lambda: knn.knn_point(k, s, q))
        times["knn_resident"].append({"shape": f"B{B} {M}q/{N} k{k}", "ms": k_ms, "plain_ms": p_ms})
    for name, rows in times.items():
        for row in rows:
            print(f"time {name} {row['shape']}: kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms  [{card}]")

    x = cloud(13, BATCH, NUM_POINT, dev)
    samples = sorted(time_ms(lambda: infer(x), reps=110))
    fwd, p90 = statistics.median(samples), samples[int(0.9 * len(samples)) - 1]
    t0 = time.perf_counter()
    for _ in range(10):
        infer(x)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 10 * 1e3
    print(f"time forward B{BATCH}x{NUM_POINT}: p50 {fwd:.3f} ms, p90 {p90:.3f} ms of "
          f"{len(samples)} (CUDA events); {wall:.3f} ms host wall; "
          f"{BATCH * NUM_POINT / fwd * 1e3:.0f} points/s at p50  [{card}]")
    return times, fwd


def main() -> int:
    card, dev = phase_device()
    errs = {"fps": phase_fps(dev), "knn_resident": phase_knn(dev)}
    infer, launches = phase_slice(dev)
    times, _ = phase_timing(dev, card, infer)
    records = []
    for name, meta in KERNELS.items():
        records.append({
            "name": name, "route": "cuda", **meta, "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": sum(r["ms"] for r in times[name]),  # per request: both layers
            "plain_ms": sum(r["plain_ms"] for r in times[name]),
            "by_shape": times[name],
        })
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
