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
     10240 x 10240 stem one cloud at a time) and the edge cases, among them
     the register lists' (register_list_cases: equal points, integer
     lattices, k of 3, 64 and 128, k > N, N not a multiple of the 1024-point
     tile, copies of points across tile boundaries).
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
     ``serve.make_inference_fn``. A step must launch FPS 4, kNN 11, the
     ball query 1 and the gather backward 19 times, a request FPS 4, kNN 11
     and no ball query or gather backward. Losses
     finite, logits (4, 10240, 21) finite, and the mean in-ball count on the
     steps' l1_xyz above 1 (the repulsion term is not degenerate).
  7. Card against CPU, one seg train step at B2 x 2048 from the same weights
     (dropout off): layer-1 FPS and kNN indices exact; loss terms, gradients
     per parameter and BN statistics within the float32 yardstick (below).
  8. Slice 3, whole-scene serving: scene-scale FPS (the cluster design)
     and the spatially-pruned kNN against their plain versions on the card,
     indices exact (kNN d2 within 1e-6 relative), at the whole-scene path's
     shapes on a 131072-point surface scene and at edge cases (the spatial
     kNN's among them: equal points, an integer lattice, k of 3, 64 and 128,
     three copies of each point); then
     ``PointASNLSemSegRes(21, nl_kv_block_size=4096)`` answers 3 requests
     of B1 x 131072 surface scenes (the first is bench.py's input) through
     ``serve.make_inference_fn``: a request must launch FPS 4, the spatial
     kNN 3, the resident kNN 8 and no ball query, and return finite
     (1, 131072, 21) logits; peak memory is printed.
  9. Card against CPU, the whole-scene model's forward at B1 x 24576 on two
     scenes (the stem's self-kNN then takes the spatial kernel): level-1 FPS
     and kNN indices exact; logits within SCENE_LOGIT_RTOL (below).
 10. Timing with CUDA events after warm-up (medians): each kernel and its
     plain version at all slices' shapes, in turns, the share of pairs
     the spatial kernel tests, and the streaming kNN on each resident and
     spatial kNN's search (off the path, to compare them), each resident and
     spatial time beside the shared-memory design's
     (KNN_SHARED_MEMORY_DESIGN_MS); the gather
     backward on a seg step's 19 gathers, each call with its sort, beside
     index_add_; the B8 x 1024 cls forward; the B4 x 10240 train step
     (p50, p90, points/s) and serve forward; one torch.profiler window
     over 3 train steps (device-busy share, device time by kernel,
     the kernels' share of the step); the whole-scene request (p50, p90,
     points/s) and a profiler window over 2 requests.
 11. Slice 4, flash attention: the forward and backward kernels against
     their plain versions on the card (o and lse, dq, dk and dv within
     FLASH_RTOL and FLASH_GRAD_RTOL, below) at the seg step's four non-local
     levels, cls's two layers and edge cases, and one forward past the TPU
     kernel's VMEM envelope; then ``PointASNLSemSegRes(21,
     nl_use_flash=True)`` takes 3 train steps at B4 x 10240 and answers 2
     requests, as in phase 6: a step must launch the flash forward 4 and
     backward 4 times beside phase 6's counts, a request the forward 4 times
     and no backward; then phase 7's card-against-CPU step under the flag.
     Timing adds the flash kernels at the path's shapes (device, call, plain
     and bound ms, and F.scaled_dot_product_attention's ms as a yardstick:
     forward, and forward with backward), the flash step and serve forward
     (p50, p90, timed in turns with phase 10's dense ones) and a profiler
     window over 3 flash steps.
 12. Slice 5, whole-scene serving past 2^21 points: the streaming kNN
     against its plain version on the card (indices exact, d2 within 1e-6
     relative; k of 1 to 512, k > N, ties, B3, disjoint queries, N not a
     multiple of its chunk) and against the spatial kernel on slice 3's
     131072-point stem; the FPS chain of a B1 x 2228224 surface scene
     (2228224 -> 278528 in the grid design, then 69632, 17408 and 8704 in
     the cluster design) against the plain version, and the grid design
     against the cluster design on 278528 -> 69632 and at 131072; each FPS
     time with its microseconds a pick and the barrier-exchange design's
     (FPS_BARRIER_DESIGN_MS) beside it; the request's 8 spatial and 2
     resident searches on those levels, each launched on its whole query
     set, against ``knn_point_chunked`` on all rows or on 2^32 / N seeded
     ones, and each spatial search also by the streaming kernel, off the
     path (equal results, timed in turns with it), with the pairs each
     spatial search tests; the stem's kNN on 4096
     seeded rows against ``knn_point_chunked`` on the card, and the full
     M = N launch's rows against those; then
     ``PointASNLSemSegRes(21, nl_kv_block_size=4096)`` answers a warm-up
     and 2 requests of B1 x 2228224: a request must launch the streaming
     kNN 1, the spatial kNN 8, the resident kNN 2, FPS 4 and no ball query
     or flash kernel, and return finite (1, 2228224, 21)
     logits; peak memory, p50 by CUDA events, a profiler window over one
     request, and the times of the path's streaming kNN (with the pairs it
     tests), FPS and its 8 spatial and 2 resident searches (device ms from
     the profiled request). This phase alone: ``python3 -c "import chip_smoke as c;
     d = c.phase_device(); c.slice5(d[1], d[0], print)"``.
 13. Slice 6, run after phase 11 and before the timing: the gather backward
     kernel on each of a B4 x 10240 seg step's 19 gathers (12 sorts: the
     gathers that share indices share them), equal to the bit to its plain
     version, to CPU float32 index_add_ and to a second launch;
     then two seg train steps at B4 x 10240 from one state with one dropout
     seed, dense and under nl_use_flash, whose gradients, updated parameters
     and BN statistics must be equal to the bit; then, apart from that
     check, one step of each under torch.use_deterministic_algorithms(True,
     warn_only=True), printing the ops PyTorch flags.

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
    "knn_streaming": {"source": "pointasnl_tpu_torch/csrc/knn_streaming.cu",
                      "replaces": "pointasnl_tpu/ops/pallas/knn.py:109",
                      "symbol": "knn_stream_kernel"},
    "flash_fwd": {"source": "pointasnl_tpu_torch/csrc/flash_attention.cu",
                  "replaces": "pointasnl_tpu/ops/pallas/flash_attention.py:90",
                  "symbol": "flash_fwd_kernel"},
    # One backward call runs delta's kernel, the backward kernel (dQ, dK,
    # dV) and, where a query tile's keys are split, the partial dQ's sum.
    "flash_bwd": {"source": "pointasnl_tpu_torch/csrc/flash_attention.cu",
                  "replaces": "pointasnl_tpu/ops/pallas/flash_attention.py:170",
                  "symbol": ("flash_bwd_delta_kernel", "flash_bwd_kernel",
                             "flash_bwd_dq_sum_kernel")},
    # Not a Pallas kernel: the TPU package's deterministic gather VJP.
    "gather_bwd": {"source": "pointasnl_tpu_torch/csrc/gather_backward.cu",
                   "replaces": "pointasnl_tpu/ops/scatter.py:40",
                   "symbol": "gather_backward_kernel"},
}
FPS_CLUSTER_SYMBOL = "fps_cluster_kernel"  # the scene-scale design of csrc/fps.cu
FPS_GRID_SYMBOL = "fps_grid_kernel"  # its design past 278528 points
# Device ms of the multi-block FPS designs that exchanged each pick through a
# cluster or grid barrier (an 8-block cluster up to 131072 points, the grid
# past it), on the NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 6), by
# (N, npoint): printed beside the barrier-free designs' times.
FPS_BARRIER_DESIGN_MS = {(131072, 16384): 49.2428, (16384, 4096): 9.3412,
                         (2228224, 278528): 1300.3983, (278528, 69632): 266.8766,
                         (69632, 17408): 45.2662, (17408, 8704): 20.2509}
# Device ms of the kNN designs before the register lists (the resident
# kernel's shared-memory rows with k argmin rounds, the spatial kernel's
# thread a query with a block-wide walk), on the NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md, section 6: scripts/torch_knn_turns.py on the parent tree),
# by (path, shape): printed beside the register-list designs' times.
KNN_SHARED_MEMORY_DESIGN_MS = {
    ("cls", "B8 512q/1024 k32"): 0.0670, ("cls", "B8 128q/512 k64"): 0.0315,
    ("seg", "B4 10240q/10240 k32"): 26.4310, ("seg", "B4 320q/1280 k32"): 0.0437,
    ("seg", "B4 320q/320 k32"): 0.0188, ("seg", "B4 80q/320 k32"): 0.0146,
    ("seg", "B4 80q/80 k32"): 0.0106, ("seg", "B4 40q/80 k32"): 0.0107,
    ("seg", "B4 40q/40 k32"): 0.0109, ("seg", "B4 80q/40 k3"): 0.0024,
    ("seg", "B4 320q/80 k3"): 0.0027, ("seg", "B4 1280q/320 k3"): 0.0063,
    ("seg", "B4 10240q/1280 k3"): 0.0917, ("scene", "B1 131072q/131072 k32"): 11.2752,
    ("scene", "B1 4096q/16384 k32"): 5.8638, ("scene", "B1 4096q/4096 k32"): 0.2782,
    ("scene", "B1 1024q/4096 k32"): 0.0723, ("scene", "B1 1024q/1024 k32"): 0.0246,
    ("scene", "B1 512q/1024 k32"): 0.0246, ("scene", "B1 512q/512 k32"): 0.0166,
    ("scene", "B1 1024q/512 k3"): 0.0035, ("scene", "B1 4096q/1024 k3"): 0.0102,
    ("scene", "B1 16384q/4096 k3"): 0.1843, ("scene", "B1 131072q/16384 k3"): 0.5801,
    ("scene_2228224", "B1 69632q/278528 k32"): 19.8142,
    ("scene_2228224", "B1 69632q/69632 k32"): 8.3319,
    ("scene_2228224", "B1 17408q/69632 k32"): 10.6633,
    ("scene_2228224", "B1 17408q/17408 k32"): 4.1154,
    ("scene_2228224", "B1 8704q/17408 k32"): 4.6272,
    ("scene_2228224", "B1 8704q/8704 k32"): 3.0484, ("scene_2228224", "B1 17408q/8704 k3"): 1.5243,
    ("scene_2228224", "B1 69632q/17408 k3"): 0.5633,
    ("scene_2228224", "B1 278528q/69632 k3"): 1.5539,
    ("scene_2228224", "B1 2228224q/278528 k3"): 8.5044}
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
# Gather backwards a seg train step launches: 22 gathers take a gradient,
# 19 of them feed the loss (tests/test_torch_gather.py).
SEG_GATHER_BWD = 19
# Index tensors those 19 sort: gathers sharing indices share a plan.
SEG_GATHER_SORTS = 12
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

# Slice 4: flash attention. (B, M queries, N keys, C, D) of the seg step's
# four non-local cells under nl_use_flash (C = D = max(32, C_in // 2)).
FLASH_SEG = [(SEG_B, SEG_N // 8, SEG_N, 32, 32), (SEG_B, SEG_N // 32, SEG_N // 8, 32, 32),
             (SEG_B, SEG_N // 128, SEG_N // 32, 64, 64), (SEG_B, SEG_N // 256, SEG_N // 128, 128, 128)]
# The kernel checks: (B, M, N, C, D, scaled, q multiplier), the seg levels,
# cls's two layers (B8), then edge cases; and one forward-only case past the
# TPU kernel's VMEM envelope, which the port does not keep.
FLASH_CASES = {
    **{f"seg level {i + 1}": (*shape, True, 1.0) for i, shape in enumerate(FLASH_SEG)},
    "cls layer 1": (8, 512, 1024, 32, 32, True, 1.0),
    "cls layer 2": (8, 128, 512, 64, 64, True, 1.0),
    "N 1": (2, 50, 1, 32, 32, True, 1.0),
    "N 1025 (a chunk and a key)": (2, 100, 1025, 32, 32, True, 1.0),
    "N 2049 (two chunks and a key)": (2, 100, 2049, 32, 32, True, 1.0),
    "M 1": (2, 1, 300, 32, 32, True, 1.0),
    "M 77 (not a multiple of a tile)": (2, 77, 300, 64, 64, True, 1.0),
    "C = D = 128 at N 10240": (1, 64, 10240, 128, 128, True, 1.0),
    "scaled=False": (2, 100, 500, 32, 32, False, 1.0),
    "q x 30 (the max moves across chunks)": (2, 100, 3000, 32, 32, True, 30.0),
    "B 1": (1, 300, 700, 32, 32, True, 1.0),
}
FLASH_FWD_ONLY = {"past the TPU's envelope, N 131072": (1, 512, 131072, 32, 32, True, 1.0)}
# |kernel - plain| may be at most FLASH_RTOL (o, lse) or FLASH_GRAD_RTOL
# (dq, dk, dv) of the quantity's largest |value|, plus YARDSTICK times the
# plain version's own distance from float64 dense attention: both sides are
# float32 with sums in other orders, and at q x 30 the scores reach ~1e2,
# whose float32 rounding moves p by ~1e-5 relative.
FLASH_RTOL, FLASH_GRAD_RTOL = 1e-5, 1e-4

# Slice 5: whole-scene serving past 2^21 points, one B1 surface scene of
# 2^21 + 2^17 = 17 x 131072 points at slice 3's density (scene() scales the
# extent to 6.0 x sqrt(17)), K/V blocks of 4096, BIG_REQUESTS requests on as
# many scenes after a warm-up. The full-scene kNN checks take BIG_ROWS seeded
# query rows.
BIG_N, BIG_REQUESTS, BIG_ROWS = 2228224, 2, 4096
# The request's other searches are held to the plain version on rows whose
# pairs stay within BIG_PAIRS (about half a second of the plain kNN).
BIG_PAIRS = 2 ** 32
BIG_LEVELS = [BIG_N, BIG_N // 8, BIG_N // 32, BIG_N // 128, BIG_N // 256]
# A request's launches, routed as the JAX package routes them: the stem's
# self-kNN takes the streaming kernel (N > 2^21); the spatial kernel layer2_1,
# layer2_2, layer3_1, layer3_2, layer4_1 and the three_nn of fa_layer2-4
# (support 17408 to 278528); the resident kernel layer4_2 (8704 points) and
# fa_layer1's three_nn; FPS the four levels, the first in the grid design and
# the other three in the cluster design.
BIG_LAUNCHES = {"fps": 4, "knn_resident": 2, "ball_query": 0, "knn_spatial": 8,
                "knn_streaming": 1, "flash_fwd": 0, "flash_bwd": 0, "gather_bwd": 0}

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, TF32
# on the tensor cores (dense) and HBM bandwidth, for each kernel's bound.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_S = 3.35e12
# The flash backward's products run on the tensor cores in TF32, three
# passes a product for float32 accuracy (csrc/flash_attention.cu): its bound
# counts each float32 operation three times at the TF32 rate.
FLASH_BWD_TF32_PASSES = 3
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


def device_ms(fn, kernels, calls: int = 10, tries: int = 3):
    """Median device time (ms) of one launch of each of `kernels` (a
    substring of a CUDA kernel's name, or a tuple of those a call launches,
    every one of them) over `calls` calls of fn, summed, from
    torch.profiler. The profiler at times records no launch of a kernel in a
    window: then the window is taken again, up to `tries` windows, and
    where a kernel is still missing, None (never the sum of the others).
    Call it before any profile_window: once that scheduled profiler has
    run, this one recorded no launch on the card."""
    from torch.profiler import ProfilerActivity, profile

    kernels = (kernels,) if isinstance(kernels, str) else tuple(kernels)
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times = {kernel: [e.time_range.elapsed_us() for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and kernel in e.name] for kernel in kernels}
        missing = [kernel for kernel, ts in times.items() if not ts]
        if not missing:
            for kernel, ts in times.items():
                if len(ts) < calls:
                    print(f"profiler: {len(ts)} of {calls} launches of {kernel} recorded")
            return sum(statistics.median(ts) for ts in times.values()) / 1e3
        print(f"profiler: no launch of {', '.join(missing)} recorded; profiling again")
    return None


def bound(nbytes: float, ops: float, peak: float = PEAK_F32_FLOPS):
    """(ms, 'bytes' or 'operations'): the least time the card could take to
    move `nbytes` through device memory and do `ops` operations at the rate
    `peak` (float32 outside the tensor cores unless given)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def fps_bound(B, N, npoint):
    # Each pick updates every point: 3 sub, 3 mul, 2 add, 1 min, 1 compare.
    return bound(B * N * 12 + B * npoint * 4, B * (npoint - 1) * N * 10)


def fps_notes(r) -> str:
    """An FPS row's microseconds a pick, and the barrier-exchange design's
    device ms at its shape where there is one."""
    N, npoint = r["fps_n"], r["fps_npoint"]
    if npoint < 2:
        return ""
    old = FPS_BARRIER_DESIGN_MS.get((N, npoint))
    return (f", {r['ms'] * 1e3 / (npoint - 1):.3f} us a pick"
            + (f" (the barrier-exchange design: {old:.4f} ms)" if old else ""))


def knn_notes(name, r) -> str:
    """A resident or spatial kNN row's device ms before the register lists,
    where there is one."""
    old = KNN_SHARED_MEMORY_DESIGN_MS.get((r["path"], r["shape"]))
    if name not in ("knn_resident", "knn_spatial") or old is None:
        return ""
    return f" (the shared-memory design: {old:.4f} ms, {old / r['ms']:.2f}x)"


def knn_bound(B, N, M, k):
    # Every pair's distance (8 operations) and one compare to select.
    return bound(B * (N + M) * 12 + B * M * k * 8, B * M * N * 9)


def flash_fwd_bound(B, M, N, C, D):
    # q, k, v in, o and lse out; the two products, 2 M N (C + D) a batch.
    return bound(B * (M * C + N * (C + D) + M * D + M) * 4, 2 * B * M * N * (C + D))


def flash_bwd_bound(B, M, N, C, D, passes: int = FLASH_BWD_TF32_PASSES):
    # q, k, v, o, dO and lse in, dq, dk, dv out; s and dO v^T recomputed,
    # then dQ, dK and dV: 2 M N (3C + 2D) a batch, each `passes` times on the
    # tensor cores in TF32; passes=None counts them once at the float32 rate.
    nbytes = B * (2 * M * C + 2 * M * D + M + 2 * N * (C + D)) * 4
    ops = 2 * B * M * N * (3 * C + 2 * D)
    if passes is None:
        return bound(nbytes, ops)
    return bound(nbytes, ops * passes, PEAK_TF32_FLOPS)


def flash_bwd_symbols(B, M, N, C, D):
    """The kernels one backward call launches at this shape: delta's, the
    backward kernel and, where a query tile's keys are split, the partial
    dQ's sum."""
    from pointasnl_tpu_torch.ops.cuda import _build

    split = _build.library().pasnl_flash_bwd_scratch(B, M, N, C, D) > 0
    return ("flash_bwd_delta_kernel", "flash_bwd_kernel") + ("flash_bwd_dq_sum_kernel",) * split


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


def check_knn(what: str, got, want, self_rows=None) -> float:
    """Indices exact and d2 within 1e-6 relative; with `self_rows`, each
    query's first neighbour is that support index. Returns max |d2 err|."""
    (got_d, got_i), (want_d, want_i) = got, want
    if got_i.shape != want_i.shape or not torch.equal(got_i, want_i):
        raise RuntimeError(f"{what}: {int((got_i != want_i).sum())} indices differ")
    err = (got_d - want_d).abs()
    if bool((err > 1e-6 * want_d.abs()).any()):
        raise RuntimeError(f"{what}: dist2 beyond 1e-6 relative (max abs {float(err.max()):.3e})")
    if self_rows is not None and not torch.equal(got_i[..., 0].long(), self_rows):
        raise RuntimeError(f"{what}: a query in the support is not its own first neighbour")
    print(f"{what}: indices exact, max |d2 err| {float(err.max()):.3e}")
    return float(err.max())


def lattice(side: int, dev) -> torch.Tensor:
    """The side^3 integer points of a cube, B1: exact ties at many distances."""
    g = np.stack(np.meshgrid(*[np.arange(side, dtype=np.float32)] * 3, indexing="ij"), -1)
    return torch.from_numpy(np.ascontiguousarray(g.reshape(1, -1, 3))).to(dev)


def register_list_cases(dev):
    """(name, support, query, k) of the resident kNN's cases for its register
    list (csrc/knn_select.cuh): equal points, exact ties at several
    distances, k of 3, 64 and 128 (one, two and four entries a lane), k > N
    at every list size, N not a multiple of the 1024-point tile, and copies of
    points on both sides of a tile boundary."""
    eq = cloud(40, 2, 1, dev).expand(2, 3000, 3).contiguous()
    lat = lattice(16, dev)
    straddle = cloud(41, 2, 3072, dev)
    straddle[:, 974:1074] = straddle[:, :100]  # copies across the first tile boundary
    straddle[:, 2000:2100] = straddle[:, :100]  # and the second
    ragged = cloud(42, 3, 2049, dev)
    return [("all equal B2 300q/3000 k32", eq, eq[:, :300].contiguous(), 32),
            ("all equal B2 300q/3000 k128", eq, eq[:, :300].contiguous(), 128),
            ("lattice 512q/4096 k32", lat, lat[:, ::8].contiguous(), 32),
            ("lattice 410q/4096 k64", lat, lat[:, ::10].contiguous(), 64),
            ("lattice 410q/4096 k128", lat, lat[:, ::10].contiguous(), 128),
            ("lattice half-integer 2000q/4096 k3", lat,
             torch.from_numpy((np.random.RandomState(43).randint(0, 31, (1, 2000, 3)) / 2.0)
                              .astype(np.float32)).to(dev), 3),
            ("k > N B2 30q/40 k64", cloud(44, 2, 40, dev), cloud(45, 2, 30, dev), 64),
            ("k > N B2 30q/100 k128", cloud(46, 2, 100, dev), cloud(47, 2, 30, dev), 128),
            ("N 2049, two tiles and a point, B3 683q k64", ragged, ragged[:, ::3].contiguous(), 64),
            ("N 12288 k128 (the largest)", cloud(48, 1, 12288, dev), cloud(49, 1, 500, dev), 128),
            ("copies across tile boundaries B2 300q/3072 k32", straddle,
             straddle[:, :300].contiguous(), 32),
            ("copies across tile boundaries B2 300q/3072 k128", straddle,
             straddle[:, :300].contiguous(), 128)]


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
    cases += register_list_cases(dev)
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
        got = knn.knn_point(k, support, query)
        want = geometry.knn_point(k, support, query)
        torch.cuda.synchronize()
        self_rows = (torch.arange(0, 1024, 4, device=dev).expand(2, -1) if "self first" in name
                     else None)
        if "all equal" in name and not torch.equal(
                got[1].long(), torch.arange(k, device=dev).expand(*got[1].shape)):
            raise RuntimeError(f"knn {name}: the indices are not 0 .. k-1")
        worst = max(worst, check_knn(f"knn {name}", got, want, self_rows))
        del got, want
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
    from pointasnl_tpu_torch.ops.cuda import (ball_query, flash_attention, fps, gather_backward,
                                              knn, knn_spatial, knn_streaming)

    return {"fps": fps.launches, "knn_resident": knn.launches, "ball_query": ball_query.launches,
            "knn_spatial": knn_spatial.launches, "knn_streaming": knn_streaming.launches,
            "flash_fwd": flash_attention.fwd_launches, "flash_bwd": flash_attention.bwd_launches,
            "gather_bwd": gather_backward.launches}


def reset_counts():
    from pointasnl_tpu_torch.ops.cuda import (ball_query, flash_attention, fps, gather_backward,
                                              knn, knn_spatial, knn_streaming)

    fps.launches = knn.launches = ball_query.launches = knn_spatial.launches = 0
    knn_streaming.launches = flash_attention.fwd_launches = flash_attention.bwd_launches = 0
    gather_backward.launches = 0


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
                    "knn_spatial": 0, "knn_streaming": 0, "flash_fwd": 0, "flash_bwd": 0,
                    "gather_bwd": 0}:
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


def phase_seg(dev, flash: bool = False):
    """Slice 2's seg train steps and requests, or slice 4's under
    nl_use_flash (`flash`), which launch the flash forward once for each
    non-local level, and in a train step the backward too."""
    from pointasnl_tpu_torch import ops
    from pointasnl_tpu_torch.models import PointASNLSemSegRes
    from pointasnl_tpu_torch.serve import make_inference_fn

    label = "flash seg" if flash else "seg"
    model = PointASNLSemSegRes(SEG_CLASSES, nl_use_flash=flash,
                               generator=torch.Generator().manual_seed(SEED), device=dev)
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
    print(f"{label} slice: PointASNLSemSegRes({SEG_CLASSES}, nl_use_flash={flash}), {n_params} "
          f"parameters; {SEG_STEPS} train steps of B{SEG_B}x{SEG_N}; launches {launches}")
    nl = 4 * flash
    if launches != {"fps": 4 * SEG_STEPS, "knn_resident": 11 * SEG_STEPS,
                    "ball_query": SEG_STEPS, "knn_spatial": 0, "knn_streaming": 0,
                    "flash_fwd": nl * SEG_STEPS, "flash_bwd": nl * SEG_STEPS,
                    "gather_bwd": SEG_GATHER_BWD * SEG_STEPS}:
        raise RuntimeError(f"{label} train launches {launches}, expected FPS 4, kNN 11, "
                           f"ball query 1, flash forward {nl} and backward {nl}, gather "
                           f"backward {SEG_GATHER_BWD} a step")
    for s, m in enumerate(metrics):
        m = {k: float(v) for k, v in m.items()}
        print(f"step {s}: " + ", ".join(f"{k} {v:.6f}" for k, v in m.items()))
        if not all(np.isfinite(v) for v in m.values()):
            raise RuntimeError(f"step {s}: a loss is not finite")
    mean_cnt = statistics.mean(
        float(ops.query_ball_point(REPULSION_RADIUS, REPULSION_NSAMPLE, x, x)[1].float().mean())
        for x in l1)
    print(f"{label} slice: mean in-ball count on l1_xyz {mean_cnt:.3f} (r {REPULSION_RADIUS}, "
          f"nsample {REPULSION_NSAMPLE})")
    if not mean_cnt > 1.0:
        raise RuntimeError("the repulsion term is degenerate: the balls hold only their point")

    infer = make_inference_fn(model)
    clouds = [cube(300 + r, SEG_B, SEG_N, SEG_SIDE, dev) for r in range(SEG_REQUESTS)]
    reset_counts()
    logits = [infer(x) for x in clouds]
    torch.cuda.synchronize()
    serve_launches = counts()
    print(f"{label} serve: {SEG_REQUESTS} requests of B{SEG_B}x{SEG_N}; launches "
          f"{serve_launches}")
    if serve_launches != {"fps": 4 * SEG_REQUESTS, "knn_resident": 11 * SEG_REQUESTS,
                          "ball_query": 0, "knn_spatial": 0, "knn_streaming": 0,
                          "flash_fwd": nl * SEG_REQUESTS, "flash_bwd": 0, "gather_bwd": 0}:
        raise RuntimeError(f"{label} serve launches {serve_launches}, expected FPS 4, kNN 11, "
                           f"flash forward {nl} and no ball query, flash or gather backward a "
                           f"request")
    for r, out in enumerate(logits):
        if out.shape != (SEG_B, SEG_N, SEG_CLASSES) or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"{label} request {r}: logits {tuple(out.shape)} not all finite")
    print(f"{label} serve: logits {tuple(logits[0].shape)} finite")
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


def phase_card_vs_cpu(dev, flash: bool = False):
    """One seg train step on the card against the CPU's, dense or under
    nl_use_flash (`flash`). The CPU's float64 step still runs its flash
    attention in float32 inside, as JAX's does."""
    from pointasnl_tpu_torch.models import PointASNLSemSegRes

    card = PointASNLSemSegRes(SEG_CLASSES, dropout_keep=1.0, nl_use_flash=flash,
                              generator=torch.Generator().manual_seed(SEED + 1), device=dev)
    sd = {k: v.cpu() for k, v in card.state_dict().items()}
    cpus = {}
    for dtype in (torch.float32, torch.float64):
        m = PointASNLSemSegRes(SEG_CLASSES, dropout_keep=1.0, nl_use_flash=flash, device="cpu")
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
        print(f"card vs cpu{' (flash)' * flash}: {name} step in {time.perf_counter() - t0:.2f} s")

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
    print(f"card vs cpu, B2x2048 train step, nl_use_flash={flash}: " + ", ".join(
        f"{k} card {float(c['metrics'][k]):.7f} cpu {float(p['metrics'][k]):.7f} "
        f"cpu64 {float(p64['metrics'][k]):.7f}" for k in c["metrics"]))
    print(f"card vs cpu{' (flash)' * flash}: layer-1 FPS and kNN indices exact; level-2 "
          f"indices differing: "
          f"fps {l2[0]}, knn {l2[1]}; worst error / limit: loss terms "
          f"{max(worst.values()):.3f}, gradients {g_ratio:.3f}, BN stats {bn_ratio:.3f} "
          f"(limit {YARDSTICK:g} x |cpu - cpu64| + {FLOOR_RTOL:g} x scale)")


def seg_gathers(dev):
    """(dout, idx, n) of each gather backward of one B4 x 10240 seg train step,
    recorded at the kernel's wrapper, in the order the step launched them."""
    from pointasnl_tpu_torch.models import PointASNLSemSegRes
    from pointasnl_tpu_torch.ops.cuda import gather_backward

    model = PointASNLSemSegRes(SEG_CLASSES, generator=torch.Generator().manual_seed(SEED + 3),
                               device=dev)
    state, step = seg_trainer(model, SEG_B)
    cases, sorts = [], []
    launch, segments = gather_backward.gather_backward, gather_backward.segments

    def record(dout, idx, n):
        cases.append((dout.detach().clone(), idx.clone(), n))
        return launch(dout, idx, n)

    def count(idx, n):
        sorts.append(n)
        return segments(idx, n)

    gather_backward.gather_backward, gather_backward.segments = record, count
    try:
        step(state, seg_batch(210, SEG_B, SEG_N, SEG_SIDE, dev))
    finally:
        gather_backward.gather_backward, gather_backward.segments = launch, segments
    torch.cuda.synchronize()
    if len(cases) != SEG_GATHER_BWD or len(sorts) != SEG_GATHER_SORTS:
        raise RuntimeError(f"a seg step ran {len(cases)} gather backwards on {len(sorts)} sorts, "
                           f"expected {SEG_GATHER_BWD} on {SEG_GATHER_SORTS}")
    return cases


def index_add(dout, idx, n):
    """The gather backward as one index_add_ over the flattened batch."""
    B, R, C = dout.shape
    flat = (idx.long() + torch.arange(B, device=idx.device)[:, None] * n).reshape(-1)
    return torch.zeros(B * n, C, device=dout.device).index_add_(0, flat, dout.reshape(B * R, C))


def phase_gather(dev):
    """The gather backward kernel on each of a seg step's 19 gathers: equal to
    the bit to its plain version on the card, to CPU float32 index_add_, and
    to a second launch. Returns the cases, for the timing."""
    from pointasnl_tpu_torch.ops.cuda import gather_backward

    cases = seg_gathers(dev)
    for i, (dout, idx, n) in enumerate(cases):
        B, R, C = dout.shape
        got = gather_backward.gather_backward(dout, idx, n)
        again = gather_backward.gather_backward(dout, idx, n)
        plain = gather_backward.gather_backward_reference(dout, idx, n)
        torch.cuda.synchronize()
        cpu = index_add(dout.cpu(), idx.cpu(), n).view(B, n, C)
        if not (torch.equal(got, again) and torch.equal(got, plain)
                and torch.equal(got.cpu(), cpu)):
            raise RuntimeError(f"gather backward {i} B{B} {R} rows -> {n} C{C}: the kernel differs "
                               f"from a second launch, its plain version or CPU index_add_")
        print(f"gather backward {i}, B{B} {R} rows -> {n} C{C} (seg step): equal to the bit to "
              f"the plain version, CPU index_add_ and a second launch")
    return cases


def phase_determinism(dev):
    """Two seg train steps at B4 x 10240 from one state, with one dropout
    seed, dense and under nl_use_flash: their gradients, updated parameters
    and BN statistics must be equal to the bit. Then one diagnostic step of
    each under torch.use_deterministic_algorithms(True, warn_only=True), apart
    from the check, lists the ops that PyTorch flags as nondeterministic;
    a difference raises after that."""
    import copy
    import warnings

    from pointasnl_tpu_torch.models import PointASNLSemSegRes

    batch = seg_batch(600, SEG_B, SEG_N, SEG_SIDE, dev)
    models, failed = {}, []
    for flash in (False, True):
        label = "flash seg" if flash else "seg"
        model = PointASNLSemSegRes(SEG_CLASSES, nl_use_flash=flash,
                                   generator=torch.Generator().manual_seed(SEED + 4), device=dev)
        init = copy.deepcopy(model.state_dict())
        runs = []
        for _ in range(2):
            model.load_state_dict(init)
            state, step = seg_trainer(model, SEG_B)
            torch.manual_seed(SEED + 5)  # the dropout mask, on every device
            step(state, batch)
            torch.cuda.synchronize()
            runs.append(({k: p.grad.clone() for k, p in model.named_parameters()},
                         {k: v.clone() for k, v in model.state_dict().items()}))
        (g1, s1), (g2, s2) = runs
        bn = [k for k in s1 if k.endswith((".mean", ".var"))]
        groups = {"gradients": (g1, g2, list(g1)),
                  "updated parameters": (s1, s2, [k for k in s1 if k not in bn]),
                  "BN statistics": (s1, s2, bn)}
        differ = {w: [k for k in keys if not torch.equal(a[k], b[k])]
                  for w, (a, b, keys) in groups.items()}
        print(f"determinism, {label} train step B{SEG_B}x{SEG_N}, twice from one state: " +
              ", ".join(f"{len(keys) - len(differ[w])} of {len(keys)} {w}"
                        for w, (_, _, keys) in groups.items()) + " equal to the bit")
        bad = [k for keys in differ.values() for k in keys]
        if bad:
            failed.append(f"{label}: {len(bad)} tensors (first: {bad[0]})")
        models[label] = (model, init)
    for label, (model, init) in models.items():
        model.load_state_dict(init)
        state, step = seg_trainer(model, SEG_B)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                step(state, batch)
                torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        flagged = sorted({str(w.message).split("\n")[0][:160] for w in caught})
        print(f"determinism, {label}: torch.use_deterministic_algorithms(warn_only=True) flags "
              f"{len(flagged)} op(s) in a train step" + "".join(f"\n  - {m}" for m in flagged))
    if failed:
        raise RuntimeError("determinism: two train steps from one state differ, " +
                           "; ".join(failed))


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
             ("N 10241, the cluster design's smallest", cloud(9, 2, 10241, dev), 500),
             ("all points equal B2 N20000 -> 500 (cluster)",
              cloud(10, 2, 1, dev).expand(2, 20000, 3).contiguous(), 500),
             ("N 278528 -> 2000, the cluster design's largest", cloud(11, 1, 278528, dev), 2000),
             ("N 278529 -> 2000, the grid design's smallest", cloud(12, 1, 278529, dev), 2000),
             ("all points equal N278529 -> 300 (grid)",
              cloud(13, 1, 1, dev).expand(1, 278529, 3).contiguous(), 300),
             # From 8 points a thread a thread keeps its largest running
             # minimum between picks: ties and minima of 0 there.
             ("duplicate points N131072 -> 4096 in one thread's rows (cluster, 8 a thread)",
              cloud(14, 1, 131072, dev, dup=131072 - 4096), 4096),
             ("duplicate points N1200000 -> 1000 (grid, 17 a thread)",
              cloud(15, 1, 1200000, dev, dup=600000), 1000)]
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
    # The register list (csrc/knn_select.cuh): equal points, exact ties,
    # k of 64 and 128, copies on both sides of segment boundaries.
    eq = cloud(18, 1, 1, dev).expand(1, 20000, 3).contiguous()
    cases.append(("all equal 20000 k32 (self)", eq, eq, 32))
    lat = lattice(24, dev)
    cases.append(("lattice 13824 k64 (self)", lat, lat, 64))
    half = torch.from_numpy((rng.randint(0, 47, (1, 3000, 3)) / 2.0).astype(np.float32)).to(dev)
    cases.append(("lattice 3000q/13824 k3, half-integer queries", lat, half, 3))
    s = scene(19, 20000, dev)
    cases.append(("scene 20000 k128 (self)", s, s, 128))
    t = scene(20, 6001, dev).repeat(1, 3, 1)
    cases.append(("three copies of each point 18003 k16 (self)", t, t, 16))
    return cases


def phase_spatial(dev) -> float:
    from pointasnl_tpu_torch.ops import geometry
    from pointasnl_tpu_torch.ops.cuda import knn_spatial

    worst = 0.0
    for name, support, query, k in spatial_cases(dev):
        got = knn_spatial.knn_point(k, support, query)
        want = geometry.knn_point(k, support, query)
        torch.cuda.synchronize()
        if "all equal" in name and not torch.equal(
                got[1].long(), torch.arange(k, device=dev).expand(*got[1].shape)):
            raise RuntimeError(f"spatial knn {name}: the indices are not 0 .. k-1")
        worst = max(worst, check_knn(f"spatial knn {name}", got, want))
        del got, want
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
            "knn_spatial": 3 * SCENE_REQUESTS, "knn_streaming": 0, "flash_fwd": 0,
            "flash_bwd": 0, "gather_bwd": 0}
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


def flash_inputs(name: str, B, M, N, C, D, qmul, dev):
    """q (times qmul), k, v and an upstream gradient dO of a flash case."""
    rng = np.random.RandomState(sum(map(ord, name)))
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
                   for shape in ((B, M, C), (B, N, C), (B, N, D), (B, M, D)))
    return q * qmul, k, v, do


def dense64(q, k, v, do, scale: float):
    """Dense float64 attention, its logsumexp and (with do) its gradients."""
    q, k, v = (t.double().requires_grad_(do is not None) for t in (q, k, v))
    s = torch.einsum("bmc,bnc->bmn", q, k) * scale
    o = torch.einsum("bmn,bnd->bmd", torch.softmax(s, dim=-1), v)
    grads = torch.autograd.grad(o, (q, k, v), do.double()) if do is not None else None
    return o.detach(), torch.logsumexp(s, dim=-1).detach(), grads


def flash_close(what: str, got, plain, ref64, rtol: float) -> float:
    """Check |kernel - plain| against rtol of the scale plus YARDSTICK times
    the plain version's distance from float64; return the error."""
    f32 = float((plain.double() - ref64).abs().max())
    limit = rtol * float(ref64.abs().max()) + YARDSTICK * f32
    err = float((got.double() - plain.double()).abs().max())
    if not err <= limit:
        raise RuntimeError(f"flash {what}: |kernel - plain| {err:.3e} over its limit {limit:.3e}")
    return err


def phase_flash(dev):
    """The flash kernels against their plain versions: the largest |kernel -
    plain| of the forward (o, lse) and of the backward (dq, dk, dv)."""
    from pointasnl_tpu_torch.ops import flash_attention as fa
    from pointasnl_tpu_torch.ops.cuda import flash_attention as cuda_flash

    worst = {"flash_fwd": 0.0, "flash_bwd": 0.0}
    cases = [(n, c, True) for n, c in FLASH_CASES.items()]
    cases += [(n, c, False) for n, c in FLASH_FWD_ONLY.items()]
    for name, (B, M, N, C, D, scaled, qmul), backward in cases:
        scale = fa.flash_scale(C, scaled)
        q, k, v, do = flash_inputs(name, B, M, N, C, D, qmul, dev)
        o, lse = cuda_flash.flash_forward(q, k, v, scale)
        po, plse = fa.flash_forward_reference(q, k, v, scale)
        if backward:
            grads = cuda_flash.flash_backward(q, k, v, o, lse, do, scale)
            pgrads = fa.flash_backward_reference(q, k, v, po, plse, do, scale)
        torch.cuda.synchronize()
        o64, lse64, g64 = dense64(q, k, v, do if backward else None, scale)
        errs = {"o": flash_close(f"{name} o", o, po, o64, FLASH_RTOL),
                "lse": flash_close(f"{name} lse", lse, plse, lse64, FLASH_RTOL)}
        worst["flash_fwd"] = max(worst["flash_fwd"], errs["o"], errs["lse"])
        if backward:
            for what, got, plain, ref in zip(("dq", "dk", "dv"), grads, pgrads, g64):
                errs[what] = flash_close(f"{name} {what}", got, plain, ref, FLASH_GRAD_RTOL)
                worst["flash_bwd"] = max(worst["flash_bwd"], errs[what])
        print(f"flash {name}, B{B} M{M} N{N} C{C} D{D}: within tolerance; max |kernel - plain| "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        del q, k, v, do, o64, g64
    return worst


def spatial_bound(B, N, M, k):
    # Bytes: the clouds in and the rows out, each once. The operations the
    # function needs are its M * k pairs' distances, far below the bytes'
    # time; the pairs a kernel tests depend on how it prunes, so they are
    # reported beside the bound (pairs_tested), not counted in it.
    return bound(B * (N + M) * 12 + B * M * k * 8, B * M * k * 9)


def gather_bound(B, n, R, C):
    # dout, idx and the output each once; one add a gathered element.
    return bound(B * R * C * 4 + B * R * 4 + B * n * C * 4, B * R * C)


def time_kernels(dev, card, gathers):
    """Kernel vs plain times, and bounds, at every slice's shapes; `gathers`
    are the (dout, idx, n) of a seg step's gather backwards."""
    from pointasnl_tpu_torch.ops import geometry
    from pointasnl_tpu_torch.ops.cuda import ball_query, fps, knn, knn_spatial, knn_streaming

    rows = {name: [] for name in KERNELS}

    def add(name, path, shape, plain, kernel, bnd, timing=LIGHT, plain_timing=None,
            symbol=None, library=None, search=None, **extra):
        call_ms, p_ms = in_turns(plain, kernel, timing, plain_timing)
        dev_ms = device_ms(kernel, symbol or KERNELS[name]["symbol"])
        if dev_ms is None:
            print(f"time {name} {shape}: the profiler saw no launch; ms is the call time")
            extra["ms_is_call_ms"] = True
        lib_ms = statistics.median(time_ms(library, *timing)) if library else None
        if search:  # a resident or spatial search: the streaming kernel on it too, off the path
            stream = lambda: knn_streaming.knn_point(*search)
            extra["streaming_ms"] = (device_ms(stream, KERNELS["knn_streaming"]["symbol"])
                                     or statistics.median(time_ms(stream, *timing)))
        rows[name].append({"path": path, "shape": shape,
                           "ms": call_ms if dev_ms is None else dev_ms, "call_ms": call_ms,
                           "plain_ms": p_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                           "library_ms": lib_ms, **extra})

    for B, N, npoint in FPS_SHAPES:
        x = cloud(11, B, N, dev)
        add("fps", "cls", f"B{B} N{N}->{npoint}", lambda: geometry.farthest_point_sample(npoint, x),
            lambda: fps.farthest_point_sample(npoint, x), fps_bound(B, N, npoint), fps_n=N,
            fps_npoint=npoint)
    for B, N, M, k in KNN_SHAPES:
        s = cloud(12, B, N, dev)
        q = geometry.gather_point(s, fps.farthest_point_sample(M, s))
        add("knn_resident", "cls", f"B{B} {M}q/{N} k{k}", lambda: geometry.knn_point(k, s, q),
            lambda: knn.knn_point(k, s, q), knn_bound(B, N, M, k), search=(k, s, q))
    levels = seg_levels(dev, seed=22)
    for a, n in zip(levels, SEG_LEVELS[1:]):
        add("fps", "seg", f"B{SEG_B} N{a.shape[1]}->{n}",
            lambda: geometry.farthest_point_sample(n, a), lambda: fps.farthest_point_sample(n, a),
            fps_bound(SEG_B, a.shape[1], n), timing=HEAVY if n >= 320 else LIGHT,
            fps_n=a.shape[1], fps_npoint=n)
    for si, qi, k in SEG_KNN:
        s, q = levels[si], levels[qi]
        N, M = s.shape[1], q.shape[1]
        add("knn_resident", "seg", f"B{SEG_B} {M}q/{N} k{k}", lambda: geometry.knn_point(k, s, q),
            lambda: knn.knn_point(k, s, q), knn_bound(SEG_B, N, M, k),
            timing=HEAVY if N * M >= 10**7 else LIGHT, search=(k, s, q))
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
            symbol=FPS_CLUSTER_SYMBOL if N > 10240 else None, fps_n=N, fps_npoint=n)
    for name, s, q, k in scene_spatial_shapes(levels):
        N, M = s.shape[1], q.shape[1]
        tested = knn_spatial.pairs_tested(k, s, q)  # one untimed call that counts
        add("knn_spatial", "scene", f"B1 {name}", lambda: geometry.knn_point(k, s, q),
            lambda: knn_spatial.knn_point(k, s, q), spatial_bound(1, N, M, k), (10, 2), SLOW,
            search=(k, s, q), pairs_tested=tested, pairs_tested_share=tested / (N * M))
    for si, qi, k in SEG_KNN:
        s, q = levels[si], levels[qi]
        N, M = s.shape[1], q.shape[1]
        if N <= 12288:
            add("knn_resident", "scene", f"B1 {M}q/{N} k{k}", lambda: geometry.knn_point(k, s, q),
                lambda: knn.knn_point(k, s, q), knn_bound(1, N, M, k),
                timing=HEAVY if N * M >= 10**7 else LIGHT, search=(k, s, q))
    # The flash seg step's four non-local cells; F.scaled_dot_product_attention
    # at the same shapes is the yardstick (library_ms): the forward, and for
    # the backward the forward with its backward.
    from pointasnl_tpu_torch.ops import flash_attention as fa
    from pointasnl_tpu_torch.ops.cuda import flash_attention as cuda_flash

    for B, M, N, C, D in FLASH_SEG:
        q, k, v, do = flash_inputs("time", B, M, N, C, D, 1.0, dev)
        scale = fa.flash_scale(C)
        o, lse = cuda_flash.flash_forward(q, k, v, scale)
        timing = HEAVY if M * N >= 10**7 else LIGHT

        def sdpa_fwd_bwd(q=q, k=k, v=v, do=do, scale=scale):
            q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
            out = torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=scale)
            torch.autograd.grad(out, (q, k, v), do)

        shape = f"B{B} {M}q/{N} C{C} D{D}"
        add("flash_fwd", "seg_flash", shape,
            lambda q=q, k=k, v=v, s=scale: fa.flash_forward_reference(q, k, v, s),
            lambda q=q, k=k, v=v, s=scale: cuda_flash.flash_forward(q, k, v, s),
            flash_fwd_bound(B, M, N, C, D), timing,
            library=lambda q=q, k=k, v=v, s=scale:
                torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=s))
        add("flash_bwd", "seg_flash", shape,
            lambda a=(q, k, v, o, lse, do, scale): fa.flash_backward_reference(*a),
            lambda a=(q, k, v, o, lse, do, scale): cuda_flash.flash_backward(*a),
            flash_bwd_bound(B, M, N, C, D), timing, symbol=flash_bwd_symbols(B, M, N, C, D),
            library=sdpa_fwd_bwd, bound_f32_ms=flash_bwd_bound(B, M, N, C, D, None)[0])

    # The seg step's gather backwards; index_add_ (atomics on the card) is
    # the one PyTorch call computing the same sums, in another order.
    from pointasnl_tpu_torch.ops.cuda import gather_backward

    def sorted_anew(dout, idx, n):  # a call with its sort: the plan kept on idx dropped
        idx.__dict__.pop("_gather_backward_plans", None)
        return gather_backward.gather_backward(dout, idx, n)

    for dout, idx, n in gathers:
        B, R, C = dout.shape
        add("gather_bwd", "seg", f"B{B} {R} rows -> {n} C{C}",
            lambda a=(dout, idx, n): gather_backward.gather_backward_reference(*a),
            lambda a=(dout, idx, n): sorted_anew(*a), gather_bound(B, n, R, C),
            plain_timing=SLOW, library=lambda a=(dout, idx, n): index_add(*a))

    for name, rs in rows.items():
        for r in rs:
            tested = (f", pairs tested {r['pairs_tested']} ({100 * r['pairs_tested_share']:.3f} % "
                      f"of M x N)" if "pairs_tested" in r else "")
            lib_name = "index_add_" if name == "gather_bwd" else "F.scaled_dot_product_attention"
            lib = (f", {lib_name} {r['library_ms']:.4f} ms"
                   f"{' (forward and backward)' if name == 'flash_bwd' else ''}"
                   if r["library_ms"] is not None else "")
            if "streaming_ms" in r:
                lib += f", the streaming kernel {r['streaming_ms']:.4f} ms"
            if name == "fps":
                tested += fps_notes(r)
            tested += knn_notes(name, r)
            if "bound_f32_ms" in r:
                tested += (f" ({FLASH_BWD_TF32_PASSES} TF32 passes on the tensor cores; at the "
                           f"float32 rate {r['bound_f32_ms']:.5f} ms)")
            where = "by CUDA events" if r.get("ms_is_call_ms") else "on the device"
            print(f"time {name} [{r['path']}] {r['shape']}: kernel {r['ms']:.4f} ms {where}, "
                  f"{r['call_ms']:.4f} ms a call back to back, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})"
                  f"{lib}{tested}  [{card}]")
    g = rows["gather_bwd"]
    print(f"time gather_bwd [seg]: a step's {len(g)} calls, each with its sort, "
          f"{sum(r['call_ms'] for r in g):.4f} ms back to back against index_add_'s "
          f"{sum(r['library_ms'] for r in g):.4f} ms; {sum(r['ms'] for r in g):.4f} ms of it "
          f"the kernel on the device; a step sorts {SEG_GATHER_SORTS} index tensors for them  "
          f"[{card}]")
    fwd, bwd = rows["flash_fwd"][0], rows["flash_bwd"][0]  # level 1
    both = fwd["ms"] + bwd["ms"]
    print(f"time flash [seg_flash] {fwd['shape']}: forward and backward {both:.4f} ms on the "
          f"device against F.scaled_dot_product_attention's {bwd['library_ms']:.4f} ms (forward "
          f"and backward), {'below' if both < bwd['library_ms'] else 'NOT below'} it  [{card}]")
    return rows


def percentiles(samples):
    s = sorted(samples)
    return statistics.median(s), s[max(int(0.9 * len(s)) - 1, 0)]


def time_seg(card, runs: dict, batch) -> dict:
    """The seg train step and serve forward of each model of `runs` (label:
    (state, step, infer, profiled launches a step, trace file)), timed in
    turns (A, B, B, A, 5 samples by CUDA events each time, so 10 a model),
    then the host wall and peak memory of 5 steps and a profiler window
    over 3 steps of each. Returns label: (step p50, serve p50)."""
    pts = batch["points"]
    order = list(runs) + list(runs)[::-1]
    steps, serves = {k: [] for k in runs}, {k: [] for k in runs}
    for label in order:
        state, step = runs[label][:2]
        steps[label] += time_ms(lambda: step(state, batch), reps=5, warmup=2)
    for label in order:
        infer = runs[label][2]
        serves[label] += time_ms(lambda: infer(pts), reps=5, warmup=2)
    out = {}
    for label, (state, step, _, per_step, trace) in runs.items():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(5):
            step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 5 * 1e3
        (step_p50, step_p90), (serve_p50, serve_p90) = percentiles(steps[label]), percentiles(
            serves[label])
        print(f"time {label} train step B{SEG_B}x{SEG_N}: p50 {step_p50:.3f} ms, p90 "
              f"{step_p90:.3f} ms of 10 (CUDA events, in turns with {' and '.join(runs)}); "
              f"{wall:.3f} ms host wall; {SEG_B * SEG_N / step_p50 * 1e3:.0f} points/s at p50; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
        print(f"time {label} serve forward B{SEG_B}x{SEG_N}: p50 {serve_p50:.3f} ms, p90 "
              f"{serve_p90:.3f} ms of 10 (CUDA events, in turns); "
              f"{SEG_B * SEG_N / serve_p50 * 1e3:.0f} points/s at p50  [{card}]")
        profile_window(lambda: step(state, batch), 3, per_step, card, f"{label} train steps",
                       trace)
        out[label] = step_p50, serve_p50
    return out


def time_paths(dev, card, cls_infer, seg_state, seg_step, seg_infer, scene_infer, scene_x,
               flash_state, flash_step, flash_infer):
    x = cloud(13, BATCH, NUM_POINT, dev)
    fwd, p90 = percentiles(time_ms(lambda: cls_infer(x), reps=50))
    print(f"time cls forward B{BATCH}x{NUM_POINT}: p50 {fwd:.3f} ms, p90 {p90:.3f} ms of 50 "
          f"(CUDA events); {BATCH * NUM_POINT / fwd * 1e3:.0f} points/s at p50  [{card}]")

    batch = seg_batch(500, SEG_B, SEG_N, SEG_SIDE, dev)
    dense = {"fps": 4, "knn": 11, "knn_spatial": 0, "knn_streaming": 0, "ball_query": 1,
             "flash_fwd": 0, "flash_bwd": 0, "gather_bwd": SEG_GATHER_BWD}
    # The dense step and the same step under nl_use_flash, in turns; a flash
    # backward is three CUDA kernels at each seg level (delta, then dQ, dK
    # and dV, then the split dQ's sum).
    seg = time_seg(card, {
        "seg": (seg_state, seg_step, seg_infer, dense, "profile_seg_step.json"),
        "flash seg": (flash_state, flash_step, flash_infer,
                      {**dense, "flash_fwd": 4, "flash_bwd": 12}, "profile_flash_seg_step.json"),
    }, batch)
    (step_p50, serve_p50), (flash_p50, flash_serve_p50) = seg["seg"], seg["flash seg"]

    torch.cuda.reset_peak_memory_stats()
    scene_p50, scene_p90 = percentiles(time_ms(lambda: scene_infer(scene_x), reps=10, warmup=1))
    print(f"time whole-scene request B1x{SCENE_N}: p50 {scene_p50:.3f} ms, p90 {scene_p90:.3f} "
          f"ms of 10 (CUDA events); {SCENE_N / scene_p50 * 1e3:.0f} points/s at p50; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    profile_window(lambda: scene_infer(scene_x), 2,
                   {"fps": 4, "knn": 8, "knn_spatial": 3, "knn_streaming": 0, "ball_query": 0,
                    "flash_fwd": 0, "flash_bwd": 0, "gather_bwd": 0}, card,
                   "whole-scene requests", "profile_whole_scene.json")
    return {"cls_forward_ms": fwd, "seg_step_ms": step_p50, "seg_serve_ms": serve_p50,
            "flash_seg_step_ms": flash_p50, "flash_seg_serve_ms": flash_serve_p50,
            "scene_ms": scene_p50}


# Each ported kernel's launches in a profiler trace, by the names they hold.
PROFILE_SYMBOLS = {"fps": ("fps_kernel", FPS_CLUSTER_SYMBOL, FPS_GRID_SYMBOL),
                   "knn": ("knn_kernel",), "knn_spatial": ("knn_spatial_kernel",),
                   "knn_streaming": ("knn_stream_kernel",), "ball_query": ("ball_query_kernel",),
                   "flash_fwd": ("flash_fwd_kernel",),
                   "flash_bwd": ("flash_bwd_delta_kernel", "flash_bwd_kernel",
                                 "flash_bwd_dq_sum_kernel"),
                   "gather_bwd": ("gather_backward_kernel",)}


def profile_window(fn, n: int, per_call: dict, card, label: str, out_name: str):
    """One torch.profiler window over n calls of fn, after one traced and
    dropped warm-up call: device-busy share and device time by kernel name,
    the ported kernels picked out with the launches recorded (`per_call`
    launches expected a call). Returns the window's device events."""
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
        return events
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
    return events

def timed(fn):
    """fn()'s result and the ms its call took by CUDA events (one call)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def streaming_cases(dev):
    """(name, support, query, k, self rows or None) of the streaming kNN's
    checks against its plain version."""
    g = cloud(30, 1, 3001, dev)  # N not a multiple of the 1024-point chunk
    self_g = torch.arange(3001, device=dev)[None]
    cases = [(f"self 3001 k{k}", g, g, k, self_g) for k in (1, 3, 32, 128, 129, 512)]
    cases.append(("k > N, B2 37q/100 k300", cloud(31, 2, 100, dev), cloud(32, 2, 37, dev), 300,
                  None))
    d = cloud(33, 1, 4000, dev, dup=2000)  # ties: the lower index first
    cases.append(("duplicates 2000q/4000 k32", d, d[:, 1000:3000].contiguous(), 32, None))
    cases.append(("disjoint B3 700q/5000 k16", cloud(34, 3, 5000, dev), cloud(35, 3, 700, dev),
                  16, None))
    c = cloud(36, 1, 1025, dev)
    cases.append(("N 1025, a chunk and a point (self) k8", c, c, 8,
                  torch.arange(1025, device=dev)[None]))
    x = scene(37, 200000, dev)
    cases.append(("scene 4000q/200000 k32", x, x[:, ::50].contiguous(), 32,
                  torch.arange(0, 200000, 50, device=dev)[None]))
    return cases


def phase_streaming(dev) -> float:
    """The streaming kNN kernel against its plain version, and against the
    spatial kernel on slice 3's 131072-point stem self-search."""
    from pointasnl_tpu_torch.ops import geometry
    from pointasnl_tpu_torch.ops.cuda import knn_spatial, knn_streaming

    worst = 0.0
    for name, support, query, k, self_rows in streaming_cases(dev):
        got = knn_streaming.knn_point(k, support, query)
        want = geometry.knn_point(k, support, query)
        torch.cuda.synchronize()
        worst = max(worst, check_knn(f"streaming knn {name}", got, want, self_rows))
        del got, want
    x = scene(0, SCENE_N, dev)
    got = knn_streaming.knn_point(32, x, x)
    want = knn_spatial.knn_point(32, x, x)
    torch.cuda.synchronize()
    if not (torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])):
        raise RuntimeError(f"streaming knn: {int((got[1] != want[1]).sum())} indices differ from "
                           f"the spatial kernel's on the {SCENE_N}-point stem")
    print(f"streaming knn {SCENE_N}q/{SCENE_N} k32 (slice 3's stem): indices and d2 equal to the "
          f"spatial kernel's")
    return worst


def big_levels(dev):
    """The xyz of a B1 x BIG_N request's five levels, FPS of FPS of the
    scene, each level's FPS (the grid design, then the cluster design) held
    to the plain version on its whole chain, the grid design against the
    cluster design on the whole chain of the level that the cluster design
    takes at its largest N, and at 131072 points. Returns (levels, the plain
    versions' ms by (N, npoint), one call each)."""
    from pointasnl_tpu_torch.ops import geometry
    from pointasnl_tpu_torch.ops.cuda import fps

    levels, plain_ms = [scene(0, BIG_N, dev)], {}
    for n in BIG_LEVELS[1:]:
        a = levels[-1]
        N, name = a.shape[1], fps.design(a.shape[1], fps.stated_cluster_max_n())
        if name != ("grid" if N > fps.CLUSTER_MAX_N else "cluster"):
            raise RuntimeError(f"fps B1 N{N}: routed to the {name} design")
        got = fps.farthest_point_sample(n, a)
        want, plain_ms[(N, n)] = timed(lambda: geometry.farthest_point_sample(n, a))
        if got.shape != want.shape or not torch.equal(got, want):
            raise RuntimeError(f"fps B1 N{N} -> {n} ({name} design): kernel and plain differ at "
                               f"{int((got != want).sum())} picks")
        print(f"fps B1 N{N} -> {n} ({name} design, the request's chain): indices exact")
        if N == fps.CLUSTER_MAX_N:  # the grid design on the same whole chain
            grid = fps._sample("grid", n, a)
            if not torch.equal(grid, got):
                raise RuntimeError(f"fps B1 N{N} -> {n}: grid and cluster designs differ at "
                                   f"{int((grid != got).sum())} picks")
            print(f"fps B1 N{N} -> {n}: grid design equal to the cluster design")
        levels.append(geometry.gather_point(a, got))
    s3 = scene(0, SCENE_N, dev)
    grid = fps._sample("grid", SCENE_LEVELS[1], s3)
    cluster = fps._sample("cluster", SCENE_LEVELS[1], s3)
    torch.cuda.synchronize()
    if not torch.equal(grid, cluster):
        raise RuntimeError(f"fps B1 N{SCENE_N} -> {SCENE_LEVELS[1]}: grid and cluster designs "
                           f"differ at {int((grid != cluster).sum())} picks")
    print(f"fps B1 N{SCENE_N} -> {SCENE_LEVELS[1]}: grid design equal to the cluster design")
    return levels, plain_ms


def phase_big_searches(levels, card):
    """A B1 x BIG_N request's kNN searches but the stem's (phase_big_scene
    checks that one), each routed as in a request and launched on its whole
    query set: the rows, all of them or BIG_PAIRS // N seeded ones where the
    plain version would take longer, held to the plain version. The
    streaming kernel runs each spatial search too, off the path: equal to
    the spatial kernel, and timed beside it. Returns (max |d2 err| by
    kernel, each search's shape, kernel, call ms, plain ms and the rows it
    was timed on, and for a spatial search its pairs tested, in the
    request's order)."""
    from pointasnl_tpu_torch import ops
    from pointasnl_tpu_torch.ops import geometry
    from pointasnl_tpu_torch.ops.cuda import knn, knn_spatial, knn_streaming

    routes, worst, searches = {}, {}, []
    for si, qi, k in SEG_KNN:
        s, q = levels[si], levels[qi]
        N, M = s.shape[1], q.shape[1]
        route = ops.dispatch.knn_route(N, k)
        routes[route] = routes.get(route, 0) + 1
        if si == qi == 0:
            continue
        got_d, got_i = ops.knn_point(k, s, q)
        rows = torch.arange(M, device=q.device)
        if M * N > BIG_PAIRS:
            rows = torch.from_numpy(np.sort(np.random.RandomState(si * 5 + qi).choice(
                M, BIG_PAIRS // N, replace=False))).to(q.device)
        want, plain_ms = timed(lambda: geometry.knn_point_chunked(k, s, q[:, rows].contiguous()))
        err = check_knn(f"{route} knn B1 {M}q/{N} k{k} (slice 5's request), {len(rows)} rows",
                        (got_d[:, rows], got_i[:, rows]), want)
        name = "knn_resident" if route == "resident" else f"knn_{route}"
        worst[name] = max(worst.get(name, 0.0), err)
        search = {"name": name, "shape": f"B1 {M}q/{N} k{k}", "plain_ms": plain_ms,
                  "plain_shape": f"B1 {len(rows)}q/{N} k{k}", "bound": spatial_bound(1, N, M, k)
                  if route == "spatial" else knn_bound(1, N, M, k)}
        if route == "spatial":  # the streaming kernel on the same search, off the path
            spatial = lambda: knn_spatial.knn_point(k, s, q)
            streaming = lambda: knn_streaming.knn_point(k, s, q)
            st_d, st_i = streaming()
            if not (torch.equal(st_i, got_i) and torch.equal(st_d, got_d)):
                raise RuntimeError(f"streaming knn B1 {M}q/{N} k{k}: differs from the spatial "
                                   f"kernel")
            sp_ms, st_ms = in_turns(streaming, spatial, (4, 1))
            print(f"time knn_spatial [scene_2228224] B1 {M}q/{N} k{k}: {sp_ms:.4f} ms a call, "
                  f"the streaming kernel {st_ms:.4f} ms a call (equal results); in turns, by "
                  f"CUDA events  [{card}]")
            tested = knn_spatial.pairs_tested(k, s, q)
            search.update(call_ms=sp_ms, streaming_call_ms=st_ms, pairs_tested=tested,
                          pairs_tested_share=tested / (N * M))
            del st_d, st_i
        else:
            search["call_ms"] = statistics.median(time_ms(lambda: knn.knn_point(k, s, q), 4, 1))
        searches.append(search)
        del got_d, got_i
    want = {r: BIG_LAUNCHES[f"knn_{r}"] for r in ("streaming", "spatial", "resident")}
    if routes != want:
        raise RuntimeError(f"slice 5's searches route {routes}, expected {want}")
    return worst, searches


def phase_big_scene(dev, card, levels, fps_plain_ms, searches):
    """Slice 5: the stem's kNN checks, then BIG_REQUESTS whole-scene requests
    of B1 x BIG_N after a warm-up (launch counts, logits, peak memory, p50), a
    profiler window over one request, and the times of the path's streaming
    kNN and FPS (on `levels`, big_levels'), and of its resident and spatial
    searches (`searches`, phase_big_searches'). Returns (launches, kernel
    rows, max |d2 err|)."""
    from pointasnl_tpu_torch import ops
    from pointasnl_tpu_torch.models import PointASNLSemSegRes
    from pointasnl_tpu_torch.ops import geometry
    from pointasnl_tpu_torch.ops.cuda import fps, knn_streaming
    from pointasnl_tpu_torch.serve import make_inference_fn

    model = PointASNLSemSegRes(SEG_CLASSES, nl_kv_block_size=SCENE_BLOCK,
                               generator=torch.Generator().manual_seed(SEED), device=dev)
    infer = make_inference_fn(model)
    scenes = levels[:1] + [scene(r, BIG_N, dev) for r in range(1, BIG_REQUESTS)]
    x = scenes[0]
    rows = torch.from_numpy(np.sort(np.random.RandomState(50).choice(BIG_N, BIG_ROWS,
                                                                     replace=False))).to(dev)
    sub = x[:, rows].contiguous()
    # The stem's search, routed as in a request, on BIG_ROWS of its rows.
    if ops.dispatch.knn_route(BIG_N, 32) != "streaming":
        raise RuntimeError("the stem's kNN is not routed to the streaming kernel")
    subset = ops.knn_point(32, x, sub)
    err = check_knn(f"streaming knn B1 {BIG_ROWS}q/{BIG_N} k32 (the stem's rows)", subset,
                    geometry.knn_point_chunked(32, x, sub))

    t0 = time.perf_counter()
    infer(x)
    torch.cuda.synchronize()
    print(f"big scene: warm-up request in {time.perf_counter() - t0:.2f} s")
    # The request's own stem graph, M = N: its rows are the subset's.
    (full_d, full_i), full_ms = timed(lambda: ops.knn_point(32, x, x))
    if not (torch.equal(full_i[:, rows], subset[1]) and torch.equal(full_d[:, rows], subset[0])):
        raise RuntimeError("streaming knn: the M = N launch's rows differ from the subset's")
    print(f"streaming knn B1 {BIG_N}q/{BIG_N} k32 (the stem graph): its {BIG_ROWS} checked rows "
          f"equal the subset launch's; {full_ms:.3f} ms a call  [{card}]")
    del full_d, full_i

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for r, xs in enumerate(scenes):
        out, ms = timed(lambda: infer(xs))
        times.append(ms)
        if out.shape != (1, BIG_N, SEG_CLASSES) or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"big-scene request {r}: logits {tuple(out.shape)} not all finite")
        del out
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    p50 = statistics.median(times)
    print(f"big scene: {BIG_REQUESTS} requests of B1x{BIG_N} (nl_kv_block_size {SCENE_BLOCK}); "
          f"launches {launches}; logits (1, {BIG_N}, {SEG_CLASSES}) finite; peak memory "
          f"{peak:.2f} GiB")
    want = {k: v * BIG_REQUESTS for k, v in BIG_LAUNCHES.items()}
    if launches != want:
        raise RuntimeError(f"big-scene launches {launches}, expected {BIG_LAUNCHES} a request")
    print(f"time big-scene request B1x{BIG_N}: p50 {p50:.3f} ms of {BIG_REQUESTS} "
          f"({', '.join(f'{t:.3f}' for t in times)} ms, CUDA events); "
          f"{BIG_N / p50 * 1e3:.0f} points/s at p50; peak memory {peak:.2f} GiB  [{card}]")
    events = profile_window(lambda: infer(x), 1, {"fps": 4, "knn": 2, "knn_spatial": 8,
                                                  "knn_streaming": 1, "ball_query": 0,
                                                  "flash_fwd": 0, "flash_bwd": 0,
                                                  "gather_bwd": 0},
                            card, "big-scene requests", "profile_big_scene.json")

    # The path's streaming kNN and FPS: device ms from the profiled request
    # (its launches of a kernel in the order they ran, so FPS level by
    # level), call ms by CUDA events; the plain kNN on BIG_ROWS rows (the
    # whole search has 544 times as many), the plain FPS as big_levels
    # timed it. Another profiler window after a request's may record no
    # launch (seen on the card), so the BIG_ROWS check row, which is off the
    # path, has CUDA-event times only.
    def in_request(symbol, count):
        ms = sorted((e.time_range.start, e.time_range.elapsed_us() / 1e3) for e in events
                    if symbol in e.name)
        if len(ms) != count:
            print(f"profile, big-scene requests: {len(ms)} of {count} launches of {symbol} "
                  f"recorded; their ms are the call times")
            return [None] * count
        return [t for _, t in ms]

    # The request's four FPS levels, routed by the caps the library states.
    routes = [fps.design(N, fps.stated_cluster_max_n()) for N in BIG_LEVELS[:-1]]
    symbol = {"grid": FPS_GRID_SYMBOL, "cluster": FPS_CLUSTER_SYMBOL}
    request_ms = {"knn_streaming": in_request(KERNELS["knn_streaming"]["symbol"], 1),
                  **{symbol[d]: in_request(symbol[d], routes.count(d)) for d in symbol}}
    for name in ("knn_resident", "knn_spatial"):  # in the request's order, searches' order
        request_ms[name] = in_request(KERNELS[name]["symbol"], BIG_LAUNCHES[name])
    rows_out = {"knn_streaming": [], "fps": [], "knn_resident": [], "knn_spatial": []}

    def row(name, shape, ms, call_ms, plain_ms, bnd, plain_shape=None, path="scene_2228224",
            **extra):
        rows_out[name].append({"path": path, "shape": shape, "ms": ms, "call_ms": call_ms,
                               "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                               "library_ms": None,
                               **({"plain_shape": plain_shape} if plain_shape else {}),
                               **({"ms_is_call_ms": True} if ms == call_ms else {}), **extra})

    # The streaming kernel prunes, so its bound is what the inputs need
    # (spatial_bound, as for the spatial kernel), with the pairs it tested
    # beside it; knn_bound, brute force's, stays beside it for comparison.
    def pruned(M):
        q = x if M == BIG_N else sub
        tested = knn_streaming.pairs_tested(32, x, q)
        return {"pairs_tested": tested, "pairs_tested_share": tested / (BIG_N * M),
                "brute_bound_ms": knn_bound(1, BIG_N, M, 32)[0]}

    sub_ms, sub_plain_ms = in_turns(lambda: geometry.knn_point_chunked(32, x, sub),
                                    lambda: ops.knn_point(32, x, sub), (2, 1))
    row("knn_streaming", f"B1 {BIG_N}q/{BIG_N} k32 (stem, self)",
        request_ms["knn_streaming"][0] or full_ms, full_ms, sub_plain_ms,
        spatial_bound(1, BIG_N, BIG_N, 32), plain_shape=f"B1 {BIG_ROWS}q/{BIG_N} k32",
        **pruned(BIG_N))
    row("knn_streaming", f"B1 {BIG_ROWS}q/{BIG_N} k32 (the stem's rows)", sub_ms, sub_ms,
        sub_plain_ms, spatial_bound(1, BIG_N, BIG_ROWS, 32), path="check", **pruned(BIG_ROWS))
    for level, (a, n) in enumerate(zip(levels, BIG_LEVELS[1:])):
        N, route = a.shape[1], routes[level]
        call_ms = statistics.median(time_ms(lambda a=a, n=n: fps.farthest_point_sample(n, a),
                                            1 if N == BIG_N else 3, 1, warmup=0))
        d_ms = request_ms[symbol[route]][routes[:level].count(route)] or call_ms
        row("fps", f"B1 N{N}->{n} ({route} design)", d_ms, call_ms, fps_plain_ms[(N, n)],
            fps_bound(1, N, n), fps_n=N, fps_npoint=n)
    for name in ("knn_resident", "knn_spatial"):
        for r, ms in zip([r for r in searches if r["name"] == name], request_ms[name]):
            extra = {k: r[k] for k in ("pairs_tested", "pairs_tested_share", "streaming_call_ms")
                     if k in r}
            row(name, r["shape"], ms or r["call_ms"], r["call_ms"], r["plain_ms"], r["bound"],
                plain_shape=r["plain_shape"], **extra)
    for name, rs in rows_out.items():
        for r in rs:
            plain = f" on {r['plain_shape']}" if "plain_shape" in r else ""
            where = "by CUDA events" if r.get("ms_is_call_ms") else "on the device"
            tested = (f", pairs tested {r['pairs_tested']} ({100 * r['pairs_tested_share']:.4f} % "
                      f"of M x N)" if "pairs_tested" in r else "")
            if "brute_bound_ms" in r:
                tested += f", brute force's bound {r['brute_bound_ms']:.4f} ms"
            if name == "fps":
                tested += fps_notes(r)
            tested += knn_notes(name, r)
            print(f"time {name} [{r['path']}] {r['shape']}: kernel {r['ms']:.4f} ms {where}, "
                  f"{r['call_ms']:.4f} ms a call, plain {r['plain_ms']:.4f} ms{plain}, "
                  f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}){tested}  [{card}]")
    return launches, rows_out, err


def slice5(dev, card, mark):
    """Slice 5's checks, requests and kernel times: (launches a run of its
    requests, kernel rows, max |err| by kernel)."""
    torch.cuda.empty_cache()  # hand the earlier phases' cached blocks back
    errs = {"knn_streaming": phase_streaming(dev), "fps": 0.0}
    levels, fps_plain_ms = big_levels(dev)
    searched, searches = phase_big_searches(levels, card)
    mark("slice 5 kernel checks")
    launches, rows, err = phase_big_scene(dev, card, levels, fps_plain_ms, searches)
    errs["knn_streaming"] = max(errs["knn_streaming"], err)
    for name, e in searched.items():
        errs[name] = max(errs.get(name, 0.0), e)
    mark("slice 5")
    return launches, rows, errs


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
    errs.update(phase_flash(dev))
    mark("flash kernel checks")
    flash_state, flash_step, flash_infer, flash_launches, flash_serve_launches = phase_seg(
        dev, flash=True)
    phase_card_vs_cpu(dev, flash=True)
    mark("slice 4")
    gathers = phase_gather(dev)
    errs["gather_bwd"] = 0.0  # equal to the bit, or phase_gather raised
    phase_determinism(dev)
    mark("slice 6: gather backward checks and determinism")
    clocks = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"
    print(f"card before timing: {clocks} = {smi(clocks)}")
    rows = time_kernels(dev, card, gathers)
    mark("kernel timing")
    time_paths(dev, card, cls_infer, seg_state, seg_step, seg_infer, scene_infer, scene_x,
               flash_state, flash_step, flash_infer)
    print(f"card after timing: {clocks} = {smi(clocks)}")
    mark("path timing")
    big_launches, big_rows, big_errs = slice5(dev, card, mark)
    for name, e in big_errs.items():
        errs[name] = max(errs.get(name, 0.0), e)
    for name, rs in big_rows.items():
        rows[name] += rs
    records = []
    for name, meta in KERNELS.items():
        # ms, call_ms, plain_ms, bound_ms and library_ms sum the shapes of
        # one call of a path: the seg train step's, for the spatial kernel
        # (which that step never launches) the whole-scene request's, for
        # the streaming kNN the B1 x 2228224 request's, for the flash
        # kernels the flash seg train step's.
        path = {"knn_spatial": "scene", "knn_streaming": "scene_2228224",
                "flash_fwd": "seg_flash", "flash_bwd": "seg_flash"}.get(name, "seg")
        shapes = [r for r in rows[name] if r["path"] == path]
        top = max(shapes, key=lambda r: r["bound_ms"])
        by_path = {"cls_serve": cls_launches[name], "seg_train": seg_launches[name],
                   "seg_serve": serve_launches[name], "whole_scene": scene_launches[name],
                   "seg_flash_train": flash_launches[name],
                   "seg_flash_serve": flash_serve_launches[name],
                   "whole_scene_2228224": big_launches[name]}
        lib = [r["library_ms"] for r in shapes]
        records.append({
            "name": name, "route": "cuda", "source": meta["source"], "replaces": meta["replaces"],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": errs[name],
            "ms_path": {"seg": "seg_train", "scene": "whole_scene", "seg_flash": "seg_flash_train",
                        "scene_2228224": "whole_scene_2228224"}[path],
            "ms": sum(r["ms"] for r in shapes),
            "call_ms": sum(r["call_ms"] for r in shapes),
            "plain_ms": sum(r["plain_ms"] for r in shapes),
            "bound_ms": sum(r["bound_ms"] for r in shapes),
            "bound_by": top["bound_by"],
            "library_ms": None if None in lib else sum(lib),
            # Where the plain version was timed on a part of the work.
            **({"plain_ms_on": [r["plain_shape"] for r in shapes]}
               if any("plain_shape" in r for r in shapes) else {}),
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
