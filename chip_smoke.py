"""Drive the PyTorch/CUDA port of PointASNL once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero with no result):
  1. Require a CUDA card; print it as nvidia-smi gives it (name, power limit),
     the torch and CUDA versions and the TF32 switches (both off); build the
     kernels from ``pointasnl_tpu_torch/csrc`` and print the build seconds.
  2. FPS kernel against its plain PyTorch version on the card: indices exact
     at both slices' shapes and at the edge cases, among them the block
     design's (fps_block_cases: each side of every boundary of its plan,
     every pick up to 1025 points and of 10240, all points equal, lattices,
     B 1 to 16), each in the design it routes to and, where that is the
     cluster design (a small batch of 8192 to 10240 points), in the block
     design too.
  3. kNN kernel against its plain version on the card: indices exact and
     squared distances within 1e-6 relative, at both slices' shapes (the
     10240 x 10240 stem one cloud at a time) and the edge cases, among them
     the register lists' (register_list_cases: equal points, integer
     lattices, k of 3, 64 and 128, k > N, N not a multiple of the 1024-point
     tile, copies of points across tile boundaries).
  4. Ball-query kernel against its plain version on the card: indices and
     counts exact at the repulsion loss's shape and the edge cases (among
     them N past the kernel's 3072-point tile, nsample 128, M not a multiple
     of a block's queries, a ball holding every point).
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
     (KNN_SHARED_MEMORY_DESIGN_MS); the ball query at the repulsion loss's
     shape and at N 10240 (off the path), with the mean count; the gather
     backward on a seg step's 19 gathers, each call with its own plan (the
     sum kernel's device ms beside), the step's 12 plans beside segments'
     sort, and the 19 as the step runs them (12 plans), beside index_add_;
     the plan off the path at B16 x 10240's level 1, with its counters in
     device memory and on long segments; the block-design
     FPS and the flash forward beside their parent designs' device ms
     (FPS_SHARED_MEMORY_DESIGN_MS, FLASH_FWD_TWO_LANE_DESIGN_MS); the B8 x
     1024 cls forward; the B4 x 10240 train step
     (p50, p90, points/s) and serve forward; one torch.profiler window
     over 3 train steps (device-busy share, device time by kernel,
     the kernels' share of the step); the whole-scene request (p50, p90,
     points/s) and a profiler window over 2 requests.
 11. Slice 4, flash attention: the forward and backward kernels against
     their plain versions on the card (o and lse, dq, dk and dv within
     FLASH_RTOL and FLASH_GRAD_RTOL, below) at the seg step's four non-local
     levels, cls's two layers and edge cases (the forward's tile, chunk and
     key ranges, C = 1, C != D, C = D = 256), and one forward past the TPU
     kernel's VMEM envelope; then ``PointASNLSemSegRes(21,
     nl_use_flash=True)`` takes 3 train steps at B4 x 10240 and answers 2
     requests, as in phase 6 (the bfloat16 kernels' checks: phase 18): a
     step must launch the flash forward 4 and
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
     and a request of B1 x 2228224: a request must launch the streaming
     kNN 1, the spatial kNN 8, the resident kNN 2, FPS 4 and no ball query
     or flash kernel, and return finite (1, 2228224, 21)
     logits; peak memory, p50 by CUDA events, a profiler window over one
     request, and the times of the path's streaming kNN (with the pairs it
     tests), FPS and its 8 spatial and 2 resident searches (device ms from
     the profiled request). This phase alone: ``python3 -c "import chip_smoke as c;
     d = c.phase_device(); c.slice5(d[1], d[0], print)"``.
 13. Slice 6, run after phase 11 and before the timing: a B4 x 10240 seg
     step's 19 gather backwards on 12 plans (the gathers that share indices
     share one), with segments, the plan's plain version, stubbed to raise;
     the plan kernel's order and offsets equal to segments' on each of the
     19 and on PLAN_CASES (B16 x 10240's level 1, counters past shared
     memory, long segments, rows never gathered); the gather backward on
     each of the 19 equal to the bit to its plain version, to CPU float32
     index_add_ and to a second launch;
     then two seg train steps at B4 x 10240 from one state with one dropout
     seed, dense and under nl_use_flash (and, since slices 11 and 15, in
     bfloat16, dense and under nl_use_flash), whose gradients, updated
     parameters and BN statistics must be equal to the bit; then, apart
     from that
     check, one step of each under torch.use_deterministic_algorithms(True,
     warn_only=True), printing the ops PyTorch flags.

 14. Slice 11, run after phase 13 and before the timing: the cls train
     step of bench.py's modelnet40_cls (``PointASNLCls(40,
     adaptive_sample=True)``, B16 x 1024, Adam, staircase LR, BN-momentum
     schedule, weight decay 1e-4) from one state in float32 and in bfloat16
     (``nn.precision``), 11 steps each on one batch: losses finite and
     falling; launches a step FPS 2 and resident kNN 2, and in bfloat16 the
     float32 step's gather backwards (float32 and bfloat16 sums together)
     on its plans; one bfloat16 step at B64 x 1024; one float32 cls step at
     B8 x 1024 card against CPU (float32 and float64), the card's searches
     replayed on the CPU, within the float32 yardstick (the gradients as
     one vector); the seg step in bfloat16 at B4 x 10240 (launches those
     of the float32 step: FPS 4, kNN 11, ball query 1, gather backward 19 on
     12 plans), JAX's bfloat16-vs-float32 gate against the card's own
     float32 step (BF16_LOSS_RTOL, BF16_D_MAX), one bfloat16 step at
     B16 x 10240; phase 13's determinism adds the bfloat16 seg step; the 19
     gather backwards of a bfloat16 seg step, each equal to the bit to its
     plain version, to a second launch and to CPU float32 index_add_
     rounded once, and the bfloat16 sum on a row gathered 3000 times and
     at B16 x 10240's level 1. Timing adds the bfloat16 sum's rows beside
     the float32 ones (index_add_ on bfloat16 as the library call), and,
     after slice 5, the cls step (float32, bfloat16, B64), the seg bfloat16
     step (B4, B16) and the float32 seg step in turns (p50, p90, peak
     memory) and a profiler window over 3 steps of each of three; then
     the train loop: a CheckpointManager save and restore after which the
     next steps equal the uninterrupted run's to the bit, a
     StepTraceWindow's trace, the metric writer, and a DeviceIouEval on
     seg logits equal to the numpy IouEval.

 15. Slice 12, run after phase 14 and before the timing: the encoder-decoder
     ``PointASNLSemSeg(21, feature_channel=3)`` as the ScanNet CLIs run
     it, on crops that ``data/scannet.py:ScannetDataset`` draws (with
     replacement: exact duplicate points) from synthetic ScanNet pickles
     written to a temporary directory (scannet_pickles). FPS on its four
     levels (8192 -> 1024 in the cluster design and in the block design
     beside it), its twelve kNN searches (the k16 self-kNN at 8192^2, the
     k3 search 8192q/1024 among them) and the repulsion loss's ball query
     against their plain versions, indices exact, on a crop and on a cube;
     3 train steps at B6 x 8192 (a step launches FPS 4, the resident kNN 12,
     the ball query 1 and the gather backward ENC_GATHER_BWD times on
     ENC_GATHER_PLANS plans; losses finite; peak memory printed) and 3
     requests through ``serve.make_inference_fn`` (FPS 4 and kNN 12 a
     request, logits finite); a step's gather backwards equal to the bit to
     their plain versions and CPU index_add_; two steps from one state
     equal to the bit; phase 7's card-against-CPU step for this model on a
     B2 x 2048 crop; one ``nl_use_flash`` step (flash forward and backward
     4 each) and, for slice 15, one in bfloat16 and a bfloat16 request (the
     bfloat16 flash forward and backward 4 each, the float32 ones 0); then
     ``cli.train_scannet --debug`` at its defaults (B6 x
     8192), ``cli.test_scannet`` with one vote on one scene and with
     ``--single_pass true --nl_block_size 4096`` on that scene of 131072
     points. Timing adds the path's kernels (device, call, plain and bound
     ms at each shape: path seg_encdec), the step and the request (p50,
     p90, peak memory, in turns) and a profiler window over 3 of each.
 16. Slice 13, run after phase 15 and before the timing: the grid-sampled
     recipes' four drivers in this process, on synthetic data written to a
     temporary directory (no download). ScanNet grid (GRID_SCENES surface
     scenes of 10^6 points in a 6 m room, with rgb, NYU40 labels, vert_ind
     and meshes): ``cli.train_scannet_grid --debug --num_point 10240
     --in_radius 2`` (B4, the 66.6 % recipe), the same with ``--nl_flash
     true``, then ``cli.test_scannet_grid --split validation --max_rounds
     1``; for slice 15 the trainer with ``--nl_flash true`` and its tester
     once more, each in a python3 subprocess whose environment holds
     POINTASNL_COMPUTE_DTYPE=bfloat16 (driver_child: the bfloat16 flash
     forward and backward 4 each a step, the float32 ones 0, the gather
     backwards float32 and bfloat16 19 in all). SemanticKITTI grid (sequences 00 and 08 of 4 scans of 122880
     points): ``cli.train_semantic_kitti_grid --prepare_data --debug`` at its
     defaults (B4 x 10240, kNN crops), then ``cli.test_semantic_kitti_grid
     --test_id 8 --max_rounds 1``. Each train step must launch FPS 4, the
     resident kNN 11, the ball query 1 and the gather backward 19 on 12
     plans (and under --nl_flash the flash forward and backward 4 each), each
     forward FPS 4 and kNN 11, and each run exactly that; each trainer's
     first step's searches are held to their plain versions (check_tape);
     each mIoU in [0, 100], a latest checkpoint the tester rebuilds from
     args.txt, the KITTI tester's .label files. Printed: per scene the
     subsampled points, the crops' ball (or kNN) sizes and how many were
     padded with duplicates, the searches' host ms; the steps' times inside
     each trainer (CUDA events, p50); the share of each epoch's train loop
     spent waiting on the Prefetcher; each pipeline's host ms for a batch
     on its own.

 17. Slice 14, run after phase 16 and before the timing: the last dataset
     drivers in this process, on synthetic data written to a temporary
     directory. SemanticKITTI blocks (sequences 00 and 08 of 6 scans of
     122880 points): ``cli.train_semantic_kitti --debug --with_remission``
     (``PointASNLSemSeg(20, feature_channel=1)``, B6 x 8192; a step launches
     FPS 4, the resident kNN 12, the ball query 1 and the gather backward 18
     on 12 plans, a forward FPS 4 and kNN 12), its first step's searches
     held to their plain versions; ``cli.test_semantic_kitti --max_scans 1
     --num_votes 1`` by sliding windows (a .label file of every raw point;
     the last batch's rows of zeros, clouds of one repeated point, through
     FPS and every kNN held to their plain versions, and the ball query on
     that batch), then ``--single_pass`` on the whole scan (B1 x 122880,
     dense attention; FPS 4, the spatial kNN 5, the resident kNN 7; its 16
     searches held to their plain versions; peak memory). ModelNet40 (40
     classes of 2 + 1 shapes of 10000 points with normals):
     ``cli.train_modelnet --AS --normal --debug`` (B16 x 1024) in float32
     and with ``--precision bfloat16`` (a step: FPS 2, kNN 2, the gather
     backward 2 on 1 plan, in bfloat16 one of them the bfloat16 sum), each
     first step's searches held to their plain versions, then
     ``cli.test_modelnet --num_votes 2 --noise``: the sweep's keys {0, 1,
     10, 50, 100}. Printed: the step times inside each trainer, the
     forwards' ms, the sliding windows' host seconds, a training batch's
     host ms alone. Timing adds the single pass's and the ModelNet step's
     searches at their shapes (paths seg_kitti_single_pass, cls_modelnet).

 18. Slice 15, the flash kernels in bfloat16, run with phase 11's checks
     and after phase 14: phase 11's kernel checks once more on the same
     inputs rounded to bfloat16, against the bfloat16 plain versions (which
     round o, delta and each 128-query tile's dK and dV where the TPU
     kernels round): o within FLASH_BF16_RTOL, dq, dk, dv within
     FLASH_BF16_GRAD_RTOL, lse within FLASH_RTOL, and o, dq, dk, dv equal
     to the bit on the shares FLASH_BF16_BITS_MIN gives; then
     ``PointASNLSemSegRes(21, nl_use_flash=True)`` in bfloat16
     (phase_seg_bf16_flash): JAX's bfloat16 gate against the card's float32
     flash step from one state (searches replayed; BF16_LOSS_RTOL,
     BF16_D_MAX), 3 train steps at B4 x 10240 (the bfloat16 flash forward
     and backward 4 each a step, the float32 ones 0, beside phase 14's
     bfloat16 counts) and 2 bfloat16 requests (the bfloat16 forward 4 each).
     Timing adds the bfloat16 kernels at the seg step's and the
     encoder-decoder's four shapes (device, call, plain and bound ms, SDPA
     on the same bfloat16 inputs as the yardstick), the bfloat16 flash step
     and request in turns with the float32 flash and bfloat16 dense steps,
     and a profiler window over 3 bfloat16 flash steps.

The line before the last is one JSON object with a record per kernel; the
last line is ``{"ok": true, "device": {...}}``. TF32 is off for every number.
"""

from __future__ import annotations

import contextlib
import importlib
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
    # The same two TPU kernels in bfloat16 (q, k, v, o and dO bfloat16, as
    # JAX's non-local cell hands them over under a bfloat16 compute dtype):
    # the kernels' __nv_bfloat16 instantiations, counted apart.
    "flash_fwd_bf16": {"source": "pointasnl_tpu_torch/csrc/flash_attention_bf16.cu",
                       "replaces": "pointasnl_tpu/ops/pallas/flash_attention.py:90",
                       "symbol": "flash_fwd_kernel"},
    "flash_bwd_bf16": {"source": "pointasnl_tpu_torch/csrc/flash_attention_bf16.cu",
                       "replaces": "pointasnl_tpu/ops/pallas/flash_attention.py:170",
                       "symbol": ("flash_bwd_delta_kernel", "flash_bwd_kernel",
                                  "flash_bwd_dq_sum_kernel")},
    # Not a Pallas kernel: the TPU package's deterministic gather VJP. A call
    # runs the plan (one an index tensor, shared by the gathers of that
    # tensor: its count and fill, then its ranking) and the sum; its rows
    # time a call with its own plan.
    "gather_bwd": {"source": "pointasnl_tpu_torch/csrc/gather_backward.cu",
                   "replaces": "pointasnl_tpu/ops/scatter.py:40",
                   "symbol": "gather_backward_kernel<float>"},
    # The plan alone: the gathered rows sorted stably by output row, in one
    # launch or two (plan_symbols).
    "gather_plan": {"source": "pointasnl_tpu_torch/csrc/gather_backward.cu",
                    "replaces": "pointasnl_tpu/ops/scatter.py:40",
                    "symbol": ("gather_plan_kernel", "gather_rank_kernel")},
    # The sum for bfloat16 cotangents (a bfloat16 train step's): the same
    # kernel's bfloat16 instantiation, on the same plans; its rows time a call
    # with its own plan, as gather_bwd's.
    "gather_bwd_bf16": {"source": "pointasnl_tpu_torch/csrc/gather_backward.cu",
                        "replaces": "pointasnl_tpu/ops/scatter.py:40",
                        "symbol": "gather_backward_kernel<__nv_bfloat16>"},
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
# Device ms of the parent designs of the kernels slice 9 redesigned, on the
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 6:
# scripts/torch_kernel_turns.py on the parent tree), by (path, shape):
# printed beside the new designs' times. The block-design FPS held its cloud
# and running minima in shared memory and crossed two block barriers a pick;
# the flash forward spread a row over 2 lanes (at C = D = 32), a block of 8
# warps holding 16 rows.
FPS_SHARED_MEMORY_DESIGN_MS = {
    ("cls", "B8 N1024->512"): 0.3428, ("cls", "B8 N512->128"): 0.0621,
    ("seg", "B4 N10240->1280"): 2.1058, ("seg", "B4 N1280->320"): 0.2396,
    ("seg", "B4 N320->80"): 0.0364, ("seg", "B4 N80->40"): 0.0173,
    ("scene", "B1 N4096->1024"): 1.0291, ("scene", "B1 N1024->512"): 0.3429}
FLASH_FWD_TWO_LANE_DESIGN_MS = {
    ("seg_flash", "B4 1280q/10240 C32 D32"): 0.8008, ("seg_flash", "B4 320q/1280 C32 D32"): 0.0489,
    ("seg_flash", "B4 80q/320 C64 D64"): 0.0289, ("seg_flash", "B4 40q/80 C128 D128"): 0.0180}
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
# Plans those 19 make, one an index tensor: gathers sharing indices share it.
SEG_GATHER_PLANS = 12
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
    # The forward's tile of 64 rows, chunk of 64 keys and key ranges, and
    # widths off its padding:
    "M 65 (a tile and a row)": (2, 65, 300, 32, 32, True, 1.0),
    "N 65 (a chunk and a key)": (2, 100, 65, 32, 32, True, 1.0),
    "N 1025 at B1 M64 (9 key ranges, the last of one key)": (1, 64, 1025, 32, 32, True, 1.0),
    "C 1": (2, 50, 300, 1, 1, True, 1.0),
    "C 32 D 64": (2, 90, 700, 32, 64, True, 1.0),
    "C = D = 256": (2, 100, 300, 256, 256, True, 1.0),
}
FLASH_FWD_ONLY = {"past the TPU's envelope, N 131072": (1, 512, 131072, 32, 32, True, 1.0)}
# |kernel - plain| may be at most FLASH_RTOL (o, lse) or FLASH_GRAD_RTOL
# (dq, dk, dv) of the quantity's largest |value|, plus YARDSTICK times the
# plain version's own distance from float64 dense attention: both sides are
# float32 with sums in other orders, and at q x 30 the scores reach ~1e2,
# whose float32 rounding moves p by ~1e-5 relative.
FLASH_RTOL, FLASH_GRAD_RTOL = 1e-5, 1e-4
# The bfloat16 kernels, on the cases' inputs rounded to bfloat16, against the
# bfloat16 plain versions, which round o, delta and each 128-query tile's dK
# and dV where the TPU kernels' bfloat16 refs round them: o within
# FLASH_BF16_RTOL (half a bfloat16 ulp at the top of its range) and dq, dk,
# dv within FLASH_BF16_GRAD_RTOL (an ulp) of the largest |value|, plus
# YARDSTICK times the plain version's distance from float64 dense attention
# on the same inputs (with one key, dK is bfloat16 rounding noise on both
# sides); lse (float32) within FLASH_RTOL as above. Each output must also
# equal the plain version's to the bit on the share of its elements that
# FLASH_BF16_BITS_MIN gives (dq, dk and dv where the softmax spans more than
# one key), for the tolerance alone lets other rounding points through:
#   - dk and dv rounded once at the end, as float32 does, equal the TPU
#     kernel's on ~54-71 % only (tests/test_torch_flash_bf16.py);
#   - kernels built to round p to bfloat16 before p v, or dS before dS k,
#     as FlashAttention-2 rounds them, stay within the tolerance at every
#     case but give an o equal to the plain version's on 59-92 % and a dq
#     on 57-70 % of its elements (on an H100; they equal it at N = 1,
#     where p = 1, and o at q x 30, whose rows are near one-hot).
# The kernels themselves reach 99.87 % (o) and 99.37 % (dq) at the least.
FLASH_BF16_RTOL, FLASH_BF16_GRAD_RTOL = 2.0 ** -8, 2.0 ** -7
FLASH_BF16_BITS_MIN = {"o": 0.99, "dq": 0.97, "dk": 0.90, "dv": 0.90}

# Each kernel wrapper's launch counter: name -> (module of ops.cuda, attribute).
COUNTERS = {"fps": ("fps", "launches"), "knn_resident": ("knn", "launches"),
            "ball_query": ("ball_query", "launches"), "knn_spatial": ("knn_spatial", "launches"),
            "knn_streaming": ("knn_streaming", "launches"),
            "flash_fwd": ("flash_attention", "fwd_launches"),
            "flash_bwd": ("flash_attention", "bwd_launches"),
            "gather_bwd": ("gather_backward", "launches"),
            "gather_plan": ("gather_backward", "plan_launches"),
            "gather_bwd_bf16": ("gather_backward", "bf16_launches"),
            "flash_fwd_bf16": ("flash_attention", "fwd_launches_bf16"),
            "flash_bwd_bf16": ("flash_attention", "bwd_launches_bf16")}


def launch_counts(**nonzero) -> dict:
    """Launches expected of every counter: those given, 0 for the rest."""
    unknown = set(nonzero) - set(COUNTERS)
    if unknown:
        raise KeyError(f"no launch counter {sorted(unknown)}")
    return {**dict.fromkeys(COUNTERS, 0), **nonzero}


# Slice 5: whole-scene serving past 2^21 points, one B1 surface scene of
# 2^21 + 2^17 = 17 x 131072 points at slice 3's density (scene() scales the
# extent to 6.0 x sqrt(17)), K/V blocks of 4096, BIG_REQUESTS requests on as
# many scenes after a warm-up. The full-scene kNN checks take BIG_ROWS seeded
# query rows.
BIG_N, BIG_REQUESTS, BIG_ROWS = 2228224, 1, 4096
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
BIG_LAUNCHES = launch_counts(fps=4, knn_resident=2, knn_spatial=8, knn_streaming=1)

# Slice 12: the encoder-decoder pointasnl_sem_seg as the ScanNet CLIs run
# it (PointASNLSemSeg(21, feature_channel=3), B6 x 8192, RGB), on crops that
# ScannetDataset draws with replacement from synthetic scenes of
# ENC_SCENE_N points (surface_scene, extent ENC_SCENE_EXTENT, random RGB and
# labels) in pickles written to a temporary directory.
ENC_B, ENC_N, ENC_FEATURES, ENC_STEPS, ENC_REQUESTS = 6, 8192, 3, 3, 3
ENC_SCENE_N, ENC_SCENE_EXTENT = 131072, 5.0
ENC_LEVELS = [ENC_N, ENC_N // 8, ENC_N // 32, ENC_N // 128, ENC_N // 256]
# kNN searches of a forward as (support level, query level, k): the four SA
# cells' groupings (queries: the FPS samples), then each decoding layer's
# three_nn (support: the sparse level) and self-kNN of 16.
ENC_KNN = [(0, 1, 32), (1, 2, 32), (2, 3, 32), (3, 4, 32), (4, 3, 3), (3, 3, 16), (3, 2, 3),
           (2, 2, 16), (2, 1, 3), (1, 1, 16), (1, 0, 3), (0, 0, 16)]
# A train step's gather backwards and their plans (tests/test_torch_sem_seg.py
# counts them on the CPU), and a forward's searches.
ENC_GATHER_BWD, ENC_GATHER_PLANS = 18, 12
ENC_LAUNCHES = launch_counts(fps=4, knn_resident=12)
# test_scannet --single_pass on one scene of ENC_SCENE_N points (B1): the
# five searches whose support passes 12288 points go to the spatial kernel
# (levels 1-2's SA groupings, the self-kNN of 16 at 131072 and 16384 points,
# the three_nn 131072q/16384), the other seven to the resident one.
ENC_SINGLE_PASS_LAUNCHES = {**ENC_LAUNCHES, "knn_resident": 7, "knn_spatial": 5}
# The encoder-decoder's card-vs-CPU step replays the card's searches on the
# CPU; the CPU's own float32 searches are then held to the card's. A call
# whose inputs are equal to the bit must give the same indices. The others
# take adaptive-sampling outputs (or points picked from them), which float32
# rounds differently on the two: their inputs within ENC_INPUT_ATOL of the
# card's (the clouds span ~1, so a wrong tensor reaching a search is far
# past it), at most ENC_FLIPS_MAX near-tie indices flipped in all, and
# three_nn's inverse-distance weights (d^2 clamped at 1e-10) within
# ENC_IDW_ATOL on the rows whose three neighbours agree. On the H100 (PERF.md
# section 6): one flip, and weights 8.4e-5 apart.
ENC_INPUT_ATOL, ENC_FLIPS_MAX, ENC_IDW_ATOL = 1e-4, 4, 1e-3
# (B, M queries, N keys, C, D) of the four non-local cells under --nl_flash.
FLASH_ENC = [(ENC_B, ENC_N // 8, ENC_N, 32, 32), (ENC_B, ENC_N // 32, ENC_N // 8, 32, 32),
             (ENC_B, ENC_N // 128, ENC_N // 32, 64, 64),
             (ENC_B, ENC_N // 256, ENC_N // 128, 128, 128)]

# Slice 13: the grid-sampled recipes' four drivers, in this process, on
# synthetic data written to a temporary directory. ScanNet grid (the
# 66.6 % recipe, README: --num_point 10240 --in_radius 2, B4, RGB):
# GRID_SCENES surface scenes of GRID_SCENE_N points in a GRID_SCENE_EXTENT m
# room (surface_scene), the last one listed for validation, each with a mesh
# of every GRID_MESH_EVERY-th point. SemanticKITTI grid (B4 x 10240, kNN
# crops of 10240 + 1024 points, no features): sequences 00 and 08 of
# KITTI_SCANS scans, each of KITTI_RINGS rings of KITTI_AZIMUTHS points
# (ranges to KITTI_MAX_RANGE m, remission, raw label ids).
GRID_B, GRID_N, GRID_RADIUS = 4, 10240, 2.0
GRID_SCENES, GRID_SCENE_N, GRID_SCENE_EXTENT, GRID_MESH_EVERY = 4, 10 ** 6, 6.0, 4
KITTI_SCANS, KITTI_RINGS, KITTI_AZIMUTHS, KITTI_MAX_RANGE = 4, 64, 1920, 80.0
# A train step of PointASNLSemSegRes(21) at B4 x 10240 (cell 2's counts,
# feature_channel 3 or 0 alike), and a forward's.
GRID_STEP_LAUNCHES = launch_counts(fps=4, knn_resident=11, ball_query=1,
                                   gather_bwd=SEG_GATHER_BWD, gather_plan=SEG_GATHER_PLANS)
GRID_FORWARD_LAUNCHES = {**GRID_STEP_LAUNCHES, "ball_query": 0, "gather_bwd": 0,
                         "gather_plan": 0}

# Slice 14: the last dataset drivers, in this process, on synthetic data
# written to a temporary directory. SemanticKITTI blocks (README:
# --with_remission, PointASNLSemSeg(20, feature_channel=1), B6 x 8192):
# sequences 00 and 08 as kitti_sequences writes them, KITTI_BLOCK_SCANS
# scans each (a B6 batch of crops draws six scans of a split), and the
# split's other sequences empty; the single pass takes one whole scan,
# B1 x KITTI_RINGS * KITTI_AZIMUTHS (a multiple of the 8192-point pad
# quantum: no padding). ModelNet40 (README: --AS --normal,
# PointASNLCls(40, use_normal=True, adaptive_sample=True), B16 x 1024): a
# modelnet40_normal_resampled tree of MODELNET_CLASSES classes,
# MODELNET_TRAIN training and MODELNET_TEST test shapes a class, each
# MODELNET_POINTS x 6 (xyz, normal) in CSV.
KITTI_BLOCK_B, KITTI_BLOCK_N, KITTI_BLOCK_SCANS, KITTI_CLASSES = 6, 8192, 6, 20
MODELNET_CLASSES, MODELNET_TRAIN, MODELNET_TEST, MODELNET_POINTS = 40, 2, 1, 10000
MODELNET_B, MODELNET_N = 16, 1024
# A KITTI train step launches the encoder-decoder step's kernels (counted
# on the CPU with the kernels' wrappers stubbed, as for feature_channel 3:
# the gather backward ENC_GATHER_BWD times on ENC_GATHER_PLANS plans), a
# forward ENC_LAUNCHES.
KITTI_STEP_LAUNCHES = {**ENC_LAUNCHES, "ball_query": 1, "gather_bwd": ENC_GATHER_BWD,
                       "gather_plan": ENC_GATHER_PLANS}
# A cls forward launches FPS 2 and the resident kNN 2 (normals or not); a
# float32 train step adds the gather backward 2 times on 1 plan, a bfloat16
# step 1 float32 and 1 bfloat16 sum on that plan (counted on the CPU as
# above).
CLS_FORWARD_LAUNCHES = {**ENC_LAUNCHES, "fps": 2, "knn_resident": 2}
CLS_STEP_LAUNCHES = {"float32": {**CLS_FORWARD_LAUNCHES, "gather_bwd": 2, "gather_plan": 1},
                     "bfloat16": {**CLS_FORWARD_LAUNCHES, "gather_bwd": 1, "gather_plan": 1,
                                  "gather_bwd_bf16": 1}}

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, TF32
# on the tensor cores (dense) and HBM bandwidth, for each kernel's bound.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
# The flash backward's products run on the tensor cores in TF32, three
# passes a product for float32 accuracy (csrc/flash_attention.cuh): its bound
# counts each float32 operation three times at the TF32 rate. In bfloat16
# only the float32 operand (p or dS) is split: two passes (mma2).
FLASH_BWD_TF32_PASSES, FLASH_BWD_BF16_TF32_PASSES = 3, 2
# The fastest exact rate for a product of a float32 and a bfloat16 operand:
# three passes on the bfloat16 tensor cores, the float32 operand split into
# bfloat16 hi + mid + lo (the bfloat16 operand exact).
PEAK_F32_BY_BF16_FLOPS = PEAK_BF16_FLOPS / 3
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


def launch_us(fn, kernels, calls: int, tries: int, seen=all):
    """The device time (us) of every launch of each of `kernels` (substrings
    of CUDA kernel names) over `calls` calls of fn, after one to warm up,
    from torch.profiler: {kernel: [us, ...]}. The profiler at times records
    no launch of a kernel in a window: then the window is taken again, up to
    `tries` windows, until `seen` (all or any) of the kernels have launches;
    else None. Call it before any profile_window: once that scheduled
    profiler has run, this one recorded no launch on the card."""
    from torch.profiler import ProfilerActivity, profile

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
        if seen(bool(ts) for ts in times.values()):
            return times
        print(f"profiler: no launch of {', '.join(k for k, ts in times.items() if not ts)} "
              f"recorded; profiling again")
    return None


def device_ms(fn, kernels, calls: int = 10, tries: int = 3):
    """Median device time (ms) of one launch of each of `kernels` (a
    substring of a CUDA kernel's name, or a tuple of those a call launches,
    every one of them) over `calls` calls of fn, summed; None where a
    kernel's launches were not recorded (never the sum of the others)."""
    kernels = (kernels,) if isinstance(kernels, str) else tuple(kernels)
    times = launch_us(fn, kernels, calls, tries)
    if times is None:
        return None
    for kernel, ts in times.items():
        if len(ts) < calls:
            print(f"profiler: {len(ts)} of {calls} launches of {kernel} recorded")
    return sum(statistics.median(ts) for ts in times.values()) / 1e3


def device_ms_all(fn, kernels, calls: int = 5, tries: int = 3):
    """Device time (ms) of a call of fn summed over every launch of every
    kernel whose name holds one of `kernels`: for a call that launches the
    same kernels many times, as a train step's gather backwards do. None
    where no launch was recorded."""
    times = launch_us(fn, tuple(kernels), calls, tries, seen=any)
    return None if times is None else sum(map(sum, times.values())) / calls / 1e3


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


def parent_notes(name, r) -> str:
    """A redesigned kernel's row: its parent design's device ms at the
    shape, where there is one."""
    what, table = {"knn_resident": ("the shared-memory design", KNN_SHARED_MEMORY_DESIGN_MS),
                   "knn_spatial": ("the shared-memory design", KNN_SHARED_MEMORY_DESIGN_MS),
                   "fps": ("the shared-memory design", FPS_SHARED_MEMORY_DESIGN_MS),
                   "flash_fwd": ("the two-lane design", FLASH_FWD_TWO_LANE_DESIGN_MS)
                   }.get(name, ("", {}))
    old = table.get((r["path"], r["shape"]))
    return "" if old is None else f" ({what}: {old:.4f} ms, {old / r['ms']:.2f}x)"


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


def flash_fwd_bound_bf16(B, M, N, C, D, pair: float = PEAK_BF16_FLOPS,
                         mixed: float = PEAK_F32_BY_BF16_FLOPS):
    # q, k, v in and o out at 2 bytes an element, lse out at 4. Products at
    # the card's peak for their operands: q k^T, of two bfloat16 operands, at
    # `pair`, the bfloat16 tensor cores' rate; p v, whose p is float32 (JAX's
    # jnp.dot promotes v), at `mixed`, three bfloat16 passes. The design runs
    # both as float32 FFMAs: pair=mixed=PEAK_F32_FLOPS counts that.
    nbytes = B * (M * C + N * (C + D) + M * D) * 2 + B * M * 4
    t_ops = 2 * B * M * N * C / pair + 2 * B * M * N * D / mixed
    return bound(nbytes, t_ops * PEAK_F32_FLOPS)


def flash_bwd_bound_bf16(B, M, N, C, D, pair: float = PEAK_BF16_FLOPS,
                         mixed: float = PEAK_F32_BY_BF16_FLOPS):
    # q, k, v, o, dO in and dq, dk, dv out at 2 bytes an element, lse in at
    # 4. s and dO v^T (two bfloat16 operands) at `pair`, the bfloat16 tensor
    # cores' rate; dQ, dK and dV, each of a float32 operand (dS or p), at
    # `mixed`, three bfloat16 passes. The design takes s and dP in one TF32
    # pass and the others in FLASH_BWD_BF16_TF32_PASSES: pair=PEAK_TF32_FLOPS,
    # mixed=PEAK_TF32_FLOPS / FLASH_BWD_BF16_TF32_PASSES counts that.
    nbytes = B * (2 * M * C + 2 * M * D + 2 * N * (C + D)) * 2 + B * M * 4
    t_ops = 2 * B * M * N * (C + D) / pair + 2 * B * M * N * (2 * C + D) / mixed
    return bound(nbytes, t_ops * PEAK_F32_FLOPS)


def flash_fwd_symbols(B, M, N, C, D):
    """The kernels one forward call launches at this shape: the forward
    kernel and, where a query tile's keys are split into ranges, their
    merge."""
    from pointasnl_tpu_torch.ops.cuda import _build

    split = _build.library().pasnl_flash_fwd_scratch(B, M, N, C, D) > 0
    return ("flash_fwd_kernel",) + ("flash_fwd_merge_kernel",) * split


def flash_bwd_symbols(B, M, N, C, D):
    """The kernels one backward call launches at this shape: delta's, the
    backward kernel and, where a query tile's keys are split, the partial
    dQ's sum."""
    from pointasnl_tpu_torch.ops.cuda import _build

    split = _build.library().pasnl_flash_bwd_scratch(B, M, N, C, D) > 0
    return ("flash_bwd_delta_kernel", "flash_bwd_kernel") + ("flash_bwd_dq_sum_kernel",) * split


def plan_symbols(B, R, n):
    """The kernels one gather plan launches at this shape: the count and
    fill, and the ranking where the library launches it."""
    from pointasnl_tpu_torch.ops.cuda import _build

    kernels = _build.library().pasnl_gather_plan_launches(B, R, n)
    return KERNELS["gather_plan"]["symbol"][:kernels]


def seg_plans(gathers):
    """(idx, n) of each plan a seg step's gathers make: one an index tensor,
    keyed as gather_backward.plan keys it."""
    plans = {}
    for _, idx, n in gathers:
        base = idx if idx._base is None else idx._base
        plans.setdefault((id(base), n, tuple(idx.shape), idx.stride(), idx.storage_offset()),
                         (idx, n))
    return list(plans.values())


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


def fps_block_cases(dev):
    """(name, xyz, npoint) of the block design's edge cases: each side of its
    plan's boundaries (every pick up to 1025 points), every pick of 10240,
    all points equal (every pick is point 0), lattices and B 1 to 16."""
    from pointasnl_tpu_torch.ops.cuda import fps

    cases = [(f"B2 N{n} -> {n if n <= 1025 else 300} (block plan edge)", cloud(n + 5, 2, n, dev),
              n if n <= 1025 else 300) for n in fps.block_plan_edges()]
    return cases + [
        ("B1 N10240 -> 10240 (every pick)", cloud(16, 1, 10240, dev), 10240),
        ("all points equal B4 N100 -> 100 (one warp)",
         cloud(17, 4, 1, dev).expand(4, 100, 3).contiguous(), 100),
        ("all points equal B4 N5000 -> 200", cloud(18, 4, 1, dev).expand(4, 5000, 3).contiguous(),
         200),
        ("lattice 10^3 B1 -> 1000", lattice(10, dev), 1000),
        ("lattice 21^3 B2 -> 1500", lattice(21, dev).expand(2, -1, 3).contiguous(), 1500),
        ("duplicate points B2 N10240 -> 2000", cloud(19, 2, 10240, dev, dup=5120), 2000),
        ("B16 N1280 -> 320", cloud(20, 16, 1280, dev), 320),
        ("B16 N80 -> 40", cloud(21, 16, 80, dev), 40),
        ("B1 N4096 -> 1024", cloud(22, 1, 4096, dev), 1024)]


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
    cases += fps_block_cases(dev)
    worst = 0
    for name, x, npoint in cases:
        want = geometry.farthest_point_sample(npoint, x)
        routed = fps_design(x)
        # A cloud that routes to the cluster design takes the block design too.
        for design in dict.fromkeys([routed] + ["block"] * (x.shape[1] <= fps.BLOCK_MAX_N)):
            got = fps._sample(design, npoint, x)
            torch.cuda.synchronize()
            if got.shape != (x.shape[0], npoint) or not torch.equal(got, want):
                raise RuntimeError(f"fps {name} ({design} design): kernel and plain differ")
            if name.startswith("all points equal") and got.any():
                raise RuntimeError(f"fps {name} ({design} design): a pick other than point 0")
            worst = max(worst, int((got - want).abs().max()))
            print(f"fps {name} ({design} design{'' if design != routed else ', routed'}): "
                  f"indices exact")
    return float(worst)


def fps_design(x) -> str:
    """The FPS design a call on x routes to on this card."""
    from pointasnl_tpu_torch.ops.cuda import fps

    B, N, _ = x.shape
    return fps.design(N, fps.stated_cluster_max_n(), B, fps.stated_cluster_slots())


def fps_symbol(x) -> str:
    """What the kernel of the FPS design a call on x routes to holds in its
    name in a profiler trace."""
    return {"block": KERNELS["fps"]["symbol"], "cluster": FPS_CLUSTER_SYMBOL,
            "grid": FPS_GRID_SYMBOL}[fps_design(x)]


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
    # The kernel's tiles: a block stages up to 3072 points (csrc/ball_query.cu),
    # so these walk several, some queries past the last tile's start.
    x = rng.rand(2, 9001, 3) * 0.5
    cases.append(("N 9001 (three tiles)", t(x), t(x[:, ::13]), 0.05, 32))
    x = rng.rand(1, 8192, 3) * 0.5
    x[0, 8000:] = x[0, 4000]  # a far cluster: hits past the second tile
    cases.append(("hits in the last tile", t(x), t(x[:, 3990:4010]), 0.02, 128))
    x = rng.rand(2, 700, 3) * 0.5
    cases.append(("nsample 128", t(x), t(x[:, ::3]), 0.25, 128))
    cases.append(("M not a multiple of a block's queries", t(x), t(x[:, :333]), 0.1, 20))
    cases.append(("every point in the ball", t(x), t(x[:, :40]), 10.0, 128))
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
        if name == "every point in the ball" and not bool(
                (got_c == min(nsample, xyz.shape[1])).all()):
            raise RuntimeError("ball query: a ball holding every point is not full")
        print(f"ball query {name}: indices and counts exact; mean count "
              f"{float(got_c.float().mean()):.2f}, max {int(got_c.max())} of {nsample}")
    return 0.0


def layer_indices(xyz: torch.Tensor, npoint: int, k: int):
    """FPS and kNN indices of one SA layer on xyz, through ops.dispatch."""
    from pointasnl_tpu_torch import ops

    fps_idx = ops.farthest_point_sample(npoint, xyz)
    _, knn_idx = ops.knn_point(k, xyz, ops.gather_point(xyz, fps_idx))
    return fps_idx.cpu(), knn_idx.cpu()


def _counter_modules():
    return {name: importlib.import_module(f"pointasnl_tpu_torch.ops.cuda.{module}")
            for name, (module, _) in COUNTERS.items()}


def counts():
    """Every kernel wrapper's launch count, by COUNTERS' names."""
    mods = _counter_modules()
    return {name: getattr(mods[name], attr) for name, (_, attr) in COUNTERS.items()}


def reset_counts():
    mods = _counter_modules()
    for name, (_, attr) in COUNTERS.items():
        setattr(mods[name], attr, 0)


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
    if launches != launch_counts(fps=2 * REQUESTS, knn_resident=2 * REQUESTS):
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


def seg_trainer(model, batch_size: int, dropout_seed: int = SEED + 5):
    """A train state and step with the ScanNet recipe's optimizer and losses;
    the step, (state, batch) -> metrics, draws its dropout masks from a
    generator on the model's device seeded with `dropout_seed`, folded with
    the state's step (so two runs from one state draw the same masks)."""
    from pointasnl_tpu_torch.train import (
        TrainState,
        bn_momentum_schedule,
        make_optimizer,
        make_train_step,
        staircase_lr_schedule,
    )

    state = TrainState(model, make_optimizer(
        "adam", staircase_lr_schedule(1e-3, batch_size, 200000, 0.7), model.parameters()))
    train_step = make_train_step(bn_schedule=bn_momentum_schedule(batch_size, 200000),
                                 task="seg", uniform_weight=0.01, weights_decay=1e-4)
    rng = torch.Generator(device=next(model.parameters()).device).manual_seed(dropout_seed)
    return state, lambda state, batch: train_step(state, batch, rng)


def seg_batch(seed: int, B: int, N: int, side: float, dev):
    rng = np.random.RandomState(seed)
    return {"points": cube(seed, B, N, side, dev),
            "labels": torch.from_numpy(rng.randint(0, SEG_CLASSES, (B, N))).to(dev),
            "smpw": torch.ones(B, N, device=dev)}


def capture_l1_xyz(model, store: list, layer: str = "layer1_1"):
    """Keep each forward's l1_xyz (the output xyz of `layer`: layer1_1 of
    the residual model, layer1 of the encoder-decoder)."""
    return getattr(model, layer).register_forward_hook(
        lambda m, a, out: store.append(out[0].detach()))


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
    if launches != launch_counts(fps=4 * SEG_STEPS, knn_resident=11 * SEG_STEPS,
                                 ball_query=SEG_STEPS, flash_fwd=nl * SEG_STEPS,
                                 flash_bwd=nl * SEG_STEPS, gather_bwd=SEG_GATHER_BWD * SEG_STEPS,
                                 gather_plan=SEG_GATHER_PLANS * SEG_STEPS):
        raise RuntimeError(f"{label} train launches {launches}, expected FPS 4, kNN 11, "
                           f"ball query 1, flash forward {nl} and backward {nl}, gather "
                           f"backward {SEG_GATHER_BWD} on {SEG_GATHER_PLANS} plans a step")
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
    if serve_launches != launch_counts(fps=4 * SEG_REQUESTS, knn_resident=11 * SEG_REQUESTS,
                                       flash_fwd=nl * SEG_REQUESTS):
        raise RuntimeError(f"{label} serve launches {serve_launches}, expected FPS 4, kNN 11, "
                           f"flash forward {nl} and no ball query, flash or gather backward a "
                           f"request")
    for r, out in enumerate(logits):
        if out.shape != (SEG_B, SEG_N, SEG_CLASSES) or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"{label} request {r}: logits {tuple(out.shape)} not all finite")
    print(f"{label} serve: logits {tuple(logits[0].shape)} finite")
    return state, step, infer, launches, serve_launches


def _ratio(card, cpu, cpu64, scale: float):
    """(error / limit, the numbers) of |card - cpu| against the float32
    yardstick: YARDSTICK x |cpu - cpu64| + FLOOR_RTOL x scale."""
    err = float((card.double() - cpu.double()).abs().max())
    f32 = float((cpu.double() - cpu64.double()).abs().max())
    limit = YARDSTICK * f32 + FLOOR_RTOL * scale
    return err / limit, (f"{err:.3e} against its limit {limit:.3e} (cpu vs float64 {f32:.3e}, "
                         f"card vs float64 {float((card.double() - cpu64.double()).abs().max()):.3e}"
                         f", scale {scale:.3e})")


def _yardstick(what: str, card, cpu, cpu64, scale: float) -> float:
    """Check |card - cpu| against the float32 yardstick; return the ratio of
    the error to its limit."""
    ratio, numbers = _ratio(card, cpu, cpu64, scale)
    if not ratio <= 1.0:
        raise RuntimeError(f"card vs cpu {what}: {numbers}")
    return ratio


def card_vs_cpu(dev, make, batch, layer: str, tag: str, tape=None):
    """One seg train step of the model make(device, generator) on the card
    against the CPU's in float32 and float64, from the same weights, on
    `batch`; `layer` is the SA cell whose output xyz is level 1. With `tape`
    (a SearchTape) the card's searches are recorded on it and replayed in
    the CPU's steps, so the steps differ in their arithmetic only. Returns
    the CPU's float32 model and the card's state_dict before the step."""
    card = make(dev, torch.Generator().manual_seed(SEED + 1))
    sd = {k: v.cpu().clone() for k, v in card.state_dict().items()}
    cpus = {}
    for dtype in (torch.float32, torch.float64):
        m = make("cpu")
        m.load_state_dict(sd)
        cpus[dtype] = m.to(dtype)
    runs = {}
    for name, model, to in (("card", card, lambda t: t),
                            ("cpu", cpus[torch.float32], lambda t: t.cpu()),
                            ("cpu64", cpus[torch.float64],
                             lambda t: t.cpu().double() if t.is_floating_point() else t.cpu())):
        state, step = seg_trainer(model, CMP_B)
        l1 = []
        hook = capture_l1_xyz(model, l1, layer)
        t0 = time.perf_counter()
        with (contextlib.nullcontext() if tape is None else
              tape.recording() if name == "card" else tape.replaying()):
            metrics = step(state, {k: to(v) for k, v in batch.items()})
        torch.cuda.synchronize()
        hook.remove()
        runs[name] = {"metrics": {k: v.cpu() for k, v in metrics.items()},
                      "grads": {k: p.grad.cpu() for k, p in model.named_parameters()},
                      "state": {k: v.cpu() for k, v in model.state_dict().items()},
                      "l1_xyz": l1[0]}
        print(f"card vs cpu{tag}: {name} step in {time.perf_counter() - t0:.2f} s")

    x = batch["points"][..., :3].contiguous()
    for what, a, b in zip(("fps", "knn"), layer_indices(x, CMP_N // 8, 32),
                          layer_indices(x.cpu(), CMP_N // 8, 32)):
        if not torch.equal(a, b):
            raise RuntimeError(f"card vs cpu{tag}: layer-1 {what} indices differ")
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
    g_ratios = sorted(((*_ratio(c["grads"][k], p["grads"][k], p64["grads"][k],
                                max(float(p64["grads"][k].abs().max()), 1e-6 * gmax)), k)
                       for k in c["grads"]), reverse=True)
    g_ratio, g_numbers, g_worst = g_ratios[0]
    print(f"card vs cpu{tag}: worst gradients (error / limit): " +
          ", ".join(f"{k} {r:.3f}" for r, _, k in g_ratios[:5]) +
          f"; {sum(r > 1 for r, _, _ in g_ratios)} of {len(g_ratios)} past it; level-2 indices "
          f"differing: fps {l2[0]}, knn {l2[1]}")
    if not g_ratio <= 1.0:
        raise RuntimeError(f"card vs cpu{tag} grad {g_worst}: {g_numbers}")
    bn_ratio = max(_yardstick(f"BN {k}", c["state"][k], p["state"][k], p64["state"][k],
                              max(float(p64["state"][k].abs().max()), 1.0))
                   for k in c["state"] if k.endswith((".mean", ".var")))
    print(f"card vs cpu{tag}, B{CMP_B}x{CMP_N} train step: " + ", ".join(
        f"{k} card {float(c['metrics'][k]):.7f} cpu {float(p['metrics'][k]):.7f} "
        f"cpu64 {float(p64['metrics'][k]):.7f}" for k in c["metrics"]))
    print(f"card vs cpu{tag}: layer-1 FPS and kNN indices exact; level-2 "
          f"indices differing: "
          f"fps {l2[0]}, knn {l2[1]}; worst error / limit: loss terms "
          f"{max(worst.values()):.3f}, gradients {g_ratio:.3f}, BN stats {bn_ratio:.3f} "
          f"(limit {YARDSTICK:g} x |cpu - cpu64| + {FLOOR_RTOL:g} x scale)")
    return cpus[torch.float32], sd


def phase_card_vs_cpu(dev, flash: bool = False):
    """One PointASNLSemSegRes train step on the card against the CPU's,
    dense or under nl_use_flash (`flash`). The CPU's float64 step still runs
    its flash attention in float32 inside, as JAX's does."""
    from pointasnl_tpu_torch.models import PointASNLSemSegRes

    def make(device, generator=None):
        return PointASNLSemSegRes(SEG_CLASSES, dropout_keep=1.0, nl_use_flash=flash,
                                  generator=generator, device=device)

    card_vs_cpu(dev, make, seg_batch(400, CMP_B, CMP_N, CMP_SIDE, dev), "layer1_1",
                f" (nl_use_flash={flash})")


def phase_encdec_card_vs_cpu(dev, root):
    """One PointASNLSemSeg(21, 3) train step on the card against the CPU's,
    on a B2 x 2048 ScannetDataset crop of the pickles in root (duplicates
    included). The CPU's steps replay the card's searches: the decoding
    layers search the adaptive-sampling outputs of levels 1-2, which float32
    rounds differently on the card and the CPU, and a near tie there flips
    (on the H100, PERF.md section 6: one of the 16 neighbours of one of the
    64 points of l2, which put fc2's gradient at 1.49 times its limit).
    The CPU's own searches are then held to the card's (own_searches)."""
    from pointasnl_tpu_torch.models import PointASNLSemSeg

    def make(device, generator=None):
        return PointASNLSemSeg(SEG_CLASSES, ENC_FEATURES, dropout_keep=1.0,
                               generator=generator, device=device)

    batch, tape = scannet_batch(root, CMP_B, CMP_N, 410, dev), SearchTape()
    cpu, sd = card_vs_cpu(dev, make, batch, "layer1", " (encoder-decoder)", tape)
    print("card vs cpu (encoder-decoder): the card's searches replayed in the CPU's steps; "
          "the CPU's own float32 searches against the card's: " + own_searches(cpu, sd, batch, tape))


def own_searches(model, sd, batch, tape) -> str:
    """One more CPU step of `model` from the state_dict `sd`, its own
    searches recorded, held to the card's on `tape` (ENC_INPUT_ATOL,
    ENC_FLIPS_MAX, ENC_IDW_ATOL): calls on inputs equal to the bit give the
    same indices; the others' inputs are near the card's, their flipped
    indices few, and three_nn's weights close where its neighbours agree.
    Returns what it measured."""
    model.load_state_dict(sd)
    own = SearchTape()
    state, step = seg_trainer(model, batch["points"].shape[0])
    with own.recording():
        step(state, {k: v.cpu() for k, v in batch.items()})
    flips, n_flips, gap, w_gap, exact = [], 0, 0.0, 0.0, 0
    for op, calls in tape.calls.items():
        if len(calls) != len(own.calls[op]):
            raise RuntimeError(f"own searches: {len(own.calls[op])} {op} calls on the CPU, "
                               f"{len(calls)} on the card")
        for i, ((_, ref), (_, got), ref_args, got_args) in enumerate(
                zip(calls, own.calls[op], tape.args[op], own.args[op])):
            d = max(float((a.detach().cpu().double() - b.detach().double()).abs().max())
                    for a, b in zip(ref_args, got_args) if torch.is_tensor(a))
            if not d <= ENC_INPUT_ATOL:
                raise RuntimeError(f"own searches: {op} call {i}'s inputs are {d:.3e} from the "
                                   f"card's, past {ENC_INPUT_ATOL:g}")
            gap = max(gap, d)
            ref, got = (ref if isinstance(ref, tuple) else (ref,)), (
                got if isinstance(got, tuple) else (got,))
            idx_r, idx_g = (ref[1], got[1]) if op == "knn_point" else (ref[0], got[0])
            differ = idx_r.cpu() != idx_g
            n = int(differ.sum())
            if n and d == 0.0:
                raise RuntimeError(f"own searches: {op} call {i} on the card's inputs to the bit "
                                   f"gives {n} other indices")
            exact += d == 0.0
            if n:
                flips.append(f"{op} {i} {tuple(idx_g.shape)}: {n}")
                n_flips += n
            if op == "knn_point" and ref[0].shape[-1] == 3:
                w = [1.0 / t.cpu().double().clamp_min(1e-10) for t in (ref[0], got[0])]
                w = [v / v.sum(-1, keepdim=True) for v in w]
                agree = ~differ.any(-1, keepdim=True)
                w_gap = max(w_gap, float(((w[0] - w[1]).abs() * agree).max()))
    said = (f"{exact} calls on inputs equal to the bit, the others' inputs up to {gap:.3e} apart; "
            f"indices differing in {len(flips)} calls ({'; '.join(flips) or 'none'}); three_nn "
            f"weights differ by up to {w_gap:.3e}")
    if n_flips > ENC_FLIPS_MAX or not w_gap <= ENC_IDW_ATOL:
        raise RuntimeError(f"own searches: {said} (at most {ENC_FLIPS_MAX} flips and "
                           f"{ENC_IDW_ATOL:g} allowed)")
    return said


def record_gathers(fn):
    """Run fn() with the gather backward's wrapper recording each call's
    (dout, idx, n) in launch order, idx as the step passed it (so the gathers
    that share an index tensor share its plan here too), and segments, the
    plan's plain version, stubbed to raise. Returns (cases, plans made)."""
    from pointasnl_tpu_torch.ops.cuda import gather_backward

    cases = []
    launch, segments = gather_backward.gather_backward, gather_backward.segments

    def record(dout, idx, n):
        cases.append((dout.detach().clone(), idx, n))
        return launch(dout, idx, n)

    def refuse(idx, n):
        raise RuntimeError("a gather backward on the card called segments, the plain plan")

    gather_backward.gather_backward, gather_backward.segments = record, refuse
    plans = gather_backward.plan_launches
    try:
        fn()
    finally:
        gather_backward.gather_backward, gather_backward.segments = launch, segments
    torch.cuda.synchronize()
    return cases, gather_backward.plan_launches - plans


def seg_gathers(dev, dtype: str = "float32"):
    """(dout, idx, n) of each gather backward of one B4 x 10240 seg train step
    in the compute dtype `dtype`, recorded at the kernel's wrapper in the
    order the step launched them (record_gathers). The step must make
    SEG_GATHER_PLANS plans on the card and never call segments."""
    from pointasnl_tpu_torch.models import PointASNLSemSegRes

    model = PointASNLSemSegRes(SEG_CLASSES, generator=torch.Generator().manual_seed(SEED + 3),
                               device=dev)
    state, step = seg_trainer(model, SEG_B)
    step = in_dtype(dtype, step)
    cases, plans = record_gathers(lambda: step(state, seg_batch(210, SEG_B, SEG_N, SEG_SIDE, dev)))
    if len(cases) != SEG_GATHER_BWD or plans != SEG_GATHER_PLANS:
        raise RuntimeError(f"a {dtype} seg step ran {len(cases)} gather backwards on {plans} "
                           f"plans, expected {SEG_GATHER_BWD} on {SEG_GATHER_PLANS}")
    return cases


def in_dtype(dtype: str, step):
    """The train step `step` run under the compute dtype `dtype`
    (nn.precision)."""
    from pointasnl_tpu_torch.nn import precision

    def run(state, batch):
        with precision.compute_dtype(dtype):
            return step(state, batch)

    return run


# (name, B, n output rows, R rows, the output rows the indices take or None
# for all) of the plan kernel's checks beside a seg step's: the B16 x 10240
# recipe's level 1, counters and slots past a block's shared memory (n + R
# ints), long segments (the walk in order), rows never gathered.
PLAN_CASES = [("B16 level 1 grouping", 16, SEG_N, 1280 * 32, None),
              ("counters past shared memory", 2, 60000, 5000, None),
              ("a row gathered 3000 times", 2, 5, 3000, (0, 3)),
              ("long and short segments", 2, 9, 5000, None),
              ("most rows never gathered", 1, 1000, 10, None),
              ("one row", 1, 1, 4, None)]


def plan_cases(dev):
    """(name, idx, n) of PLAN_CASES, seeded."""
    out = []
    for name, B, n, R, rows in PLAN_CASES:
        rng = np.random.RandomState(sum(map(ord, name)))
        idx = (rng.randint(0, n, (B, R)) if rows is None
               else np.asarray(rows)[rng.randint(0, len(rows), (B, R))])
        out.append((name, torch.from_numpy(idx.astype(np.int32)).to(dev), n))
    return out


def index_add(dout, idx, n):
    """The gather backward as one index_add_ over the flattened batch."""
    B, R, C = dout.shape
    flat = (idx.long() + torch.arange(B, device=idx.device)[:, None] * n).reshape(-1)
    return torch.zeros(B * n, C, device=dout.device, dtype=dout.dtype).index_add_(
        0, flat, dout.reshape(B * R, C))


def phase_gather(dev):
    """The plan kernel's (order, offsets) equal to segments, its plain
    version, for each of a seg step's 19 gathers and PLAN_CASES; the gather
    backward on each of the 19 equal to the bit to its plain version on the
    card, to CPU float32 index_add_, and to a second launch. Returns the
    step's cases, for the timing."""
    from pointasnl_tpu_torch.ops.cuda import gather_backward

    cases = seg_gathers(dev)
    checks = [(f"seg step gather {i}", idx, n) for i, (_, idx, n) in enumerate(cases)]
    for name, idx, n in checks + plan_cases(dev):
        B, R = idx.shape
        got, want = gather_backward.plan_kernel(idx, n), gather_backward.segments(idx, n)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise RuntimeError(f"gather plan {name}, B{B} {R} rows -> {n}: (order, offsets) "
                               f"differ from segments")
        longest = int(torch.diff(want[1].long()).max())
        print(f"gather plan {name}, B{B} {R} rows -> {n}: order and offsets equal to segments "
              f"(longest segment {longest} rows; the walk in order past "
              f"{gather_backward.long_len(R)})")
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


def twice_from_one_state(label: str, model, batch, dtype: str = "float32") -> list:
    """Two train steps of `model` from its present state with one dropout
    seed; prints how many gradients, updated parameters and BN statistics
    are equal to the bit, and returns the names of those that differ. The
    model is left at its state after the second step."""
    import copy

    init = copy.deepcopy(model.state_dict())
    runs = []
    for _ in range(2):
        model.load_state_dict(init)
        state, step = seg_trainer(model, batch["points"].shape[0])  # one dropout seed for both
        in_dtype(dtype, step)(state, batch)
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
    print(f"determinism, {label}, twice from one state: " +
          ", ".join(f"{len(keys) - len(differ[w])} of {len(keys)} {w}"
                    for w, (_, _, keys) in groups.items()) + " equal to the bit")
    return [k for keys in differ.values() for k in keys]


def phase_determinism(dev):
    """Two seg train steps at B4 x 10240 from one state, with one dropout
    seed, dense, under nl_use_flash, in bfloat16 and under nl_use_flash in
    bfloat16 (the bfloat16 flash kernels): their gradients,
    updated parameters and BN statistics must be equal to the bit. Then one
    diagnostic step of
    each under torch.use_deterministic_algorithms(True, warn_only=True), apart
    from the check, lists the ops that PyTorch flags as nondeterministic;
    a difference raises after that."""
    import copy
    import warnings

    from pointasnl_tpu_torch.models import PointASNLSemSegRes

    batch = seg_batch(600, SEG_B, SEG_N, SEG_SIDE, dev)
    models, failed = {}, []
    for label, flash, dtype in (("seg", False, "float32"), ("flash seg", True, "float32"),
                                ("bf16 seg", False, "bfloat16"),
                                ("bf16 flash seg", True, "bfloat16")):
        model = PointASNLSemSegRes(SEG_CLASSES, nl_use_flash=flash,
                                   generator=torch.Generator().manual_seed(SEED + 4), device=dev)
        init = copy.deepcopy(model.state_dict())
        bad = twice_from_one_state(f"{label} train step B{SEG_B}x{SEG_N}", model, batch, dtype)
        if bad:
            failed.append(f"{label}: {len(bad)} tensors (first: {bad[0]})")
        models[label] = (model, init, dtype)
    for label, (model, init, dtype) in models.items():
        model.load_state_dict(init)
        state, step = seg_trainer(model, SEG_B)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                in_dtype(dtype, step)(state, batch)
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
    want = launch_counts(fps=4 * SCENE_REQUESTS, knn_resident=8 * SCENE_REQUESTS,
                         knn_spatial=3 * SCENE_REQUESTS)
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
    """The flash kernels against their plain versions, in float32 and in
    bfloat16 (the same cases' inputs rounded to it): the largest |kernel -
    plain| of each forward (o, lse) and backward (dq, dk, dv)."""
    from pointasnl_tpu_torch.ops import flash_attention as fa
    from pointasnl_tpu_torch.ops.cuda import flash_attention as cuda_flash

    worst = {"flash_fwd": 0.0, "flash_bwd": 0.0, "flash_fwd_bf16": 0.0, "flash_bwd_bf16": 0.0}
    cases = [(n, c, True) for n, c in FLASH_CASES.items()]
    cases += [(n, c, False) for n, c in FLASH_FWD_ONLY.items()]
    for dtype, tag, rtols in ((torch.float32, "", (FLASH_RTOL, FLASH_GRAD_RTOL)),
                              (torch.bfloat16, "_bf16", (FLASH_BF16_RTOL, FLASH_BF16_GRAD_RTOL))):
        for name, (B, M, N, C, D, scaled, qmul), backward in cases:
            scale = fa.flash_scale(C, scaled)
            q, k, v, do = (t.to(dtype) for t in flash_inputs(name, B, M, N, C, D, qmul, dev))
            o, lse = cuda_flash.flash_forward(q, k, v, scale)
            po, plse = fa.flash_forward_reference(q, k, v, scale)
            if backward:
                grads = cuda_flash.flash_backward(q, k, v, o, lse, do, scale)
                pgrads = fa.flash_backward_reference(q, k, v, po, plse, do, scale)
            torch.cuda.synchronize()
            if o.dtype != dtype or lse.dtype != torch.float32 or (
                    backward and any(g.dtype != dtype for g in grads)):
                raise RuntimeError(f"flash {name} in {dtype}: outputs of dtypes {o.dtype}, "
                                   f"{lse.dtype}" + (f", {[g.dtype for g in grads]}"
                                                     if backward else ""))
            o64, lse64, g64 = dense64(q, k, v, do if backward else None, scale)
            errs = {"o": flash_close(f"{name}{tag} o", o, po, o64, rtols[0]),
                    "lse": flash_close(f"{name}{tag} lse", lse, plse, lse64, FLASH_RTOL)}
            worst["flash_fwd" + tag] = max(worst["flash_fwd" + tag], errs["o"], errs["lse"])
            bits = {}
            if backward:
                for what, got, plain, ref in zip(("dq", "dk", "dv"), grads, pgrads, g64):
                    errs[what] = flash_close(f"{name}{tag} {what}", got, plain, ref, rtols[1])
                    worst["flash_bwd" + tag] = max(worst["flash_bwd" + tag], errs[what])
                    bits[what] = float((got == plain).float().mean())
            bits["o"] = float((o == po).float().mean())
            short = [f"{k} {100 * v:.2f} % (need {100 * FLASH_BF16_BITS_MIN[k]:g} %)"
                     for k, v in bits.items()
                     if tag and (k == "o" or N > 1) and v < FLASH_BF16_BITS_MIN[k]]
            if short:
                raise RuntimeError(f"flash {name} bfloat16: equal to the plain version's to "
                                   f"the bit on too few elements: {', '.join(short)}")
            print(f"flash {name} {str(dtype)[6:]}, B{B} M{M} N{N} C{C} D{D}: within tolerance; "
                  f"max |kernel - plain| " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                  + "; equal to the bit " + ", ".join(f"{k} {100 * v:.2f} %"
                                                      for k, v in bits.items()))
            del q, k, v, do, o64, g64
    return worst


def spatial_bound(B, N, M, k):
    # Bytes: the clouds in and the rows out, each once. The operations the
    # function needs are its M * k pairs' distances, far below the bytes'
    # time; the pairs a kernel tests depend on how it prunes, so they are
    # reported beside the bound (pairs_tested), not counted in it.
    return bound(B * (N + M) * 12 + B * M * k * 8, B * M * k * 9)


def gather_bound(B, n, R, C, element: int = 4):
    # dout, idx and the output each once (`element` bytes a value: 4 for
    # float32, 2 for bfloat16); one add a gathered element.
    return bound(B * R * C * element + B * R * 4 + B * n * C * element, B * R * C)


def plan_bound(B, n, R):
    # idx in, order and offsets out, each once; one count and one slot a row.
    return bound(B * R * 4 + B * R * 4 + (B * n + 1) * 4, 2 * B * R)


def time_kernels(dev, card, gathers, gathers_bf16, enc, drivers):
    """Kernel vs plain times, and bounds, at every slice's shapes; `gathers`
    are the (dout, idx, n) of a seg step's gather backwards, `gathers_bf16`
    those of a bfloat16 seg step, `enc` slice 12's (slice12), `drivers`
    slice 14's (slice14)."""
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
            lambda: fps.farthest_point_sample(npoint, x), fps_bound(B, N, npoint),
            symbol=fps_symbol(x), fps_n=N, fps_npoint=npoint)
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
            symbol=fps_symbol(a), fps_n=a.shape[1], fps_npoint=n)
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
        ball_bound(n1, n1, SEG_B, REPULSION_NSAMPLE, idx, cnt),
        mean_count=float(cnt.float().mean()))
    # Off the path: the ball query's N 10240 check, past one tile.
    x = cube(24, 1, SEG_N, SEG_SIDE, dev)
    q = x[:, ::8].contiguous()
    idx, cnt = ball_query.query_ball_point(REPULSION_RADIUS, REPULSION_NSAMPLE, x, q)
    add("ball_query", "check", f"B1 {q.shape[1]}q/{SEG_N} ns{REPULSION_NSAMPLE} "
        f"r{REPULSION_RADIUS}",
        lambda: geometry.query_ball_point(REPULSION_RADIUS, REPULSION_NSAMPLE, x, q),
        lambda: ball_query.query_ball_point(REPULSION_RADIUS, REPULSION_NSAMPLE, x, q),
        ball_bound(SEG_N, q.shape[1], 1, REPULSION_NSAMPLE, idx, cnt),
        mean_count=float(cnt.float().mean()))

    # The whole-scene request's shapes, on a scene of bench.py's density.
    levels = scene_levels(dev, seed=23)
    for a, n in zip(levels, SCENE_LEVELS[1:]):
        N = a.shape[1]
        add("fps", "scene", f"B1 N{N}->{n}", lambda: geometry.farthest_point_sample(n, a),
            lambda: fps.farthest_point_sample(n, a), fps_bound(1, N, n),
            timing=(10, 2) if N == SCENE_N else HEAVY if N > 1024 else LIGHT,
            plain_timing=SLOW if N >= SCENE_LEVELS[1] else None,
            symbol=fps_symbol(a), fps_n=N, fps_npoint=n)
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
    # the backward the forward with its backward. In bfloat16 (slice 15) SDPA
    # rounds p to bfloat16, where the kernels keep it float32: a yardstick,
    # not the same function.
    from pointasnl_tpu_torch.ops import flash_attention as fa
    from pointasnl_tpu_torch.ops.cuda import flash_attention as cuda_flash

    def add_flash(path, shapes, dtype=torch.float32):
        tag = "_bf16" if dtype == torch.bfloat16 else ""
        for B, M, N, C, D in shapes:
            q, k, v, do = (t.to(dtype) for t in flash_inputs("time", B, M, N, C, D, 1.0, dev))
            scale = fa.flash_scale(C)
            o, lse = cuda_flash.flash_forward(q, k, v, scale)
            timing = HEAVY if M * N >= 10**7 else LIGHT

            def sdpa_fwd_bwd(q=q, k=k, v=v, do=do, scale=scale):
                q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
                out = torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=scale)
                torch.autograd.grad(out, (q, k, v), do)

            shape = f"B{B} {M}q/{N} C{C} D{D}"
            add("flash_fwd" + tag, path, shape,
                lambda q=q, k=k, v=v, s=scale: fa.flash_forward_reference(q, k, v, s),
                lambda q=q, k=k, v=v, s=scale: cuda_flash.flash_forward(q, k, v, s),
                (flash_fwd_bound_bf16 if tag else flash_fwd_bound)(B, M, N, C, D), timing,
                symbol=flash_fwd_symbols(B, M, N, C, D),
                library=lambda q=q, k=k, v=v, s=scale:
                    torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=s),
                **({"bound_design_ms": flash_fwd_bound_bf16(
                    B, M, N, C, D, PEAK_F32_FLOPS, PEAK_F32_FLOPS)[0]} if tag else {}))
            extra = ({"bound_design_ms": flash_bwd_bound_bf16(
                         B, M, N, C, D, PEAK_TF32_FLOPS,
                         PEAK_TF32_FLOPS / FLASH_BWD_BF16_TF32_PASSES)[0]}
                     if tag else {"bound_f32_ms": flash_bwd_bound(B, M, N, C, D, None)[0]})
            add("flash_bwd" + tag, path, shape,
                lambda a=(q, k, v, o, lse, do, scale): fa.flash_backward_reference(*a),
                lambda a=(q, k, v, o, lse, do, scale): cuda_flash.flash_backward(*a),
                (flash_bwd_bound_bf16 if tag else flash_bwd_bound)(B, M, N, C, D), timing,
                symbol=flash_bwd_symbols(B, M, N, C, D), library=sdpa_fwd_bwd, **extra)

    add_flash("seg_flash", FLASH_SEG)
    add_flash("seg_flash_bf16", FLASH_SEG, torch.bfloat16)

    # The seg step's gather backwards; index_add_ (atomics on the card) is
    # the one PyTorch call computing the same sums, in another order. A row
    # times a call with its own plan (plan and sum kernels); sum_ms is its sum
    # kernel alone, on the plan kept from an earlier call.
    from pointasnl_tpu_torch.ops.cuda import gather_backward

    def drop_plans(idx):  # the plans kept on the tensor idx views
        (idx if idx._base is None else idx._base).__dict__.pop("_gather_backward_plans", None)

    def planned_anew(dout, idx, n):  # a call with its plan
        drop_plans(idx)
        return gather_backward.gather_backward(dout, idx, n)

    def as_a_step_runs_them(gathers=gathers):  # the 19 in order, each index tensor planned once
        for _, idx, _ in gathers:
            drop_plans(idx)
        for dout, idx, n in gathers:
            gather_backward.gather_backward(dout, idx, n)

    for dout, idx, n in gathers:
        B, R, C = dout.shape
        gather_backward.gather_backward(dout, idx, n)  # keeps its plan, for sum_ms
        sum_ms = device_ms(lambda a=(dout, idx, n): gather_backward.gather_backward(*a),
                           "gather_backward_kernel")
        add("gather_bwd", "seg", f"B{B} {R} rows -> {n} C{C}",
            lambda a=(dout, idx, n): gather_backward.gather_backward_reference(*a),
            lambda a=(dout, idx, n): planned_anew(*a), gather_bound(B, n, R, C),
            plain_timing=SLOW, library=lambda a=(dout, idx, n): index_add(*a), sum_ms=sum_ms,
            symbol=plan_symbols(B, R, n) + (KERNELS["gather_bwd"]["symbol"],))
    # The bfloat16 step's gathers of bfloat16 cotangents (its xyz gathers are
    # float32), each a call with its own plan, index_add_ on bfloat16 beside.
    for dout, idx, n in [g for g in gathers_bf16 if g[0].dtype == torch.bfloat16]:
        B, R, C = dout.shape
        gather_backward.gather_backward(dout, idx, n)  # keeps its plan, for sum_ms
        sum_ms = device_ms(lambda a=(dout, idx, n): gather_backward.gather_backward(*a),
                           KERNELS["gather_bwd_bf16"]["symbol"])
        add("gather_bwd_bf16", "seg_bf16", f"B{B} {R} rows -> {n} C{C}",
            lambda a=(dout, idx, n): gather_backward.gather_backward_reference(*a),
            lambda a=(dout, idx, n): planned_anew(*a), gather_bound(B, n, R, C, element=2),
            plain_timing=SLOW, library=lambda a=(dout, idx, n): index_add(*a), sum_ms=sum_ms,
            symbol=plan_symbols(B, R, n) + (KERNELS["gather_bwd_bf16"]["symbol"],))
    for idx, n in seg_plans(gathers):
        B, R = idx.shape
        plan, symbols = (lambda a=(idx, n): gather_backward.plan_kernel(*a),  # noqa: E731
                         plan_symbols(B, R, n))
        add("gather_plan", "seg", f"B{B} {R} rows -> {n}",
            lambda a=(idx, n): gather_backward.segments(*a), plan, plan_bound(B, n, R),
            symbol=symbols, fill_ms=device_ms(plan, symbols[0]),
            rank_ms=device_ms(plan, symbols[1]) if len(symbols) > 1 else 0.0)
    # The B16 recipe's level 1, the counters in device memory and the walk in
    # order, off the path.
    for name, idx, n in plan_cases(dev)[:3]:
        B, R = idx.shape
        add("gather_plan", "check", f"B{B} {R} rows -> {n} ({name})",
            lambda a=(idx, n): gather_backward.segments(*a),
            lambda a=(idx, n): gather_backward.plan_kernel(*a), plan_bound(B, n, R),
            symbol=plan_symbols(B, R, n))

    # Slice 12's shapes (path seg_encdec), on the levels of a ScannetDataset
    # crop: FPS (8192 -> 1024 also in the block design, off the path), the
    # twelve kNN searches, the repulsion loss's ball query, the flash kernels
    # at the four non-local cells of --nl_flash, and an encdec step's gather
    # backwards (each a call with its own plan) and their plans.
    levels = enc["levels"]
    for a, n in zip(levels, ENC_LEVELS[1:]):
        N = a.shape[1]
        add("fps", "seg_encdec", f"B{ENC_B} N{N}->{n}",
            lambda a=a, n=n: geometry.farthest_point_sample(n, a),
            lambda a=a, n=n: fps.farthest_point_sample(n, a), fps_bound(ENC_B, N, n),
            timing=HEAVY if n >= 256 else LIGHT, symbol=fps_symbol(a), fps_n=N, fps_npoint=n)
    a, n = levels[0], ENC_LEVELS[1]
    add("fps", "check", f"B{ENC_B} N{ENC_N}->{n} (block design, off the path)",
        lambda: geometry.farthest_point_sample(n, a), lambda: fps._sample("block", n, a),
        fps_bound(ENC_B, ENC_N, n), timing=HEAVY, symbol=KERNELS["fps"]["symbol"],
        fps_n=ENC_N, fps_npoint=n)
    for si, qi, k in ENC_KNN:
        s_, q = levels[si], levels[qi]
        N, M = s_.shape[1], q.shape[1]
        add("knn_resident", "seg_encdec", f"B{ENC_B} {M}q/{N} k{k}",
            lambda s_=s_, q=q, k=k: geometry.knn_point(k, s_, q),
            lambda s_=s_, q=q, k=k: knn.knn_point(k, s_, q), knn_bound(ENC_B, N, M, k),
            timing=HEAVY if N * M >= 10**7 else LIGHT)
    l1 = levels[1]
    idx, cnt = ball_query.query_ball_point(REPULSION_RADIUS, REPULSION_NSAMPLE, l1, l1)
    n1 = l1.shape[1]
    add("ball_query", "seg_encdec", f"B{ENC_B} {n1}q/{n1} ns{REPULSION_NSAMPLE} "
        f"r{REPULSION_RADIUS}",
        lambda: geometry.query_ball_point(REPULSION_RADIUS, REPULSION_NSAMPLE, l1, l1),
        lambda: ball_query.query_ball_point(REPULSION_RADIUS, REPULSION_NSAMPLE, l1, l1),
        ball_bound(n1, n1, ENC_B, REPULSION_NSAMPLE, idx, cnt),
        mean_count=float(cnt.float().mean()))
    add_flash("seg_encdec", FLASH_ENC)
    add_flash("seg_encdec_bf16", FLASH_ENC, torch.bfloat16)
    # test_scannet --single_pass's twelve searches on the scene of
    # ENC_SCENE_N points, on the inputs the pass gave them (path
    # seg_encdec_single_pass); its four FPS calls have the whole-scene
    # request's shapes (path scene).
    def recorded_searches(path, fps_calls, searches):
        """Rows of the FPS calls [(npoint, xyz)] and kNN searches [(kernel,
        k, support, query)] a run recorded, on the inputs it gave them."""
        for npoint, a in fps_calls:
            a = a.detach().float()
            B, N = a.shape[:2]
            # The plain version takes ~0.15 ms a pick on the card.
            add("fps", path, f"B{B} N{N}->{npoint}",
                lambda a=a, n=npoint: geometry.farthest_point_sample(n, a),
                lambda a=a, n=npoint: fps.farthest_point_sample(n, a), fps_bound(B, N, npoint),
                timing=(10, 2) if npoint >= 8192 else HEAVY if npoint >= 320 else LIGHT,
                plain_timing=SLOW if npoint >= 2048 else HEAVY if npoint >= 128 else LIGHT,
                symbol=fps_symbol(a), fps_n=N, fps_npoint=npoint)
        for name, k, s_, q in searches:
            self_query = q is s_
            s_ = s_.detach().float()
            q = s_ if self_query else q.detach().float()
            B, N, M = s_.shape[0], s_.shape[1], q.shape[1]
            shape = f"B{B} {M}q/{N} k{k}{' (self)' if q is s_ else ''}"
            plain = lambda s_=s_, q=q, k=k: geometry.knn_point(k, s_, q)  # noqa: E731
            if name == "knn_spatial":
                tested = knn_spatial.pairs_tested(k, s_, q)
                add(name, path, shape, plain,
                    lambda s_=s_, q=q, k=k: knn_spatial.knn_point(k, s_, q),
                    spatial_bound(B, N, M, k), (10, 2),
                    SLOW if B * N * M >= 10**9 else HEAVY, pairs_tested=tested,
                    pairs_tested_share=tested / (B * N * M))
            else:
                add(name, path, shape, plain, lambda s_=s_, q=q, k=k: knn.knn_point(k, s_, q),
                    knn_bound(B, N, M, k), timing=HEAVY if B * N * M >= 10**7 else LIGHT)

    recorded_searches("seg_encdec_single_pass", [], enc["single_pass"])
    # Slice 14: the SemanticKITTI single pass's FPS calls and searches
    # (B1 x KITTI_RINGS * KITTI_AZIMUTHS) and those of the ModelNet40 cls
    # step with normals (B16 x 1024), on the inputs the runs gave them.
    recorded_searches("seg_kitti_single_pass", *drivers["single_pass"])
    recorded_searches("cls_modelnet", *drivers["cls"])
    # The step's gathers and plans in all, as the step runs them (one row
    # each: device ms of all their launches), and its largest gather, the
    # last decoding layer's grouping, and its plan at their own shape.
    enc_gathers, enc_plans = enc["gathers"], seg_plans(enc["gathers"])
    step_all = lambda: as_a_step_runs_them(enc_gathers)  # noqa: E731
    call_ms, p_ms = in_turns(
        lambda: [gather_backward.gather_backward_reference(*g) for g in enc_gathers], step_all,
        HEAVY, SLOW)
    sum_ms = device_ms_all(step_all, (KERNELS["gather_bwd"]["symbol"],))
    plan_ms = device_ms_all(step_all, KERNELS["gather_plan"]["symbol"])
    bounds = [gather_bound(*g[0].shape[:2], g[2], g[0].shape[2]) for g in enc_gathers]
    seen = sum_ms is not None and plan_ms is not None  # else ms is the call's, by CUDA events
    rows["gather_bwd"].append({
        "path": "seg_encdec", "shape": f"the {len(enc_gathers)} of a B{ENC_B}x{ENC_N} step as it "
        f"runs them ({len(enc_plans)} plans)", "ms": sum_ms + plan_ms if seen else call_ms,
        **({} if seen else {"ms_is_call_ms": True}),
        "call_ms": call_ms, "plain_ms": p_ms, "bound_ms": sum(b[0] for b in bounds),
        "bound_by": "bytes", "sum_ms": sum_ms,
        "library_ms": statistics.median(time_ms(lambda: [index_add(*g) for g in enc_gathers],
                                                *HEAVY))})
    plan_call_ms, segments_ms = in_turns(
        lambda: [gather_backward.segments(*p) for p in enc_plans],
        lambda: [gather_backward.plan_kernel(*p) for p in enc_plans], HEAVY)
    rows["gather_plan"].append({
        "path": "seg_encdec", "shape": f"the {len(enc_plans)} plans of a B{ENC_B}x{ENC_N} step",
        "ms": plan_ms if plan_ms is not None else plan_call_ms,
        **({} if plan_ms is not None else {"ms_is_call_ms": True}),
        "call_ms": plan_call_ms, "plain_ms": segments_ms,
        "bound_ms": sum(plan_bound(idx.shape[0], n, idx.shape[1])[0] for idx, n in enc_plans),
        "bound_by": "bytes", "library_ms": None})
    dout, idx, n = max(enc_gathers, key=lambda g: g[0].numel())
    B, R, C = dout.shape
    add("gather_bwd", "check", f"B{B} {R} rows -> {n} C{C} (the step's largest)",
        lambda: gather_backward.gather_backward_reference(dout, idx, n),
        lambda: planned_anew(dout, idx, n), gather_bound(B, n, R, C), plain_timing=SLOW,
        library=lambda: index_add(dout, idx, n),
        symbol=plan_symbols(B, R, n) + (KERNELS["gather_bwd"]["symbol"],))
    add("gather_plan", "check", f"B{B} {R} rows -> {n} (the step's largest)",
        lambda: gather_backward.segments(idx, n), lambda: gather_backward.plan_kernel(idx, n),
        plan_bound(B, n, R), symbol=plan_symbols(B, R, n))

    for name, rs in rows.items():
        for r in rs:
            tested = (f", pairs tested {r['pairs_tested']} ({100 * r['pairs_tested_share']:.3f} % "
                      f"of M x N)" if "pairs_tested" in r else "")
            lib_name = ("index_add_" if name.startswith("gather_bwd")
                        else "F.scaled_dot_product_attention")
            if "mean_count" in r:
                tested += f", mean count {r['mean_count']:.3f}"
            if "fill_ms" in r:
                tested += (f", its count and fill {r['fill_ms']} ms and ranking {r['rank_ms']} "
                           f"ms on the device")
            if r.get("sum_ms") is not None:
                tested += f", the sum kernel {r['sum_ms']:.4f} ms on the device"
            lib = (f", {lib_name} {r['library_ms']:.4f} ms"
                   f"{' (forward and backward)' if name.startswith('flash_bwd') else ''}"
                   if r["library_ms"] is not None else "")
            if "streaming_ms" in r:
                lib += f", the streaming kernel {r['streaming_ms']:.4f} ms"
            if name == "fps":
                tested += fps_notes(r)
            tested += parent_notes(name, r)
            if "bound_f32_ms" in r:
                tested += (f" ({FLASH_BWD_TF32_PASSES} TF32 passes on the tensor cores; at the "
                           f"float32 rate {r['bound_f32_ms']:.5f} ms)")
            if "bound_design_ms" in r:
                tested += (" (the bfloat16 pairs on the bfloat16 tensor cores, the float32-operand "
                           "products in three bfloat16 passes; at the design's units, "
                           + ("float32 FFMA for both products" if name.startswith("flash_fwd")
                              else f"one TF32 pass for s and dP and {FLASH_BWD_BF16_TF32_PASSES} "
                                   "for dQ, dK, dV")
                           + f", {r['bound_design_ms']:.5f} ms)")
            where = "by CUDA events" if r.get("ms_is_call_ms") else "on the device"
            print(f"time {name} [{r['path']}] {r['shape']}: kernel {r['ms']:.4f} ms {where}, "
                  f"{r['call_ms']:.4f} ms a call back to back, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})"
                  f"{lib}{tested}  [{card}]")
    plans = gather_backward.plan_launches
    as_a_step_runs_them()
    plans = gather_backward.plan_launches - plans
    step_ms = statistics.median(time_ms(as_a_step_runs_them, *LIGHT))
    add_ms = statistics.median(time_ms(lambda: [index_add(*g) for g in gathers], *LIGHT))
    print(f"time gather_bwd [seg]: a step's {len(gathers)} calls as the step runs them "
          f"({plans} plans, shared), {step_ms:.4f} ms by CUDA events back to back "
          f"against index_add_'s {add_ms:.4f} ms on the same {len(gathers)} shapes: "
          f"{'the kernels are' if step_ms < add_ms else 'index_add_ is'} faster  [{card}]")
    bf16_ms = statistics.median(time_ms(lambda: as_a_step_runs_them(gathers_bf16), *LIGHT))
    bf16_add_ms = statistics.median(time_ms(lambda: [index_add(*g) for g in gathers_bf16],
                                            *LIGHT))
    n_bf16 = sum(g[0].dtype == torch.bfloat16 for g in gathers_bf16)
    print(f"time gather_bwd_bf16 [seg_bf16]: a bfloat16 step's {len(gathers_bf16)} calls "
          f"({n_bf16} of bfloat16 cotangents) as the step runs them, {bf16_ms:.4f} ms by CUDA "
          f"events back to back against index_add_'s {bf16_add_ms:.4f} ms on the same shapes and "
          f"dtypes  [{card}]")
    g = [r for r in rows["gather_bwd"] if r["path"] == "seg"]
    p = [r for r in rows["gather_plan"] if r["path"] == "seg"]
    print(f"time gather_bwd [seg]: a step's {len(g)} calls, each with its own plan, "
          f"{sum(r['call_ms'] for r in g):.4f} ms back to back against index_add_'s "
          f"{sum(r['library_ms'] for r in g):.4f} ms; on the device {sum(r['ms'] for r in g):.4f} "
          f"ms, of which the sum kernel {sum(r['sum_ms'] or 0.0 for r in g):.4f} ms; the step's "
          f"{len(p)} plans {sum(r['ms'] for r in p):.4f} ms on the device (bound "
          f"{sum(r['bound_ms'] for r in p):.5f} ms), {sum(r['call_ms'] for r in p):.4f} ms a call "
          f"back to back, segments (torch.sort) {sum(r['plain_ms'] for r in p):.4f} ms  [{card}]")
    for tag in ("", "_bf16"):
        fwd, bwd = rows["flash_fwd" + tag][0], rows["flash_bwd" + tag][0]  # level 1
        both = fwd["ms"] + bwd["ms"]
        print(f"time flash [{fwd['path']}] {fwd['shape']}: forward and backward {both:.4f} ms "
              f"on the device against F.scaled_dot_product_attention's {bwd['library_ms']:.4f} "
              f"ms (forward and backward), {'below' if both < bwd['library_ms'] else 'NOT below'}"
              f" it  [{card}]")
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
               flash_state, flash_step, flash_infer, plan_kernels: int):
    x = cloud(13, BATCH, NUM_POINT, dev)
    fwd, p90 = percentiles(time_ms(lambda: cls_infer(x), reps=50))
    print(f"time cls forward B{BATCH}x{NUM_POINT}: p50 {fwd:.3f} ms, p90 {p90:.3f} ms of 50 "
          f"(CUDA events); {BATCH * NUM_POINT / fwd * 1e3:.0f} points/s at p50  [{card}]")

    batch = seg_batch(500, SEG_B, SEG_N, SEG_SIDE, dev)
    dense = {"fps": 4, "knn": 11, "ball_query": 1, "gather_bwd": SEG_GATHER_BWD,
             "gather_plan": plan_kernels}
    # The dense step and the same step under nl_use_flash, in turns; a flash
    # backward is three CUDA kernels at each seg level (delta, then dQ, dK
    # and dV, then the split dQ's sum), a forward one or two (the kernel,
    # then the merge of its key ranges).
    flash_kernels = {"flash_fwd": sum(len(flash_fwd_symbols(*shape)) for shape in FLASH_SEG),
                     "flash_bwd": sum(len(flash_bwd_symbols(*shape)) for shape in FLASH_SEG)}
    seg = time_seg(card, {
        "seg": (seg_state, seg_step, seg_infer, dense, "profile_seg_step.json"),
        "flash seg": (flash_state, flash_step, flash_infer, {**dense, **flash_kernels},
                      "profile_flash_seg_step.json"),
    }, batch)
    (step_p50, serve_p50), (flash_p50, flash_serve_p50) = seg["seg"], seg["flash seg"]

    torch.cuda.reset_peak_memory_stats()
    scene_p50, scene_p90 = percentiles(time_ms(lambda: scene_infer(scene_x), reps=10, warmup=1))
    print(f"time whole-scene request B1x{SCENE_N}: p50 {scene_p50:.3f} ms, p90 {scene_p90:.3f} "
          f"ms of 10 (CUDA events); {SCENE_N / scene_p50 * 1e3:.0f} points/s at p50; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    profile_window(lambda: scene_infer(scene_x), 2,
                   {"fps": 4, "knn": 8, "knn_spatial": 3}, card,
                   "whole-scene requests", "profile_whole_scene.json")
    return {"cls_forward_ms": fwd, "seg_step_ms": step_p50, "seg_serve_ms": serve_p50,
            "flash_seg_step_ms": flash_p50, "flash_seg_serve_ms": flash_serve_p50,
            "scene_ms": scene_p50}


# Each ported kernel's launches in a profiler trace, by the names they hold.
PROFILE_SYMBOLS = {"fps": ("fps_kernel", FPS_CLUSTER_SYMBOL, FPS_GRID_SYMBOL),
                   "knn": ("knn_kernel",), "knn_spatial": ("knn_spatial_kernel",),
                   "knn_streaming": ("knn_stream_kernel",), "ball_query": ("ball_query_kernel",),
                   "flash_fwd": ("flash_fwd_kernel", "flash_fwd_merge_kernel"),
                   "flash_bwd": ("flash_bwd_delta_kernel", "flash_bwd_kernel",
                                 "flash_bwd_dq_sum_kernel"),
                   "gather_bwd": (KERNELS["gather_bwd"]["symbol"],),
                   "gather_plan": KERNELS["gather_plan"]["symbol"],
                   "gather_bwd_bf16": (KERNELS["gather_bwd_bf16"]["symbol"],),
                   # the same names as flash_fwd's and flash_bwd's, of __nv_bfloat16
                   "flash_fwd_bf16": ("flash_fwd_kernel", "flash_fwd_merge_kernel"),
                   "flash_bwd_bf16": ("flash_bwd_delta_kernel", "flash_bwd_kernel",
                                      "flash_bwd_dq_sum_kernel")}
BF16_NAME = "__nv_bfloat16"  # what a bfloat16 instantiation's name holds


def profile_window(fn, n: int, per_call: dict, card, label: str, out_name: str):
    """One torch.profiler window over n calls of fn, after one traced and
    dropped warm-up call: device-busy share and device time by kernel name,
    the ported kernels picked out with the launches recorded (`per_call`
    launches expected a call, 0 where it names none). Returns the window's
    device events."""
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

    def ours(name):  # no symbol is a part of another; the flash kernels' dtype is in the name
        bf16 = BF16_NAME in name
        return next((k for k, syms in PROFILE_SYMBOLS.items() if any(s in name for s in syms)
                     and (not k.startswith("flash") or k.endswith("_bf16") == bf16)), None)

    mine = {k: 0.0 for k in PROFILE_SYMBOLS}
    seen = {k: 0 for k in PROFILE_SYMBOLS}
    for e in events:
        k = ours(e.name)
        if k:
            mine[k] += e.time_range.end - e.time_range.start
            seen[k] += 1
    expected = {k: per_call.get(k, 0) * n for k in PROFILE_SYMBOLS}
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
                                                  "knn_streaming": 1},
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
            tested += parent_notes(name, r)
            print(f"time {name} [{r['path']}] {r['shape']}: kernel {r['ms']:.4f} ms {where}, "
                  f"{r['call_ms']:.4f} ms a call, plain {r['plain_ms']:.4f} ms{plain}, "
                  f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}){tested}  [{card}]")
    return launches, rows_out, err


# Slice 11: the cls train step of bench.py's modelnet40_cls (B16 x 1024,
# Adam, staircase LR from 1e-3, BN-momentum schedule, weight decay 1e-4, no
# uniform loss) in float32 and bfloat16; modelnet40_cls_b64 in bfloat16; the
# seg step in bfloat16 at B4 and B16 x 10240; the train loop's modules.
CLS_TRAIN_B, CLS_B64, CLS_LEARN_STEPS, CLS_CMP_B, SEG_B16 = 16, 64, 11, 8, 16
# JAX's bfloat16-vs-float32 gate (tests/test_precision.py:57-94) has a loss
# part, 2e-2 relative, held here as it stands. Its per-parameter part (each
# update norm within max(0.1 a, 1e-2 max)) fails for JAX's own full models
# (tests/test_torch_precision.py): the update norms are compared as one
# vector instead, |n_bf16 - n_f32| / |n_f32| at most BF16_D_MAX, 1.5 times
# the distance between JAX's own bfloat16 and float32 seg steps on the CPU
# (0.394 at B2 x 2048, the searches held equal), the tests' BF16_DRIFT.
BF16_LOSS_RTOL, BF16_D_MAX = 2e-2, 1.5 * 0.394


class SearchTape:
    """The searches' results (FPS, kNN, ball query) of one run, replayed in
    others, each op's calls in order, every call's sizes and shapes checked
    against the recording: runs on other devices or in other dtypes then
    differ in their arithmetic only. Use as `with tape.recording():` and
    `with tape.replaying():`. A recording also keeps each call's arguments
    (`args`), so its searches can be run again."""

    OPS = ("farthest_point_sample", "knn_point", "query_ball_point")

    def __init__(self):
        self.calls = {op: [] for op in self.OPS}
        self.args = {op: [] for op in self.OPS}

    @staticmethod
    def _sig(args):
        return tuple(a if isinstance(a, (int, float)) else tuple(a.shape) for a in args)

    @contextlib.contextmanager
    def _patched(self, make):
        from pointasnl_tpu_torch import ops
        from pointasnl_tpu_torch.ops import dispatch

        saved = {op: getattr(dispatch, op) for op in self.OPS}
        try:
            for op in self.OPS:
                for module in (dispatch, ops):
                    setattr(module, op, make(op, saved[op]))
            yield
        finally:
            for op, fn in saved.items():
                for module in (dispatch, ops):
                    setattr(module, op, fn)

    def recording(self):
        def make(op, inner):
            def recorded(*args):
                out = inner(*args)
                self.calls[op].append((self._sig(args), out))
                self.args[op].append(args)
                return out
            return recorded
        return self._patched(make)

    def replaying(self):
        pos = {op: 0 for op in self.OPS}

        def make(op, inner):
            def replayed(*args):
                sig, out = self.calls[op][pos[op]]
                if sig != self._sig(args):
                    raise RuntimeError(f"search tape: {op} call {pos[op]} is {self._sig(args)}, "
                                       f"recorded {sig}")
                pos[op] += 1
                dev = next(a.device for a in args if torch.is_tensor(a))
                return (tuple(o.to(dev) for o in out) if isinstance(out, tuple)
                        else out.to(dev))
            return replayed
        return self._patched(make)


def cls_trainer(model, batch_size: int, dropout_seed: int = SEED + 8, dropout_device=None):
    """A train state and step with bench.py's modelnet40_cls optimizer and
    losses; the step, (state, batch) -> metrics, draws its dropout masks
    from a generator seeded with `dropout_seed` on `dropout_device` (the
    model's device unless given), folded with the state's step."""
    from pointasnl_tpu_torch.train import (
        TrainState,
        bn_momentum_schedule,
        make_optimizer,
        make_train_step,
        staircase_lr_schedule,
    )

    state = TrainState(model, make_optimizer(
        "adam", staircase_lr_schedule(1e-3, batch_size, 200000, 0.7), model.parameters()))
    train_step = make_train_step(bn_schedule=bn_momentum_schedule(batch_size, 200000),
                                 task="cls", weights_decay=1e-4)
    device = dropout_device or next(model.parameters()).device
    rng = torch.Generator(device=device).manual_seed(dropout_seed)
    return state, lambda state, batch: train_step(state, batch, rng)


def cls_train_batch(seed: int, B: int, dev):
    """bench.py's cls batch: normal points, uniform labels."""
    rng = np.random.RandomState(seed)
    return {"points": torch.from_numpy(rng.randn(B, NUM_POINT, 3).astype(np.float32)).to(dev),
            "labels": torch.from_numpy(rng.randint(0, NUM_CLASS, B)).to(dev)}


def per_step(launches: dict, steps: int, what: str) -> dict:
    if any(v % steps for v in launches.values()):
        raise RuntimeError(f"{what}: launches {launches} are not the same in each of {steps} steps")
    return {k: v // steps for k, v in launches.items()}


def check_dtypes(model, what: str):
    bad = [k for k, v in model.state_dict().items() if v.dtype != torch.float32]
    if bad:
        raise RuntimeError(f"{what}: parameters or BN statistics left float32: {bad[:3]}")


def phase_cls_train(dev):
    """The cls train step at B16 x 1024 in float32 and in bfloat16 from one
    initial state, CLS_LEARN_STEPS steps each on one fixed batch: losses
    finite, the last below the first (tests/test_precision.py:37-55);
    launches a step FPS 2, resident kNN 2, no other search, and in bfloat16
    the gather backwards (float32 and bfloat16 sums together) and plans of
    the float32 step; parameters and BN statistics stay float32. Then one
    bfloat16 step at B64 x 1024 (modelnet40_cls_b64). Returns the launches a
    step by dtype, the gathers of a float32 and of a bfloat16 step, and
    (model, initial state, batch) for the timing."""
    import copy

    from pointasnl_tpu_torch.models import PointASNLCls

    model = PointASNLCls(NUM_CLASS, adaptive_sample=True,
                         generator=torch.Generator().manual_seed(SEED + 6), device=dev)
    init = copy.deepcopy(model.state_dict())
    batch = cls_train_batch(700, CLS_TRAIN_B, dev)
    launches, gathers = {}, {}
    for dtype in ("float32", "bfloat16"):
        model.load_state_dict(init)
        state, step = cls_trainer(model, CLS_TRAIN_B)
        step = in_dtype(dtype, step)
        reset_counts()
        losses = [float(step(state, batch)["loss"]) for _ in range(CLS_LEARN_STEPS)]
        torch.cuda.synchronize()
        launches[dtype] = per_step(counts(), CLS_LEARN_STEPS, f"cls {dtype} train")
        check_dtypes(model, f"cls {dtype} train")
        print(f"cls train {dtype}, B{CLS_TRAIN_B}x{NUM_POINT}: losses " +
              " ".join(f"{v:.4f}" for v in losses) + f"; launches a step {launches[dtype]}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise RuntimeError(f"cls {dtype} train: the loss is not finite or did not fall")
        model.load_state_dict(init)
        state, step = cls_trainer(model, CLS_TRAIN_B)
        gathers[dtype], _ = record_gathers(lambda: in_dtype(dtype, step)(state, batch))
    f32, bf16 = launches["float32"], launches["bfloat16"]
    searches = {"fps": 2, "knn_resident": 2, "ball_query": 0, "knn_spatial": 0,
                "knn_streaming": 0, "flash_fwd": 0, "flash_bwd": 0}
    if ({k: f32[k] for k in searches} != searches or {k: bf16[k] for k in searches} != searches
            or f32["gather_bwd_bf16"] != 0 or not f32["gather_bwd"]
            or bf16["gather_bwd"] + bf16["gather_bwd_bf16"] != f32["gather_bwd"]
            or bf16["gather_plan"] != f32["gather_plan"] or not bf16["gather_bwd_bf16"]):
        raise RuntimeError(f"cls train launches a step: float32 {f32}, bfloat16 {bf16}")

    model64 = PointASNLCls(NUM_CLASS, adaptive_sample=True,
                           generator=torch.Generator().manual_seed(SEED + 6), device=dev)
    state, step = cls_trainer(model64, CLS_B64)
    batch64 = cls_train_batch(701, CLS_B64, dev)
    reset_counts()
    loss = float(in_dtype("bfloat16", step)(state, batch64)["loss"])
    torch.cuda.synchronize()
    got = counts()
    print(f"cls train bfloat16, B{CLS_B64}x{NUM_POINT}: loss {loss:.4f}; launches {got}")
    if not np.isfinite(loss) or got != bf16:
        raise RuntimeError(f"cls B{CLS_B64} bfloat16 step: loss {loss}, launches {got}, "
                           f"expected those of B{CLS_TRAIN_B}: {bf16}")
    check_dtypes(model64, "cls B64 bfloat16 train")
    return launches, gathers, (model, init, batch, model64, batch64)


def phase_cls_card_vs_cpu(dev, B: int = CLS_CMP_B):
    """One float32 cls train step at B8 x 1024 on the card against the same
    step on the CPU in float32 and float64, the same weights, the same
    dropout masks (drawn on the card, moved to the CPU), and the card's
    searches replayed on the CPU (SearchTape), so the steps differ in their
    arithmetic only. The CPU's own layer-1 FPS and kNN indices must equal
    the card's (its level-2 differences and the heads' max-pool argmax
    differences are counted). Loss terms and BN statistics within the
    float32 yardstick each, as phase_card_vs_cpu; the gradients as one
    vector: |card - cpu| <= YARDSTICK |cpu - cpu64| + FLOOR_RTOL |cpu64| over
    all parameters. Leaf by leaf the yardstick is ill-posed here: where the
    CPU's float32 error in a leaf happens to be tiny, the card's, no larger
    over the model, exceeds ten times it (on the H100, PERF.md section 6: 14
    of 104 leaves, while the whole vector was 6.4e-5 apart against the CPU's
    own 2.1e-4 from float64); the worst leaves are printed."""
    from pointasnl_tpu_torch.models import PointASNLCls

    card = PointASNLCls(NUM_CLASS, adaptive_sample=True,
                        generator=torch.Generator().manual_seed(SEED + 9), device=dev)
    sd = {k: v.cpu() for k, v in card.state_dict().items()}
    batch = cls_train_batch(710, B, dev)
    tape, runs = SearchTape(), {}
    for name, dtype in (("card", None), ("cpu", torch.float32), ("cpu64", torch.float64)):
        if dtype is None:
            model, to = card, (lambda t: t)
        else:
            model = PointASNLCls(NUM_CLASS, adaptive_sample=True, device="cpu")
            model.load_state_dict(sd)
            model.to(dtype)
            to = (lambda t, d=dtype: t.cpu().to(d) if t.is_floating_point() else t.cpu())
        state, step = cls_trainer(model, B, dropout_device=dev)
        seen = {}
        hooks = [model.layer1.register_forward_hook(
            lambda m, a, out: seen.__setitem__("l1_xyz", out[0].detach()))]
        hooks += [getattr(model, h).convs[-1].register_forward_hook(  # the heads' pre-pool
            lambda m, a, out, h=h: seen.__setitem__(h, out.detach().argmax(dim=2).cpu()))
            for h in ("layer3_1", "layer3_2")]
        with (tape.recording() if name == "card" else tape.replaying()):
            metrics = step(state, {k: to(v) for k, v in batch.items()})
        torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        runs[name] = {"metrics": {k: v.cpu() for k, v in metrics.items()},
                      "grads": {k: p.grad.cpu().double() for k, p in model.named_parameters()},
                      "state": {k: v.cpu() for k, v in model.state_dict().items()}, **seen}
    x = batch["points"]
    for what, a, b in zip(("fps", "knn"), layer_indices(x, 512, 32),
                          layer_indices(x.cpu(), 512, 32)):
        if not torch.equal(a, b):
            raise RuntimeError(f"cls card vs cpu: layer-1 {what} indices differ")
    l2 = [int((a != b).sum()) for a, b in zip(layer_indices(runs["card"]["l1_xyz"], 128, 64),
                                               layer_indices(runs["cpu"]["l1_xyz"], 128, 64))]
    flips = {h: int((runs["card"][h] != runs["cpu"][h]).sum()) for h in ("layer3_1", "layer3_2")}
    c, p, p64 = runs["card"], runs["cpu"], runs["cpu64"]
    worst = {"loss terms": max(_yardstick(k, c["metrics"][k], p["metrics"][k], p64["metrics"][k],
                                          abs(float(p64["metrics"][k])))
                               for k in c["metrics"] if k != "accuracy"),
             "BN stats": max(_yardstick(f"BN {k}", c["state"][k], p["state"][k], p64["state"][k],
                                        max(float(p64["state"][k].abs().max()), 1.0))
                             for k in c["state"] if k.endswith((".mean", ".var")))}
    g, g32, g64 = (torch.cat([r["grads"][k].flatten() for k in c["grads"]]) for r in (c, p, p64))
    err, f32 = float((g - g32).norm()), float((g32 - g64).norm())
    limit = YARDSTICK * f32 + FLOOR_RTOL * float(g64.norm())
    gmax = float(g64.abs().max())
    leaves = sorted(((float((c["grads"][k] - p["grads"][k]).abs().max())
                      / (YARDSTICK * float((p["grads"][k] - p64["grads"][k]).abs().max())
                         + FLOOR_RTOL * max(float(p64["grads"][k].abs().max()), 1e-6 * gmax)), k)
                     for k in c["grads"]), reverse=True)
    print(f"cls card vs cpu, B{B}x{NUM_POINT} train step (searches replayed, the same dropout "
          f"masks): " + ", ".join(
              f"{k} card {float(c['metrics'][k]):.7f} cpu {float(p['metrics'][k]):.7f} cpu64 "
              f"{float(p64['metrics'][k]):.7f}" for k in ("loss", "classify_loss", "reg_loss")))
    print(f"cls card vs cpu: layer-1 FPS and kNN indices exact; the CPU's own level-2 indices "
          f"differing: fps {l2[0]}, knn {l2[1]}; the heads' max-pool argmax differing: {flips}; "
          f"worst error / limit: loss terms {worst['loss terms']:.3f}, BN stats "
          f"{worst['BN stats']:.3f}; gradients as one vector |card - cpu| {err:.3e} against "
          f"|cpu - cpu64| {f32:.3e} (limit {limit:.3e}: {err / limit:.3f}); leaf by leaf, worst "
          + ", ".join(f"{k} {r:.3f}" for r, k in leaves[:3]) +
          f", {sum(r > 1 for r, _ in leaves)} of {len(leaves)} past it")
    if not err <= limit:
        raise RuntimeError(f"cls card vs cpu: gradients {err:.3e} apart, over {limit:.3e}")


def update_norms(model, before):
    return {k: float((p.detach().double() - before[k]).norm())
            for k, p in model.named_parameters()}


def bf16_gate(label: str, model, init, batch):
    """JAX's bfloat16 gate against the card's own float32 step: from the
    state `init`, one step of `model` (SGD with momentum at 1e-2, as JAX's
    gate) in float32, its searches recorded, and one in bfloat16 with those
    searches replayed: the loss within BF16_LOSS_RTOL relative, the update
    norms within BF16_D_MAX as one vector. The model is left at the
    bfloat16 step's state."""
    from pointasnl_tpu_torch.nn import precision
    from pointasnl_tpu_torch.train import (
        TrainState,
        bn_momentum_schedule,
        make_optimizer,
        make_train_step,
        staircase_lr_schedule,
    )

    B, N = batch["points"].shape[:2]
    dev = batch["points"].device
    runs, tape = {}, SearchTape()
    for dtype in ("float32", "bfloat16"):
        model.load_state_dict(init)
        before = {k: p.detach().double().clone() for k, p in model.named_parameters()}
        state = TrainState(model, make_optimizer(
            "momentum", staircase_lr_schedule(1e-2, B, 1e9, 0.7), model.parameters()))
        step = make_train_step(bn_schedule=bn_momentum_schedule(B, 1e9), task="seg",
                               uniform_weight=0.01)
        with (tape.recording() if dtype == "float32" else tape.replaying()), \
                precision.compute_dtype(dtype):
            loss = float(step(state, batch, torch.Generator(device=dev).manual_seed(SEED + 11))
                         ["loss"])
        runs[dtype] = loss, update_norms(model, before)
    (l32, n32), (l16, n16) = runs["float32"], runs["bfloat16"]
    loss_rel = abs(l16 - l32) / abs(l32)
    d = float(np.sqrt(sum((n16[k] - n32[k]) ** 2 for k in n32) / sum(v ** 2 for v in n32.values())))
    floor = 1e-2 * max(n32.values())
    leaf, name = max((abs(n16[k] - a) / max(0.1 * a, floor), k) for k, a in n32.items())
    print(f"{label}, B{B}x{N} (searches replayed): loss float32 {l32:.6f} bfloat16 "
          f"{l16:.6f}, {loss_rel:.2e} relative (limit {BF16_LOSS_RTOL}); update norms "
          f"{d:.4f} apart relative (limit {BF16_D_MAX:.3f}); JAX's per-parameter gate's worst "
          f"{leaf:.3f} x its limit ({name})")
    if not loss_rel < BF16_LOSS_RTOL or not d <= BF16_D_MAX:
        raise RuntimeError(f"{label}: the bfloat16 step fails the bfloat16 gate against the "
                           f"float32 step")
    return loss_rel, d


def phase_seg_bf16(dev):
    """The seg step in bfloat16: 3 of the recipe's steps at B4 x 10240
    (launches a step those of the float32 step: FPS 4, kNN 11, ball query 1,
    gather backward 19 on 12 plans, float32 and bfloat16 sums together);
    JAX's gate against the card's own float32 step (SGD with momentum 1e-2
    from one state, the float32 step's searches replayed in the bfloat16
    one): loss within BF16_LOSS_RTOL, update norms within BF16_D_MAX; one
    bfloat16 step at B16 x 10240 (scannet_seg_res_b16). Parameters and BN
    statistics stay float32. Returns the B4 state and bfloat16 step, and
    its launches a step."""
    import copy

    from pointasnl_tpu_torch.models import PointASNLSemSegRes

    model = PointASNLSemSegRes(SEG_CLASSES, generator=torch.Generator().manual_seed(SEED + 7),
                               device=dev)
    init = copy.deepcopy(model.state_dict())
    batch = seg_batch(800, SEG_B, SEG_N, SEG_SIDE, dev)
    bf16_gate("seg bf16 gate", model, init, batch)

    model.load_state_dict(init)
    state, step = seg_trainer(model, SEG_B)
    step = in_dtype("bfloat16", step)
    reset_counts()
    metrics = [step(state, batch) for _ in range(SEG_STEPS)]
    torch.cuda.synchronize()
    launches = per_step(counts(), SEG_STEPS, "seg bfloat16 train")
    check_dtypes(model, "seg bfloat16 train")
    losses = [float(m["loss"]) for m in metrics]
    print(f"seg train bfloat16, B{SEG_B}x{SEG_N}: losses " + " ".join(f"{v:.4f}" for v in losses) +
          f"; launches a step {launches}")
    want = {"fps": 4, "knn_resident": 11, "ball_query": 1, "knn_spatial": 0, "knn_streaming": 0,
            "flash_fwd": 0, "flash_bwd": 0, "flash_fwd_bf16": 0, "flash_bwd_bf16": 0,
            "gather_plan": SEG_GATHER_PLANS}
    if ({k: launches[k] for k in want} != want or not launches["gather_bwd_bf16"]
            or launches["gather_bwd"] + launches["gather_bwd_bf16"] != SEG_GATHER_BWD
            or not all(np.isfinite(losses))):
        raise RuntimeError(f"seg bfloat16 train: launches a step {launches}, losses {losses}")

    big = PointASNLSemSegRes(SEG_CLASSES, generator=torch.Generator().manual_seed(SEED + 7),
                             device=dev)
    state16, step16 = seg_trainer(big, SEG_B16)
    batch16 = seg_batch(801, SEG_B16, SEG_N, SEG_SIDE, dev)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loss = float(in_dtype("bfloat16", step16)(state16, batch16)["loss"])
    torch.cuda.synchronize()
    got = counts()
    print(f"seg train bfloat16, B{SEG_B16}x{SEG_N}: loss {loss:.4f}; launches {got}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not np.isfinite(loss) or got != launches:
        raise RuntimeError(f"seg B{SEG_B16} bfloat16 step: loss {loss}, launches {got}, expected "
                           f"those of B{SEG_B}: {launches}")
    check_dtypes(big, "seg B16 bfloat16 train")
    return state, step, launches, (big, state16, step16, batch16, batch)


def phase_seg_bf16_flash(dev):
    """Slice 15: PointASNLSemSegRes(21, nl_use_flash=True) in bfloat16, as
    the dense bfloat16 step and the float32 flash step run: SEG_STEPS of the
    recipe's steps at B4 x 10240, each launching the bfloat16 flash forward
    and backward once for each of the 4 non-local cells and the float32
    flash kernels never, beside the bfloat16 step's FPS 4, kNN 11, ball
    query 1 and 19 gather backwards on 12 plans; SEG_REQUESTS requests
    through serve.make_inference_fn under the same compute dtype (the
    bfloat16 forward 4 a request, logits finite); and JAX's bfloat16 gate
    (bf16_gate) against the card's float32 flash step from one state, its
    searches replayed. Returns (state, step, infer, launches a step,
    launches a request), the step and the request run in bfloat16."""
    import copy

    from pointasnl_tpu_torch.models import PointASNLSemSegRes
    from pointasnl_tpu_torch.nn import precision
    from pointasnl_tpu_torch.serve import make_inference_fn

    model = PointASNLSemSegRes(SEG_CLASSES, nl_use_flash=True,
                               generator=torch.Generator().manual_seed(SEED + 9), device=dev)
    init = copy.deepcopy(model.state_dict())
    batch = seg_batch(810, SEG_B, SEG_N, SEG_SIDE, dev)
    bf16_gate("seg bf16 flash gate", model, init, batch)

    model.load_state_dict(init)
    state, step = seg_trainer(model, SEG_B)
    step = in_dtype("bfloat16", step)
    batches = [seg_batch(820 + s, SEG_B, SEG_N, SEG_SIDE, dev) for s in range(SEG_STEPS)]
    reset_counts()
    metrics = [step(state, b) for b in batches]
    torch.cuda.synchronize()
    launches = per_step(counts(), SEG_STEPS, "seg bfloat16 flash train")
    check_dtypes(model, "seg bfloat16 flash train")
    losses = [float(m["loss"]) for m in metrics]
    print(f"seg train bfloat16 flash, B{SEG_B}x{SEG_N}: losses " +
          " ".join(f"{v:.4f}" for v in losses) + f"; launches a step {launches}")
    want = {**GRID_STEP_LAUNCHES, "flash_fwd_bf16": 4, "flash_bwd_bf16": 4}
    if (fold_gathers(launches) != fold_gathers(want) or not launches["gather_bwd_bf16"]
            or not all(np.isfinite(losses))):
        raise RuntimeError(f"seg bfloat16 flash train: launches a step {launches}, expected "
                           f"{want} (float32 and bfloat16 gather sums together); losses "
                           f"{losses}")

    infer = make_inference_fn(model)

    def infer_bf16(x):
        with precision.compute_dtype("bfloat16"):
            return infer(x)

    clouds = [cube(830 + r, SEG_B, SEG_N, SEG_SIDE, dev) for r in range(SEG_REQUESTS)]
    reset_counts()
    logits = [infer_bf16(x) for x in clouds]
    torch.cuda.synchronize()
    serve_launches = per_step(counts(), SEG_REQUESTS, "seg bfloat16 flash serve")
    print(f"seg serve bfloat16 flash: {SEG_REQUESTS} requests of B{SEG_B}x{SEG_N}; launches a "
          f"request {serve_launches}")
    want = {**GRID_FORWARD_LAUNCHES, "flash_fwd_bf16": 4}
    if serve_launches != want:
        raise RuntimeError(f"seg bfloat16 flash serve: launches a request {serve_launches}, "
                           f"expected {want}")
    for r, out in enumerate(logits):
        if out.shape != (SEG_B, SEG_N, SEG_CLASSES) or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"seg bfloat16 flash request {r}: logits {tuple(out.shape)} not "
                               f"all finite")
    return state, step, infer_bf16, launches, serve_launches


def phase_gather_bf16(dev):
    """The 19 gather backwards of a bfloat16 seg step at B4 x 10240 (those of
    bfloat16 cotangents take the bfloat16 sum, the xyz gathers' the float32
    one), each equal to the bit to its plain version on the card, to a second
    launch and to CPU float32 index_add_ of the widened rows, rounded to the
    cotangents' dtype once. Returns the cases, for the timing."""
    from pointasnl_tpu_torch.ops.cuda import gather_backward

    cases = seg_gathers(dev, "bfloat16")
    for i, (dout, idx, n) in enumerate(cases):
        B, R, C = dout.shape
        got = gather_backward.gather_backward(dout, idx, n)
        again = gather_backward.gather_backward(dout, idx, n)
        plain = gather_backward.gather_backward_reference(dout, idx, n)
        torch.cuda.synchronize()
        cpu = index_add(dout.cpu().float(), idx.cpu(), n).to(dout.dtype).view(B, n, C)
        if not (got.dtype == dout.dtype and torch.equal(got, again) and torch.equal(got, plain)
                and torch.equal(got.cpu(), cpu)):
            raise RuntimeError(f"bfloat16 step's gather backward {i} B{B} {R} rows -> {n} C{C} "
                               f"{dout.dtype}: the kernel differs from a second launch, its plain "
                               f"version or CPU float32 index_add_ rounded once")
        print(f"gather backward {i} of a bfloat16 seg step, B{B} {R} rows -> {n} C{C} "
              f"{str(dout.dtype)[6:]}: equal to the bit to the plain version, CPU index_add_ "
              f"(float32, rounded once) and a second launch")
    # A row gathered 3000 times, and B16 x 10240's level-1 grouping, in bfloat16.
    for name, idx, n in plan_cases(dev)[:3:2]:
        B, R = idx.shape
        rng = np.random.RandomState(R)
        dout = torch.from_numpy(rng.randn(B, R, 32).astype(np.float32)).to(dev).bfloat16()
        got = gather_backward.gather_backward(dout, idx, n)
        want = gather_backward.gather_backward_reference(dout, idx, n)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"bfloat16 gather backward {name}: differs from its plain version")
        print(f"bfloat16 gather backward {name}, B{B} {R} rows -> {n} C32: equal to the bit to the "
              f"plain version")
    return cases


def time_steps(card, runs: dict, reps: int = 5) -> dict:
    """Each step of `runs` (label: (fn, points a step)) timed in turns (A, B,
    ..., B, A; `reps` samples by CUDA events each time), then its peak
    memory over 2 more calls. Returns label: (p50, p90, peak GiB)."""
    order = list(runs) + list(runs)[::-1]
    samples = {k: [] for k in runs}
    for label in order:
        samples[label] += time_ms(runs[label][0], reps=reps, warmup=1)
    out = {}
    for label, (fn, points) in runs.items():
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        p50, p90 = percentiles(samples[label])
        print(f"time {label}: p50 {p50:.3f} ms, p90 {p90:.3f} ms of {len(samples[label])} (CUDA "
              f"events, in turns with {', '.join(k for k in runs if k != label)}); "
              f"{points / p50 * 1e3:.0f} points/s at p50; peak memory {peak:.2f} GiB  [{card}]")
        out[label] = p50, p90, peak
    return out


def plan_kernels(gathers) -> int:
    return sum(len(plan_symbols(*idx.shape, n)) for idx, n in seg_plans(gathers))


def time_slice11(card, cls, cls_launches, cls_gathers, seg_state, seg_step, seg_launches,
                 seg_gathers_bf16, seg_extra, seg_f32, seg_bf16_flash, seg_flash):
    """Step times of slice 11 (p50 and p90 by CUDA events, peak memory), in
    turns with the float32 seg step (`seg_f32`: its state and step) and, for
    slice 15, the bfloat16 flash seg step and request (`seg_bf16_flash`, as
    phase_seg_bf16_flash returns them) and the float32 flash step
    (`seg_flash`); a profiler window over 3 steps of each of the cls float32
    and bfloat16 steps, the seg bfloat16 step and the bfloat16 flash step
    (device-busy share)."""
    model, init, batch, model64, batch64 = cls
    big, state16, step16, batch16, _ = seg_extra
    model.load_state_dict(init)
    state, step = cls_trainer(model, CLS_TRAIN_B)
    state64, step64 = cls_trainer(model64, CLS_B64)
    steps = {
        f"cls train step float32 B{CLS_TRAIN_B}x{NUM_POINT}":
            (lambda: step(state, batch), CLS_TRAIN_B * NUM_POINT),
        f"cls train step bfloat16 B{CLS_TRAIN_B}x{NUM_POINT}":
            (lambda: in_dtype("bfloat16", step)(state, batch), CLS_TRAIN_B * NUM_POINT),
        f"seg train step bfloat16 B{SEG_B}x{SEG_N}":
            (lambda: seg_step(seg_state, seg_extra[4]), SEG_B * SEG_N),
        f"seg train step float32 B{SEG_B}x{SEG_N}":
            (lambda: seg_f32[1](seg_f32[0], seg_extra[4]), SEG_B * SEG_N),
        f"seg train step bfloat16 flash B{SEG_B}x{SEG_N}":
            (lambda: seg_bf16_flash[1](seg_bf16_flash[0], seg_extra[4]), SEG_B * SEG_N),
        f"seg train step float32 flash B{SEG_B}x{SEG_N}":
            (lambda: seg_flash[1](seg_flash[0], seg_extra[4]), SEG_B * SEG_N),
        f"seg serve request bfloat16 flash B{SEG_B}x{SEG_N}":
            (lambda: seg_bf16_flash[2](seg_extra[4]["points"]), SEG_B * SEG_N),
    }
    out = time_steps(card, steps, reps=5)
    out.update(time_steps(card, {
        f"cls train step bfloat16 B{CLS_B64}x{NUM_POINT}":
            (lambda: in_dtype("bfloat16", step64)(state64, batch64), CLS_B64 * NUM_POINT),
        f"seg train step bfloat16 B{SEG_B16}x{SEG_N}":
            (lambda: in_dtype("bfloat16", step16)(state16, batch16), SEG_B16 * SEG_N)}, reps=2))

    def expected(launches, gathers):
        rename = {"knn_resident": "knn"}
        per_call = {rename.get(k, k): v for k, v in launches.items()}
        per_call["gather_plan"] = plan_kernels(gathers)
        return per_call

    for label, fn, launches, gathers, trace in (
            ("cls float32 train steps", lambda: step(state, batch), cls_launches["float32"],
             cls_gathers["float32"], "profile_cls_step.json"),
            ("cls bfloat16 train steps", lambda: in_dtype("bfloat16", step)(state, batch),
             cls_launches["bfloat16"], cls_gathers["bfloat16"], "profile_cls_bf16_step.json"),
            ("seg bfloat16 train steps", lambda: seg_step(seg_state, seg_extra[4]), seg_launches,
             seg_gathers_bf16, "profile_seg_bf16_step.json")):
        profile_window(fn, 3, expected(launches, gathers), card, label, trace)
    # The bfloat16 flash step: a forward call is one or two kernels at each
    # level, a backward two or three (flash_fwd_symbols, flash_bwd_symbols).
    per_call = {**expected(seg_bf16_flash[3], seg_gathers_bf16),
                "flash_fwd_bf16": sum(len(flash_fwd_symbols(*shape)) for shape in FLASH_SEG),
                "flash_bwd_bf16": sum(len(flash_bwd_symbols(*shape)) for shape in FLASH_SEG)}
    profile_window(lambda: seg_bf16_flash[1](seg_bf16_flash[0], seg_extra[4]), 3, per_call, card,
                   "seg bfloat16 flash train steps", "profile_seg_bf16_flash_step.json")
    return out


def phase_train_loop(dev, seg_infer):
    """The train loop's modules on the card: cls float32 steps at B16 x 1024
    with a CheckpointManager save after 2 steps; 2 more steps; a fresh model
    and optimizer restored from the save take the same 2 steps, equal to
    the bit (parameters, BN statistics, Adam's moments, metrics); a
    StepTraceWindow of 3 steps writes its trace; the metrics go through
    MetricWriter.create; a DeviceIouEval on seg logits equals the numpy
    IouEval."""
    import shutil

    from pointasnl_tpu_torch.models import PointASNLCls
    from pointasnl_tpu_torch.train import CheckpointManager, DeviceIouEval, IouEval
    from pointasnl_tpu_torch.train.profiling import StepTimer, StepTraceWindow
    from pointasnl_tpu_torch.train.summary import MetricWriter

    root = OUT_DIR / "train_loop"
    shutil.rmtree(root, ignore_errors=True)

    def fresh():
        model = PointASNLCls(NUM_CLASS, adaptive_sample=True,
                             generator=torch.Generator().manual_seed(SEED + 12), device=dev)
        return (model, *cls_trainer(model, CLS_TRAIN_B, dropout_seed=SEED + 13))

    batch = cls_train_batch(720, CLS_TRAIN_B, dev)
    model, state, step = fresh()
    manager = CheckpointManager(str(root / "ckpt"), max_to_keep=2)
    writer = MetricWriter.create(str(root / "logs"), "train")
    window = StepTraceWindow(str(root / "profile"), enabled=True, steps=3, log=print)
    timer = StepTimer(points_per_step=CLS_TRAIN_B * NUM_POINT)
    for epoch in range(2):
        with timer.step():
            metrics = window.traced(lambda: step(state, batch))
        writer.scalars({k: float(v) for k, v in metrics.items()}, state.step)
    manager.save(state, 1, is_best=True)
    after = []
    for _ in range(2):
        with timer.step():
            metrics = window.traced(lambda: step(state, batch))
        writer.scalars({k: float(v) for k, v in metrics.items()}, state.step)
        after.append(({k: v.clone() for k, v in model.state_dict().items()},
                      {k: float(v) for k, v in metrics.items()}))
    window.close()
    writer.close()
    model2, state2, step2 = fresh()
    manager.restore(state2, "latest")
    again = []
    for _ in range(2):
        metrics = step2(state2, batch)
        again.append(({k: v.clone() for k, v in model2.state_dict().items()},
                      {k: float(v) for k, v in metrics.items()}))
    torch.cuda.synchronize()
    same = all(m1 == m2 and all(torch.equal(w1[k], w2[k]) for k in w1)
               for (w1, m1), (w2, m2) in zip(after, again))
    same &= all(torch.equal(state.optimizer.state[p]["exp_avg_sq"],
                            state2.optimizer.state[q]["exp_avg_sq"])
                for p, q in zip(model.parameters(), model2.parameters()))
    if not same:
        raise RuntimeError("train loop: the run restored from the checkpoint differs from the "
                           "uninterrupted one")
    if window.path is None or not Path(window.path).stat().st_size:
        raise RuntimeError("train loop: the StepTraceWindow wrote no trace")
    logs = sorted(p.name for p in (root / "logs").rglob("*") if p.is_file())
    print(f"train loop: restored at step 2 from {manager.epochs()} (best "
          f"{manager.best_epoch()}), the next 2 steps equal to the bit to the uninterrupted "
          f"run's; trace of 3 steps {Path(window.path).name} "
          f"({Path(window.path).stat().st_size} bytes); metric files {logs}; {timer.summary()}")

    x = cube(900, SEG_B, SEG_N, SEG_SIDE, dev)
    labels = torch.from_numpy(np.random.RandomState(901).randint(0, SEG_CLASSES, (SEG_B, SEG_N)))
    preds = seg_infer(x).argmax(-1)
    host, device = IouEval(SEG_CLASSES, ignore=[0]), DeviceIouEval(SEG_CLASSES, ignore=[0],
                                                                   device=dev)
    host.addBatch(preds.cpu().numpy(), labels.numpy())
    device.addBatch(preds, labels.to(dev))
    (m_host, iou_host), (m_dev, iou_dev) = host.getIoU(), device.getIoU()
    if not (device.conf_matrix.is_cuda and np.array_equal(device.conf_matrix.cpu().numpy(),
                                                          host.conf_matrix)
            and m_host == m_dev and np.array_equal(iou_host, iou_dev)
            and host.getacc() == device.getacc()):
        raise RuntimeError("train loop: the device IouEval differs from the numpy one")
    print(f"train loop: DeviceIouEval on B{SEG_B}x{SEG_N} seg logits equal to the numpy IouEval "
          f"(mIoU {m_dev:.5f}, accuracy {device.getacc():.5f})")


def scannet_pickles(root: Path, seed: int = SEED + 40, scenes: int = ENC_B):
    """Write synthetic ScanNet pickles (the four lists data/scannet.py reads)
    of `scenes` ENC_SCENE_N-point surface scenes with random RGB and labels
    a split into root, and the val split's scene list. The trainer's debug
    epoch draws one batch of crops from as many scenes."""
    import pickle

    from pointasnl_tpu_torch.data import surface_scene

    rng = np.random.RandomState(seed)
    for split in ("train", "val"):
        xyz = [surface_scene(rng, 1, ENC_SCENE_N, extent=ENC_SCENE_EXTENT)[0]
               for _ in range(scenes)]
        lists = ([np.concatenate([x, (rng.rand(ENC_SCENE_N, 3) * 255).astype(np.float32)], 1)
                  for x in xyz],
                 [rng.randint(0, SEG_CLASSES, ENC_SCENE_N).astype(np.int32) for _ in xyz],
                 [np.arange(ENC_SCENE_N) for _ in xyz], [ENC_SCENE_N for _ in xyz])
        with open(root / f"scannet_{split}_rgb21c_pointid.pickle", "wb") as f:
            for obj in lists:
                pickle.dump(obj, f)
    (root / "scannetv2_val.txt").write_text("".join(f"scene{i:04d}_00\n" for i in range(scenes)))


def scannet_batch(root, B: int, N: int, seed: int, dev, split: str = "train"):
    """B crops of N points that ScannetDataset draws (with replacement, so
    with exact duplicates) from the pickles in root, z-rotated and
    normalised as cli/train_scannet.py does it: points (B, N, 6), labels and
    smpw, on dev."""
    from pointasnl_tpu_torch.data import provider
    from pointasnl_tpu_torch.data.scannet import ScannetDataset

    rs = np.random.RandomState(seed)
    ds = ScannetDataset(str(root), block_points=N, split=split, with_rgb=True, random_state=rs)
    crops = [ds[i % len(ds)] for i in range(B)]
    pts = np.stack([c[0] for c in crops]).astype(np.float32)
    pts[..., :3] = provider.rotate_point_cloud_z(pts[..., :3], random_state=rs)
    pts[..., :3] = provider.normalize_data(pts[..., :3])
    return {"points": torch.from_numpy(pts).to(dev),
            "labels": torch.from_numpy(np.stack([c[1] for c in crops])).to(dev),
            "smpw": torch.from_numpy(np.stack([c[2] for c in crops]).astype(np.float32)).to(dev)}


def duplicates(points) -> int:
    """Points of a batch that repeat an earlier point of their cloud exactly."""
    x = points[..., :3].cpu().numpy()
    return sum(len(c) - len(np.unique(c, axis=0)) for c in x)


def enc_levels(xyz):
    """The xyz of the encoder-decoder's five levels: FPS of FPS of xyz."""
    from pointasnl_tpu_torch.ops import geometry
    from pointasnl_tpu_torch.ops.cuda import fps

    levels = [xyz]
    for n in ENC_LEVELS[1:]:
        levels.append(geometry.gather_point(levels[-1], fps.farthest_point_sample(n, levels[-1])))
    return levels


def phase_encdec_kernels(dev, root) -> dict:
    """Slice 12's kernel checks: FPS on the four levels (8192 -> 1024 in the
    cluster design and in the block design beside it) and the twelve kNN
    searches (among them the k16 self-kNN at 8192^2 and the k3 search
    8192q/1024) against their plain versions, indices exact, on a
    ScannetDataset batch (with duplicates) and on a cube; the ball query of
    the repulsion loss on the crop's l1. Returns max |err| by kernel."""
    from pointasnl_tpu_torch.ops import geometry
    from pointasnl_tpu_torch.ops.cuda import ball_query, fps, knn

    errs = {"fps": 0.0, "knn_resident": 0.0, "ball_query": 0.0}
    crop = scannet_batch(root, ENC_B, ENC_N, 420, dev)["points"][..., :3].contiguous()
    inputs = {f"ScannetDataset crop ({duplicates(crop)} duplicate points)": crop,
              "cube": cube(421, ENC_B, ENC_N, SEG_SIDE, dev)}
    for what, x in inputs.items():
        levels = enc_levels(x)
        for a, n in zip(levels, ENC_LEVELS[1:]):
            want = geometry.farthest_point_sample(n, a)
            routed = fps_design(a)
            for design in dict.fromkeys([routed, "block"]):
                got = fps._sample(design, n, a)
                if not torch.equal(got, want):
                    raise RuntimeError(f"fps B{ENC_B} N{a.shape[1]} -> {n} on the {what} "
                                       f"({design} design): kernel and plain differ")
                print(f"fps B{ENC_B} N{a.shape[1]} -> {n} on the {what} ({design} design"
                      f"{', routed' if design == routed else ''}): indices exact")
        for si, qi, k in ENC_KNN:
            s, q = levels[si], levels[qi]
            err = check_knn(f"knn B{ENC_B} {q.shape[1]}q/{s.shape[1]} k{k} on the {what}",
                            knn.knn_point(k, s, q), geometry.knn_point(k, s, q))
            errs["knn_resident"] = max(errs["knn_resident"], err)
        l1 = levels[1]
        got = ball_query.query_ball_point(REPULSION_RADIUS, REPULSION_NSAMPLE, l1, l1)
        want = geometry.query_ball_point(REPULSION_RADIUS, REPULSION_NSAMPLE, l1, l1)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise RuntimeError(f"ball query B{ENC_B} {l1.shape[1]}q/{l1.shape[1]} on the {what}: "
                               f"kernel and plain differ")
        print(f"ball query B{ENC_B} {l1.shape[1]}q/{l1.shape[1]} ns{REPULSION_NSAMPLE} "
              f"r{REPULSION_RADIUS} on the {what}: indices and counts exact (mean count "
              f"{float(got[1].float().mean()):.3f})")
    return errs


def encdec_model(dev, seed: int = SEED, flash: bool = False):
    from pointasnl_tpu_torch.models import PointASNLSemSeg

    return PointASNLSemSeg(SEG_CLASSES, ENC_FEATURES, nl_use_flash=flash,
                           generator=torch.Generator().manual_seed(seed), device=dev)


def phase_encdec(dev, root):
    """Slice 12's train and serve paths: PointASNLSemSeg(21, feature_channel=3)
    takes ENC_STEPS train steps at B6 x 8192 on ScannetDataset crops (Adam,
    staircase LR, BN-momentum schedule, weight decay 1e-4, uniform weight
    0.01, dropout keep 0.5): a step must launch FPS 4, the resident kNN 12,
    the ball query 1 and the gather backward ENC_GATHER_BWD on
    ENC_GATHER_PLANS plans, its losses finite; then it answers ENC_REQUESTS
    requests through serve.make_inference_fn: FPS 4 and kNN 12 a request,
    no ball query or gather backward, logits finite. Then one more step
    with the gather backward's wrapper recorded: each of its gathers equal
    to the bit to its plain version and to CPU index_add_; and two steps
    from one state equal to the bit."""
    from pointasnl_tpu_torch.serve import make_inference_fn

    model = encdec_model(dev)
    n_params = sum(p.numel() for p in model.parameters())
    state, step = seg_trainer(model, ENC_B)
    batches = [scannet_batch(root, ENC_B, ENC_N, 430 + s, dev) for s in range(ENC_STEPS)]
    print(f"encdec slice: PointASNLSemSeg({SEG_CLASSES}, feature_channel={ENC_FEATURES}), "
          f"{n_params} parameters; crops of B{ENC_B}x{ENC_N} hold "
          f"{[duplicates(b['points']) for b in batches]} duplicate points")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30  # the earlier phases' and this model's
    reset_counts()
    metrics = [step(state, b) for b in batches]
    torch.cuda.synchronize()
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"encdec slice: {ENC_STEPS} train steps of B{ENC_B}x{ENC_N}; launches {launches}; "
          f"peak memory {peak:.2f} GiB, {peak - held:.2f} GiB above the {held:.2f} GiB allocated "
          f"before the steps")
    want = {**ENC_LAUNCHES, "ball_query": 1, "gather_bwd": ENC_GATHER_BWD,
            "gather_plan": ENC_GATHER_PLANS}
    if launches != {k: v * ENC_STEPS for k, v in want.items()}:
        raise RuntimeError(f"encdec train launches {launches}, expected {want} a step")
    for s, m in enumerate(metrics):
        m = {k: float(v) for k, v in m.items()}
        print(f"encdec step {s}: " + ", ".join(f"{k} {v:.6f}" for k, v in m.items()))
        if not all(np.isfinite(v) for v in m.values()):
            raise RuntimeError(f"encdec step {s}: a loss is not finite")

    infer = make_inference_fn(model)
    requests = [scannet_batch(root, ENC_B, ENC_N, 440 + r, dev, split="val")["points"]
                for r in range(ENC_REQUESTS)]
    reset_counts()
    logits = [infer(x) for x in requests]
    torch.cuda.synchronize()
    serve_launches = counts()
    print(f"encdec serve: {ENC_REQUESTS} requests of B{ENC_B}x{ENC_N}; launches "
          f"{serve_launches}")
    if serve_launches != {k: v * ENC_REQUESTS for k, v in ENC_LAUNCHES.items()}:
        raise RuntimeError(f"encdec serve launches {serve_launches}, expected {ENC_LAUNCHES} "
                           f"a request")
    for r, out in enumerate(logits):
        if out.shape != (ENC_B, ENC_N, SEG_CLASSES) or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"encdec request {r}: logits {tuple(out.shape)} not all finite")
    print(f"encdec serve: logits {tuple(logits[0].shape)} finite")

    gathers, plans = record_gathers(lambda: step(state, batches[0]))
    if len(gathers) != ENC_GATHER_BWD or plans != ENC_GATHER_PLANS:
        raise RuntimeError(f"an encdec step ran {len(gathers)} gather backwards on {plans} plans, "
                           f"expected {ENC_GATHER_BWD} on {ENC_GATHER_PLANS}")
    from pointasnl_tpu_torch.ops.cuda import gather_backward

    for i, (dout, idx, n) in enumerate(gathers):
        B, R, C = dout.shape
        got = gather_backward.gather_backward(dout, idx, n)
        plain = gather_backward.gather_backward_reference(dout, idx, n)
        cpu = index_add(dout.cpu(), idx.cpu(), n).view(B, n, C)
        if not (torch.equal(got, plain) and torch.equal(got.cpu(), cpu)):
            raise RuntimeError(f"encdec gather backward {i} B{B} {R} rows -> {n} C{C}: the kernel "
                               f"differs from its plain version or CPU index_add_")
    print(f"encdec: the {len(gathers)} gather backwards of a step ({plans} plans) equal to the bit "
          f"to their plain versions and CPU index_add_")
    bad = twice_from_one_state(f"encdec train step B{ENC_B}x{ENC_N}", model, batches[1])
    if bad:
        raise RuntimeError(f"determinism: two encdec train steps from one state differ in "
                           f"{len(bad)} tensors (first: {bad[0]})")
    return state, step, infer, launches, serve_launches, gathers, batches[0]


def phase_encdec_flash(dev, root) -> dict:
    """One train step of PointASNLSemSeg(21, 3, nl_use_flash=True) at
    B6 x 8192 (what --nl_flash true builds): the flash forward and backward
    4 times each beside the dense step's launches, losses finite."""
    model = encdec_model(dev, SEED + 1, flash=True)
    state, step = seg_trainer(model, ENC_B)
    batch = scannet_batch(root, ENC_B, ENC_N, 450, dev)
    reset_counts()
    metrics = {k: float(v) for k, v in step(state, batch).items()}
    torch.cuda.synchronize()
    launches = counts()
    want = {**ENC_LAUNCHES, "ball_query": 1, "gather_bwd": ENC_GATHER_BWD,
            "gather_plan": ENC_GATHER_PLANS, "flash_fwd": 4, "flash_bwd": 4}
    print(f"encdec flash step B{ENC_B}x{ENC_N}: launches {launches}; " +
          ", ".join(f"{k} {v:.6f}" for k, v in metrics.items()))
    if launches != want:
        raise RuntimeError(f"encdec flash step launches {launches}, expected {want}")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise RuntimeError("encdec flash step: a loss is not finite")
    return launches


def phase_encdec_flash_bf16(dev, root) -> dict:
    """Slice 15: one train step of PointASNLSemSeg(21, 3, nl_use_flash=True)
    at B6 x 8192 in bfloat16 and one request through serve.make_inference_fn
    in bfloat16: the step launches the bfloat16 flash forward and backward 4
    times each and the float32 ones never, beside the dense step's searches
    and its gather backwards (float32 and bfloat16 sums together) on its
    plans; the request the bfloat16 forward 4 times beside a forward's
    searches. Loss and logits finite. Returns {"train": launches,
    "serve": launches}."""
    from pointasnl_tpu_torch.nn import precision
    from pointasnl_tpu_torch.serve import make_inference_fn

    model = encdec_model(dev, SEED + 2, flash=True)
    state, step = seg_trainer(model, ENC_B)
    batch = scannet_batch(root, ENC_B, ENC_N, 455, dev)
    reset_counts()
    metrics = {k: float(v) for k, v in in_dtype("bfloat16", step)(state, batch).items()}
    torch.cuda.synchronize()
    launches = counts()
    check_dtypes(model, "encdec bfloat16 flash step")
    want = {**ENC_LAUNCHES, "ball_query": 1, "gather_bwd": ENC_GATHER_BWD,
            "gather_plan": ENC_GATHER_PLANS, "flash_fwd_bf16": 4, "flash_bwd_bf16": 4}
    print(f"encdec bfloat16 flash step B{ENC_B}x{ENC_N}: launches {launches}; " +
          ", ".join(f"{k} {v:.6f}" for k, v in metrics.items()))
    if fold_gathers(launches) != fold_gathers(want) or not launches["gather_bwd_bf16"]:
        raise RuntimeError(f"encdec bfloat16 flash step launches {launches}, expected {want} "
                           f"(float32 and bfloat16 gather sums together)")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise RuntimeError("encdec bfloat16 flash step: a loss is not finite")
    infer = make_inference_fn(model)
    reset_counts()
    with precision.compute_dtype("bfloat16"):
        logits = infer(batch["points"])
    torch.cuda.synchronize()
    serve = counts()
    want = {**ENC_LAUNCHES, "flash_fwd_bf16": 4}
    print(f"encdec bfloat16 flash request B{ENC_B}x{ENC_N}: launches {serve}; logits "
          f"{tuple(logits.shape)} {logits.dtype}")
    if serve != want:
        raise RuntimeError(f"encdec bfloat16 flash request launches {serve}, expected {want}")
    if logits.shape != (ENC_B, ENC_N, SEG_CLASSES) or not bool(torch.isfinite(logits).all()):
        raise RuntimeError("encdec bfloat16 flash request: logits not all finite")
    return {"train": launches, "serve": serve}


def phase_scannet_clis(dev, root):
    """The ScanNet CLIs on the card, in this process: cli.train_scannet
    --debug at its defaults (B6 x 8192, two epochs of one step, a chopped
    and a whole-scene eval, a checkpoint an epoch), then cli.test_scannet
    with one vote on one scene (the sliding windows: a forward's launches
    each B6 batch of windows), and with --single_pass true --nl_block_size
    4096 on the scene of ENC_SCENE_N points (ENC_SINGLE_PASS_LAUNCHES);
    each mIoU in [0, 1]. The single pass's searches are recorded and held
    to their plain versions (check_single_pass). Returns the launches of
    each test_scannet run, the single pass's searches and max |err| by
    kernel."""
    from pointasnl_tpu_torch.cli import test_scannet, train_scannet

    logs, dump = root / "logs", root / "dump"
    t0 = time.perf_counter()
    best = train_scannet.main(["--data", str(root), "--log_dir", str(logs), "--debug"])
    t1 = time.perf_counter()
    if not (0.0 <= best <= 1.0 and (logs / "latest" / "state.pt").is_file()):
        raise RuntimeError(f"train_scannet: best mIoU {best}, or no latest checkpoint")
    print(f"cli train_scannet --debug (B6x8192): best chopped mIoU {best:.5f}, latest "
          f"checkpoint written, {t1 - t0:.1f} s")
    runs = {"sliding windows": [], "single pass": ["--single_pass", "true",
                                                   "--nl_block_size", "4096"]}
    launches, tapes = {}, {}
    for what, extra in runs.items():
        tapes[what] = tape = SearchTape()
        reset_counts()
        t0 = time.perf_counter()
        with tape.recording():
            miou = test_scannet.main(["--data", str(root), "--model_path", str(logs), "--ckpt",
                                      "latest", "--dump_dir", str(dump), "--num_votes", "1",
                                      "--max_scenes", "1"] + extra)
        torch.cuda.synchronize()
        launches[what] = got = counts()
        forwards = len(tape.calls["farthest_point_sample"]) / ENC_LAUNCHES["fps"]
        print(f"cli test_scannet ({what}, 1 vote, 1 scene of {ENC_SCENE_N} points): mIoU "
              f"{miou:.5f}, {time.perf_counter() - t0:.1f} s; {forwards:g} forwards; launches "
              f"{ {k: v for k, v in got.items() if v} }")
        if not 0.0 <= miou <= 1.0:
            raise RuntimeError(f"test_scannet ({what}): mIoU {miou}")
        want = ({k: v * int(forwards) for k, v in ENC_LAUNCHES.items()} if what == "sliding windows"
                else ENC_SINGLE_PASS_LAUNCHES if forwards == 1 else None)
        if got != want or forwards != int(forwards):
            raise RuntimeError(f"test_scannet ({what}): {forwards:g} forwards launched {got}, "
                               f"expected {ENC_SINGLE_PASS_LAUNCHES if want is None else want}")
    searches, errs = check_single_pass(tapes["single pass"])
    return launches, searches, errs


def check_single_pass(tape):
    """The searches of test_scannet --single_pass (its four FPS calls and its
    twelve kNN calls), recorded on `tape`, held to their plain versions
    (check_tape)."""
    return check_tape(tape, "test_scannet --single_pass")


def check_tape(tape, what: str):
    """Hold each search recorded on `tape` against its plain version on the
    same inputs (in float32, as ops.dispatch gives them to the kernels), at
    the shapes the run gave it: FPS indices exact (in the
    design the call routes to), kNN (each routed as dispatch.knn_route
    routes it) indices exact and d2 within 1e-6 relative, the ball query's
    indices and counts exact. Returns ([(kernel, k, support, query)] of the
    kNN calls, max |d2 err| by kernel)."""
    from pointasnl_tpu_torch.ops import dispatch, geometry

    searches, errs = [], {"knn_resident": 0.0, "knn_spatial": 0.0}
    with torch.no_grad():
        for (_, got), (npoint, xyz) in zip(tape.calls["farthest_point_sample"],
                                           tape.args["farthest_point_sample"]):
            B, N = xyz.shape[:2]
            if not torch.equal(got, geometry.farthest_point_sample(npoint, xyz.detach().float())):
                raise RuntimeError(f"fps B{B} N{N} -> {npoint} ({what}): kernel and plain differ")
            print(f"fps B{B} N{N} -> {npoint} ({what}, {fps_design(xyz)} design): indices exact")
        for (_, got), (k, s, q) in zip(tape.calls["knn_point"], tape.args["knn_point"]):
            name = "knn_" + dispatch.knn_route(s.shape[1], k)
            self_query = " (self)" if q is s else ""
            err = check_knn(f"{name} B{s.shape[0]} {q.shape[1]}q/{s.shape[1]} k{k}{self_query} "
                            f"({what})", got, geometry.knn_point(k, s.detach().float(),
                                                                 q.detach().float()))
            errs[name] = max(errs[name], err)
            searches.append((name, k, s, q))
            torch.cuda.empty_cache()
        for (_, got), (radius, nsample, xyz, new_xyz) in zip(tape.calls["query_ball_point"],
                                                             tape.args["query_ball_point"]):
            want = geometry.query_ball_point(radius, nsample, xyz.detach().float(),
                                             new_xyz.detach().float())
            B, M = new_xyz.shape[:2]
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise RuntimeError(f"ball query B{B} {M}q/{xyz.shape[1]} ({what}): kernel and "
                                   f"plain differ")
            print(f"ball query B{B} {M}q/{xyz.shape[1]} ns{nsample} r{radius} ({what}): indices "
                  f"and counts exact (mean count {float(got[1].float().mean()):.3f})")
    return searches, errs


def slice12(dev, mark):
    """Slice 12's checks, paths and CLIs. Returns what the timing and the
    kernels line need."""
    import tempfile

    tmp = tempfile.TemporaryDirectory(prefix="scannet_")
    root = Path(tmp.name)
    scannet_pickles(root)
    errs = phase_encdec_kernels(dev, root)
    mark("slice 12 kernel checks")
    enc = phase_encdec(dev, root)
    phase_encdec_card_vs_cpu(dev, root)
    flash_launches = phase_encdec_flash(dev, root)
    flash_bf16 = phase_encdec_flash_bf16(dev, root)
    mark("slice 12 train, serve, card vs CPU, determinism, flash step, bfloat16 flash step")
    cli_launches, single_pass, cli_errs = phase_scannet_clis(dev, root)
    for name, e in cli_errs.items():
        errs[name] = max(errs.get(name, 0.0), e)
    mark("slice 12 CLIs and the single pass's searches")
    levels = enc_levels(scannet_batch(root, ENC_B, ENC_N, 460, dev)["points"][..., :3]
                        .contiguous())
    return {"tmp": tmp, "errs": errs, "state": enc[0], "step": enc[1], "infer": enc[2],
            "launches": enc[3], "serve_launches": enc[4], "gathers": enc[5], "batch": enc[6],
            "flash_launches": flash_launches, "flash_bf16_launches": flash_bf16,
            "levels": levels, "cli_launches": cli_launches,
            "single_pass": single_pass}


def time_encdec(card, enc):
    """Slice 12's step and request times: the B6 x 8192 train step and
    serve request (p50, p90 by CUDA events, peak memory) and a profiler
    window over 3 steps and one over 3 requests (device-busy share, device
    activities a call)."""
    state, step, infer, batch = enc["state"], enc["step"], enc["infer"], enc["batch"]
    pts = batch["points"]
    out = time_steps(card, {
        f"encdec train step B{ENC_B}x{ENC_N}": (lambda: step(state, batch), ENC_B * ENC_N),
        f"encdec serve request B{ENC_B}x{ENC_N}": (lambda: infer(pts), ENC_B * ENC_N)}, reps=5)
    per_step = {"fps": 4, "knn": 12, "ball_query": 1, "gather_bwd": ENC_GATHER_BWD,
                "gather_plan": plan_kernels(enc["gathers"])}
    profile_window(lambda: step(state, batch), 3, per_step, card, "encdec train steps",
                   "profile_encdec_step.json")
    profile_window(lambda: infer(pts), 3, {**per_step, "ball_query": 0, "gather_bwd": 0,
                                           "gather_plan": 0}, card, "encdec serve requests",
                   "profile_encdec_serve.json")
    return out


def scannet_grid_layout(root: Path, seed: int = SEED + 50) -> list:
    """Write the layout ScannetGridDataset reads into root: GRID_SCENES
    surface scenes of GRID_SCENE_N points (training_points/*.ply: xyz, rgb,
    NYU40 labels of the recipe's 21 values, constant over 0.5 m cells, and
    vert_ind) with their meshes (training_meshes/*_mesh.ply: every
    GRID_MESH_EVERY-th point, its rgb and label, and faces), the last scene
    listed in scannet_v2_val.txt. Returns the scene names."""
    from pointasnl_tpu_torch.data import surface_scene
    from pointasnl_tpu_torch.data.ply import write_ply
    from pointasnl_tpu_torch.data.scannet_grid import ScannetGridDataset

    rng = np.random.RandomState(seed)
    values = np.sort(list(ScannetGridDataset.LABEL_TO_NAMES))
    names = [f"scene{i:04d}_00" for i in range(GRID_SCENES)]
    fields = ["x", "y", "z", "red", "green", "blue", "class"]
    for sub in ("training_points", "training_meshes"):
        (root / sub).mkdir(parents=True)
    for name in names:
        xyz = surface_scene(rng, 1, GRID_SCENE_N, extent=GRID_SCENE_EXTENT)[0]
        rgb = (rng.rand(GRID_SCENE_N, 3) * 255).astype(np.uint8)
        cell = np.floor(xyz / 0.5).astype(np.int64)
        labels = values[(cell[:, 0] * 7 + cell[:, 1] * 13 + cell[:, 2] * 3) % len(values)]
        labels = labels.astype(np.int32)
        vert_ind = (np.arange(GRID_SCENE_N) // GRID_MESH_EVERY).astype(np.int32)
        mesh = slice(None, None, GRID_MESH_EVERY)
        nv = len(xyz[mesh])
        faces = np.stack([np.arange(nv - 2), np.arange(1, nv - 1), np.arange(2, nv)], 1)
        write_ply(str(root / "training_points" / f"{name}.ply"), [xyz, rgb, labels, vert_ind],
                  fields + ["vert_ind"])
        write_ply(str(root / "training_meshes" / f"{name}_mesh.ply"),
                  [xyz[mesh], rgb[mesh], labels[mesh]], fields,
                  triangular_faces=faces.astype(np.int32))
    (root / "scannet_v2_val.txt").write_text(names[-1] + "\n")
    return names


def kitti_sequences(root: Path, seed: int = SEED + 60, scans: int = KITTI_SCANS):
    """Write raw SemanticKITTI sequences 00 and 08 of `scans` scans into
    root (velodyne/*.bin: x, y, z, remission float32; labels/*.label: raw
    label ids, cars with instance ids): KITTI_RINGS rings from +2 to -24.8
    degrees, KITTI_AZIMUTHS points a ring, each ray ending on the ground
    1.73 m below the sensor (road within 4 m of the axis, sidewalk past it)
    or on a wall of its 10-degree sector (building, vegetation or car), at
    most KITTI_MAX_RANGE m away."""
    rng = np.random.RandomState(seed)
    elev0, az0 = np.meshgrid(np.deg2rad(np.linspace(2.0, -24.8, KITTI_RINGS)),
                             np.linspace(-np.pi, np.pi, KITTI_AZIMUTHS, endpoint=False),
                             indexing="ij")
    for seq in ("00", "08"):
        (root / seq / "velodyne").mkdir(parents=True)
        (root / seq / "labels").mkdir(parents=True)
        for i in range(scans):
            elev = elev0 + rng.randn(*elev0.shape) * 1e-3
            az = az0 + rng.randn(*az0.shape) * 1e-3
            sector = ((az + np.pi) / (2 * np.pi) * 36).astype(np.int64) % 36
            wall = rng.uniform(6.0, KITTI_MAX_RANGE, 36)[sector]
            ground = np.where(elev < 0, 1.73 / np.tan(-np.minimum(elev, -1e-4)), np.inf)
            r = np.minimum(np.minimum(ground, wall), KITTI_MAX_RANGE)
            r = r + rng.randn(*r.shape) * 0.02
            x, y = r * np.cos(elev) * np.cos(az), r * np.cos(elev) * np.sin(az)
            z = r * np.sin(elev)
            on_ground = ground <= wall
            kind = rng.permutation([50, 70, 10] * 12)[sector]
            sem = np.where(on_ground, np.where(np.abs(y) < 4.0, 40, 48), kind).astype(np.uint32)
            inst = np.where(sem == 10, sector + 1, 0).astype(np.uint32)
            pts = np.stack([x, y, z, rng.rand(*r.shape)], -1).reshape(-1, 4).astype(np.float32)
            pts.tofile(root / seq / "velodyne" / f"{i:06d}.bin")
            (sem | (inst << 16)).reshape(-1).tofile(root / seq / "labels" / f"{i:06d}.label")


@contextlib.contextmanager
def driver_probe():
    """Watch one driver run in this process: each train step timed by CUDA
    events (and on the host) with the launches it made, its first step's
    searches recorded (SearchTape), the forwards of its predict and eval
    steps counted and timed by CUDA events, each Prefetcher's wait for batches and the wall of its loop
    (from its start to its last batch),
    and each crop's search (the cloud's size, the crop's, host ms)."""
    import pointasnl_tpu_torch.train as train
    from pointasnl_tpu_torch.data import grid_pipeline, scannet_grid, semantic_kitti_grid

    rec = {"steps": [], "forwards": 0, "forward_events": [], "tape": SearchTape(), "epochs": [],
           "crops": [], "capacity": set()}
    real_make, real_predict = train.make_train_step, train.make_predict_step
    real_eval = train.make_eval_step
    real_prefetcher = grid_pipeline.Prefetcher
    searches = [(m, f) for m in (scannet_grid, semantic_kitti_grid)
                for f in ("ball_indices", "knn_indices")]
    saved = {(m, f): getattr(m, f) for m, f in searches}

    def make_train_step(**kwargs):
        step = real_make(**kwargs)

        def probed(state, batch, rng):
            first = not rec["steps"]
            before = counts()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            with rec["tape"].recording() if first else contextlib.nullcontext():
                out = step(state, batch, rng)
            e1.record()
            host_ms = (time.perf_counter() - t0) * 1e3
            after = counts()
            rec["steps"].append((e0, e1, host_ms, {k: after[k] - before[k] for k in after}))
            return out
        return probed

    def forward(fn, *args):
        rec["forwards"] += 1
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*args)
        e1.record()
        rec["forward_events"].append((e0, e1))
        return out

    def make_predict_step():
        predict = real_predict()
        return lambda state, points: forward(predict, state, points)

    def make_eval_step(**kwargs):
        evaluate = real_eval(**kwargs)
        return lambda state, batch: forward(evaluate, state, batch)

    class Prefetcher(real_prefetcher):
        def __init__(self, iterator, capacity: int = 8):
            super().__init__(iterator, capacity)
            rec["capacity"].add(capacity)
            self.t0 = self.end = time.perf_counter()
            self.wait = 0.0

        def __next__(self):
            t = time.perf_counter()
            try:
                return super().__next__()
            finally:
                self.end = time.perf_counter()
                self.wait += self.end - t

        def close(self):
            super().close()
            rec["epochs"].append((self.wait, self.end - self.t0))

    def timed(fn):
        def probed(tree, center, arg):
            t = time.perf_counter()
            out = fn(tree, center, arg)
            rec["crops"].append((tree.n, len(out), (time.perf_counter() - t) * 1e3))
            return out
        return probed

    try:
        train.make_train_step, train.make_predict_step = make_train_step, make_predict_step
        train.make_eval_step = make_eval_step
        grid_pipeline.Prefetcher = Prefetcher
        for (m, f), fn in saved.items():
            setattr(m, f, timed(fn))
        yield rec
    finally:
        train.make_train_step, train.make_predict_step = real_make, real_predict
        train.make_eval_step = real_eval
        grid_pipeline.Prefetcher = real_prefetcher
        for (m, f), fn in saved.items():
            setattr(m, f, fn)


def fold_gathers(launches: dict) -> dict:
    """Launches with a bfloat16 step's float32 and bfloat16 gather sums
    counted together (which gathers take which follows the dtypes of their
    cotangents)."""
    out = dict(launches)
    out["gather_bwd"] += out.pop("gather_bwd_bf16")
    return out


def run_driver(label: str, main_fn, argv: list, flash: bool = False, trains: bool = True,
               step_want: dict = GRID_STEP_LAUNCHES, fwd_want: dict = GRID_FORWARD_LAUNCHES,
               shape: str = f"B{GRID_B}x{GRID_N}", bf16: bool = False):
    """Run one driver in this process under driver_probe, its launch
    counts set to 0 just before and read just after: a trainer's
    (`trains`) each train step must launch `step_want` (a grid driver's
    by default; with the flash forward and backward 4 each under `flash`), a
    tester takes no step, and the run must launch that and `fwd_want` (the
    flash forward 4 under `flash`) for each forward (predict or eval step),
    no more. Under a bfloat16 compute dtype (`bf16`: the flash kernels are
    the bfloat16 ones, and a step's gather backwards are counted float32 and
    bfloat16 sums together, some of them bfloat16). For a trainer
    prints the step times (CUDA events; p50 of the steps after the first)
    and the share of each epoch's train loop spent waiting on the
    Prefetcher. Returns (what the CLI's main returned, the probe's record,
    launches)."""
    nl, tag = 4 * flash, "_bf16" if bf16 else ""
    step_want = {**step_want, "flash_fwd" + tag: nl, "flash_bwd" + tag: nl}
    fwd_want = {**fwd_want, "flash_fwd" + tag: nl}
    same = fold_gathers if bf16 else dict
    reset_counts()
    t0 = time.perf_counter()
    with driver_probe() as rec:
        result = main_fn(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts()
    steps, forwards = rec["steps"], rec["forwards"]
    want = {k: len(steps) * step_want[k] + forwards * fwd_want[k] for k in step_want}
    print(f"{label}: {seconds:.1f} s; {len(steps)} train steps, {forwards} forwards; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    bad = [i for i, (_, _, _, got) in enumerate(steps)
           if same(got) != same(step_want) or (bf16 and not got["gather_bwd_bf16"])]
    if bad or same(launches) != same(want) or bool(steps) != trains or not forwards:
        raise RuntimeError(f"{label}: launches {launches} (steps {[s[3] for s in steps]}, "
                           f"{forwards} forwards), expected {step_want} a train step and "
                           f"{fwd_want} a forward")
    if not trains:
        return result, rec, launches
    ms = [e0.elapsed_time(e1) for e0, e1, _, _ in steps]
    # The first step records its searches on the tape (and is the model's
    # first): the others make the p50.
    p50, p90 = percentiles(ms[1:] or ms)
    print(f"{label}: train step {shape} p50 {p50:.3f} ms, p90 {p90:.3f} ms of "
          f"the {len(ms[1:] or ms)} after the first (CUDA events inside the trainer: "
          f"{', '.join(f'{m:.1f}' for m in ms)}; host {', '.join(f'{s[2]:.1f}' for s in steps)} "
          f"ms)")
    for e, (wait, loop) in enumerate(rec["epochs"]):
        print(f"{label}: epoch {e}'s train loop {loop * 1e3:.1f} ms, of which "
              f"{wait * 1e3:.1f} ms ({100 * wait / loop:.1f} %) waiting on the Prefetcher "
              f"(capacity {sorted(rec['capacity'])})")
    return result, rec, launches


def driver_child(argv: list) -> int:
    """The subprocess of run_driver_in_child: run the driver that the JSON
    spec argv[0] names in this process under run_driver (its launches
    asserted) and write what it returned, its launches and its first train
    step's searches held to their plain versions (check_tape) to the spec's
    "out" path. The drivers run in this subprocess are the flash ones under
    POINTASNL_COMPUTE_DTYPE=bfloat16 (run_driver's flash=True, bf16=True)."""
    spec = json.loads(argv[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, rec, launches = run_driver(
        spec["label"], importlib.import_module(spec["module"]).main, spec["argv"],
        flash=True, trains=spec["trains"], bf16=True)
    errs = check_tape(rec["tape"], f"{spec['label']}, its first step")[1] if spec["trains"] else {}
    Path(spec["out"]).write_text(json.dumps({"result": None if result is None else float(result),
                                             "launches": launches, "errs": errs}))
    return 0


def run_driver_in_child(label: str, module: str, argv: list, env: dict, out: Path,
                        trains: bool = True):
    """Run a driver in a python3 subprocess whose environment adds `env`
    (POINTASNL_COMPUTE_DTYPE=bfloat16: the JAX package's way to a bfloat16
    run, read by nn.precision), through driver_child, and wait for it. Its
    output is printed; a non-zero exit raises. Returns (what the driver
    returned, launches, max |err| of its first step's searches)."""
    import os

    spec = {"label": label, "module": module, "argv": argv, "trains": trains, "out": str(out)}
    code = "import sys, chip_smoke; sys.exit(chip_smoke.driver_child(sys.argv[1:]))"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(spec)],
                          cwd=Path(__file__).resolve().parent, env={**os.environ, **env},
                          capture_output=True, text=True, timeout=900)
    print("\n".join(f"  [child] {line}" for line in proc.stdout.splitlines()))
    if proc.returncode != 0:
        raise RuntimeError(f"{label}: the subprocess exited {proc.returncode}:\n"
                           f"{proc.stderr[-6000:]}")
    got = json.loads(out.read_text())
    print(f"{label}: a subprocess with {env}, {time.perf_counter() - t0:.1f} s")
    return got["result"], got["launches"], got["errs"]


def crop_report(label: str, clouds: dict, crops: list):
    """Per cloud (name: subsampled points): the crops' search sizes (ball
    or kNN) and how many were short of GRID_N points (padded with
    duplicates), and the searches' host ms."""
    by_n = {}
    for n, size, ms in crops:
        by_n.setdefault(n, []).append((size, ms))
    for name, n in clouds.items():
        got = by_n.get(n, [])
        sizes = [s for s, _ in got]
        line = f"{label} {name}: {n} subsampled points; {len(got)} crops"
        if got:
            line += (f", search sizes {min(sizes)}-{max(sizes)} (median "
                     f"{statistics.median(sizes):g}), {sum(s < GRID_N for s in sizes)} padded "
                     f"with duplicates; search host ms median "
                     f"{statistics.median(m for _, m in got):.2f}")
        print(line)


def batch_ms(batches, n: int) -> list:
    """Host ms of each of the first n batches of a fresh batch iterator."""
    out = []
    for _ in range(n):
        t = time.perf_counter()
        next(batches)
        out.append((time.perf_counter() - t) * 1e3)
    batches.close()
    return out


def phase_grid_scannet(root: Path) -> dict:
    """Slice 13, ScanNet grid (the 66.6 % recipe): train_scannet_grid
    --debug --num_point 10240 --in_radius 2 at B4, then again with
    --nl_flash true, then test_scannet_grid --split validation --max_rounds
    1 on the first run's latest checkpoint, which it rebuilds from
    args.txt; each mIoU in [0, 100]. The first train step's searches are
    held to their plain versions (check_tape). Then one pipeline's host ms
    for a batch on its own. Returns (launches by path, max |err| by
    kernel)."""
    from pointasnl_tpu_torch.cli import test_scannet_grid, train_scannet_grid
    from pointasnl_tpu_torch.data.grid_pipeline import GridConfig
    from pointasnl_tpu_torch.data.ply import read_ply
    from pointasnl_tpu_torch.data.scannet_grid import ScannetGridDataset

    t0 = time.perf_counter()
    names = scannet_grid_layout(root)
    print(f"scannet grid: {GRID_SCENES} scenes of {GRID_SCENE_N} points written "
          f"({time.perf_counter() - t0:.1f} s)")
    recipe = ["--data", str(root), "--debug", "--num_point", str(GRID_N), "--in_radius",
              str(GRID_RADIUS)]
    launches, errs, crops = {}, {}, []
    runs = {"grid_scannet_train": ["--log_dir", str(root / "logs")],
            "grid_scannet_flash_train": ["--log_dir", str(root / "logs_flash"), "--nl_flash",
                                         "true"]}
    for path, extra in runs.items():
        best, rec, launches[path] = run_driver(f"cli train_scannet_grid ({path})",
                                               train_scannet_grid.main, recipe + extra,
                                               flash="--nl_flash" in extra)
        if not 0.0 <= best <= 100.0:
            raise RuntimeError(f"train_scannet_grid ({path}): best voting mIoU {best}")
        print(f"cli train_scannet_grid ({path}): best voting mIoU {best:.3f} %")
        if not (Path(extra[1]) / "latest" / "state.pt").is_file():
            raise RuntimeError(f"train_scannet_grid ({path}): no latest checkpoint")
        _, e = check_tape(rec["tape"], f"train_scannet_grid ({path}), its first step")
        for name, v in e.items():
            errs[name] = max(errs.get(name, 0.0), v)
        crops += rec["crops"]
    miou, rec, launches["grid_scannet_test"] = run_driver(
        "cli test_scannet_grid --split validation --max_rounds 1", test_scannet_grid.main,
        ["--data", str(root), "--model_path", str(root / "logs"), "--ckpt", "latest",
         "--split", "validation", "--max_rounds", "1", "--dump_dir", str(root / "dump")],
        trains=False)
    if not 0.0 <= miou <= 100.0:
        raise RuntimeError(f"test_scannet_grid: voting mIoU {miou}")
    print(f"cli test_scannet_grid: voting mIoU {miou:.3f} %")
    crops += rec["crops"]
    # Slice 15: the trainer under --nl_flash true and its tester with
    # POINTASNL_COMPUTE_DTYPE=bfloat16 in their environment only.
    bf16 = {"POINTASNL_COMPUTE_DTYPE": "bfloat16"}
    logs = str(root / "logs_bf16_flash")
    best, launches["grid_scannet_bf16_flash_train"], e = run_driver_in_child(
        "cli train_scannet_grid --nl_flash true (bfloat16)",
        "pointasnl_tpu_torch.cli.train_scannet_grid",
        recipe + ["--log_dir", logs, "--nl_flash", "true"], bf16, root / "bf16_train.json")
    if not 0.0 <= best <= 100.0 or not (Path(logs) / "latest" / "state.pt").is_file():
        raise RuntimeError(f"train_scannet_grid (bfloat16 flash): best voting mIoU {best}, or "
                           f"no latest checkpoint")
    for name, v in e.items():
        errs[name] = max(errs.get(name, 0.0), v)
    miou, launches["grid_scannet_bf16_flash_test"], _ = run_driver_in_child(
        "cli test_scannet_grid --split validation --max_rounds 1 (bfloat16 flash)",
        "pointasnl_tpu_torch.cli.test_scannet_grid",
        ["--data", str(root), "--model_path", logs, "--ckpt", "latest", "--split",
         "validation", "--max_rounds", "1", "--dump_dir", str(root / "dump_bf16_flash")], bf16,
        root / "bf16_test.json", trains=False)
    if not 0.0 <= miou <= 100.0:
        raise RuntimeError(f"test_scannet_grid (bfloat16 flash): voting mIoU {miou}")
    print(f"cli train_scannet_grid --nl_flash true (bfloat16): best voting mIoU {best:.3f} %; "
          f"test_scannet_grid: voting mIoU {miou:.3f} %")
    clouds = {n: len(read_ply(str(root / "input_0.040" / f"{n}.ply"))) for n in names}
    crop_report("scannet grid", clouds, crops)

    ds = ScannetGridDataset(str(root), npoint=GRID_N, debug=True,
                            random_state=np.random.RandomState(SEED))
    t0 = time.perf_counter()
    ds.load_subsampled_clouds(0.04)
    load_s = time.perf_counter() - t0
    cfg = GridConfig(batch_size=GRID_B, epoch_steps=6, in_radius=GRID_RADIUS, input_threads=8)
    ms = batch_ms(ds.batches("training", cfg), 6)
    print(f"scannet grid pipeline alone: load {load_s:.2f} s (cached subsampled plys, "
          f"{GRID_SCENES} cKDTrees); B{GRID_B}x{GRID_N} training batches (8 input threads) "
          f"{', '.join(f'{m:.1f}' for m in ms)} ms, median of the last 5 "
          f"{statistics.median(ms[1:]):.1f} ms")
    return launches, errs


def phase_grid_kitti(root: Path) -> dict:
    """Slice 13, SemanticKITTI grid: train_semantic_kitti_grid --prepare_data
    --debug at its defaults (B4 x 10240, kNN crops of 10240 + 1024 points),
    then test_semantic_kitti_grid --test_id 8 --max_rounds 1 on its latest
    checkpoint (rebuilt from args.txt): the trainer's mIoU in [0, 100], a
    .label file of every raw point of each scan of sequence 08. The first
    train step's searches are held to their plain versions. Then the
    pipeline's host ms for a batch on its own. Returns (launches by path,
    max |err| by kernel)."""
    from pointasnl_tpu_torch.cli import test_semantic_kitti_grid, train_semantic_kitti_grid
    from pointasnl_tpu_torch.data.grid_pipeline import GridConfig
    from pointasnl_tpu_torch.data.semantic_kitti_config import LEARNING_MAP_INV
    from pointasnl_tpu_torch.data.semantic_kitti_grid import SemanticKittiGridDataset

    seqs = root / "sequences"
    t0 = time.perf_counter()
    kitti_sequences(seqs)
    print(f"kitti grid: sequences 00 and 08 of {KITTI_SCANS} scans of "
          f"{KITTI_RINGS * KITTI_AZIMUTHS} points written ({time.perf_counter() - t0:.1f} s)")
    launches = {}
    best, rec, launches["grid_kitti_train"] = run_driver(
        "cli train_semantic_kitti_grid --prepare_data --debug", train_semantic_kitti_grid.main,
        ["--data", str(seqs), "--log_dir", str(root / "logs"), "--prepare_data", "--debug",
         "--num_point", str(GRID_N)])
    if not 0.0 <= best <= 100.0 or not (root / "logs" / "latest" / "state.pt").is_file():
        raise RuntimeError(f"train_semantic_kitti_grid: best mIoU {best}, or no checkpoint")
    print(f"cli train_semantic_kitti_grid: best mIoU {best:.3f} %")
    _, errs = check_tape(rec["tape"], "train_semantic_kitti_grid, its first step")
    crops = rec["crops"]
    pred = root / "pred"
    _, rec, launches["grid_kitti_test"] = run_driver(
        "cli test_semantic_kitti_grid --test_id 8 --max_rounds 1", test_semantic_kitti_grid.main,
        ["--data", str(seqs), "--model_path", str(root / "logs"), "--ckpt", "latest",
         "--test_id", "8", "--max_rounds", "1", "--save_dir", str(pred)], trains=False)
    crops += rec["crops"]
    files = sorted((pred / "sequences" / "08" / "predictions").glob("*.label"))
    raw = set(LEARNING_MAP_INV.values())
    for f in files:
        out = np.fromfile(f, dtype=np.uint32)
        if out.shape != (KITTI_RINGS * KITTI_AZIMUTHS,) or not set(np.unique(out)) <= raw:
            raise RuntimeError(f"test_semantic_kitti_grid: {f.name} holds {out.shape} labels")
    if len(files) != KITTI_SCANS:
        raise RuntimeError(f"test_semantic_kitti_grid wrote {len(files)} label files")
    print(f"cli test_semantic_kitti_grid: {len(files)} .label files of "
          f"{KITTI_RINGS * KITTI_AZIMUTHS} raw label ids each")
    prepared = Path(str(seqs) + "_0.06")
    clouds = {f"{seq}/{f.stem}": len(np.load(f)) for seq in ("00", "08")
              for f in sorted((prepared / seq / "velodyne").glob("*.npy"))}
    crop_report("kitti grid", clouds, crops)

    ds = SemanticKittiGridDataset(str(seqs), num_point=GRID_N, test_id=8,
                                  random_state=np.random.RandomState(SEED))
    cfg = GridConfig(batch_size=GRID_B, input_threads=8)
    train_ms = batch_ms(ds.batches("training", cfg), 1)
    test_ms = batch_ms(ds.batches("test", cfg, augment=False), 4)
    print(f"kitti grid pipeline alone: B{GRID_B}x{GRID_N} training batch {train_ms[0]:.1f} ms, "
          f"test batches {', '.join(f'{m:.1f}' for m in test_ms)} ms (8 input threads; a scan's "
          f"cKDTree built from its .npy at each read)")
    return launches, errs


def slice13(dev, mark):
    """Slice 13's drivers on synthetic data in a temporary directory.
    Returns what the kernels line needs."""
    import tempfile

    tmp = tempfile.TemporaryDirectory(prefix="grid_")
    root = Path(tmp.name)
    launches, errs = phase_grid_scannet(root / "scannet")
    mark("slice 13 ScanNet grid drivers")
    kitti_launches, kitti_errs = phase_grid_kitti(root / "kitti")
    launches.update(kitti_launches)
    for name, e in kitti_errs.items():
        errs[name] = max(errs.get(name, 0.0), e)
    mark("slice 13 SemanticKITTI grid drivers")
    tmp.cleanup()
    return {"launches": launches, "errs": errs}


def kitti_block_dataset(root: Path) -> Path:
    """Sequences 00 and 08 of KITTI_BLOCK_SCANS scans (kitti_sequences)
    under root/sequences, and the train and valid splits' other sequences
    empty (the datasets list each). Returns root."""
    from pointasnl_tpu_torch.data.semantic_kitti_config import SPLIT

    kitti_sequences(root / "sequences", scans=KITTI_BLOCK_SCANS)
    for seq in SPLIT["train"] + SPLIT["valid"]:
        for sub in ("velodyne", "labels"):
            (root / "sequences" / f"{seq:02d}" / sub).mkdir(parents=True, exist_ok=True)
    return root


@contextlib.contextmanager
def sliding_window_builds():
    """Each scan's sliding-window blocks built in this block, as (host
    seconds, blocks)."""
    from pointasnl_tpu_torch.data.semantic_kitti import SemanticKittiDatasetSlidingWindow as ds

    builds, real = [], ds.__getitem__

    def getitem(self, index):
        t = time.perf_counter()
        item = real(self, index)
        builds.append((time.perf_counter() - t, item[0].shape[0]))
        return item

    ds.__getitem__ = getitem
    try:
        yield builds
    finally:
        ds.__getitem__ = real


def forward_ms(rec) -> list:
    """The CUDA-event ms of each forward a driver_probe record timed."""
    return [e0.elapsed_time(e1) for e0, e1 in rec["forward_events"]]


def last_forward(tape, fps: int = 4, knn: int = 12):
    """A SearchTape of the last forward's searches on `tape`: its last
    `fps` FPS and `knn` kNN calls."""
    out = SearchTape()
    for op, n in (("farthest_point_sample", fps), ("knn_point", knn)):
        out.calls[op], out.args[op] = tape.calls[op][-n:], tape.args[op][-n:]
    return out


def repeated_point_clouds(x: torch.Tensor) -> int:
    """How many clouds of x (B, N, 3) are one point repeated."""
    return int((x == x[:, :1]).all(-1).all(-1).sum())


def routed(tape) -> dict:
    """The launches a run of the searches on `tape` makes, routed as
    ops.dispatch routes them: FPS, and each kNN to its kernel."""
    from pointasnl_tpu_torch.ops import dispatch

    out = {"fps": len(tape.calls["farthest_point_sample"])}
    for k, s, _ in tape.args["knn_point"]:
        name = "knn_" + dispatch.knn_route(s.shape[1], k)
        out[name] = out.get(name, 0) + 1
    return out


def encdec_launches(n: int) -> dict:
    """A B1 x n forward's launches of the encoder-decoder: FPS 4, and its
    twelve kNN searches (ENC_KNN) each routed as ops.dispatch routes it
    (at n = 131072 or 122880, ENC_SINGLE_PASS_LAUNCHES)."""
    from pointasnl_tpu_torch.ops import dispatch

    levels = [n, n // 8, n // 32, n // 128, n // 256]
    out = {**ENC_LAUNCHES, "knn_resident": 0}
    for si, _, k in ENC_KNN:
        out["knn_" + dispatch.knn_route(levels[si], k)] += 1
    return out


def merge_errs(errs: dict, more: dict) -> dict:
    for name, e in more.items():
        errs[name] = max(errs.get(name, 0.0), e)
    return errs


def phase_kitti_blocks(root: Path):
    """Slice 14, SemanticKITTI blocks: cli.train_semantic_kitti --debug
    --with_remission at its defaults (B6 x 8192), its first step's searches
    held to their plain versions (check_tape); cli.test_semantic_kitti
    --max_scans 1 --num_votes 1 on sequence 08 by sliding windows, a .label
    file of every raw point written, and its last forward's batch, whose
    unused rows are zeros (clouds of one repeated point), held search by
    search to the plain versions (FPS and every kNN; then the ball query on
    that batch, which a forward does not run); then --single_pass on the
    whole scan (B1 x KITTI_RINGS * KITTI_AZIMUTHS): launches
    encdec_launches (ENC_SINGLE_PASS_LAUNCHES at 122880 points), which its
    recorded searches' routing must give too, and its 16 searches held to
    their plain versions; then a training batch's host
    ms on its own. Returns (launches by path, max |err| by kernel, the
    single pass's (FPS calls, kNN searches))."""
    from pointasnl_tpu_torch.cli import test_semantic_kitti, train_semantic_kitti
    from pointasnl_tpu_torch.data import provider
    from pointasnl_tpu_torch.data.semantic_kitti import SemanticKittiDataset
    from pointasnl_tpu_torch.ops import geometry
    from pointasnl_tpu_torch.ops.cuda import ball_query

    t0 = time.perf_counter()
    data = kitti_block_dataset(root / "dataset")
    n_scan = KITTI_RINGS * KITTI_AZIMUTHS
    print(f"kitti blocks: sequences 00 and 08 of {KITTI_BLOCK_SCANS} scans of {n_scan} points "
          f"written ({time.perf_counter() - t0:.1f} s)")
    logs, shape = root / "logs", f"B{KITTI_BLOCK_B}x{KITTI_BLOCK_N}"
    sizes = ["--batch_size", str(KITTI_BLOCK_B), "--num_point", str(KITTI_BLOCK_N)]
    launches = {}
    best, rec, launches["seg_kitti_train"] = run_driver(
        "cli train_semantic_kitti --debug --with_remission", train_semantic_kitti.main,
        ["--data", str(data), "--log_dir", str(logs), "--debug", "--with_remission"] + sizes,
        step_want=KITTI_STEP_LAUNCHES, fwd_want=ENC_LAUNCHES, shape=shape)
    if not 0.0 <= best <= 1.0 or not (logs / "latest" / "state.pt").is_file():
        raise RuntimeError(f"train_semantic_kitti: best mIoU {best}, or no latest checkpoint")
    print(f"cli train_semantic_kitti: best mIoU {best:.5f}; eval forwards "
          f"{', '.join(f'{m:.1f}' for m in forward_ms(rec))} ms (CUDA events)")
    _, errs = check_tape(rec["tape"], "train_semantic_kitti --with_remission, its first step")

    # Sliding windows. The scan's 195 blocks (fixed by its data) leave the
    # last B6 batch 3 rows of zeros; a count that filled every batch would
    # need another batch size, and raises.
    test_argv = ["--data", str(data), "--model_path", str(logs), "--ckpt", "latest",
                 "--max_scans", "1", "--num_votes", "1", "--dump_dir", str(root / "dump"),
                 "--num_point", str(KITTI_BLOCK_N)]
    bs, pred, tape = KITTI_BLOCK_B, root / "pred", SearchTape()
    with tape.recording(), sliding_window_builds() as builds:
        miou, rec, got = run_driver(
            "cli test_semantic_kitti (sliding windows, 1 vote, 1 scan)", test_semantic_kitti.main,
            test_argv + ["--batch_size", str(bs), "--save_dir", str(pred)], trains=False,
            fwd_want=ENC_LAUNCHES)
    (build_s, blocks), = builds
    if not blocks % bs:
        raise RuntimeError(f"test_semantic_kitti: {blocks} blocks fill every B{bs} batch: no "
                           f"row of zeros to check; take another scan or batch size")
    launches["seg_kitti_sliding_windows"] = got
    ms = forward_ms(rec)
    if not 0.0 <= miou <= 1.0 or rec["forwards"] != -(-blocks // bs):
        raise RuntimeError(f"test_semantic_kitti: mIoU {miou}, {rec['forwards']} forwards of "
                           f"{blocks} blocks")
    files = sorted((pred / "sequences" / "08" / "predictions").glob("*.label"))
    out = np.fromfile(files[0], dtype=np.uint32) if len(files) == 1 else None
    if out is None or out.shape != (n_scan,) or not 1 <= out.min() <= out.max() < KITTI_CLASSES:
        raise RuntimeError(f"test_semantic_kitti: {len(files)} .label files, "
                           f"{None if out is None else out.shape} labels")
    print(f"cli test_semantic_kitti (sliding windows): scan of {n_scan} points in "
          f"{blocks} blocks, built in {build_s:.2f} s on the host; {rec['forwards']} "
          f"forwards at B{bs}x{KITTI_BLOCK_N}, forward p50 {statistics.median(ms):.3f} ms "
          f"(CUDA events; {min(ms):.3f}-{max(ms):.3f}); mIoU {miou:.5f}; a .label file of "
          f"{n_scan} training ids")
    last = last_forward(tape)
    npoint, xyz = last.args["farthest_point_sample"][0]
    pad = repeated_point_clouds(xyz)
    if pad != bs - blocks % bs or not bool((xyz[blocks % bs:] == 0).all()):
        raise RuntimeError(f"test_semantic_kitti: the last batch has {pad} clouds of one point, "
                           f"expected its {bs - blocks % bs} rows of zeros")
    what = (f"the last sliding-window batch, {pad} of its {bs} clouds one repeated point "
            f"(0, 0, 0)")
    for op, calls in last.args.items():
        for args in calls:
            x = args[1] if op == "farthest_point_sample" else args[2]
            if repeated_point_clouds(x[..., :3]) < pad:
                raise RuntimeError(f"{what}: a {op} call's input has fewer such clouds")
    merge_errs(errs, check_tape(last, what)[1])
    new_xyz = geometry.gather_point(xyz, last.calls["farthest_point_sample"][0][1])
    with torch.no_grad():
        got = ball_query.query_ball_point(REPULSION_RADIUS, REPULSION_NSAMPLE, xyz, new_xyz)
        want = geometry.query_ball_point(REPULSION_RADIUS, REPULSION_NSAMPLE, xyz, new_xyz)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError(f"ball query B{bs} {npoint}q/{KITTI_BLOCK_N} ({what}): kernel and "
                           f"plain differ")
    print(f"ball query B{bs} {npoint}q/{KITTI_BLOCK_N} ns{REPULSION_NSAMPLE} r{REPULSION_RADIUS} "
          f"({what}): indices and counts exact (the repeated clouds' counts "
          f"{got[1][blocks % bs:].unique().tolist()})")
    del tape, last

    # The whole scan at once.
    tape = SearchTape()
    torch.cuda.reset_peak_memory_stats()
    with tape.recording():
        miou, rec, got = run_driver(
            "cli test_semantic_kitti --single_pass", test_semantic_kitti.main,
            test_argv + ["--single_pass", "--save_dir", str(root / "pred_sp")], trains=False,
            fwd_want=encdec_launches(n_scan))
    peak = torch.cuda.max_memory_allocated()
    launches["seg_kitti_single_pass"] = got
    want = routed(tape)
    if {k: v for k, v in got.items() if v} != want or not 0.0 <= miou <= 1.0:
        raise RuntimeError(f"test_semantic_kitti --single_pass: launches {got}, its searches "
                           f"route to {want}; mIoU {miou}")
    print(f"cli test_semantic_kitti --single_pass: B1x{n_scan} forward "
          f"{forward_ms(rec)[0]:.3f} ms (CUDA events), peak memory {peak / 2**30:.2f} GiB; "
          f"mIoU {miou:.5f}; searches routed {want}")
    searches, e = check_tape(tape, f"test_semantic_kitti --single_pass, B1x{n_scan}")
    merge_errs(errs, e)
    fps_calls = tape.args["farthest_point_sample"]

    ds = SemanticKittiDataset(str(data), sample_points=KITTI_BLOCK_N, split="train",
                              with_remission=True, random_state=np.random.RandomState(SEED))
    rs, idxs, host_ms = np.random.RandomState(SEED), np.arange(len(ds)), []
    for _ in range(3):
        t = time.perf_counter()
        bd = train_semantic_kitti.get_batch(ds, idxs, 0, KITTI_BLOCK_B, KITTI_BLOCK_N, 1)[0]
        bd[:, :, :3] = provider.rotate_point_cloud_z(bd[:, :, :3], random_state=rs)
        host_ms.append((time.perf_counter() - t) * 1e3)
    print(f"kitti blocks: a {shape} training batch (crops with remission and the rotation) "
          f"alone on the host: {', '.join(f'{m:.1f}' for m in host_ms)} ms")
    return launches, errs, (fps_calls, searches)


def modelnet_tree(root: Path, seed: int = SEED + 70) -> Path:
    """Write a modelnet40_normal_resampled tree into root: MODELNET_CLASSES
    classes, MODELNET_TRAIN training and MODELNET_TEST test shapes a class,
    each MODELNET_POINTS points (x, y, z, unit normal) in CSV, and the
    shape-name and split lists. Returns root."""
    rng = np.random.RandomState(seed)
    names = [f"shape{c:02d}" for c in range(MODELNET_CLASSES)]
    root.mkdir(parents=True)
    (root / "modelnet40_shape_names.txt").write_text("\n".join(names) + "\n")
    splits = {"train": [], "test": []}
    for c, name in enumerate(names):
        (root / name).mkdir()
        for i in range(MODELNET_TRAIN + MODELNET_TEST):
            sid = f"{name}_{i:04d}"
            xyz = rng.randn(MODELNET_POINTS, 3) * (1.0 + 0.05 * c)
            normal = rng.randn(MODELNET_POINTS, 3)
            normal /= np.linalg.norm(normal, axis=1, keepdims=True)
            np.savetxt(root / name / f"{sid}.txt", np.concatenate([xyz, normal], 1),
                       fmt="%.6f", delimiter=",")
            splits["train" if i < MODELNET_TRAIN else "test"].append(sid)
    for split, ids in splits.items():
        (root / f"modelnet40_{split}.txt").write_text("\n".join(ids) + "\n")
    return root


def phase_modelnet(root: Path):
    """Slice 14, ModelNet40: cli.train_modelnet --AS --normal --debug at
    its defaults (B16 x 1024), in float32 and with --precision bfloat16, each
    first step's searches held to their plain versions; then
    cli.test_modelnet --num_votes 2 --noise on the float32 run's latest
    checkpoint: the sweep's keys {0, 1, 10, 50, 100}, each accuracy in
    [0, 1], a forward's launches CLS_FORWARD_LAUNCHES. Returns (launches by
    path, max |err| by kernel, the float32 first step's (FPS calls, kNN
    searches))."""
    from pointasnl_tpu_torch.cli import test_modelnet, train_modelnet

    t0 = time.perf_counter()
    data = modelnet_tree(root / "modelnet40_normal_resampled")
    n_test = MODELNET_CLASSES * MODELNET_TEST
    print(f"modelnet: {MODELNET_CLASSES} classes of {MODELNET_TRAIN} + {MODELNET_TEST} shapes of "
          f"{MODELNET_POINTS} points with normals written ({time.perf_counter() - t0:.1f} s)")
    sizes = ["--batch_size", str(MODELNET_B), "--num_point", str(MODELNET_N), "--AS", "--normal"]
    shape = f"B{MODELNET_B}x{MODELNET_N}"
    launches, errs = {}, {}
    for precision, path in (("float32", "cls_modelnet_train"),
                            ("bfloat16", "cls_modelnet_train_bf16")):
        logs = root / f"logs_{precision}"
        best, rec, launches[path] = run_driver(
            f"cli train_modelnet --AS --normal --debug --precision {precision}",
            train_modelnet.main, ["--data", str(data), "--log_dir", str(logs), "--debug",
                                  "--precision", precision] + sizes,
            step_want=CLS_STEP_LAUNCHES[precision], fwd_want=CLS_FORWARD_LAUNCHES, shape=shape)
        if not 0.0 <= best <= 1.0 or not (logs / "latest" / "state.pt").is_file():
            raise RuntimeError(f"train_modelnet ({precision}): best accuracy {best}, or no "
                               f"latest checkpoint")
        print(f"cli train_modelnet ({precision}): best accuracy {best:.4f}")
        searches, e = check_tape(rec["tape"], f"train_modelnet {precision}, its first step")
        merge_errs(errs, e)
        if precision == "float32":
            first = (rec["tape"].args["farthest_point_sample"], searches)
    sweep, rec, launches["cls_modelnet_test"] = run_driver(
        "cli test_modelnet --num_votes 2 --noise", test_modelnet.main,
        ["--data", str(data), "--log_dir", str(root / "logs_float32"), "--ckpt", "latest",
         "--num_votes", "2", "--noise"] + sizes, trains=False, fwd_want=CLS_FORWARD_LAUNCHES)
    passes = 1 + len(test_modelnet.NOISE_POINTS)
    if (sorted(sweep) != [0, 1, 10, 50, 100] or not all(0.0 <= v <= 1.0 for v in sweep.values())
            or rec["forwards"] != passes * 2 * -(-n_test // MODELNET_B)):
        raise RuntimeError(f"test_modelnet --noise: sweep {sweep}, {rec['forwards']} forwards")
    ms = forward_ms(rec)
    print(f"cli test_modelnet --num_votes 2 --noise: sweep {sweep} (accuracy by noise points, "
          f"{n_test} test shapes); {rec['forwards']} forwards at {shape}, p50 "
          f"{statistics.median(ms):.3f} ms (CUDA events)")
    return launches, errs, first


def slice14(dev, mark):
    """Slice 14's drivers on synthetic data in a temporary directory.
    Returns what the kernels line and the timing need."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="drivers_") as tmp:
        root = Path(tmp)
        launches, errs, single_pass = phase_kitti_blocks(root / "kitti")
        mark("slice 14 SemanticKITTI block drivers")
        cls_launches, cls_errs, cls = phase_modelnet(root / "modelnet")
        mark("slice 14 ModelNet40 drivers")
    launches.update(cls_launches)
    return {"launches": launches, "errs": merge_errs(errs, cls_errs),
            "single_pass": single_pass, "cls": cls}


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
    errs["gather_bwd"] = errs["gather_plan"] = 0.0  # equal, or phase_gather raised
    phase_determinism(dev)
    mark("slice 6: gather backward checks and determinism")
    cls_train_launches, cls_gathers, cls = phase_cls_train(dev)
    phase_cls_card_vs_cpu(dev)
    seg16_state, seg16_step, seg16_launches, seg16_extra = phase_seg_bf16(dev)
    gathers_bf16 = phase_gather_bf16(dev)
    errs["gather_bwd_bf16"] = 0.0  # equal, or phase_gather_bf16 raised
    mark("slice 11: cls train, bfloat16 steps and the bfloat16 gather backward")
    seg16f = phase_seg_bf16_flash(dev)
    mark("slice 15: the bfloat16 flash seg step and requests")
    enc = slice12(dev, mark)
    for name, e in enc["errs"].items():
        errs[name] = max(errs[name], e)
    grid = slice13(dev, mark)
    for name, e in grid["errs"].items():
        errs[name] = max(errs[name], e)
    drivers = slice14(dev, mark)
    merge_errs(errs, drivers["errs"])
    clocks = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"
    print(f"card before timing: {clocks} = {smi(clocks)}")
    rows = time_kernels(dev, card, gathers, gathers_bf16, enc, drivers)
    mark("kernel timing")
    time_paths(dev, card, cls_infer, seg_state, seg_step, seg_infer, scene_infer, scene_x,
               flash_state, flash_step, flash_infer,
               sum(len(plan_symbols(*idx.shape, n)) for idx, n in seg_plans(gathers)))
    print(f"card after timing: {clocks} = {smi(clocks)}")
    mark("path timing")
    big_launches, big_rows, big_errs = slice5(dev, card, mark)
    for name, e in big_errs.items():
        errs[name] = max(errs.get(name, 0.0), e)
    for name, rs in big_rows.items():
        rows[name] += rs
    torch.cuda.empty_cache()
    time_slice11(card, cls, cls_train_launches, cls_gathers, seg16_state, seg16_step,
                 seg16_launches, gathers_bf16, seg16_extra, (seg_state, seg_step),
                 seg16f, (flash_state, flash_step))
    phase_train_loop(dev, seg_infer)
    mark("slice 11: step times and the train loop")
    time_encdec(card, enc)
    enc["tmp"].cleanup()
    mark("slice 12: step and request times")
    records = []
    for name, meta in KERNELS.items():
        # ms, call_ms, plain_ms, bound_ms and library_ms sum the shapes of
        # one call of a path: the seg train step's, for the spatial kernel
        # (which that step never launches) the whole-scene request's, for
        # the streaming kNN the B1 x 2228224 request's, for the flash
        # kernels the flash seg train step's (the bfloat16 ones': in
        # bfloat16).
        path = {"knn_spatial": "scene", "knn_streaming": "scene_2228224",
                "flash_fwd": "seg_flash", "flash_bwd": "seg_flash",
                "flash_fwd_bf16": "seg_flash_bf16", "flash_bwd_bf16": "seg_flash_bf16",
                "gather_bwd_bf16": "seg_bf16"}.get(name, "seg")
        shapes = [r for r in rows[name] if r["path"] == path]
        top = max(shapes, key=lambda r: r["bound_ms"])
        by_path = {"cls_serve": cls_launches[name], "seg_train": seg_launches[name],
                   "seg_serve": serve_launches[name], "whole_scene": scene_launches[name],
                   "seg_flash_train": flash_launches[name],
                   "seg_flash_serve": flash_serve_launches[name],
                   "whole_scene_2228224": big_launches[name],
                   "cls_train": cls_train_launches["float32"][name] * CLS_LEARN_STEPS,
                   "cls_train_bf16": cls_train_launches["bfloat16"][name] * CLS_LEARN_STEPS,
                   "seg_train_bf16": seg16_launches[name] * SEG_STEPS,
                   "seg_flash_train_bf16": seg16f[3][name] * SEG_STEPS,
                   "seg_flash_serve_bf16": seg16f[4][name] * SEG_REQUESTS,
                   "seg_encdec_train": enc["launches"][name],
                   "seg_encdec_serve": enc["serve_launches"][name],
                   "seg_encdec_flash_train": enc["flash_launches"][name],
                   "seg_encdec_flash_train_bf16": enc["flash_bf16_launches"]["train"][name],
                   "seg_encdec_flash_serve_bf16": enc["flash_bf16_launches"]["serve"][name],
                   "seg_encdec_sliding_windows": enc["cli_launches"]["sliding windows"][name],
                   "seg_encdec_single_pass": enc["cli_launches"]["single pass"][name],
                   **{path: got[name] for path, got in grid["launches"].items()},
                   **{path: got[name] for path, got in drivers["launches"].items()}}
        lib = [r["library_ms"] for r in shapes]
        records.append({
            "name": name, "route": "cuda", "source": meta["source"], "replaces": meta["replaces"],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": errs[name],
            "ms_path": {"seg": "seg_train", "scene": "whole_scene", "seg_flash": "seg_flash_train",
                        "scene_2228224": "whole_scene_2228224", "seg_bf16": "seg_train_bf16",
                        "seg_flash_bf16": "seg_flash_train_bf16"}[path],
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
