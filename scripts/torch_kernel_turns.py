"""FPS's block design, the flash forward, the ball query and the gather
backward of two source trees, timed in turns on a card; or one tree's plans
side by side; or the flash forward at the B1 x 2228224 request's level 1.

Each tree is a checkout of the repo (for example the parent commit unpacked
with ``git archive`` beside this one). Turns run in the order A, B, B, A, each
in a process of its own that imports ``pointasnl_tpu_torch`` from its tree
(building that tree's kernels there once) and this checkout's
``chip_smoke.py`` for its inputs and its profiler timing. A turn runs, from
seeded inputs (chip_smoke's ``time_kernels`` inputs), every block-design FPS
of the paths (the seg train step's four levels, the cls request's two, the
B1 x 131072 request's last two), the flash forward at the seg step's four
non-local levels and the ball query at the repulsion loss's shape and at N
10240, and takes the device ms of one call (``device_ms``: the median of 10
calls by torch.profiler, the forward's merge kernel included where a tree
has one) and the ms of a call back to back by CUDA events; then a seg step's
19 gather backwards as the step runs them (each index tensor planned once),
by CUDA events and as the device time of every kernel they launch (the
plans' sorts or plan kernels included), beside ``index_add_`` on the same
shapes. FPS and ball-query indices and the gradients must equal the first
turn's in every turn; a tree's flash outputs must equal its first turn's to
the bit, and each turn prints the largest |o - plain| over the output's
scale. Prints each shape's ms of both trees (the median of each tree's
turns), then one JSON line.

    python3 scripts/torch_kernel_turns.py TREE_A TREE_B
    python3 scripts/torch_kernel_turns.py --plans [TREE]    # this tree's plans side by side
    python3 scripts/torch_kernel_turns.py --big [TREE ...]  # flash forward, 278528q/2228224
    python3 scripts/torch_kernel_turns.py --ball-plans [TREE]  # the ball query's plans

``--plans`` builds the one tree's kernels with the sweep's entry points
(-DFPS_PLAN_SWEEP -DFLASH_FWD_PLAN_SWEEP, in a build directory of their
own) and times each path FPS shape under every points-a-thread variant of
the block design (the fewest warps that hold N, and twice that where the
variant takes it), the block and cluster designs side by side at 4096 to
10240 points in batches on each side of the card's cluster slots, each
flash level at 1 to 16 key ranges beside the plan's, and the forward's
error against the keys a range holds (``--big``'s 256 rows over 2228224
keys, and N 131072). ``--big`` times the flash forward once at the
B1 x 2228224 request's level 1 (278528 queries over 2228224 keys, C = D =
32, from a seed) by CUDA events, beside its float32 bound and its error on
256 rows, in each tree given, and F.scaled_dot_product_attention on the same
inputs. ``--ball-plans`` builds the sweep's entry points too
(-DBALL_QUERY_SWEEP) and times the ball query at both of its shapes under
every plan: 2, 4 or 8 points a lane a round, 1 to 8 queries a warp, each
exact against the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _import_tree(tree: str):
    sys.path.insert(0, tree)
    import pointasnl_tpu_torch

    if not os.path.realpath(pointasnl_tpu_torch.__file__).startswith(os.path.realpath(tree)):
        raise RuntimeError(f"imported {pointasnl_tpu_torch.__file__}, not the tree {tree}")


def _fps_shapes(smoke, dev):
    """(path, shape, npoint, xyz) of every block-design FPS of the paths."""
    from pointasnl_tpu_torch.ops.cuda import fps

    out = [("cls", f"B{B} N{N}->{m}", m, smoke.cloud(11, B, N, dev)) for B, N, m in smoke.FPS_SHAPES]
    for path, levels, sizes in (("seg", smoke.seg_levels(dev, seed=22), smoke.SEG_LEVELS),
                                ("scene", smoke.scene_levels(dev, seed=23), smoke.SCENE_LEVELS)):
        for a, n in zip(levels, sizes[1:]):
            if a.shape[1] <= fps.BLOCK_MAX_N:
                out.append((path, f"B{a.shape[0]} N{a.shape[1]}->{n}", n, a))
    return out


def _fps_symbol(fps, x) -> str:
    """The kernel an FPS call launches on x in this tree: the cluster
    design's where the tree routes x's batch to it, else the block
    design's."""
    B, N, _ = x.shape
    if hasattr(fps, "stated_cluster_slots") and fps.design(
            N, fps.stated_cluster_max_n(), B, fps.stated_cluster_slots()) == "cluster":
        return "fps_cluster_kernel"
    return "fps_kernel"


def _flash_symbols(lib, B, M, N, C, D):
    """The kernels a forward call launches in this tree."""
    if not hasattr(lib, "pasnl_flash_fwd_scratch"):
        return ("flash_fwd_kernel",)  # a tree before the range split
    split = lib.pasnl_flash_fwd_scratch(B, M, N, C, D) > 0
    return ("flash_fwd_kernel",) + ("flash_fwd_merge_kernel",) * split


def _digest(*tensors) -> str:
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in tensors)).hexdigest()[:16]


def _seg_gathers(smoke, dev):
    """(dout, idx, n) of each gather backward of one B4 x 10240 seg train step
    in this tree, recorded at its wrapper (chip_smoke.seg_gathers' inputs)."""
    import torch

    from pointasnl_tpu_torch.models import PointASNLSemSegRes
    from pointasnl_tpu_torch.ops.cuda import gather_backward

    model = PointASNLSemSegRes(smoke.SEG_CLASSES, device=dev,
                               generator=torch.Generator().manual_seed(smoke.SEED + 3))
    state, step = smoke.seg_trainer(model, smoke.SEG_B)
    cases, launch = [], gather_backward.gather_backward

    def record(dout, idx, n):
        cases.append((dout.detach().clone(), idx, n))
        return launch(dout, idx, n)

    gather_backward.gather_backward = record
    torch.manual_seed(0)  # dropout's masks: the same gradients in every turn
    try:
        step(state, smoke.seg_batch(210, smoke.SEG_B, smoke.SEG_N, smoke.SEG_SIDE, dev))
    finally:
        gather_backward.gather_backward = launch
    return cases


def _device_total_ms(fn, calls: int = 10) -> float:
    """Device time (ms) of every kernel one call of fn launches, by
    torch.profiler over `calls` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / calls / 1e3


def worker_turn(tree: str) -> None:
    _import_tree(tree)
    import torch

    smoke = _smoke()
    from pointasnl_tpu_torch.ops import flash_attention as fa
    from pointasnl_tpu_torch.ops.cuda import _build, fps
    from pointasnl_tpu_torch.ops.cuda import flash_attention as cuda_flash

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    lib = _build.library()
    rows = []
    for path, shape, npoint, x in _fps_shapes(smoke, dev):
        call = lambda: fps.farthest_point_sample(npoint, x)  # noqa: E731
        idx = call()
        torch.cuda.synchronize()
        rows.append({"kernel": "fps", "path": path, "shape": shape,
                     "ms": smoke.device_ms(call, _fps_symbol(fps, x)),
                     "call_ms": statistics.median(smoke.time_ms(call, *smoke.HEAVY)),
                     "digest": _digest(idx)})
    for B, M, N, C, D in smoke.FLASH_SEG:
        q, k, v, _ = smoke.flash_inputs("time", B, M, N, C, D, 1.0, dev)
        scale = fa.flash_scale(C)
        call = lambda: cuda_flash.flash_forward(q, k, v, scale)  # noqa: E731
        o, lse = call()
        po, _ = fa.flash_forward_reference(q, k, v, scale)
        torch.cuda.synchronize()
        rows.append({"kernel": "flash_fwd", "path": "seg_flash", "shape": f"B{B} {M}q/{N} C{C} D{D}",
                     "ms": smoke.device_ms(call, _flash_symbols(lib, B, M, N, C, D)),
                     "call_ms": statistics.median(smoke.time_ms(call, *smoke.LIGHT)),
                     "rel_err": float((o - po).abs().max() / po.abs().max()),
                     "digest": _digest(o, lse)})
    from pointasnl_tpu_torch.ops.cuda import ball_query, gather_backward

    l1 = smoke.seg_levels(dev, seed=22)[1]
    x = smoke.cube(24, 1, smoke.SEG_N, smoke.SEG_SIDE, dev)
    radius, nsample = smoke.REPULSION_RADIUS, smoke.REPULSION_NSAMPLE
    for path, s, q in (("seg", l1, l1), ("check", x, x[:, ::8].contiguous())):
        call = lambda: ball_query.query_ball_point(radius, nsample, s, q)  # noqa: E731
        idx, cnt = call()
        torch.cuda.synchronize()
        rows.append({"kernel": "ball_query", "path": path,
                     "shape": f"B{s.shape[0]} {q.shape[1]}q/{s.shape[1]} ns{nsample} r{radius}",
                     "ms": smoke.device_ms(call, "ball_query_kernel"),
                     "call_ms": statistics.median(smoke.time_ms(call, *smoke.LIGHT)),
                     "digest": _digest(idx, cnt)})
    gathers = _seg_gathers(smoke, dev)

    def as_a_step_runs_them():  # each index tensor planned once, as in the step
        for _, idx, _ in gathers:
            (idx if idx._base is None else idx._base).__dict__.pop("_gather_backward_plans", None)
        return [gather_backward.gather_backward(*g) for g in gathers]

    grads = as_a_step_runs_them()
    torch.cuda.synchronize()
    rows.append({"kernel": "gather_bwd", "path": "seg",
                 "shape": f"a seg step's {len(gathers)} gather backwards as the step runs them",
                 "ms": _device_total_ms(as_a_step_runs_them),
                 "call_ms": statistics.median(smoke.time_ms(as_a_step_runs_them, *smoke.LIGHT)),
                 "library_ms": statistics.median(smoke.time_ms(
                     lambda: [smoke.index_add(*g) for g in gathers], *smoke.LIGHT)),
                 "digest": _digest(*grads)})
    print(json.dumps({"tree": tree, "rows": rows}))


def _sweep_library():
    """This tree's kernels built with the plan sweep's entry points
    (-DFPS_PLAN_SWEEP, -DFLASH_FWD_PLAN_SWEEP), in a build directory of their
    own; the wrappers then launch from it."""
    from pointasnl_tpu_torch.ops.cuda import _build

    _build.NVCC_FLAGS += ["-DFPS_PLAN_SWEEP", "-DFLASH_FWD_PLAN_SWEEP", "-DBALL_QUERY_SWEEP"]
    lib = _build.library()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pasnl_ball_query_planned.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, i, i, p]
    lib.pasnl_ball_query_planned.restype = i
    lib.pasnl_fps_block_planned.argtypes = [p, p, i, i, i, i, i, p]
    lib.pasnl_fps_block_planned.restype = i
    lib.pasnl_flash_fwd_force_splits.argtypes = [i]
    lib.pasnl_flash_fwd_force_splits.restype = None
    return lib


def _ref64(q, k, v, scale, chunk: int = 1 << 16):
    """o of dense attention in float64, over the keys in chunks."""
    import torch

    q = q.double()
    m = torch.full(q.shape[:2] + (1,), float("-inf"), dtype=torch.float64, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape[:2] + (v.shape[-1],), dtype=torch.float64, device=q.device)
    for s0 in range(0, k.shape[1], chunk):
        s = torch.einsum("bmc,bnc->bmn", q, k[:, s0:s0 + chunk].double()) * scale
        m2 = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m2)
        alpha = torch.exp(m - m2)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bmn,bnd->bmd", p, v[:, s0:s0 + chunk].double())
        m = m2
    return acc / l


def _errors(o, plain, ref64) -> dict:
    """|o - plain|, |o - ref64| and |plain - ref64| over max|ref64|, and
    whether |o - plain| holds chip_smoke's limit for o (FLASH_RTOL of the
    scale plus YARDSTICK times the plain version's distance from float64)."""
    smoke = _smoke()
    scale = float(ref64.abs().max())
    err, dist = float((o.double() - plain.double()).abs().max()), float(
        (plain.double() - ref64).abs().max())
    return {"o_plain": err / scale, "o_64": float((o.double() - ref64).abs().max()) / scale,
            "plain_64": dist / scale,
            "holds": err <= smoke.FLASH_RTOL * scale + smoke.YARDSTICK * dist}


def worker_plans(tree: str) -> None:
    _import_tree(tree)
    import numpy as np
    import torch

    smoke = _smoke()
    from pointasnl_tpu_torch.ops import flash_attention as fa
    from pointasnl_tpu_torch.ops import geometry
    from pointasnl_tpu_torch.ops.cuda import _build, fps
    from pointasnl_tpu_torch.ops.cuda import flash_attention as cuda_flash

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    lib = _sweep_library()
    card = smoke.smi("name,power.limit")
    slots = fps.stated_cluster_slots()
    print(f"the cluster design: {slots} clusters at once at a block-design N  [{card}]")
    out = [{"cluster_slots": slots}]
    variants = sorted({ppt for _, ppt in fps.BLOCK_PLAN})

    def block(x, npoint, ppt, warps):
        """(out, a call of the block design at plan (ppt, warps) into out)."""
        B, N, _ = x.shape
        got = torch.empty((B, npoint), dtype=torch.int32, device=dev)
        return got, lambda: _build.check(lib.pasnl_fps_block_planned(
            x.data_ptr(), got.data_ptr(), B, N, npoint, ppt, warps,
            torch.cuda.current_stream().cuda_stream), "fps kernel (block design)")

    for path, shape, npoint, x in _fps_shapes(smoke, dev):
        B, N, _ = x.shape
        want = geometry.farthest_point_sample(npoint, x)
        plans = []
        for ppt in variants:
            warps = -(-N // (32 * ppt))
            plans += [(ppt, w) for w in (warps, 2 * warps) if w * 32 * ppt >= N and
                      w <= min(32, -(-fps.BLOCK_MAX_N // (32 * ppt)))]
        for ppt, warps in plans:
            got, call = block(x, npoint, ppt, warps)
            call()
            torch.cuda.synchronize()
            ms = smoke.device_ms(call, "fps_kernel")
            exact = bool(torch.equal(got, want))
            planned = (ppt, warps) == fps.block_plan(N)
            out.append({"kernel": "fps", "path": path, "shape": shape, "ppt": ppt,
                        "warps": warps, "ms": ms, "exact": exact, "planned": planned})
            print(f"fps [{path}] {shape}: {ppt} a thread, {warps} warps: {ms} ms on the device"
                  f"{' (the plan)' if planned else ''}{'' if exact else ' NOT EXACT'}  [{card}]")
    # The block and cluster designs side by side at the largest block-design
    # clouds, in batches on each side of the card's cluster slots.
    for B in sorted({1, 4, slots, slots + 1, 16}):
        for N in (4096, 6144, 8192, 10240):
            x, npoint = smoke.cloud(N + B, B, N, dev), N // 8
            want = geometry.farthest_point_sample(npoint, x)
            row = {"kernel": "fps", "shape": f"B{B} N{N}->{npoint}",
                   "route": fps.design(N, fps.stated_cluster_max_n(), B, slots)}
            for name, symbol in (("block", "fps_kernel"), ("cluster", "fps_cluster_kernel")):
                call = lambda: fps._sample(name, npoint, x)  # noqa: E731
                if not torch.equal(call(), want):
                    raise RuntimeError(f"fps {name} design {row['shape']}: not exact")
                row[name] = smoke.device_ms(call, symbol)
            out.append(row)
            print(f"fps {row['shape']}: block {row['block']} ms, cluster {row['cluster']} ms on "
                  f"the device; routed to the {row['route']} design  [{card}]")
    for B, M, N, C, D in smoke.FLASH_SEG:
        q, k, v, _ = smoke.flash_inputs("time", B, M, N, C, D, 1.0, dev)
        scale = fa.flash_scale(C)
        po, _ = fa.flash_forward_reference(q, k, v, scale)
        for force in (0, 1, 2, 3, 4, 5, 8, 10, 16):
            lib.pasnl_flash_fwd_force_splits(force)
            call = lambda: cuda_flash.flash_forward(q, k, v, scale)  # noqa: E731
            o, _ = call()
            torch.cuda.synchronize()
            scratch = lib.pasnl_flash_fwd_scratch(B, M, N, C, D)
            splits = scratch // (B * M * (D + 2)) if scratch else 1
            ms = smoke.device_ms(call, _flash_symbols(lib, B, M, N, C, D))
            call_ms = statistics.median(smoke.time_ms(call, *smoke.LIGHT))
            err = float((o - po).abs().max() / po.abs().max())
            out.append({"kernel": "flash_fwd", "shape": f"B{B} {M}q/{N} C{C} D{D}",
                        "splits": splits, "ms": ms, "call_ms": call_ms, "rel_err": err,
                        "planned": force == 0})
            print(f"flash_fwd B{B} {M}q/{N} C{C} D{D}: {splits} ranges: {ms} ms on the device, "
                  f"{call_ms:.4f} ms a call, |o - plain| / max|o| {err:.2e}"
                  f"{' (the plan)' if force == 0 else ''}  [{card}]")
    # Accuracy against the keys a range holds: the --big inputs' 256 rows
    # over 2228224 keys, and FLASH_FWD_ONLY's N 131072 case.
    M, N, C = smoke.BIG_LEVELS[1], smoke.BIG_N, 32
    rng = np.random.RandomState(9)
    q, k, v = (torch.from_numpy(rng.randn(1, n, C).astype(np.float32)).to(dev) for n in (M, N, N))
    rows = torch.randperm(M, generator=torch.Generator().manual_seed(0))[:256].to(dev)
    q = q[:, rows].contiguous()
    cases = [("B1 256q/2228224 C32 (--big's rows)", q, k, v, (0, 1, 2, 4, 9, 17, 34, 68, 136))]
    for name, (B, M, N, C, D, scaled, qmul) in smoke.FLASH_FWD_ONLY.items():
        cases.append((f"B{B} {M}q/{N} C{C} D{D} ({name})",
                       *smoke.flash_inputs(name, B, M, N, C, D, qmul, dev)[:3], (0, 1, 2, 4, 16)))
    for name, q, k, v, forces in cases:
        scale = fa.flash_scale(q.shape[-1])
        plain, _ = fa.flash_forward_reference(q, k, v, scale)
        ref64 = _ref64(q, k, v, scale)
        for force in forces:
            lib.pasnl_flash_fwd_force_splits(force)
            (B, M, C), N, D = q.shape, k.shape[1], v.shape[-1]
            scratch = lib.pasnl_flash_fwd_scratch(B, M, N, C, D)
            splits = scratch // (B * M * (D + 2)) if scratch else 1
            o, _ = cuda_flash.flash_forward(q, k, v, scale)
            e = _errors(o, plain, ref64)
            out.append({"kernel": "flash_fwd", "accuracy": name, "splits": splits,
                        "keys_a_range": -(-N // splits), "planned": force == 0, **e})
            print(f"flash_fwd accuracy {name}: {splits} ranges of <= {-(-N // splits)} keys: "
                  f"|o - plain| {e['o_plain']:.2e}, |o - f64| {e['o_64']:.2e}, |plain - f64| "
                  f"{e['plain_64']:.2e} of max|o|; chip_smoke's limit "
                  f"{'holds' if e['holds'] else 'FAILS'}{' (the plan)' if force == 0 else ''}"
                  f"  [{card}]")
    lib.pasnl_flash_fwd_force_splits(0)
    print(json.dumps({"tree": tree, "card": card, "plans": out}))


def worker_ball_plans(tree: str) -> None:
    """The ball query at its two shapes under every plan of the sweep."""
    _import_tree(tree)
    import torch

    smoke = _smoke()
    from pointasnl_tpu_torch.ops import geometry
    from pointasnl_tpu_torch.ops.cuda import _build
    from pointasnl_tpu_torch.ops.geometry import _radius_sq

    dev = torch.device("cuda")
    lib = _sweep_library()
    card = smoke.smi("name,power.limit")
    radius, nsample = smoke.REPULSION_RADIUS, smoke.REPULSION_NSAMPLE
    l1 = smoke.seg_levels(dev, seed=22)[1]
    x = smoke.cube(24, 1, smoke.SEG_N, smoke.SEG_SIDE, dev)
    out = []
    for path, s, q in (("seg", l1, l1), ("check", x, x[:, ::8].contiguous())):
        (B, N, _), M = s.shape, q.shape[1]
        want = geometry.query_ball_point(radius, nsample, s, q)
        shape = f"B{B} {M}q/{N} ns{nsample} r{radius}"
        for per_lane in (2, 4, 8):
            for per_warp in (1, 2, 4, 8):
                idx = torch.empty((B, M, nsample), dtype=torch.int32, device=dev)
                cnt = torch.empty((B, M), dtype=torch.int32, device=dev)
                call = lambda: _build.check(lib.pasnl_ball_query_planned(  # noqa: E731
                    s.data_ptr(), q.data_ptr(), idx.data_ptr(), cnt.data_ptr(), B, N, M, nsample,
                    _radius_sq(radius), per_lane, per_warp,
                    torch.cuda.current_stream().cuda_stream), "ball query kernel (planned)")
                call()
                torch.cuda.synchronize()
                exact = bool(torch.equal(idx, want[0]) and torch.equal(cnt, want[1]))
                ms = smoke.device_ms(call, "ball_query_kernel")
                out.append({"kernel": "ball_query", "path": path, "shape": shape,
                            "per_lane": per_lane, "per_warp": per_warp, "ms": ms,
                            "exact": exact})
                print(f"ball_query [{path}] {shape}: {per_lane} points a lane, {per_warp} "
                      f"queries a warp: {ms} ms on the device{'' if exact else ' NOT EXACT'}  "
                      f"[{card}]")
    print(json.dumps({"tree": tree, "card": card, "plans": out}))


def worker_big(tree: str) -> None:
    """The flash forward once at 278528q/2228224 C32 D32, by CUDA events."""
    _import_tree(tree)
    import numpy as np
    import torch

    smoke = _smoke()
    from pointasnl_tpu_torch.ops import flash_attention as fa
    from pointasnl_tpu_torch.ops.cuda import flash_attention as cuda_flash

    dev = torch.device("cuda")
    M, N, C = smoke.BIG_LEVELS[1], smoke.BIG_N, 32
    rng = np.random.RandomState(9)
    q, k, v = (torch.from_numpy(rng.randn(1, n, C).astype(np.float32)).to(dev)
               for n in (M, N, N))
    scale = fa.flash_scale(C)
    call = lambda: cuda_flash.flash_forward(q, k, v, scale)  # noqa: E731
    ms = smoke.time_ms(call, reps=2, warmup=1)
    o, lse = call()
    rows = torch.randperm(M, generator=torch.Generator().manual_seed(0))[:256].to(dev)
    po, _ = fa.flash_forward_reference(q[:, rows], k, v, scale)
    e = _errors(o[:, rows], po, _ref64(q[:, rows], k, v, scale))
    bnd = smoke.flash_fwd_bound(1, M, N, C, C)
    finite = bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
    del o, lse
    # F.scaled_dot_product_attention on the same inputs, float32 with TF32
    # off: the yardstick (library ms), or why it cannot run here.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=scale)  # noqa: E731
    try:
        library_ms = smoke.time_ms(sdpa, reps=2, warmup=1)
        so = sdpa()[:, rows]
        library = {"library_ms": library_ms,
                   "library_rel_err_on_256_rows": float((so - po).abs().max() / po.abs().max())}
    except RuntimeError as err:  # out of memory, or no kernel for these inputs
        torch.cuda.empty_cache()
        library = {"library_ms": None, "library_error": str(err).splitlines()[0][:300]}
    print(json.dumps({"tree": tree, "shape": f"B1 {M}q/{N} C{C} D{C}", "ms": ms,
                      "bound_ms": bnd[0], "bound_by": bnd[1], "rel_err_on_256_rows": e["o_plain"],
                      "errors_on_256_rows": e, **library, "finite": finite}))


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def _run(mode: str, tree: str) -> dict:
    out = subprocess.run([sys.executable, os.path.abspath(__file__), f"--worker-{mode}", tree],
                         capture_output=True, text=True, cwd=tree)
    if out.returncode != 0:
        print(out.stdout[-4000:], out.stderr[-4000:], sep="\n")
        raise SystemExit(1)
    if mode in ("plans", "ball_plans"):
        print(out.stdout.strip(), flush=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--plans", action="store_true", help="one tree's plans side by side")
    ap.add_argument("--big", action="store_true", help="the flash forward at 278528q/2228224")
    ap.add_argument("--ball-plans", action="store_true", help="the ball query's plans")
    for mode in ("turn", "plans", "big", "ball_plans"):
        ap.add_argument(f"--worker-{mode}", help=argparse.SUPPRESS)
    args = ap.parse_args()
    for mode, fn in (("turn", worker_turn), ("plans", worker_plans), ("big", worker_big),
                     ("ball_plans", worker_ball_plans)):
        if getattr(args, f"worker_{mode}"):
            fn(getattr(args, f"worker_{mode}"))
            return 0
    trees = [os.path.abspath(t) for t in args.trees] or [str(ROOT)]
    card = _card()
    if args.plans:
        _run("plans", trees[0])
        return 0
    if args.ball_plans:
        _run("ball_plans", trees[0])
        return 0
    if args.big:
        for tree in trees:
            r = _run("big", tree)
            print(f"flash_fwd [scene_2228224 level 1] {r['shape']} ({tree}): "
                  f"{statistics.median(r['ms']):.1f} ms a call by CUDA events "
                  f"({', '.join(f'{x:.1f}' for x in r['ms'])}), bound {r['bound_ms']:.1f} ms "
                  f"({r['bound_by']}), |o - plain| / max|o| on 256 rows "
                  f"{r['rel_err_on_256_rows']:.2e} (|o - f64| "
                  f"{r['errors_on_256_rows']['o_64']:.2e}, |plain - f64| "
                  f"{r['errors_on_256_rows']['plain_64']:.2e}; chip_smoke's limit "
                  f"{'holds' if r['errors_on_256_rows']['holds'] else 'FAILS'}), "
                  f"finite {r['finite']}  [{card}]")
            if r["library_ms"]:
                print(f"F.scaled_dot_product_attention at {r['shape']} ({tree}): "
                      f"{statistics.median(r['library_ms']):.1f} ms a call by CUDA events "
                      f"({', '.join(f'{x:.1f}' for x in r['library_ms'])}), |o - plain| / max|o| "
                      f"on 256 rows {r['library_rel_err_on_256_rows']:.2e}  [{card}]")
            else:
                print(f"F.scaled_dot_product_attention at {r['shape']}: cannot run here: "
                      f"{r['library_error']}  [{card}]")
            print(json.dumps({"card": card, **r}))
        return 0
    if len(trees) != 2:
        ap.error("give two trees")
    a, b = trees
    turns = {a: [], b: []}
    first, firsts = None, {}
    for turn, tree in enumerate((a, b, b, a)):
        rows = _run("turn", tree)["rows"]
        for r in rows:
            print(f"turn {turn + 1}, {tree}: {r['kernel']} [{r['path']}] {r['shape']}: "
                  f"{r['ms']} ms on the device, {r['call_ms']:.4f} ms a call"
                  + (f", |o - plain| / max|o| {r['rel_err']:.2e}" if "rel_err" in r else ""))
        key = lambda r: (r["kernel"], r["path"], r["shape"])  # noqa: E731
        exact = ("fps", "ball_query", "gather_bwd")  # equal across the trees too
        first = first or {key(r): r["digest"] for r in rows if r["kernel"] in exact}
        mine = firsts.setdefault(tree, {key(r): r["digest"] for r in rows})
        differ = [r["shape"] for r in rows if (r["kernel"] in exact and first[key(r)] != r["digest"])
                  or mine[key(r)] != r["digest"]]
        if differ:
            print(f"turn {turn + 1}, {tree}: results differ from an earlier turn at {differ}")
            return 1
        turns[tree].append(rows)

    def median(tree, i, k):
        xs = [t[i][k] for t in turns[tree]]
        return None if None in xs else statistics.median(xs)

    result = {"card": card, "trees": [a, b], "rows": []}
    for i, r in enumerate(turns[a][0]):
        row = {"kernel": r["kernel"], "path": r["path"], "shape": r["shape"],
               "ms": [median(a, i, "ms"), median(b, i, "ms")],
               "call_ms": [median(a, i, "call_ms"), median(b, i, "call_ms")]}
        if "library_ms" in r:
            row["library_ms"] = [median(a, i, "library_ms"), median(b, i, "library_ms")]
        result["rows"].append(row)
        (ms_a, ms_b), (call_a, call_b) = row["ms"], row["call_ms"]
        ratio = f", {ms_a / ms_b:.2f}x" if ms_a and ms_b else ""
        lib = (f"; index_add_ {row['library_ms'][0]:.4f} and {row['library_ms'][1]:.4f} ms"
               if "library_ms" in row else "")
        print(f"{r['kernel']} [{r['path']}] {r['shape']}: {ms_a} ms (A) -> {ms_b} ms (B) on the "
              f"device{ratio}; a call {call_a:.4f} -> {call_b:.4f} ms{lib}  [{card}]")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
