"""The port's seg train step, timed for two source trees in turns, on a card.

Each tree is a checkout of the repo (for example the parent commit unpacked
with ``git archive`` beside this one). Turns run in the order A, B, B, A
(``--rounds`` times over), each in a process of its own that imports
``pointasnl_tpu_torch`` from its tree (building that tree's kernels there
once), makes ``PointASNLSemSegRes(21)`` from one seed, takes WARMUP steps
at B4x10240 with the ScanNet recipe's optimizer and losses, and times STEPS
more, one by one, by CUDA events. Prints each turn's p50 and p90, each tree's p50 over
its turns, and one JSON line.

    python3 scripts/torch_step_turns.py TREE_A TREE_B [--flash] [--rounds R]
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

B, N, CLASSES, SIDE = 4, 10240, 21, 0.5
WARMUP, STEPS, BATCHES = 3, 20, 4


def worker(root: str, flash: bool) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import pointasnl_tpu_torch
    from pointasnl_tpu_torch.models import PointASNLSemSegRes
    from pointasnl_tpu_torch.train import (
        TrainState,
        bn_momentum_schedule,
        make_optimizer,
        make_train_step,
        staircase_lr_schedule,
    )

    if not os.path.realpath(pointasnl_tpu_torch.__file__).startswith(os.path.realpath(root)):
        raise RuntimeError(f"imported {pointasnl_tpu_torch.__file__}, not the tree {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    model = PointASNLSemSegRes(CLASSES, nl_use_flash=flash,
                               generator=torch.Generator().manual_seed(0), device=dev)
    state = TrainState(model, make_optimizer(
        "adam", staircase_lr_schedule(1e-3, B, 200000, 0.7), model.parameters()))
    step = make_train_step(bn_schedule=bn_momentum_schedule(B, 200000), task="seg",
                           uniform_weight=0.01, weights_decay=1e-4)
    batches = []
    for seed in range(BATCHES):
        rng = np.random.RandomState(seed)
        batches.append({
            "points": torch.from_numpy((rng.rand(B, N, 3) * SIDE).astype(np.float32)).to(dev),
            "labels": torch.from_numpy(rng.randint(0, CLASSES, (B, N))).to(dev),
            "smpw": torch.ones(B, N, device=dev)})
    # The dropout masks' generator, where the tree's step takes one.
    extra = ((torch.Generator(device=dev).manual_seed(0),)
             if "dropout_rng" in inspect.signature(step).parameters else ())
    for i in range(WARMUP):
        step(state, batches[i % BATCHES], *extra)
    torch.cuda.synchronize()
    ms = []
    for i in range(STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, batches[i % BATCHES], *extra)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    print(json.dumps({"root": root, "ms": ms}))


def p90(xs):
    s = sorted(xs)
    return s[max(int(0.9 * len(s)) - 1, 0)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--flash", action="store_true", help="the step under nl_use_flash")
    ap.add_argument("--rounds", type=int, default=1, help="A, B, B, A this many times")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.flash)
        return 0
    if len(args.trees) != 2:
        ap.error("give two trees")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    a, b = (os.path.abspath(t) for t in args.trees)
    label = "flash seg" if args.flash else "seg"
    runs = {a: [], b: []}
    for turn, root in enumerate((a, b, b, a) * args.rounds):
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", root] + ["--flash"] * args.flash
        out = subprocess.run(cmd, capture_output=True, text=True, cwd=root)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], sep="\n")
            return 1
        ms = json.loads(out.stdout.strip().splitlines()[-1])["ms"]
        runs[root].append(ms)
        print(f"turn {turn + 1}, {root}: {label} train step B{B}x{N} p50 "
              f"{statistics.median(ms):.3f} ms, p90 {p90(ms):.3f} ms of {len(ms)}  [{card}]")
    result = {"card": card, "step": label, "batch": f"B{B}x{N}", "trees": {}}
    for root, turns in runs.items():
        flat = [x for t in turns for x in t]
        result["trees"][root] = {"p50_ms": statistics.median(flat), "p90_ms": p90(flat),
                                 "turn_p50_ms": [statistics.median(t) for t in turns]}
        print(f"{root}: p50 {statistics.median(flat):.3f} ms over its turns  [{card}]")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
