"""The resident and spatial kNN kernels of two source trees, timed in turns
on a card.

Each tree is a checkout of the repo (for example the parent commit unpacked
with ``git archive`` beside this one). Turns run in the order A, B, B, A,
each in a process of its own that imports ``pointasnl_tpu_torch`` from its
tree (building that tree's kernels there once) and this checkout's
``chip_smoke.py`` for its inputs and its profiler timing. A turn makes the
searches of every path from seeded inputs (chip_smoke's ``time_kernels``
inputs: the cls request's two, the seg train step's eleven, the B1x131072
request's eleven; and a B1x2228224 request's ten but its stem, on the FPS
chain of ``scene(0, BIG_N)``), routes each as ``ops.dispatch.knn_route``
does, and takes the device ms of one launch of its kernel (``device_ms``:
the median of 10 launches, by torch.profiler), the pairs a spatial search
tests (``pairs_tested``) and, with ``--streaming``, the streaming kernel's
device ms on each spatial search. Every turn's indices must equal the first
turn's. Prints each search's device ms of both trees (the median of each
tree's turns), then one JSON line.

    python3 scripts/torch_knn_turns.py TREE_A TREE_B [--streaming]
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worker(tree: str, streaming: bool) -> None:
    sys.path.insert(0, tree)
    import torch

    import pointasnl_tpu_torch

    if not os.path.realpath(pointasnl_tpu_torch.__file__).startswith(os.path.realpath(tree)):
        raise RuntimeError(f"imported {pointasnl_tpu_torch.__file__}, not the tree {tree}")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from pointasnl_tpu_torch import ops
    from pointasnl_tpu_torch.ops import geometry
    from pointasnl_tpu_torch.ops.cuda import fps, knn, knn_spatial, knn_streaming

    dev = torch.device("cuda")
    searches = []  # (path, shape, k, support, query)
    for B, N, M, k in smoke.KNN_SHAPES:
        s = smoke.cloud(12, B, N, dev)
        searches.append(("cls", f"B{B} {M}q/{N} k{k}", k, s,
                         geometry.gather_point(s, fps.farthest_point_sample(M, s))))
    for path, levels in (("seg", smoke.seg_levels(dev, seed=22)),
                         ("scene", smoke.scene_levels(dev, seed=23))):
        for si, qi, k in smoke.SEG_KNN:
            s, q = levels[si], levels[qi]
            searches.append((path, f"B{s.shape[0]} {q.shape[1]}q/{s.shape[1]} k{k}", k, s,
                             s if si == qi else q))
    big = [smoke.scene(0, smoke.BIG_N, dev)]
    for n in smoke.BIG_LEVELS[1:]:
        big.append(geometry.gather_point(big[-1], fps.farthest_point_sample(n, big[-1])))
    for si, qi, k in smoke.SEG_KNN:
        if si == qi == 0:
            continue  # the stem is the streaming kernel's
        s, q = big[si], big[qi]
        searches.append(("scene_2228224", f"B1 {q.shape[1]}q/{s.shape[1]} k{k}", k, s,
                         s if si == qi else q))

    rows = []
    for path, shape, k, s, q in searches:
        route = ops.dispatch.knn_route(s.shape[1], k)
        if route == "streaming":
            raise RuntimeError(f"{path} {shape}: routed to the streaming kernel")
        mod, symbol = ((knn, "knn_kernel") if route == "resident"
                       else (knn_spatial, "knn_spatial_kernel"))
        d, i = mod.knn_point(k, s, q)
        torch.cuda.synchronize()
        row = {"path": path, "shape": shape, "route": route,
               "ms": smoke.device_ms(lambda: mod.knn_point(k, s, q), symbol),
               "digest": hashlib.sha256(i.cpu().numpy().tobytes()
                                        + d.cpu().numpy().tobytes()).hexdigest()[:16]}
        if route == "spatial":
            row["pairs_tested"] = knn_spatial.pairs_tested(k, s, q)
            if streaming:
                row["streaming_ms"] = smoke.device_ms(lambda: knn_streaming.knn_point(k, s, q),
                                                      "knn_stream_kernel")
        rows.append(row)
        del d, i
    print(json.dumps({"tree": tree, "rows": rows}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--streaming", action="store_true",
                    help="also the streaming kernel's device ms on each spatial search")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.streaming)
        return 0
    if len(args.trees) != 2:
        ap.error("give two trees")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    a, b = (os.path.abspath(t) for t in args.trees)
    turns = {a: [], b: []}
    first = None
    for turn, tree in enumerate((a, b, b, a)):
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", tree]
        out = subprocess.run(cmd + ["--streaming"] * args.streaming, capture_output=True,
                             text=True, cwd=tree)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], sep="\n")
            return 1
        rows = json.loads(out.stdout.strip().splitlines()[-1])["rows"]
        for r in rows:
            print(f"turn {turn + 1}, {tree}: {r['route']} [{r['path']}] {r['shape']}: "
                  f"{r['ms']} ms on the device" + (f", pairs tested {r['pairs_tested']}"
                                                   if "pairs_tested" in r else ""))
        first = first or {(r["path"], r["shape"]): r["digest"] for r in rows}
        differ = [r["shape"] for r in rows if first[(r["path"], r["shape"])] != r["digest"]]
        if differ:
            print(f"turn {turn + 1}, {tree}: results differ from turn 1 at {differ}")
            return 1
        turns[tree].append(rows)

    def median(tree, i, key):
        xs = [t[i].get(key) for t in turns[tree]]
        return None if None in xs else statistics.median(xs)

    result = {"card": card, "trees": [a, b], "rows": []}
    for i, r in enumerate(turns[a][0]):
        ra, rb = turns[a][0][i], turns[b][0][i]
        row = {"path": r["path"], "shape": r["shape"], "route": r["route"],
               "ms": [median(a, i, "ms"), median(b, i, "ms")]}
        if "pairs_tested" in r:
            row["pairs_tested"] = [ra["pairs_tested"], rb["pairs_tested"]]
            if "streaming_ms" in r:
                row["streaming_ms"] = [median(a, i, "streaming_ms"), median(b, i, "streaming_ms")]
        result["rows"].append(row)
        ms_a, ms_b = row["ms"]
        ratio = f", {ms_a / ms_b:.2f}x" if ms_a and ms_b else ""
        print(f"{r['route']} [{r['path']}] {r['shape']}: {ms_a} ms (A) -> {ms_b} ms (B){ratio}"
              + (f"; pairs tested {row['pairs_tested']}" if "pairs_tested" in row else "")
              + (f"; streaming {row['streaming_ms']} ms" if "streaming_ms" in row else "")
              + f"  [{card}]")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
