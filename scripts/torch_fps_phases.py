"""Where a pick's time goes in FPS's multi-block designs, on the card.

Builds ``csrc/fps.cu`` of each checkout given twice, as shipped and with
``-DFPS_PROBE``, which makes thread 0 of every block of the cluster and grid
designs sum the ``clock64()`` cycles of each phase of a pick (the update pass,
the block's argmax, publishing its candidate, waiting for and reducing the
blocks' candidates, the rest) and bracket its pick loop with ``%globaltimer``.
Every checkout's ``fps.cu`` must carry the probe block and marks. Both
libraries are plain C, loaded with ctypes, apart from the package's own build.

For each multi-block design at the shapes of the whole-scene requests
(B1 x 2228224: 2228224 -> 278528 and 278528 -> 69632 in the grid design,
278528 -> 69632, 69632 -> 17408 and 17408 -> 8704 in the cluster design
where the checkout's cluster takes N; B1 x 131072: 131072 -> 16384 and
16384 -> 4096 in the cluster design) it prints, per
checkout, microseconds a pick by CUDA events for the shipped and the probe
build, and the probe build's split into phases (the mean over blocks of each
phase's cycles a pick, at the clock the globaltimer gives), then one JSON line.
Checkouts run in turns A, B, B, A; every launch's indices must equal the
first checkout's shipped build's (chip_smoke.py holds the designs to the
plain version). Exits 1 if any differ.

    python3 scripts/torch_fps_phases.py                  # this checkout, on a card
    python3 scripts/torch_fps_phases.py build/parent .   # the parent (git archive HEAD) and this
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from pointasnl_tpu_torch.ops import geometry  # noqa: E402
from pointasnl_tpu_torch.ops.cuda import _build  # noqa: E402

SOURCE = "pointasnl_tpu_torch/csrc/fps.cu"
OUT = ROOT / "build" / "fps_probe"
PHASES = ("update", "argmax", "publish", "exchange", "rest")
PROBE_BEGIN = "// fps-probe: begin"
# The shapes: (design, which scene, N, npoint).
SHAPES = [("grid", "big", smoke.BIG_LEVELS[0], smoke.BIG_LEVELS[1]),
          ("grid", "big", smoke.BIG_LEVELS[1], smoke.BIG_LEVELS[2]),
          ("cluster", "big", smoke.BIG_LEVELS[1], smoke.BIG_LEVELS[2]),
          ("cluster", "big", smoke.BIG_LEVELS[2], smoke.BIG_LEVELS[3]),
          ("cluster", "big", smoke.BIG_LEVELS[3], smoke.BIG_LEVELS[4]),
          ("cluster", "scene", smoke.SCENE_LEVELS[0], smoke.SCENE_LEVELS[1]),
          ("cluster", "scene", smoke.SCENE_LEVELS[1], smoke.SCENE_LEVELS[2])]


def build(tree: Path, probe: bool) -> ctypes.CDLL:
    """The checkout's fps.cu, with its probes if `probe`, as a loaded library."""
    src = (tree / SOURCE).read_text()
    if PROBE_BEGIN not in src:
        raise RuntimeError(f"{tree / SOURCE}: no probe block ({PROBE_BEGIN!r})")
    flags = [*_build.NVCC_FLAGS, *(["-DFPS_PROBE"] if probe else [])]
    key = hashlib.sha256((" ".join(flags) + src).encode()).hexdigest()[:16]
    out = OUT / key
    so = out / "libfps.so"
    if not so.exists():
        out.mkdir(parents=True, exist_ok=True)
        (out / "fps.cu").write_text(src)
        cmd = [_build._nvcc(), *flags, "-shared", "-o", str(so), str(out / "fps.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pasnl_fps_cluster.argtypes = [p, p, i, i, i, p]
    lib.pasnl_fps_grid.argtypes = [p, p, p, i, i, i, p]
    for name in ("pasnl_fps_cluster", "pasnl_fps_grid", "pasnl_fps_grid_scratch_bytes",
                 "pasnl_fps_cluster_max_n"):
        getattr(lib, name).restype = i
    if probe:
        lib.pasnl_fps_probe_read.argtypes = [p]
        for name in ("pasnl_fps_probe_rows", "pasnl_fps_probe_width", "pasnl_fps_probe_reset",
                     "pasnl_fps_probe_read"):
            getattr(lib, name).restype = i
    return lib


def check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def launch(lib, design: str, npoint: int, x: torch.Tensor):
    """(indices, ms by CUDA events) of one launch of `design`."""
    B, N, _ = x.shape
    out = torch.empty((B, npoint), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    slots = torch.zeros(lib.pasnl_fps_grid_scratch_bytes(), dtype=torch.uint8, device=x.device)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    if design == "grid":
        err = lib.pasnl_fps_grid(x.data_ptr(), out.data_ptr(), slots.data_ptr(), B, N, npoint,
                                 stream)
    else:
        err = lib.pasnl_fps_cluster(x.data_ptr(), out.data_ptr(), B, N, npoint, stream)
    end.record()
    check(lib, err, f"fps {design} B{B} N{N} -> {npoint}")
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def split(lib, design: str, npoint: int, x: torch.Tensor):
    """(indices, ms, {phase: us a pick}, probe rows) of one probed launch."""
    check(lib, lib.pasnl_fps_probe_reset(), "probe reset")
    out, ms = launch(lib, design, npoint, x)
    rows = torch.zeros((lib.pasnl_fps_probe_rows(), lib.pasnl_fps_probe_width()),
                       dtype=torch.int64)
    check(lib, lib.pasnl_fps_probe_read(rows.data_ptr()), "probe read")
    rows = [r for r in rows.tolist() if r[len(PHASES)] > 0]
    us = {}
    for k, phase in enumerate(PHASES):
        # cycles a pick / (cycles a ns) -> ns a pick, averaged over blocks
        us[phase] = statistics.mean(r[k] / r[len(PHASES)] / (r[-2] / r[-1]) for r in rows) / 1e3
    ghz = statistics.mean(r[-2] / r[-1] for r in rows)
    spread = {phase: (min(r[k] / r[len(PHASES)] / (r[-2] / r[-1]) for r in rows) / 1e3,
                      max(r[k] / r[len(PHASES)] / (r[-2] / r[-1]) for r in rows) / 1e3)
              for k, phase in enumerate(PHASES)}
    return out, ms, us, {"blocks": len(rows), "ghz": ghz, "spread": spread}


def main(argv) -> int:
    trees = [(a, Path(a).resolve()) for a in argv] or [(".", ROOT)]
    card = smoke.smi("name,power.limit")
    print(card)
    dev = torch.device("cuda")
    with ThreadPoolExecutor(2 * len(trees)) as pool:  # one nvcc a build, all at once
        futures = {(t, probe): pool.submit(build, t[1], probe)
                   for t in trees for probe in (False, True)}
        libs = {k: f.result() for k, f in futures.items()}
    # The inputs: the whole-scene requests' levels, by the first checkout's
    # shipped build.
    first = libs[(trees[0], False)]
    clouds = {"big": smoke.scene(0, smoke.BIG_N, dev), "scene": smoke.scene(0, smoke.SCENE_N, dev)}
    inputs = {}
    for _, which, N, npoint in SHAPES:  # the grid design takes every N
        x = clouds[which] if N in (smoke.BIG_N, smoke.SCENE_N) else inputs[(which, N)]
        idx, _ = launch(first, "grid", npoint, x)
        inputs[(which, npoint)] = geometry.gather_point(x, idx)
        inputs[(which, N)] = x
    order = trees + trees[::-1] if len(trees) > 1 else trees * 2
    results = {t[0]: {} for t in trees}
    differ = []
    for design, which, N, npoint in SHAPES:
        x = inputs[(which, N)]
        want = None
        for tree in order:
            if design == "cluster" and N > libs[(tree, False)].pasnl_fps_cluster_max_n():
                print(f"{tree[0]}: fps cluster B1 N{N} -> {npoint}: past this checkout's "
                      f"cluster design")
                continue
            plain_idx, ms = launch(libs[(tree, False)], design, npoint, x)
            probe_idx, probe_ms, us, meta = split(libs[(tree, True)], design, npoint, x)
            want = plain_idx if want is None else want
            for what, got in (("shipped", plain_idx), ("probe", probe_idx)):
                if not torch.equal(got, want):
                    differ.append(f"{tree[0]} {what} {design} N{N} -> {npoint}")
            r = results[tree[0]].setdefault(f"{design} B1 {N}->{npoint}", {
                "us_a_pick": [], "probe_us_a_pick": [], "phases_us": []})
            picks = npoint - 1
            r["us_a_pick"].append(ms * 1e3 / picks)
            r["probe_us_a_pick"].append(probe_ms * 1e3 / picks)
            r["phases_us"].append(us)
            print(f"{tree[0]}: fps {design} B1 N{N} -> {npoint}: {ms * 1e3 / picks:.3f} us a pick "
                  f"({ms:.3f} ms), probe build {probe_ms * 1e3 / picks:.3f}: "
                  + ", ".join(f"{ph} {v:.3f}" for ph, v in us.items())
                  + f" us a pick (sum {sum(us.values()):.3f}; {meta['blocks']} blocks at "
                  f"{meta['ghz']:.3f} GHz)  [{card}]")
    for tree_results in results.values():
        for r in tree_results.values():
            r["us_a_pick"] = statistics.median(r["us_a_pick"])
            r["probe_us_a_pick"] = statistics.median(r["probe_us_a_pick"])
            r["phases_us"] = {ph: statistics.median(u[ph] for u in r["phases_us"]) for ph in PHASES}
    if differ:
        print("indices differ from the first checkout's shipped build: " + "; ".join(differ))
    else:
        print("every launch's indices equal the first checkout's shipped build's")
    print(json.dumps({"card": card, "results": results, "differ": differ}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
