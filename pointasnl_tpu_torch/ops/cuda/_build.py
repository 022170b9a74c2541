"""Build the CUDA kernels of ``pointasnl_tpu_torch/csrc`` and load them.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all at once, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``. The build happens at the
first kernel call, never at import, and lands in
``build/pointasnl_tpu_torch/<hash>/`` at the root of the checkout, keyed on a
hash of the flags, the sources and the headers they share (``csrc/*.cuh``),
so a changed source or header builds anew and an unchanged tree loads the
library already built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "pointasnl_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
LINK_FLAGS = [*ARCH, "-shared"]

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build in this process, None if loaded


def _sources():
    """The files compiled, one nvcc each."""
    return sorted(CSRC.glob("*.cu"))


def _inputs():
    """Every file the build reads: the sources and the headers they include."""
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in files:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in ("pasnl_fps", "pasnl_fps_cluster"):
        getattr(lib, name).argtypes = [p, p, i, i, i, p]
        getattr(lib, name).restype = i
    for name in ("pasnl_fps_block_ppt", "pasnl_fps_block_warps"):
        getattr(lib, name).argtypes = [i]
        getattr(lib, name).restype = i
    lib.pasnl_fps_grid.argtypes = [p, p, p, i, i, i, p]
    lib.pasnl_fps_grid.restype = i
    lib.pasnl_knn.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.pasnl_knn.restype = i
    lib.pasnl_ball_query.argtypes = [p, p, p, p, i, i, i, i, f, p]
    lib.pasnl_ball_query.restype = i
    lib.pasnl_knn_spatial.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.pasnl_knn_spatial.restype = i
    lib.pasnl_knn_streaming.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.pasnl_knn_streaming.restype = i
    for name in ("pasnl_flash_fwd", "pasnl_flash_fwd_bf16"):
        getattr(lib, name).argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, p]
        getattr(lib, name).restype = i
    for name in ("pasnl_flash_bwd", "pasnl_flash_bwd_bf16"):
        getattr(lib, name).argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, f, p]
        getattr(lib, name).restype = i
    for name in ("pasnl_flash_fwd_scratch", "pasnl_flash_bwd_scratch"):
        getattr(lib, name).argtypes = [i, i, i, i, i]
        getattr(lib, name).restype = ctypes.c_longlong
    for name in ("pasnl_gather_backward", "pasnl_gather_backward_bf16"):
        getattr(lib, name).argtypes = [p, p, p, p, ctypes.c_longlong, i, p]
        getattr(lib, name).restype = i
    lib.pasnl_gather_plan.argtypes = [p, p, p, p, i, i, i, p]
    lib.pasnl_gather_plan.restype = i
    lib.pasnl_gather_plan_scratch.argtypes = [i, i, i]
    lib.pasnl_gather_plan_scratch.restype = ctypes.c_longlong
    lib.pasnl_gather_plan_launches.argtypes = [i, i, i]
    lib.pasnl_gather_plan_launches.restype = i
    for name in ("pasnl_fps_max_n", "pasnl_fps_cluster_max_n", "pasnl_fps_cluster_slots",
                 "pasnl_fps_grid_max_n", "pasnl_fps_grid_blocks", "pasnl_fps_grid_scratch_bytes",
                 "pasnl_knn_max_n", "pasnl_knn_max_k", "pasnl_knn_streaming_max_n",
                 "pasnl_knn_streaming_max_k", "pasnl_ball_query_max_n",
                 "pasnl_ball_query_max_nsample", "pasnl_knn_spatial_tile", "pasnl_flash_max_width"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.pasnl_error_string.argtypes = [i]
    lib.pasnl_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source tree has none."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        out_dir = BUILD_ROOT / _digest(_inputs())
        so = out_dir / "libpointasnl_kernels.so"
        if not so.exists():
            nvcc = _nvcc()
            out_dir.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            # Build in a private directory, then rename the library into
            # place: a concurrent process sees either no library or a whole one.
            work = tempfile.mkdtemp(dir=out_dir)
            try:
                objs = [os.path.join(work, src.stem + ".o") for src in sources]
                procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True)
                         for src, obj in zip(sources, objs)]
                logs = [proc.communicate()[0] for proc in procs]
                for proc, log in zip(procs, logs):
                    if proc.returncode != 0:
                        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                           f"{' '.join(proc.args)}\n{log}")
                tmp = os.path.join(work, so.name)
                cmd = [nvcc, *LINK_FLAGS, "-o", tmp, *objs]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, so)
            finally:
                shutil.rmtree(work, ignore_errors=True)
            build_seconds = time.perf_counter() - t0
        _lib = _declare(ctypes.CDLL(str(so)))
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().pasnl_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
