"""The deterministic backward of the point gathers on the card: the wrappers
of ``csrc/gather_backward.cu`` (the plan and the sum) and their plain
versions.

Replaces ``pointasnl_tpu/ops/scatter.py:onehot_scatter_add`` (with
``gather_point_mxu`` and ``group_point_mxu``): the JAX package's gather VJP
without atomics, there as one-hot matmuls on the TPU's matrix unit. Here it
is a segmented sum: the plan sorts the gathered rows stably by the row they
came from (``plan_kernel``, a counting sort on the card, made once for each
index tensor by ``plan``, for every gather that shares it), and the sum adds
each segment in ascending row order from 0.0, as CPU float32 ``index_add_``
does, so the gradient is the same to the bit from run to run and against the
CPU.

The sum takes float32 or bfloat16 cotangents and returns their dtype. A
bfloat16 one is added in float32, in the same order, and rounded to
bfloat16 once: float32 ``index_add_`` of the widened rows, rounded, to the
bit.

``segments`` is the plan's plain version (a stable sort, for CPU tensors and
the tests), ``emulate`` runs the plan kernel's algorithm in plain PyTorch for
the CPU tests, and ``gather_backward_reference`` is the sum's plain version:
the same sums in the same order, one segment position at a time.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pointasnl_tpu_torch.ops.cuda import _build

MAX_ROWS = 2 ** 31 - 1  # gathered rows and output rows index int32 segments
# The plan kernel's walk in order takes at most PLAN_LONG_LIST segments, those
# longer than long_len(R) rows (csrc/gather_backward.cu: kLongList, kLongMin).
PLAN_LONG_LIST, PLAN_LONG_MIN = 256, 512
PLAN_THREADS = 1024  # the plan's block, one a cloud: its walk takes 1024 rows at a time

launches = 0  # float32 sum kernel launches made by this process
bf16_launches = 0  # bfloat16 sum kernel launches made by this process
plan_launches = 0  # plans made on the card by this process (two kernel launches each)


def _check_rows(B: int, R: int, n: int) -> None:
    if B * R > MAX_ROWS or B * n >= MAX_ROWS:
        raise ValueError(f"gather backward takes at most {MAX_ROWS} rows, got B={B}, R={R}, n={n}")


def segments(idx: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, offsets) of the gather backward for indices idx (B, R) into n
    rows: order (B * R,) int32 holds the flat gathered rows b * R + r sorted
    stably by their output row b * n + idx[b, r]; output row i sums
    order[offsets[i]:offsets[i + 1]], offsets (B * n + 1,) int32. The plan
    kernel's plain version."""
    B, R = idx.shape
    _check_rows(B, R, n)
    base = torch.arange(0, B * n, n, device=idx.device, dtype=torch.int32)[:, None]
    key, order = torch.sort((idx.to(torch.int32) + base).reshape(-1), stable=True)
    rows = torch.arange(B * n + 1, device=idx.device, dtype=torch.int32)
    return order.to(torch.int32), torch.searchsorted(key, rows, out_int32=True)


def long_len(R: int) -> int:
    """Rows of a segment the plan kernel ranks in place; a longer one takes
    its walk in order. At least R / PLAN_LONG_LIST, so at most that many
    segments are longer."""
    return max(-(-R // PLAN_LONG_LIST), PLAN_LONG_MIN)


def emulate(idx: torch.Tensor, n: int,
            slots: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plan kernel's algorithm in plain PyTorch: (order, offsets) as
    ``segments`` gives them. For tests.

    Each cloud: count each output row's hits, take their exclusive scan (the
    segments' starts), drop each row into its segment at the next slot of
    the segment's cursor in the order the rows arrive (``slots[b]``, a
    permutation of the R rows standing in for the order in which the
    kernel's atomics hand out slots; a seeded shuffle by default), then put
    each segment in ascending r: a segment of at most ``long_len(R)`` rows by
    ranking each row against the others of its segment, a longer one by
    walking the cloud's rows in order, PLAN_THREADS at a time, a hit's place
    being the hits of earlier warps and of its warp's lower lanes.
    """
    B, R = idx.shape
    _check_rows(B, R, n)
    order = torch.empty(B * R, dtype=torch.int64)
    offsets = torch.empty(B * n + 1, dtype=torch.int64)
    offsets[-1] = B * R
    longest = long_len(R)
    for b in range(B):
        key = idx[b].detach().cpu().long().clamp(0, max(n - 1, 0))
        counts = torch.bincount(key, minlength=n)
        cursor = (torch.cumsum(counts, 0) - counts).tolist()
        arrive = (torch.randperm(R, generator=torch.Generator().manual_seed(b))
                  if slots is None else slots[b])
        keys, fill = key.tolist(), [0] * R
        for i in arrive.tolist():
            fill[cursor[keys[i]]] = i
            cursor[keys[i]] += 1
        end = torch.tensor(cursor, dtype=torch.int64)  # segment k is [end[k - 1], end[k])
        start = torch.cat([end.new_zeros(1), end[:-1]])
        offsets[b * n:(b + 1) * n] = b * R + start
        rows = order[b * R:(b + 1) * R]
        for v in fill:
            s, e = int(start[keys[v]]), int(end[keys[v]])
            if e - s <= longest:
                rows[s + sum(u < v for u in fill[s:e])] = b * R + v
        for k in torch.nonzero(counts > longest).flatten().tolist():
            done, s = 0, int(start[k])
            for i0 in range(0, R, PLAN_THREADS):
                if done == int(counts[k]):
                    break
                hit = torch.zeros(PLAN_THREADS, dtype=torch.int64)
                hit[:min(PLAN_THREADS, R - i0)] = key[i0:i0 + PLAN_THREADS] == k
                warps = hit.view(-1, 32)
                before = torch.cumsum(warps.sum(1), 0) - warps.sum(1)
                place = done + before[:, None] + torch.cumsum(warps, 1) - warps
                lanes = torch.nonzero(hit).flatten()
                rows[s + place.flatten()[lanes]] = b * R + i0 + lanes
                done += int(hit.sum())
    return order.to(torch.int32), offsets.to(torch.int32)


def plan_kernel(idx: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plan kernels: segments(idx, n) of an integer CUDA tensor idx
    (B, R), made on the card by two launches (the count and fill, one block a
    cloud, then the ranking, a thread a row), their outputs and scratch in
    one allocation."""
    global plan_launches
    if not idx.is_cuda or idx.is_floating_point() or idx.dim() != 2:
        raise ValueError(f"gather plan kernel takes idx as a (B, R) integer CUDA tensor, got "
                         f"{tuple(idx.shape)} {idx.dtype} on {idx.device}")
    B, R = idx.shape
    _check_rows(B, R, n)
    lib = _build.library()
    scratch = lib.pasnl_gather_plan_scratch(B, R, n) if B and R and n else 0
    buf = torch.empty(B * R + B * n + 1 + scratch, dtype=torch.int32, device=idx.device)
    order, offsets = buf[:B * R], buf[B * R:B * R + B * n + 1]
    if not scratch:  # no row or no output row: every segment is empty
        offsets.zero_()
        return order, offsets
    idx = idx.to(torch.int32).contiguous()
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.pasnl_gather_plan(idx.data_ptr(), order.data_ptr(), offsets.data_ptr(),
                                           buf[B * R + B * n + 1:].data_ptr(), B, R, n, stream),
                     "gather plan kernel")
    plan_launches += 1
    return order, offsets


def plan(idx: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """segments(idx, n), made once for each index tensor, by the plan kernel
    on a CUDA tensor and by ``segments`` on a CPU one: the result is
    kept on the tensor idx views (its ``_base``, or idx itself), keyed on
    the view and the tensor's version, so the gathers that share indices (a
    grouping's xyz and features, a sampling's points and features, each a
    reshape of one kNN or FPS output) plan them once, and an index tensor
    changed in place is planned again. The plans go with the tensor."""
    base = idx if idx._base is None else idx._base
    key = (n, tuple(idx.shape), idx.stride(), idx.storage_offset(), base._version)
    plans = base.__dict__.setdefault("_gather_backward_plans", {})
    if key not in plans:
        for stale in [k for k in plans if k[-1] != base._version]:
            del plans[stale]
        plans[key] = plan_kernel(idx, n) if idx.is_cuda else segments(idx, n)
    return plans[key]


def gather_backward_reference(dout: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """dPoints (B, n, C) of a gather of idx (B, R) from (B, n, C) points, for
    the upstream gradient dout (B, R, C), on any device: each output row
    adds its segment's rows in ascending r, starting from 0, in dout's
    dtype, or for bfloat16 in float32 and rounded to bfloat16 once."""
    B, R, C = dout.shape
    order, offsets = segments(idx, n)
    order, offsets = order.long(), offsets.long()
    counts = offsets[1:] - offsets[:-1]
    acc = torch.float32 if dout.dtype == torch.bfloat16 else dout.dtype
    rows_in = dout.reshape(B * R, C).to(acc)
    out = rows_in.new_zeros(B * n, C)
    for r in range(int(counts.max()) if counts.numel() else 0):
        rows = torch.nonzero(counts > r).squeeze(1)  # each output row at most once
        out[rows] = out[rows] + rows_in[order[offsets[rows] + r]]
    return out.to(dout.dtype).view(B, n, C)


# The sum kernel's entry point for each dtype it takes.
_ENTRY = {torch.float32: "pasnl_gather_backward", torch.bfloat16: "pasnl_gather_backward_bf16"}


def gather_backward(dout: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """The sum kernel: dPoints (B, n, C) of a gather of idx (B, R) from
    (B, n, C) points, for the upstream gradient dout (B, R, C), float32 or
    bfloat16, in dout's dtype."""
    global launches, bf16_launches
    if not dout.is_cuda or dout.dtype not in _ENTRY or dout.dim() != 3:
        raise ValueError(f"gather backward kernel takes dout as a (B, R, C) float32 or bfloat16 "
                         f"CUDA tensor, got {tuple(dout.shape)} {dout.dtype} on {dout.device}")
    B, R, C = dout.shape
    if tuple(idx.shape) != (B, R) or idx.device != dout.device or idx.is_floating_point():
        raise ValueError(f"gather backward kernel takes idx as a ({B}, {R}) integer tensor on "
                         f"{dout.device}, got {tuple(idx.shape)} {idx.dtype} on {idx.device}")
    out = torch.empty((B, n, C), dtype=dout.dtype, device=dout.device)
    if B == 0 or n == 0 or C == 0:
        return out
    if R == 0:
        return out.zero_()
    order, offsets = plan(idx, n)
    dout = dout.detach().contiguous()
    lib = _build.library()
    with torch.cuda.device(dout.device):
        stream = torch.cuda.current_stream().cuda_stream
        entry = getattr(lib, _ENTRY[dout.dtype])
        _build.check(entry(dout.data_ptr(), order.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                           B * n, C, stream), "gather backward kernel")
    if dout.dtype == torch.float32:
        launches += 1
    else:
        bf16_launches += 1
    return out
