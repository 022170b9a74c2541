"""The deterministic backward of the point gathers on the card: the segments
around ``csrc/gather_backward.cu``, the kernel's wrapper and its plain version.

Replaces ``pointasnl_tpu/ops/scatter.py:onehot_scatter_add`` (with
``gather_point_mxu`` and ``group_point_mxu``): the JAX package's gather VJP
without atomics, there as one-hot matmuls on the TPU's matrix unit. Here it
is a segmented sum: ``segments`` sorts the gathered rows stably by the row
they came from, in plain tensor ops on the device (``plan`` sorts each index
tensor once, for every gather that shares it), and the kernel sums each
segment in ascending row order from 0.0, as CPU float32 ``index_add_`` does,
so the gradient is the same to the bit from run to run and against the CPU.

``gather_backward_reference`` is the plain version the kernel is held
against: the same sums in the same order, one segment position at a time.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pointasnl_tpu_torch.ops.cuda import _build

MAX_ROWS = 2 ** 31 - 1  # gathered rows and output rows index int32 segments

launches = 0  # kernel launches made by this process


def segments(idx: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, offsets) of the gather backward for indices idx (B, R) into n
    rows: order (B * R,) int32 holds the flat gathered rows b * R + r sorted
    stably by their output row b * n + idx[b, r]; output row i sums
    order[offsets[i]:offsets[i + 1]], offsets (B * n + 1,) int32."""
    B, R = idx.shape
    if B * R > MAX_ROWS or B * n >= MAX_ROWS:
        raise ValueError(f"gather backward takes at most {MAX_ROWS} rows, got B={B}, R={R}, n={n}")
    base = torch.arange(0, B * n, n, device=idx.device, dtype=torch.int32)[:, None]
    key, order = torch.sort((idx.to(torch.int32) + base).reshape(-1), stable=True)
    rows = torch.arange(B * n + 1, device=idx.device, dtype=torch.int32)
    return order.to(torch.int32), torch.searchsorted(key, rows, out_int32=True)


def plan(idx: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """segments(idx, n), sorted once for each index tensor: the result is
    kept on the tensor idx views (its ``_base``, or idx itself), keyed on
    the view and the tensor's version, so the gathers that share indices (a
    grouping's xyz and features, a sampling's points and features, each a
    reshape of one kNN or FPS output) sort them once, and an index tensor
    changed in place is sorted again. The plans go with the tensor."""
    base = idx if idx._base is None else idx._base
    key = (n, tuple(idx.shape), idx.stride(), idx.storage_offset(), base._version)
    plans = base.__dict__.setdefault("_gather_backward_plans", {})
    if key not in plans:
        for stale in [k for k in plans if k[-1] != base._version]:
            del plans[stale]
        plans[key] = segments(idx, n)
    return plans[key]


def gather_backward_reference(dout: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """dPoints (B, n, C) of a gather of idx (B, R) from (B, n, C) points, for
    the upstream gradient dout (B, R, C), on any device: each output row
    adds its segment's rows in ascending r, starting from 0."""
    B, R, C = dout.shape
    order, offsets = segments(idx, n)
    order, offsets = order.long(), offsets.long()
    counts = offsets[1:] - offsets[:-1]
    rows_in = dout.reshape(B * R, C)
    out = dout.new_zeros(B * n, C)
    for r in range(int(counts.max()) if counts.numel() else 0):
        rows = torch.nonzero(counts > r).squeeze(1)  # each output row at most once
        out[rows] = out[rows] + rows_in[order[offsets[rows] + r]]
    return out.view(B, n, C)


def gather_backward(dout: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """The kernel: dPoints (B, n, C) float32 of a gather of idx (B, R) from
    (B, n, C) points, for the upstream gradient dout (B, R, C) float32."""
    global launches
    if not dout.is_cuda or dout.dtype != torch.float32 or dout.dim() != 3:
        raise ValueError(f"gather backward kernel takes dout as a (B, R, C) float32 CUDA "
                         f"tensor, got {tuple(dout.shape)} {dout.dtype} on {dout.device}")
    B, R, C = dout.shape
    if tuple(idx.shape) != (B, R) or idx.device != dout.device or idx.is_floating_point():
        raise ValueError(f"gather backward kernel takes idx as a ({B}, {R}) integer tensor on "
                         f"{dout.device}, got {tuple(idx.shape)} {idx.dtype} on {idx.device}")
    out = torch.empty((B, n, C), dtype=torch.float32, device=dout.device)
    if B == 0 or n == 0 or C == 0:
        return out
    if R == 0:
        return out.zero_()
    order, offsets = plan(idx, n)
    dout = dout.detach().contiguous()
    lib = _build.library()
    with torch.cuda.device(dout.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.pasnl_gather_backward(dout.data_ptr(), order.data_ptr(),
                                               offsets.data_ptr(), out.data_ptr(), B * n, C,
                                               stream), "gather backward kernel")
    launches += 1
    return out
