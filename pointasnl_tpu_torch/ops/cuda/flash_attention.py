"""Flash attention on the card: the wrapper of ``csrc/flash_attention.cu``.

Replaces ``pointasnl_tpu/ops/pallas/flash_attention.py`` (``_flash_fwd_kernel``
and ``_flash_bwd_kernel``). The plain versions it is held against are
``ops.flash_attention.flash_forward_reference`` and
``flash_backward_reference``. One forward call launches the forward kernel
and, where the library splits a query tile's keys into ranges, the kernel
that merges the ranges in order; it counts as one launch of the
forward. One backward call launches delta's kernel, then the backward kernel
(dQ, dK and dV) and, where a query tile's keys are split, the fixed-order sum
of the partial dQ; it counts as one launch of the backward.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pointasnl_tpu_torch.ops.cuda import _build

fwd_launches = 0  # forward launches made by this process (its one or two kernels together)
bwd_launches = 0  # backward launches (its two or three kernels together)


def _check(name: str, t: torch.Tensor, shape: tuple) -> torch.Tensor:
    if not t.is_cuda or t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"flash attention kernel takes {name} as a float32 CUDA tensor of "
                         f"shape {shape}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    return t.detach().contiguous()


def _operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """((B, M, N, C, D), q, k, v contiguous), or raise on what the kernels
    do not take."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash attention kernel takes q (B, M, C), k (B, N, C), v (B, N, D)")
    B, M, C = q.shape
    N, D = k.shape[1], v.shape[-1]
    q, k, v = _check("q", q, (B, M, C)), _check("k", k, (B, N, C)), _check("v", v, (B, N, D))
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash attention kernel: q, k and v lie on different devices")
    width = _build.library().pasnl_flash_max_width()
    if N < 1 or not 1 <= C <= width or not 1 <= D <= width:
        raise ValueError(f"flash attention kernel takes N >= 1 and 1 <= C, D <= {width}, "
                         f"got N={N}, C={C}, D={D}")
    return (B, M, N, C, D), q, k, v


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel: (o (B, M, D), lse (B, M) float32)."""
    global fwd_launches
    (B, M, N, C, D), q, k, v = _operands(q, k, v)
    o = torch.empty((B, M, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, M), dtype=torch.float32, device=q.device)
    if B == 0 or M == 0:
        return o, lse
    lib = _build.library()
    scratch = lib.pasnl_flash_fwd_scratch(B, M, N, C, D)  # the key ranges' parts, merged in order
    part = torch.empty(scratch, dtype=torch.float32, device=q.device) if scratch else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.pasnl_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                         lse.data_ptr(), part.data_ptr() if scratch else None,
                                         B, M, N, C, D, scale, stream),
                     "flash attention forward kernel")
    fwd_launches += 1
    return o, lse


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                   lse: torch.Tensor, do: torch.Tensor,
                   scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward kernels: (dq (B, M, C), dk (B, N, C), dv (B, N, D))."""
    global bwd_launches
    (B, M, N, C, D), q, k, v = _operands(q, k, v)
    o, lse, do = _check("o", o, (B, M, D)), _check("lse", lse, (B, M)), _check("do", do, (B, M, D))
    dq = torch.empty((B, M, C), dtype=torch.float32, device=q.device)
    if B == 0 or M == 0:
        return dq, torch.zeros_like(k), torch.zeros_like(v)
    dk = torch.empty((B, N, C), dtype=torch.float32, device=q.device)
    dv = torch.empty((B, N, D), dtype=torch.float32, device=q.device)
    delta = torch.empty((B, M), dtype=torch.float32, device=q.device)
    lib = _build.library()
    scratch = lib.pasnl_flash_bwd_scratch(B, M, N, C, D)  # the splits' partial dQ
    dq_part = torch.empty(scratch, dtype=torch.float32, device=q.device) if scratch else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.pasnl_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                         lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
                                         dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                                         dq_part.data_ptr() if scratch else None, B, M, N, C, D,
                                         scale, stream),
                     "flash attention backward kernels")
    bwd_launches += 1
    return dq, dk, dv
