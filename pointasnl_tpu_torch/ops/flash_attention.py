"""Flash attention of the non-local cell: softmax(q k^T * scale) v, fused, with
a hand-written backward. The counterpart of
``pointasnl_tpu/ops/pallas/flash_attention.py``.

  - ``flash_forward_reference`` and ``flash_backward_reference`` are the plain
    PyTorch versions of the two TPU kernels: an online softmax over KV chunks
    of 1024 keys that keeps each row's logsumexp, and a backward that
    recomputes p = exp(s - lse) from it. They compute in float32 whatever the
    input dtype and return the input dtype, as the TPU kernels do (their dots
    ask for float32 results and their statistics are float32), so a float64
    model still gets float32-precision attention here, as in JAX. In
    bfloat16 the backward also rounds delta and each query tile's dK and dV
    to bfloat16, where the TPU kernel's bfloat16 refs round them.
  - ``FlashAttention`` is the autograd function around them; its forward
    keeps q, k, v, o and the float32 lse (B, M) for the backward.
  - Routing goes by device, as ``ops.dispatch`` does: a CPU tensor takes the
    plain versions, a CUDA tensor the kernels of ``ops.cuda.flash_attention``
    (float32 or bfloat16, the dtype's own kernels), or the call raises. There
    is no switch and no fallback.

The scale is JAX's flash scale, float32(1 / sqrt(C)), and it multiplies the
scores; the dense cell divides by float32(sqrt(C)) instead. The two can differ
in the last bit (``flash_scale``).

Not ported: the (B, M, 128) lane-broadcast statistics and the VMEM envelope
(``fits_vmem``): the CUDA kernels stream K/V from device memory at any N.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from pointasnl_tpu_torch.ops.cuda import flash_attention as _cuda_flash
from pointasnl_tpu_torch.ops.dispatch import _on_cuda

CHUNK_N = 1024  # the TPU kernel's KV chunk (flash_attention.py:CHUNK_N)
TILE_M = 128  # its query tile (flash_attention.py:TILE_M): bfloat16 dK, dV round a tile


def flash_scale(channels: int, scaled: bool = True) -> float:
    """The flash path's score multiplier: 1 / sqrt(C) rounded to float32 (1.0
    unscaled)."""
    if not scaled:
        return 1.0
    return torch.tensor(1.0 / math.sqrt(channels), dtype=torch.float32).item()


def flash_forward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o (B, M, D) in q's dtype, lse (B, M) float32), in float32 inside.

    A ragged last chunk holds fewer keys: they add exactly what the TPU
    kernel's masked (-3e38) columns add, 0, and leave the running max."""
    dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    B, M, _ = q.shape
    acc = q.new_zeros((B, M, v.shape[-1]))
    m = q.new_full((B, M, 1), float("-inf"))
    l = q.new_zeros((B, M, 1))
    for s0 in range(0, k.shape[1], CHUNK_N):
        kc, vc = k[:, s0:s0 + CHUNK_N], v[:, s0:s0 + CHUNK_N]
        s = torch.einsum("bmc,bnc->bmn", q, kc) * scale
        m2 = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m2)
        p = torch.exp(s - m2)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bmn,bnd->bmd", p, vc)
        m = m2
    return (acc / l).to(dtype), (m + torch.log(l))[..., 0]


def flash_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                             scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in q's dtype, in float32 inside: p = exp(s - lse),
    dS = p * (dO v^T - rowsum(dO * o)) * scale, dQ = dS k, dK = dS^T q,
    dV = p^T dO. bfloat16 inputs round where the TPU kernel rounds
    (``_bf16_backward``)."""
    if q.dtype == torch.bfloat16:
        return _bf16_backward(q, k, v, o, lse, do, scale)
    dtype = q.dtype
    q, k, v, o, do = q.float(), k.float(), v.float(), o.float(), do.float()
    L = lse.float()[..., None]
    delta = (do * o).sum(dim=-1, keepdim=True)
    dq = torch.zeros_like(q)
    dks, dvs = [], []
    for s0 in range(0, k.shape[1], CHUNK_N):
        kc, vc = k[:, s0:s0 + CHUNK_N], v[:, s0:s0 + CHUNK_N]
        p = torch.exp(torch.einsum("bmc,bnc->bmn", q, kc) * scale - L)
        ds = p * (torch.einsum("bmd,bnd->bmn", do, vc) - delta) * scale
        dq = dq + torch.einsum("bmn,bnc->bmc", ds, kc)
        dks.append(torch.einsum("bmn,bmc->bnc", ds, q))
        dvs.append(torch.einsum("bmn,bmd->bnd", p, do))
    return dq.to(dtype), torch.cat(dks, dim=1).to(dtype), torch.cat(dvs, dim=1).to(dtype)


def _bf16_backward(q, k, v, o, lse, do, scale):
    """The backward of bfloat16 q, k, v, o and dO at the TPU kernel's
    rounding points (``_flash_bwd_kernel`` with bfloat16 refs):

      - delta = bf16(sum_f32(bf16(dO * o))): the products rounded to
        bfloat16, summed in float32, the sum rounded to bfloat16;
      - dP = dO v^T and dS = p (dP - delta) scale in float32; dQ summed in
        float32 and rounded once;
      - dK and dV summed in float32 over each tile of TILE_M query rows,
        each tile's sum rounded to bfloat16 and added to the bfloat16 total
        in ascending tile order (the kernel's output blocks are bfloat16,
        revisited by every query tile of a batch).

    Products of two bfloat16 operands are exact in float32; those with a
    float32 operand (p, dS) are float32 products, as jnp.dot promotes."""
    bf16 = torch.bfloat16
    delta = (do * o).float().sum(dim=-1, keepdim=True).to(bf16).float()
    q, k, v, do = q.float(), k.float(), v.float(), do.float()
    L = lse.float()[..., None]
    dq = torch.zeros_like(q)
    dk = torch.zeros(k.shape, dtype=bf16, device=k.device)
    dv = torch.zeros(v.shape, dtype=bf16, device=v.device)
    for m0 in range(0, q.shape[1], TILE_M):
        qt, dot, Lt, dt = (t[:, m0:m0 + TILE_M] for t in (q, do, L, delta))
        dks, dvs = [], []
        for s0 in range(0, k.shape[1], CHUNK_N):
            kc, vc = k[:, s0:s0 + CHUNK_N], v[:, s0:s0 + CHUNK_N]
            p = torch.exp(torch.einsum("bmc,bnc->bmn", qt, kc) * scale - Lt)
            ds = p * (torch.einsum("bmd,bnd->bmn", dot, vc) - dt) * scale
            dq[:, m0:m0 + TILE_M] += torch.einsum("bmn,bnc->bmc", ds, kc)
            dks.append(torch.einsum("bmn,bmc->bnc", ds, qt))
            dvs.append(torch.einsum("bmn,bmd->bnd", p, dot))
        dk = dk + torch.cat(dks, dim=1).to(bf16)  # bfloat16 + bfloat16, rounded
        dv = dv + torch.cat(dvs, dim=1).to(bf16)
    return dq.to(bf16), dk, dv


def _forward(q, k, v, scale):
    if _on_cuda(q, "flash_attention"):
        return _cuda_flash.flash_forward(q, k, v, scale)
    return flash_forward_reference(q, k, v, scale)


def _backward(q, k, v, o, lse, do, scale):
    if _on_cuda(q, "flash_attention"):
        return _cuda_flash.flash_backward(q, k, v, o, lse, do, scale)
    return flash_backward_reference(q, k, v, o, lse, do, scale)


class FlashAttention(torch.autograd.Function):
    """o = softmax(q k^T * scale) v with the flash backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        o, lse = _forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scaled: bool = True) -> torch.Tensor:
    """Fused softmax(q k^T [* 1/sqrt(C)]) v. q (B, M, C), k (B, N, C),
    v (B, N, D) -> (B, M, D)."""
    return FlashAttention.apply(q, k, v, flash_scale(q.shape[-1], scaled))
