"""Blockwise non-local attention: softmax(q k^T / sqrt(C)) v with K/V streamed
in blocks and an online softmax, the counterpart of
``pointasnl_tpu/nn/blockwise.py:blockwise_attention``.

The (M, N) attention map of the non-local cell is the model's only quadratic
object: at a whole scene of 131072 points, level 1 alone would hold a
16384 x 131072 map (8.6 GB in float32). Streaming K/V in blocks keeps
O(M * block) memory and gives the dense softmax's result up to rounding.
Plain PyTorch, as the JAX package computes it with einsums outside any
kernel. The ring (multi-device) version is not ported.
"""

from __future__ import annotations

import torch


def attention_scale(channels: int) -> float:
    """sqrt(channels) rounded to float32, the JAX package's constant
    (``jnp.sqrt(jnp.float32(C))``), whatever the dtype of the scores."""
    return torch.tensor(channels, dtype=torch.float32).sqrt().item()


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """t in the promotion of its dtype with float32: a bfloat16 tensor
    becomes float32, a float32 or float64 one stays as it is."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def scale_scores(scores: torch.Tensor, channels: int) -> torch.Tensor:
    """scores / sqrt(channels) as the JAX package computes it: divided by a
    strongly typed float32 scalar, so bfloat16 scores promote to float32
    (and the softmax after it runs in float32), float64 ones stay float64.
    PyTorch would keep bfloat16 against a 0-d float32 tensor or a Python
    float, so the scores are promoted first."""
    return at_least_f32(scores) / attention_scale(channels)


def promoted_einsum(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.einsum on the promotion of a's and b's dtypes, as jnp.einsum
    promotes (float32 attention weights against bfloat16 values give
    float32); torch.einsum takes one dtype only."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(equation, a.to(dtype), b.to(dtype))


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        block_size: int = 2048, scaled: bool = True) -> torch.Tensor:
    """softmax(q k^T / sqrt(C)) v over K/V blocks of `block_size`.

    q (B, M, C), k (B, N, C), v (B, N, D) -> (B, M, D). With N <= block_size
    it is the dense softmax. A ragged last block is masked with -1e30 in the
    scores' dtype, so it adds exp(...) = 0 without moving the running max.
    The scores are at least float32, as JAX's, whose scale is a float32
    scalar: bfloat16 q and k give float32 scores, softmax and output.
    """
    N, C = k.shape[1], q.shape[-1]
    # JAX multiplies by 1 / sqrt(C) in float32; the float64 quotient here
    # rounds to the same float32 when it meets the float32 scores.
    scale = 1.0 / attention_scale(C) if scaled else 1.0
    if N <= block_size:
        attn = torch.softmax(at_least_f32(torch.einsum("bmc,bnc->bmn", q, k)) * scale, dim=-1)
        return promoted_einsum("bmn,bnd->bmd", attn, v)

    B, M = q.shape[:2]
    dtype = torch.promote_types(q.dtype, torch.float32)
    m = q.new_full((B, M, 1), float("-inf"), dtype=dtype)
    l = q.new_zeros((B, M, 1), dtype=dtype)
    o = q.new_zeros((B, M, v.shape[-1]), dtype=dtype)
    for s0 in range(0, N, block_size):
        k_blk, v_blk = k[:, s0:s0 + block_size], v[:, s0:s0 + block_size]
        scores = at_least_f32(torch.einsum("bmc,bnc->bmn", q, k_blk)) * scale
        if k_blk.shape[1] < block_size:  # the ragged tail, masked as if zero-padded
            pad = block_size - k_blk.shape[1]
            scores = torch.cat([scores, scores.new_full((B, M, pad), -1e30)], dim=-1)
            v_blk = torch.cat([v_blk, v_blk.new_zeros((B, pad, v_blk.shape[-1]))], dim=1)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        p = torch.exp(scores - m_new)
        correction = torch.exp(m - m_new)
        l = l * correction + p.sum(dim=-1, keepdim=True)
        o = o * correction + promoted_einsum("bmn,bnd->bmd", p, v_blk)
        m = m_new
    return o / l
