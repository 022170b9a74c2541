"""Compute-dtype policy (mixed precision), the counterpart of
``pointasnl_tpu/nn/precision.py``.

One switch sets the compute dtype of every ``Dense`` (and so of every
``PointConv`` and ``FullyConnected``) in the model: in bfloat16 each casts its
input and its weight to bfloat16 and returns bfloat16. Parameters stay
float32 (master weights, updated in float32 by the optimizer); BatchNorm
reduces its moments in at least float32; the losses upcast the logits to
float32. Every other op keeps PyTorch's type promotion, which the modules
steer to JAX's where the two differ (``nn.blockwise.scale_scores``,
``nn.blockwise.promoted_einsum``).

It is not ``torch.autocast``: autocast also casts ops of its own lists
(softmax, reductions, matmuls outside the dense layers) up or down, and
JAX's policy touches nothing but the dense layers.

Usage:

    from pointasnl_tpu_torch.nn import precision
    precision.set_compute_dtype("bfloat16")       # process-wide
    with precision.compute_dtype("bfloat16"):      # or scoped
        metrics = train_step(state, batch, dropout_rng)

JAX reads the policy when it traces a step; the port reads it at every call
of a dense layer, so it must be in effect while the step runs (its forward
pass; the backward follows the forward's dtypes).

Env default: POINTASNL_COMPUTE_DTYPE={float32,bfloat16}.
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch

_NAMES = {
    "float32": torch.float32,
    "f32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}

_state = threading.local()


def _resolve(dtype):
    if dtype is None:
        return None
    if isinstance(dtype, str):
        return _NAMES[dtype]
    return dtype


def set_compute_dtype(dtype) -> None:
    """Set the process-wide compute dtype (None = float32 default)."""
    _state.dtype = _resolve(dtype)


def current_compute_dtype():
    """The active compute dtype, or None (float32 semantics)."""
    explicit = getattr(_state, "dtype", None)
    if explicit is not None:
        return explicit
    env = os.environ.get("POINTASNL_COMPUTE_DTYPE")
    if env and env in _NAMES and _NAMES[env] is not torch.float32:
        return _NAMES[env]
    return None


@contextlib.contextmanager
def compute_dtype(dtype):
    """Scoped compute-dtype override (must cover the call of the step)."""
    prev = getattr(_state, "dtype", None)
    _state.dtype = _resolve(dtype)
    try:
        yield
    finally:
        _state.dtype = prev
