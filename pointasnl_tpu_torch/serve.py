"""Serving: the canonical inference forward of a port model.

The counterpart of ``pointasnl_tpu/serve.py:make_inference_fn``: eval mode
(BN uses its running statistics, no dropout) under ``torch.inference_mode()``.
Exporting an artifact (``jax.export`` in the JAX package) is not ported yet.

Usage:
    model = PointASNLCls(40, adaptive_sample=True, device="cuda")
    model.load_state_dict(...)
    infer = make_inference_fn(model)
    logits = infer(points)  # points (B, N, 3) float32 on the model's device
"""

from __future__ import annotations

from typing import Callable

import torch


def make_inference_fn(model: torch.nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """Put `model` in eval mode and return points -> logits, each call in
    eval mode, as JAX passes ``training=False`` to each call: a train step
    between two requests puts the model in train mode, and the next request
    puts it back."""
    model.eval()

    def infer(points: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            logits, _ = model(points)
        return logits

    return infer
