"""Name -> model-class registry, keyed by the JAX package's names, and the
placement every model constructor shares."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

MODEL_REGISTRY: Dict[str, type] = {}


def register_model(name: str):
    def deco(cls):
        MODEL_REGISTRY[name] = cls
        return cls

    return deco


def get_model_class(name: str):
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}"
        ) from None


def place(model: nn.Module, device) -> None:
    """Move a freshly initialised model to `device`. A model runs on the card
    unless the caller asks for the CPU: a CUDA device with no card raises,
    and the model never stays on the CPU in its stead."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{type(model).__name__} is built on {device}, but no CUDA card is "
                           f"available; pass device='cpu' to run on the CPU")
    model.to(device)
