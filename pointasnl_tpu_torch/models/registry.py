"""Name -> model-class registry, keyed by the JAX package's model names."""

from __future__ import annotations

from typing import Dict

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
