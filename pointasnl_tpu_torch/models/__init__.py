"""Model zoo, selected by the JAX package's names ('pointasnl_cls' so far)."""

from pointasnl_tpu_torch.models.cls import PointASNLCls
from pointasnl_tpu_torch.models.registry import MODEL_REGISTRY, get_model_class, register_model

__all__ = [
    "MODEL_REGISTRY",
    "PointASNLCls",
    "get_model_class",
    "register_model",
]
