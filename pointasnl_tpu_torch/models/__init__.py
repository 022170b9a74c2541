"""Model zoo, selected by the JAX package's names ('pointasnl_cls',
'pointasnl_sem_seg', 'pointasnl_sem_seg_res')."""

from pointasnl_tpu_torch.models.cls import PointASNLCls
from pointasnl_tpu_torch.models.registry import MODEL_REGISTRY, get_model_class, register_model
from pointasnl_tpu_torch.models.sem_seg import PointASNLSemSeg
from pointasnl_tpu_torch.models.sem_seg_res import PointASNLSemSegRes

__all__ = [
    "MODEL_REGISTRY",
    "PointASNLCls",
    "PointASNLSemSeg",
    "PointASNLSemSegRes",
    "get_model_class",
    "register_model",
]
