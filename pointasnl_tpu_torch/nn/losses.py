"""Loss functions, the PyTorch counterparts of ``pointasnl_tpu/nn/losses.py``.

The one live weight-decay path of the reference is an explicit L2 over the
conv and dense kernels (models/pointasnl_cls.py:58-59); here that is every
``Dense`` weight of the model, found by module type.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pointasnl_tpu_torch import ops
from pointasnl_tpu_torch.nn.layers import Dense


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-log p of each label. The label's log-probability is picked by a
    one-hot product, the same value to the bit as a gather, so that its
    gradient is an elementwise product and not a scatter."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -(logp * F.one_hot(labels.long(), logp.shape[-1]).to(logp.dtype)).sum(dim=-1)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean sparse softmax cross-entropy (models/pointasnl_cls.py:60-61)."""
    return _nll(logits, labels).mean()


def weighted_softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                   weights: torch.Tensor) -> torch.Tensor:
    """Weighted sparse softmax cross-entropy with TF's SUM_BY_NONZERO_WEIGHTS
    reduction (models/pointasnl_sem_seg.py:61): sum(w * ce) divided by
    max(count_nonzero(w), 1)."""
    num_nonzero = (weights != 0).float().sum().clamp_min(1.0)
    return (_nll(logits, labels) * weights).sum() / num_nonzero


def l2_regularization(model: nn.Module) -> torch.Tensor:
    """0.5 * sum(w^2) over every Dense weight (the conv and FC kernels),
    never a BN scale or a bias."""
    sq = [m.weight.float().square().sum() for m in model.modules() if isinstance(m, Dense)]
    return 0.5 * torch.stack(sq).sum()


def classification_loss(logits: torch.Tensor, labels: torch.Tensor, model: nn.Module, *,
                        l1_xyz: Optional[torch.Tensor] = None, uniform_weight: float = 0.0,
                        weights_decay: float = 1e-4
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total classification loss (models/pointasnl_cls.py:55-70). Without a
    uniform weight the repulsion term is not computed and the reference's
    placeholder (the classify loss) stands in its metric."""
    classify = softmax_cross_entropy(logits, labels)
    reg = weights_decay * l2_regularization(model)
    uniform = ops.repulsion_loss(l1_xyz, nsample=20, radius=0.07) if uniform_weight > 0 else classify
    total = classify + uniform_weight * uniform + reg
    return total, {"classify_loss": classify, "uniform_loss": uniform, "reg_loss": reg}


def segmentation_loss(logits: torch.Tensor, labels: torch.Tensor, smpw: torch.Tensor,
                      model: nn.Module, *, l1_xyz: torch.Tensor, uniform_weight: float = 0.01,
                      weights_decay: float = 1e-4, radius: float = 0.07
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total segmentation loss (models/pointasnl_sem_seg.py:53-68). The
    repulsion term on l1_xyz is always computed, whatever its weight."""
    classify = weighted_softmax_cross_entropy(logits, labels, smpw)
    reg = weights_decay * l2_regularization(model)
    uniform = ops.repulsion_loss(l1_xyz, nsample=20, radius=radius)
    total = classify + uniform_weight * uniform + reg
    return total, {"classify_loss": classify, "uniform_loss": uniform, "reg_loss": reg}
