"""Base layers: the PyTorch counterparts of ``pointasnl_tpu/nn/layers.py``.

- Every convolution of the reference is pointwise, so ``PointConv`` is a dense
  layer over the last axis (+ BatchNorm + activation), like the JAX package.
- ``BatchNorm`` is the reference's, not ``torch.nn.BatchNorm1d``: eps 1e-3,
  the EMA momentum is passed at call time with
  ``moving = moving * m + batch * (1 - m)``, and training uses the biased batch
  variance ``mean(x^2) - mean(x)^2``.
- ``PointConv`` and ``FullyConnected`` drop the dense bias when BN follows,
  as the JAX package does (layers.py:133-138).
- Parameters and buffers carry the flax names (``conv``/``dense``, ``bn``,
  ``kernel`` -> ``weight`` stored transposed as (out, in), ``scale``, ``bias``,
  ``mean``, ``var``), so a flax variable tree converts mechanically
  (``utils.convert``).
- Modules take their input width explicitly and initialise from an explicit
  ``torch.Generator``: Xavier-uniform kernels, zero biases, BN 1/0/0/1.
- Train or eval mode is the module's ``training`` flag (``.train()`` /
  ``.eval()``), where flax passes ``training=`` to each call.
- ``Dense`` computes in the dtype of ``nn.precision``, as the JAX package
  passes it to flax's ``Dense(dtype=...)``: in bfloat16 the input and the
  float32 weight are cast to bfloat16 and the output is bfloat16.
- ``Dropout`` draws its mask from the ``torch.Generator`` the caller passes,
  as flax draws it from the ``dropout`` key, never from a global RNG.
- ``MLP`` is a stack of ``PointConv``s ``conv{i}`` (no model calls it; it is
  kept for the JAX package's API).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from pointasnl_tpu_torch.nn import precision

Activation = Optional[Callable[[torch.Tensor], torch.Tensor]]


class Dense(nn.Module):
    """x @ weight.T (+ bias) with a Xavier-uniform weight, like flax's Dense.

    It computes in the compute dtype of ``nn.precision``, else in the
    promotion of the input's and the weight's dtypes (flax's
    ``dtype=None``); the parameters keep their own dtype."""

    def __init__(self, in_features: int, features: int, *, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        limit = math.sqrt(6.0 / (in_features + features))
        weight = torch.empty(features, in_features).uniform_(-limit, limit, generator=generator)
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = (precision.current_compute_dtype()
                 or torch.promote_types(x.dtype, self.weight.dtype))
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype), bias)


class BatchNorm(nn.Module):
    """Batch normalisation over the last axis with a call-time EMA momentum."""

    def __init__(self, features: int, *, epsilon: float = 1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, momentum=0.9) -> torch.Tensor:
        if self.training:
            reduce_dims = tuple(range(x.dim() - 1))
            # At least float32 moments, as in the JAX package: a float64
            # input keeps float64.
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = xf.mean(dim=reduce_dims)
            var = xf.square().mean(dim=reduce_dims) - mean.square()
            with torch.no_grad():
                m = torch.as_tensor(momentum, dtype=torch.float32, device=x.device)
                self.mean.copy_(self.mean * m + mean * (1.0 - m))
                self.var.copy_(self.var * m + var * (1.0 - m))
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.scale + self.bias).to(x.dtype)


class Dropout(nn.Module):
    """Dropout with the reference's keep_prob convention (tf_util.py:594),
    as flax's: in train mode each element is kept with probability
    keep_prob (a uniform draw below it) and scaled by 1 / keep_prob, else 0.

    The mask is drawn on the device of `generator`, the only source of its
    randomness, then moved to x's: the same generator state gives the same
    mask on any device. Train mode with keep_prob < 1 needs a generator, as
    flax needs a ``dropout`` key; eval mode, or keep_prob 1, returns x."""

    def __init__(self, keep_prob: float = 0.5):
        super().__init__()
        self.keep_prob = keep_prob

    def keep_mask(self, shape, generator: torch.Generator) -> torch.Tensor:
        """Bernoulli(keep_prob) draws of `shape`, as a bool tensor on the
        generator's device."""
        u = torch.rand(shape, generator=generator, device=generator.device)
        return u < self.keep_prob

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        rate = 1.0 - self.keep_prob
        if not self.training or rate == 0.0:
            return x
        if generator is None:
            raise ValueError("Dropout in train mode draws its mask from a generator: pass one "
                             "(the train step takes it as dropout_rng)")
        keep = self.keep_mask(x.shape, generator).to(x.device)
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class PointConv(nn.Module):
    """Pointwise (1x1) convolution: Dense [+ BN] [+ activation].

    The dense bias is dropped when ``bn`` is set (BN's mean subtraction
    cancels it), as in the JAX package.
    """

    def __init__(self, in_features: int, features: int, *, bn: bool = True,
                 activation: Activation = F.relu,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.conv = Dense(in_features, features, use_bias=not bn, generator=generator)
        self.bn = BatchNorm(features) if bn else None

    def forward(self, x: torch.Tensor, bn_momentum=0.9) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x, momentum=bn_momentum)
        if self.activation is not None:
            x = self.activation(x)
        return x


class FullyConnected(nn.Module):
    """Dense [+ BN] [+ activation], tf_util.fully_connected (:327).

    Like PointConv, the bias is dropped when BN follows.
    """

    def __init__(self, in_features: int, features: int, *, bn: bool = False,
                 activation: Activation = F.relu,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.dense = Dense(in_features, features, use_bias=not bn, generator=generator)
        self.bn = BatchNorm(features) if bn else None

    def forward(self, x: torch.Tensor, bn_momentum=0.9) -> torch.Tensor:
        x = self.dense(x)
        if self.bn is not None:
            x = self.bn(x, momentum=bn_momentum)
        if self.activation is not None:
            x = self.activation(x)
        return x


class MLP(nn.Module):
    """A stack of PointConvs ``conv{i}`` (a per-point MLP) of widths
    `features`; `last_activation` and `last_bn` set the last one's, as the
    JAX package's ``MLP`` (layers.py:267-289). Its ``dtype`` has no
    counterpart here: ``nn.precision`` sets the compute dtype of every
    Dense."""

    def __init__(self, in_features: int, features, *, bn: bool = True,
                 activation: Activation = F.relu, last_activation: Activation = F.relu,
                 last_bn: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        width = in_features
        for i, f in enumerate(features):
            last = i == len(features) - 1
            self.add_module(f"conv{i}", PointConv(
                width, f, bn=last_bn if last else bn,
                activation=last_activation if last else activation, generator=generator))
            width = f

    def forward(self, x: torch.Tensor, bn_momentum=0.9) -> torch.Tensor:
        for conv in self.children():
            x = conv(x, bn_momentum=bn_momentum)
        return x
