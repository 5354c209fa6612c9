"""Eval-mode primitive layers with the JAX package's numerics.

Each function takes the torch module that holds the parameters (an
``nn.Conv2d``, ``nn.Linear`` or ``nn.BatchNorm*d``) and applies it the way
the JAX package's ``models/layers.py`` does, in particular eval BatchNorm
as ``(x - mean) * (weight * rsqrt(var + eps)) + bias`` — the same
expression and rounding order, not ``F.batch_norm``.  Shared-stem inference
relies on every path rounding alike (models/shared_stem.py).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5

Pair = Union[int, Tuple[int, int]]


def conv2d(x: torch.Tensor, conv: nn.Conv2d, stride: Pair = 1, padding: Pair = 1,
           dilation: Pair = 1) -> torch.Tensor:
    """NCHW conv with the module's OIHW weight (and bias, if any)."""
    return F.conv2d(x, conv.weight, conv.bias, stride=stride, padding=padding,
                    dilation=dilation)


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """[B, in] x weight [out, in] + bias."""
    return x @ lin.weight.T + lin.bias


def batch_norm(x: torch.Tensor, bn: Optional[nn.Module]) -> torch.Tensor:
    """Eval BatchNorm over the channel axis (axis 1 of NCHW or [B, C]);
    identity when ``bn`` is None (the batch-norm-free models)."""
    if bn is None:
        return x
    shape = (1, -1, 1, 1) if x.ndim == 4 else (1, -1)
    inv = torch.rsqrt(bn.running_var + BN_EPS)
    y = (x - bn.running_mean.reshape(shape)) * (bn.weight * inv).reshape(shape)
    return y + bn.bias.reshape(shape)


def bn_eval_affine(bn: nn.Module) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm folded to per-channel ``(scale, bias)``, ``y = x *
    scale + bias`` (JAX ``layers.bn_eval_affine``).  Algebraically
    :func:`batch_norm` but not bit-identical to it: only the fully
    convolutional path (models/fully_conv.py) folds, as JAX's does; the
    windows paths keep :func:`batch_norm` so that they round alike."""
    scale = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
    return scale, bn.bias - bn.running_mean * scale


def avg_pool2d(x: torch.Tensor, k: int) -> torch.Tensor:
    """torch AvgPool2d(k) semantics (stride k, no padding, floor output
    size), computed as a mean over the reshaped k x k cells."""
    b, c, h, w = x.shape
    oh, ow = h // k, w // k
    x = x[:, :, : oh * k, : ow * k].reshape(b, c, oh, k, ow, k)
    return x.mean(dim=(3, 5))
