"""Primitive layers with the JAX package's numerics.

Each function takes the torch module that holds the parameters (an
``nn.Conv2d``, ``nn.Linear`` or ``nn.BatchNorm*d``) and applies it the way
the JAX package's ``models/layers.py`` does, in particular eval BatchNorm
as ``(x - mean) * (weight * rsqrt(var + eps)) + bias`` — the same
expression and rounding order, not ``F.batch_norm``.  Shared-stem inference
relies on every path rounding alike (models/shared_stem.py).  The layers run
in the dtype of what they are given; in bf16 they round where XLA rounds
the JAX package's ops (``_rsqrt``, ``conv_bias``).

Train mode, as JAX's: BatchNorm normalizes by the batch's biased variance
(statistics in float32) and moves the running statistics by momentum 0.1
with the unbiased one; dropout scales the kept values by 1 / keep.  The
initializers draw from an explicit ``torch.Generator``.

Inside :func:`data_parallel_scope` (``parallel.DataParallelTrainer``) each
process holds one contiguous block of rows of a global batch, and both
train-mode layers act on the global batch, as the JAX package's
data-parallel step does (JAX ``parallel/data_parallel.py:10-13``):
BatchNorm's statistics are sums all-reduced over the process group divided
by the global count, and dropout draws the global batch's mask and keeps
this process's rows, so a data-parallel step is numerically the one-process
big-batch step.  Outside the scope nothing is reduced.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

# Registers torch.ops.laughter_icsi_torch.bn_act, conv_bn_act's kernel.
from laughter_detection_icsi_tpu_torch.ops import bn_act_cuda  # noqa: F401

BN_EPS = 1e-5
BN_MOMENTUM = 0.1

Pair = Union[int, Tuple[int, int]]


def conv2d(x: torch.Tensor, conv: nn.Conv2d, stride: Pair = 1, padding: Pair = 1,
           dilation: Pair = 1) -> torch.Tensor:
    """NCHW conv with the module's OIHW weight (and bias, if any)."""
    return conv_bias(x, conv.weight, conv.bias, stride=stride, padding=padding,
                     dilation=dilation)


def conv_bias(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
              **kw) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, **kw)``.  Below float32 the bias is added
    after the product is rounded to the activation dtype, as the JAX
    package's conv then add rounds.  A library conv adds it inside its
    float32 accumulator, which moves the bf16 probabilities 2-4x further
    from JAX's, past the 2e-2 bound on fused_conv (pinned by
    tests/test_torch_precision.py::test_bias_after_the_rounded_conv_is_what_holds_jax).
    In float32 the library adds it."""
    if x.dtype == torch.float32 or bias is None:
        return F.conv2d(x, weight, bias, **kw)
    return F.conv2d(x, weight, None, **kw) + bias.reshape(1, -1, 1, 1)


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """[B, in] x weight [out, in] + bias."""
    return x @ lin.weight.T + lin.bias


def conv_bn_act(x: torch.Tensor, conv: nn.Conv2d, bn: Optional[nn.Module],
                train: bool = False, relu: bool = True,
                residual: Optional[torch.Tensor] = None, stride: Pair = 1,
                padding: Pair = 1, dilation: Pair = 1,
                pad_rows: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """``relu(batch_norm(conv2d(x)) + residual)``: a conv of the ResNet
    family and what follows it, the ReLU only where ``relu``, the residual
    only where given, with ``pad_rows = (top, bottom)`` zero rows added
    above and below (along H): the input of a conv that pads in time on one
    side.  A CUDA tensor outside train mode takes one launch of
    the epilogue kernel (ops/bn_act_cuda.py) after the library's conv, in
    the memory format the conv wrote (NHWC where the conv's weight is
    channels-last), the zero rows written by the same launch; it rounds as
    the composed chain does, so the two give the same bits.
    Anything else (the CPU, train mode's batch statistics) runs the
    composed chain, the plain version, and pads its result with ``F.pad``."""
    kw = dict(stride=stride, padding=padding, dilation=dilation)
    if train or not x.is_cuda:
        y = batch_norm(conv2d(x, conv, **kw), bn, train)
        if residual is not None:
            y = y + residual
        y = torch.relu(y) if relu else y
        return F.pad(y, (0, 0, *pad_rows)) if any(pad_rows) else y
    # conv_bias's split: the library adds a float32 bias in its accumulator;
    # below float32 the kernel adds it to the rounded product.
    f32 = x.dtype == torch.float32
    y = F.conv2d(x, conv.weight, conv.bias if f32 else None, **kw)
    norm = ((None,) * 4 if bn is None
            else (bn.weight, bn.bias, bn.running_mean, bn.running_var))
    return torch.ops.laughter_icsi_torch.bn_act(
        y, None if f32 else conv.bias, *norm, residual, relu, BN_EPS, *pad_rows)


def _rsqrt(v: torch.Tensor) -> torch.Tensor:
    """``rsqrt(v)`` computed in float32 and rounded once to ``v``'s dtype,
    as XLA computes a bf16 rsqrt (the CPU's bf16 ``torch.rsqrt`` rounds the
    square root to bf16 before the reciprocal); the identity for float32."""
    return torch.rsqrt(v.float()).to(v.dtype)


def batch_norm(x: torch.Tensor, bn: Optional[nn.Module], train: bool = False) -> torch.Tensor:
    """BatchNorm over the channel axis (axis 1 of NCHW or [B, C]); identity
    when ``bn`` is None (the batch-norm-free models).  Eval uses the running
    statistics; ``train`` the batch's, and updates the running ones in
    place (:func:`_batch_stats`)."""
    if bn is None:
        return x
    shape = (1, -1, 1, 1) if x.ndim == 4 else (1, -1)
    if train:
        mean, var = _batch_stats(x, bn, shape)
        inv = _rsqrt(var + BN_EPS)
        y = (x - mean.reshape(shape)) * (bn.weight * inv).reshape(shape)
        return y + bn.bias.reshape(shape)
    inv = _rsqrt(bn.running_var + BN_EPS)
    y = (x - bn.running_mean.reshape(shape)) * (bn.weight * inv).reshape(shape)
    return y + bn.bias.reshape(shape)


class _Shard(NamedTuple):
    rank: int
    world: int


_SHARD: contextvars.ContextVar[Optional[_Shard]] = contextvars.ContextVar(
    "data_parallel_shard", default=None)


@contextlib.contextmanager
def data_parallel_scope():
    """Train-mode BatchNorm and dropout over the global batch of the
    default process group inside the block: this process's rows are block
    ``rank`` of ``world`` equal blocks.  Every process of the group must
    run the same layers in the same order.  Without a process group, or in
    a group of one, the layers are unchanged."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        yield
        return
    token = _SHARD.set(_Shard(dist.get_rank(), dist.get_world_size()))
    try:
        yield
    finally:
        _SHARD.reset(token)


class _AllReduceSum(torch.autograd.Function):
    """A sum over the group, differentiable: the gradient of every
    process's copy of the sum is summed back onto each input."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


def _batch_stats(x: torch.Tensor, bn: nn.Module, shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batch's mean and biased variance per channel, in float32 (or
    the input's wider dtype); the running statistics move by ``BN_MOMENTUM`` toward the mean and the
    unbiased variance, and ``num_batches_tracked`` counts one more batch.
    Inside :func:`data_parallel_scope` the batch is the global one: the
    sums are all-reduced and divided by the global count."""
    axes = (0, 2, 3) if x.ndim == 4 else (0,)
    shard = _SHARD.get()
    n = x.numel() // x.shape[1] * (shard.world if shard else 1)
    if n <= 1:
        # torch raises here too; a zero "unbiased" variance would quietly
        # decay running_var toward 0.
        raise ValueError(
            f"batch_norm(train=True) needs more than 1 value per channel, got {n} "
            "(size-1 tail batch? use drop_remainder)"
        )
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if shard is None:
        mean = xf.mean(dim=axes)
        var = ((xf - mean.reshape(shape)) ** 2).mean(dim=axes)
    else:
        mean = _AllReduceSum.apply(xf.sum(dim=axes)) / n
        var = _AllReduceSum.apply(((xf - mean.reshape(shape)) ** 2).sum(dim=axes)) / n
    with torch.no_grad():
        bn.running_mean.copy_((1 - BN_MOMENTUM) * bn.running_mean + BN_MOMENTUM * mean)
        bn.running_var.copy_((1 - BN_MOMENTUM) * bn.running_var
                             + BN_MOMENTUM * (var * (n / (n - 1))))
        bn.num_batches_tracked.add_(1)
    return mean.to(x.dtype), var.to(x.dtype)


def bn_eval_affine(bn: nn.Module) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm folded to per-channel ``(scale, bias)``, ``y = x *
    scale + bias`` (JAX ``layers.bn_eval_affine``).  Algebraically
    :func:`batch_norm` but not bit-identical to it: only the fully
    convolutional path (models/fully_conv.py) folds, as JAX's does; the
    windows paths keep :func:`batch_norm` so that they round alike."""
    scale = bn.weight * _rsqrt(bn.running_var + BN_EPS)
    return scale, bn.bias - bn.running_mean * scale


def avg_pool2d(x: torch.Tensor, k: int) -> torch.Tensor:
    """torch AvgPool2d(k) semantics (stride k, no padding, floor output
    size), computed as a mean over the reshaped k x k cells.  A
    channels-last ``x`` is copied to NCHW first, so that the mean sums each
    cell in the order it does for NCHW (the head's input is small)."""
    b, c, h, w = x.shape
    oh, ow = h // k, w // k
    x = x.contiguous()[:, :, : oh * k, : ow * k].reshape(b, c, oh, k, ow, k)
    return x.mean(dim=(3, 5))


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            train: bool) -> torch.Tensor:
    """Inverted dropout: in train mode each value is kept with probability
    ``1 - rate`` (a uniform draw from ``generator`` below it) and scaled by
    ``1 / (1 - rate)``; the identity otherwise, or without a generator.
    Inside :func:`data_parallel_scope` the draw is the global batch's and
    this process keeps its rows of it."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    shard = _SHARD.get()
    if shard is None:
        draw = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        b = x.shape[0]
        draw = torch.rand((b * shard.world, *x.shape[1:]), generator=generator,
                          device=x.device)[shard.rank * b:(shard.rank + 1) * b]
    mask = draw < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    draw = torch.empty(t.shape, dtype=t.dtype).uniform_(-bound, bound, generator=generator)
    with torch.no_grad():
        t.copy_(draw)


def conv_init(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """JAX ``layers.conv_init``: weight and bias uniform in
    +-1/sqrt(fan_in), drawn from ``generator`` (a CPU one)."""
    bound = 1.0 / math.sqrt(conv.weight[0].numel())
    _uniform_(conv.weight, bound, generator)
    if conv.bias is not None:
        _uniform_(conv.bias, bound, generator)


def linear_init(lin: nn.Linear, generator: torch.Generator) -> None:
    """JAX ``layers.linear_init``: weight and bias uniform in
    +-1/sqrt(in_features)."""
    bound = 1.0 / math.sqrt(lin.in_features)
    _uniform_(lin.weight, bound, generator)
    _uniform_(lin.bias, bound, generator)


def reference_init(module: nn.Module, generator: torch.Generator, std: float = 0.01) -> None:
    """The reference's blanket re-init: normal(0, std) on every parameter,
    BatchNorm's weight and bias included (reference utils/torch_utils.py:
    22-24); buffers (the running statistics) are left as they are."""
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=generator, dtype=p.dtype) * std)
