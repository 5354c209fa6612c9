"""The laughter-classifier model zoo as ``nn.Module``s.

The architectures of the JAX package's ``models/zoo.py`` (reference
models.py:6-308): ``ResNetBigger`` (the production model), ``ResNet``,
``ResNetNoBN`` and ``MLPModel``.  Each module's ``state_dict`` keys and
shapes equal the JAX package's flat checkpoint keys (``conv1.weight``,
``block1.0.bn1.running_mean``, ``block2.0.shortcut.0.weight``, ...), so a
JAX ``(params, state)`` pair loads with ``load_state_dict(strict=True)``
(train/checkpoint.py).

``forward(x, generator=None)`` takes [B, 1, window, F] and returns [B]
probabilities.  It branches on ``self.training``, as JAX's ``apply`` on
``train``: in eval mode BatchNorm uses its running statistics and dropout
is the identity; in train mode BatchNorm normalizes by the batch's
statistics and updates the running ones in place, and dropout draws from
``generator`` (required when ``dropout_rate > 0``: without it dropout
would silently act as 0).  ``build`` draws the initial weights from a
seed; ``reference_init`` gives the reference's normal(0, 0.01) init.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from laughter_detection_icsi_tpu_torch.models import layers as L


class ResidualBlock(nn.Module):
    """conv3x3(+bias) -> BN -> ReLU -> conv3x3(+bias) -> BN, plus a 1x1
    conv (no bias) + BN shortcut when the shape changes; add; ReLU
    (reference models.py:82-115; without BN for ResidualBlockNoBN)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, with_bn: bool):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, bias=True)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, bias=True)
        self.bn1 = nn.BatchNorm2d(out_ch) if with_bn else None
        self.bn2 = nn.BatchNorm2d(out_ch) if with_bn else None
        self.shortcut = None
        if stride != 1 or in_ch != out_ch:
            sc = [nn.Conv2d(in_ch, out_ch, 1, bias=False)]
            if with_bn:
                sc.append(nn.BatchNorm2d(out_ch))
            self.shortcut = nn.Sequential(*sc)

    def shortcut_bn(self) -> Optional[nn.Module]:
        return self.shortcut[1] if len(self.shortcut) > 1 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        train = self.training
        out = L.conv_bn_act(x, self.conv1, self.bn1, train, stride=self.stride)
        sc = x
        if self.shortcut is not None:
            sc = L.conv_bn_act(x, self.shortcut[0], self.shortcut_bn(), train, relu=False,
                               stride=self.stride, padding=0)
        return L.conv_bn_act(out, self.conv2, self.bn2, train, residual=sc)


def _stage(in_ch: int, out_ch: int, stride: int, with_bn: bool) -> nn.Sequential:
    """Two residual blocks: the first with the given stride, the second
    with stride 1 (reference models.py:216-220)."""
    return nn.Sequential(
        ResidualBlock(in_ch, out_ch, stride, with_bn),
        ResidualBlock(out_ch, out_ch, 1, with_bn),
    )


class ResNetFamily(nn.Module):
    """ResNetBigger / ResNet / ResNetNoBN: a 3x3 stem conv (no bias) -> BN
    -> ReLU, four stages (strides 1, 2, 2, 2), AvgPool2d(4), flatten,
    BN1d -> Linear(->32) -> BN1d -> ReLU -> Linear(->1) -> sigmoid."""

    STRIDES = (1, 2, 2, 2)

    def __init__(self, name: str, dropout_rate: float, linear_layer_size: int,
                 filter_sizes: Sequence[int], stem_channels: int, with_bn: bool):
        super().__init__()
        filter_sizes = tuple(filter_sizes)
        if len(filter_sizes) != 4:
            # The family is a fixed 4-stage network: extra entries would be
            # silently dropped and fewer would fail far from here.
            raise ValueError(
                f"{name} needs exactly 4 filter_sizes (one per stage), "
                f"got {len(filter_sizes)}: {filter_sizes}"
            )
        self.name = name
        self.dropout_rate = dropout_rate
        self.with_bn = with_bn
        chans = (stem_channels,) + filter_sizes
        self.conv1 = nn.Conv2d(1, stem_channels, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(stem_channels) if with_bn else None
        for i in range(4):
            self.add_module(
                f"block{i + 1}", _stage(chans[i], chans[i + 1], self.STRIDES[i], with_bn)
            )
        self.bn2 = nn.BatchNorm1d(linear_layer_size) if with_bn else None
        self.linear1 = nn.Linear(linear_layer_size, 32)
        self.bn3 = nn.BatchNorm1d(32) if with_bn else None
        self.linear2 = nn.Linear(32, 1)

    def stages(self) -> Tuple[nn.Sequential, ...]:
        return (self.block1, self.block2, self.block3, self.block4)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """conv1 -> BN -> ReLU."""
        return L.conv_bn_act(x, self.conv1, self.bn1, self.training)

    def tail(self, x: torch.Tensor, first_stage: int,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Stages ``first_stage``..4 and the head on a stage-(first_stage-1)
        output [B, C, H, F] -> [B] probabilities (dropout, in train mode,
        after the head's two BatchNorms)."""
        train, rate = self.training, self.dropout_rate
        for stage in self.stages()[first_stage - 1:]:
            x = stage(x)
        x = L.avg_pool2d(x, 4)
        x = x.reshape(x.shape[0], -1)  # NCHW flatten, torch .view order
        x = L.dropout(L.batch_norm(x, self.bn2, train), rate, generator, train)
        x = L.batch_norm(L.linear(x, self.linear1), self.bn3, train)
        x = torch.relu(L.dropout(x, rate, generator, train))
        return torch.sigmoid(L.linear(x, self.linear2))[:, 0]

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        _check_generator(self, generator)
        return self.tail(self.stem(x), first_stage=1, generator=generator)


class MLPModel(nn.Module):
    """reference models.py:6-40: Linear -> BN -> ReLU -> Linear -> BN ->
    ReLU -> Linear -> sigmoid over the flattened window.
    ``linear_layer_size`` is the INPUT dim (the flattened window size)."""

    def __init__(self, linear_layer_size: int = 101 * 40, hid_dim1: int = 600,
                 hid_dim2: int = 100, dropout_rate: float = 0.5,
                 filter_sizes: Optional[Sequence[int]] = None):
        super().__init__()
        del filter_sizes  # accepted and ignored, like the reference constructor
        self.name = "MLPModel"
        self.dropout_rate = dropout_rate
        self.linear_layer_size = linear_layer_size
        self.linear1 = nn.Linear(linear_layer_size, hid_dim1)
        self.bn1 = nn.BatchNorm1d(hid_dim1)
        self.linear2 = nn.Linear(hid_dim1, hid_dim2)
        self.bn2 = nn.BatchNorm1d(hid_dim2)
        self.linear3 = nn.Linear(hid_dim2, 1)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        _check_generator(self, generator)
        feat = math.prod(x.shape[1:])
        if x.ndim > 1 and feat != self.linear_layer_size:
            # The reference's view(-1, input_dim) would silently regroup the
            # batch whenever the window size divides by input_dim.
            raise ValueError(
                f"MLPModel(linear_layer_size={self.linear_layer_size}) got "
                f"windows of {feat} features each (input shape "
                f"{tuple(x.shape)}); linear_layer_size must equal the "
                "flattened window size"
            )
        x = x.reshape(-1, self.linear_layer_size)
        train, rate = self.training, self.dropout_rate
        h = L.batch_norm(L.linear(x, self.linear1), self.bn1, train)
        h = torch.relu(L.dropout(h, rate, generator, train))
        h = L.batch_norm(L.linear(h, self.linear2), self.bn2, train)
        h = torch.relu(L.dropout(h, rate, generator, train))
        return torch.sigmoid(L.linear(h, self.linear3))[:, 0]


def _check_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Train mode with dropout and no generator raises, as JAX's ``apply``
    without an rng does."""
    if model.training and generator is None and model.dropout_rate > 0.0:
        raise ValueError(
            f"{model.name} in train mode needs a generator: dropout_rate="
            f"{model.dropout_rate} would silently act as 0.0 without one"
        )


def _check_fixed_filter_plan(name: str, filter_sizes, fixed: Tuple[int, ...]):
    """ResNet/ResNetNoBN hardcode their channel plans (their reference
    constructors take no filter_sizes): accept a matching plan, reject a
    different one loudly."""
    if filter_sizes is not None and tuple(filter_sizes) != fixed:
        raise ValueError(
            f"{name} hardcodes filter plan {fixed} (its reference "
            f"constructor takes no filter_sizes); got {tuple(filter_sizes)}"
        )


def ResNetBigger(dropout_rate: float = 0.5, linear_layer_size: int = 192,
                 filter_sizes: Sequence[int] = (64, 32, 16, 16)) -> ResNetFamily:
    """reference models.py:181-244."""
    return ResNetFamily("ResNetBigger", dropout_rate, linear_layer_size,
                        filter_sizes, stem_channels=64, with_bn=True)


def ResNet(dropout_rate: float = 0.5, linear_layer_size: int = 192,
           filter_sizes: Optional[Sequence[int]] = None) -> ResNetFamily:
    """reference models.py:118-178: 32-channel stem."""
    _check_fixed_filter_plan("ResNet", filter_sizes, (32, 16, 16, 16))
    return ResNetFamily("ResNet", dropout_rate, linear_layer_size,
                        (32, 16, 16, 16), stem_channels=32, with_bn=True)


def ResNetNoBN(dropout_rate: float = 0.5, linear_layer_size: int = 192,
               filter_sizes: Optional[Sequence[int]] = None) -> ResNetFamily:
    """reference models.py:247-308: ResNetBigger shape without batch norm."""
    _check_fixed_filter_plan("ResNetNoBN", filter_sizes, (64, 32, 16, 16))
    return ResNetFamily("ResNetNoBN", dropout_rate, linear_layer_size,
                        (64, 32, 16, 16), stem_channels=64, with_bn=False)


MODEL_REGISTRY = {
    "ResNetBigger": ResNetBigger,
    "ResNet": ResNet,
    "ResNetNoBN": ResNetNoBN,
    "MLPModel": MLPModel,
}


def build(architecture: str, dropout_rate: float = 0.5,
          linear_layer_size: Optional[int] = None,
          filter_sizes: Optional[Sequence[int]] = None, seed: int = 0) -> nn.Module:
    """Build a model by architecture name (config.ModelPreset.model), in
    eval mode.  ``linear_layer_size`` / ``filter_sizes`` left as None take
    each architecture's own default.  The initial weights are JAX's
    initializers (``layers.conv_init`` / ``linear_init``; BatchNorm at
    weight 1, bias 0) drawn from a generator seeded with ``seed``; a
    checkpoint or :func:`reference_init` replaces them."""
    if architecture not in MODEL_REGISTRY:
        raise KeyError(
            f"unknown architecture {architecture!r}; "
            f"available: {sorted(MODEL_REGISTRY)}"
        )
    kwargs: Dict[str, object] = {"dropout_rate": dropout_rate}
    if linear_layer_size is not None:
        kwargs["linear_layer_size"] = linear_layer_size
    if filter_sizes is not None:
        kwargs["filter_sizes"] = filter_sizes
    with torch.random.fork_rng(devices=[]):  # the modules' own init draws globally
        model = MODEL_REGISTRY[architecture](**kwargs)
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            L.conv_init(m, gen)
        elif isinstance(m, nn.Linear):
            L.linear_init(m, gen)
    return model.eval()


def reference_init(model: nn.Module, seed: int) -> nn.Module:
    """The reference's init, the one its training starts from: normal(0,
    0.01) on every parameter (BatchNorm's included), drawn in parameter
    order from a generator seeded with ``seed``; buffers untouched.
    Returns ``model``."""
    L.reference_init(model, torch.Generator().manual_seed(seed))
    return model
