"""ResNetBigger, the laughter classifier, in plain PyTorch: the plain reference.

The architecture of the published laughter-detection model (its
``models.py``, ``ResNetBigger``), applied to one 100 x 44 window at a
time: a 3 x 3 stem conv (no bias), BatchNorm, ReLU; four stages of two
residual blocks each (the first block of a stage carries its stride, both
dims; a block is conv3x3 + bias, BN, ReLU, conv3x3 + bias, BN, plus a 1 x 1
conv without bias and a BN on the shortcut where the shape changes; add,
ReLU); AvgPool2d(4), flatten in channel-major order, BatchNorm1d, dropout,
Linear, BatchNorm1d, ReLU, dropout, Linear to one logit, sigmoid.

Parameters are a flat dict under the published module's ``state_dict``
names (``conv1.weight``, ``block1.0.bn1.running_mean``,
``block2.0.shortcut.0.weight``, ...).  Everything is torch's own
functional ops: ``F.conv2d``, ``F.batch_norm`` (in train mode it moves the
running statistics in place, by momentum 0.1 toward the batch mean and the
unbiased variance), ``F.avg_pool2d``, ``F.linear``.  Dropout keeps a value
where a uniform draw from the given generator lies below ``1 - rate`` and
scales it by ``1 / (1 - rate)``; its draws are ``[B, linear_layer_size]``
then ``[B, head]``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
RUNNING = ("running_mean", "running_var")


def _bn_shapes(shapes: dict, name: str, c: int) -> None:
    for leaf in ("weight", "bias", *RUNNING):
        shapes[f"{name}.{leaf}"] = (c,)


def param_shapes(model: dict) -> Dict[str, tuple]:
    """Every leaf of the model (parameters and BN running statistics) and
    its shape, from the configuration's ``model`` group."""
    s: Dict[str, tuple] = {}
    c0 = model["stem_channels"]
    s["conv1.weight"] = (c0, 1, 3, 3)
    _bn_shapes(s, "bn1", c0)
    cin = c0
    for i, (cout, stride) in enumerate(zip(model["filter_sizes"], model["strides"]), 1):
        for b in range(2):
            pre = f"block{i}.{b}."
            ci, st = (cin, stride) if b == 0 else (cout, 1)
            s[pre + "conv1.weight"], s[pre + "conv1.bias"] = (cout, ci, 3, 3), (cout,)
            _bn_shapes(s, pre + "bn1", cout)
            s[pre + "conv2.weight"], s[pre + "conv2.bias"] = (cout, cout, 3, 3), (cout,)
            _bn_shapes(s, pre + "bn2", cout)
            if st != 1 or ci != cout:
                s[pre + "shortcut.0.weight"] = (cout, ci, 1, 1)
                _bn_shapes(s, pre + "shortcut.1", cout)
        cin = cout
    flat, head = model["linear_layer_size"], model["head"]
    _bn_shapes(s, "bn2", flat)
    s["linear1.weight"], s["linear1.bias"] = (head, flat), (head,)
    _bn_shapes(s, "bn3", head)
    s["linear2.weight"], s["linear2.bias"] = (1, head), (1,)
    return s


def is_running(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in RUNNING


#: ``on_layer(name, x, weight, y)`` is called after each conv and linear.
LayerHook = Callable[[str, torch.Tensor, torch.Tensor, torch.Tensor], None]


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, model: dict, train: bool = False,
            generator: Optional[torch.Generator] = None, momentum: float = BN_MOMENTUM,
            quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
            on_layer: Optional[LayerHook] = None) -> torch.Tensor:
    """[B, 1, window, F] windows -> [B] probabilities.  ``train``: BatchNorm
    by the batch's statistics (moving ``p``'s running ones in place) and
    dropout from ``generator``.  ``quant``, when given, rounds the input and
    the weight of every conv and linear (a lower-precision control)."""
    q = quant or (lambda t: t)

    def conv(name, h, stride, pad, bias=True):
        w = p[f"{name}.weight"]
        y = F.conv2d(q(h), q(w), p[f"{name}.bias"] if bias else None, stride=stride, padding=pad)
        if on_layer:
            on_layer(name, h, w, y)
        return y

    def linear(name, h):
        w = p[f"{name}.weight"]
        y = F.linear(q(h), q(w), p[f"{name}.bias"])
        if on_layer:
            on_layer(name, h, w, y)
        return y

    def bn(name, h):
        return F.batch_norm(h, p[f"{name}.running_mean"], p[f"{name}.running_var"],
                            p[f"{name}.weight"], p[f"{name}.bias"], training=train,
                            momentum=momentum, eps=BN_EPS)

    def dropout(h):
        rate = model["dropout_rate"]
        if not train or rate == 0.0:
            return h
        keep = 1.0 - rate
        draw = torch.rand(h.shape, generator=generator, device=h.device)
        return torch.where(draw < keep, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))

    h = torch.relu(bn("bn1", conv("conv1", x, 1, 1, bias=False)))
    for i, stride in enumerate(model["strides"], 1):
        for b in range(2):
            pre = f"block{i}.{b}."
            st = stride if b == 0 else 1
            out = torch.relu(bn(pre + "bn1", conv(pre + "conv1", h, st, 1)))
            out = bn(pre + "bn2", conv(pre + "conv2", out, 1, 1))
            if pre + "shortcut.0.weight" in p:
                h = bn(pre + "shortcut.1", conv(pre + "shortcut.0", h, st, 0, bias=False))
            h = torch.relu(out + h)
    h = F.avg_pool2d(h, 4).flatten(1)
    h = dropout(bn("bn2", h))
    h = torch.relu(dropout(bn("bn3", linear("linear1", h))))
    return torch.sigmoid(linear("linear2", h))[:, 0]


def probs_in_blocks(p, windows: torch.Tensor, model: dict, block: int = 1024, **kw) -> torch.Tensor:
    """Eval-mode probabilities of many windows, ``block`` at a time."""
    with torch.no_grad():
        return torch.cat([forward(p, windows[i:i + block], model, **kw)
                          for i in range(0, windows.shape[0], block)])
