"""Operations of ResNetBigger, counted from a configuration's widths.

A convolution or a linear layer costs two operations (a multiply and an
add) per weight per output position: ``2 * kh * kw * cin * cout * outputs``.
BatchNorm, ReLU, pooling, the bias adds and the sigmoid are not counted:
the peak they are compared with is that of multiply-adds.  Spatial sizes
follow the convolutions' arithmetic, ``(n + 2 pad - k) // stride + 1``.
"""

from __future__ import annotations


def _out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def window_layer_flops(model: dict, window: int, num_filters: int):
    """[(name, operations for one window, output height)] of every conv and
    linear, in the order they run."""
    out = []

    def conv(name, k, ci, co, stride, pad, h, w):
        ho, wo = _out(h, k, stride, pad), _out(w, k, stride, pad)
        out.append((name, 2 * k * k * ci * co * ho * wo, ho))
        return ho, wo

    c0 = model["stem_channels"]
    h, w = conv("conv1", 3, 1, c0, 1, 1, window, num_filters)
    cin = c0
    for i, (cout, stride) in enumerate(zip(model["filter_sizes"], model["strides"]), 1):
        for b in range(2):
            pre = f"block{i}.{b}."
            ci, st = (cin, stride) if b == 0 else (cout, 1)
            ho, wo = conv(pre + "conv1", 3, ci, cout, st, 1, h, w)
            conv(pre + "conv2", 3, cout, cout, 1, 1, ho, wo)
            if st != 1 or ci != cout:
                conv(pre + "shortcut.0", 1, ci, cout, st, 0, h, w)
            h, w = ho, wo
        cin = cout
    flat, head = model["linear_layer_size"], model["head"]
    out.append(("linear1", 2 * flat * head, 1))
    out.append(("linear2", 2 * head, 1))
    return out


def forward_flops(model: dict, window: int, num_filters: int) -> int:
    """Operations of one window's forward pass."""
    return sum(f for _, f, _ in window_layer_flops(model, window, num_filters))


def train_flops(model: dict, window: int, num_filters: int) -> int:
    """Operations of one sample's training step: the forward pass, the
    gradients of every weight (as many as the forward), and the gradients
    of every layer's input except the stem's (its input is the data)."""
    layers = window_layer_flops(model, window, num_filters)
    fwd = sum(f for _, f, _ in layers)
    stem = next(f for name, f, _ in layers if name == "conv1")
    return fwd + fwd + (fwd - stem)


def fully_conv_flops_per_frame(model: dict, window: int, num_filters: int) -> int:
    """Operations per output frame of the network's fully convolutional
    form: every conv computes each frame once at full time resolution (its
    stride in time replaced by dilation), so a layer costs its per-window
    operations divided by its output height; the head runs once a frame.
    No implementation of one output per frame needs fewer."""
    total = 0
    for name, f, ho in window_layer_flops(model, window, num_filters):
        total += f if name.startswith("linear") else f // ho
    return total
