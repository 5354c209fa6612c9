"""Operations of the Audio Spectrogram Transformer, counted from a
configuration's widths.

Every product costs two operations (a multiply and an add) per
multiply-add: the patch convolution ``2 k^2 dim`` a patch, each linear ``2
in out`` a token, and attention's two products ``2 n^2 dim`` a block each
(``q k^T`` over every pair of the ``n`` tokens, and the weights times
``v``; ``heads x head_dim = dim``).  LayerNorm, softmax, GELU, the
residual adds and the biases are not counted, as ``counts/resnet.py``
does not count BatchNorm: the peak they are compared with is that of
multiply-adds.  At the published widths a clip is 261.0 GFLOP, 20.8% of
it attention.
"""

from __future__ import annotations

from typing import List, Tuple


def tokens(model: dict) -> int:
    """Patch tokens plus the cls and dist tokens."""
    k = model["patch"]
    f = (model["fdim"] - k) // model["fstride"] + 1
    t = (model["tdim"] - k) // model["tstride"] + 1
    return f * t + 2


def clip_layer_flops(model: dict) -> List[Tuple[str, int]]:
    """[(name, operations for one clip)] of every product, in the order
    they run."""
    n, d, m, k = tokens(model), model["dim"], model["mlp"], model["patch"]
    out = [("patch_embed", 2 * k * k * d * (n - 2))]
    for i in range(model["depth"]):
        b = f"blocks.{i}."
        out += [(b + "qkv", 2 * n * d * 3 * d), (b + "qk", 2 * n * n * d),
                (b + "av", 2 * n * n * d), (b + "proj", 2 * n * d * d),
                (b + "fc1", 2 * n * d * m), (b + "fc2", 2 * n * m * d)]
    out.append(("head", 2 * d * model["label_dim"]))
    return out


def clip_flops(model: dict) -> int:
    """Operations of one clip's forward pass."""
    return sum(f for _, f in clip_layer_flops(model))


def attention_flops(model: dict) -> int:
    """Operations of one clip's attention products (``q k^T`` and the
    weights times ``v``, every block)."""
    return sum(f for name, f in clip_layer_flops(model) if name.endswith((".qk", ".av")))
