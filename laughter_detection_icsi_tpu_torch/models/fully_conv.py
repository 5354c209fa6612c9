"""Fully-convolutional (à-trous) inference for the ResNetBigger family.

The port of the JAX package's ``models/fully_conv.py``.  The reference
classifies every 10 ms frame by running the whole conv stack on a
100-frame window per output; adjacent windows overlap 99%.  This module
evaluates the same weights once over the whole feature track with the
dilation trick: every stride-2-in-time conv becomes a stride-1 conv with
doubled time dilation (frequency keeps its stride), so the network stays at
full time resolution and output t of the final map equals the strided
network's row for the window starting at t.  The AvgPool + flatten + linear
head becomes twelve shifted adds over the final map plus a [T, 48] matmul
(18.5 against 1,389 MFLOP per output frame).

Numerics: for a window with silence around it the paths agree up to the
*bias leak*: a zero track region carries ``relu(bias)``/BN-affine constants
through the stack where the per-window path saw literal per-layer zeros.
On continuous audio interior windows see real neighbour audio where the
reference saw zeros, so this is a better-posed model but not checkpoint
parity: an opt-in mode (``InferenceSettings(mode="fused_conv")``).

BatchNorm is folded as JAX folds it (``layers.bn_eval_affine``), not with
the windows paths' ``layers.batch_norm`` expression.  ResNetNoBN (no BN
anywhere) skips every fold.  Functions take the ``ResNetFamily`` module
and NCHW tensors; tracks are [T, F].
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from laughter_detection_icsi_tpu_torch.models import layers as L
from laughter_detection_icsi_tpu_torch.models.zoo import ResidualBlock, ResNetFamily

#: The one stride plan of ``zoo.ResNetFamily`` (stage strides).
STRIDES = ResNetFamily.STRIDES
POOL = 4


def _conv(x: torch.Tensor, conv, f_stride: int, t_dil: int,
          valid_t: bool = False) -> torch.Tensor:
    """NCHW conv with the module's weight and bias, 'same' in frequency;
    time stride 1 with dilation ``t_dil``, 'same' in time or, with
    ``valid_t``, VALID in time (the blocked path's halos give the
    context)."""
    kh, kw = conv.weight.shape[2], conv.weight.shape[3]
    pad_t = 0 if valid_t else t_dil * (kh // 2)
    return L.conv_bias(x, conv.weight, conv.bias, stride=(1, f_stride),
                       padding=(pad_t, kw // 2), dilation=(t_dil, 1))


def _bn4(x: torch.Tensor, bn: Optional[torch.nn.Module]) -> torch.Tensor:
    if bn is None:
        return x
    scale, bias = L.bn_eval_affine(bn)
    return x * scale[None, :, None, None] + bias[None, :, None, None]


def _block(x: torch.Tensor, blk: ResidualBlock, f_stride: int, t_dil_in: int,
           replaced_stride: int, valid_t: bool = False) -> Tuple[torch.Tensor, int]:
    """A residual block with its time stride replaced by dilation.

    ``t_dil_in`` is the dilation entering the block; the first conv keeps
    it and every later conv uses ``t_dil_in * replaced_stride``.  With
    ``valid_t`` each conv consumes its dilation of halo rows from each
    side, and the 1x1 shortcut (no time context) is sliced to stay
    aligned."""
    t_dil_out = t_dil_in * replaced_stride
    out = torch.relu(_bn4(_conv(x, blk.conv1, f_stride, t_dil_in, valid_t), blk.bn1))
    out = _bn4(_conv(out, blk.conv2, 1, t_dil_out, valid_t), blk.bn2)
    if blk.shortcut is not None:
        sc = L.conv_bias(x, blk.shortcut[0].weight, blk.shortcut[0].bias,
                         stride=(1, f_stride))
        sc = _bn4(sc, blk.shortcut_bn())
    else:
        sc = x
    if valid_t:
        off = t_dil_in + t_dil_out  # rows the two convs consumed per side
        sc = sc[:, :, off : sc.shape[2] - off, :]
    return torch.relu(out + sc), t_dil_out


def _stack(model: ResNetFamily, x: torch.Tensor, valid_t: bool = False) -> torch.Tensor:
    """Stem + the four dilated stages over [B, 1, T, F]."""
    x = torch.relu(_bn4(_conv(x, model.conv1, 1, 1, valid_t), model.bn1))
    t_dil = 1
    for stage, s in zip(model.stages(), STRIDES):
        # The first block of a stage carries its stride, the second is s=1.
        x, t_dil = _block(x, stage[0], s, t_dil, s, valid_t)
        x, _ = _block(x, stage[1], 1, t_dil, 1, valid_t)
    return x


def _head(flat: torch.Tensor, model: ResNetFamily) -> torch.Tensor:
    """BN1d -> linear1 -> BN1d -> ReLU -> linear2 -> sigmoid over the
    flattened pooled map (reference models.py:231-238); the folds are
    skipped for ResNetNoBN."""
    h = flat
    if model.bn2 is not None:
        scale, bias = L.bn_eval_affine(model.bn2)
        h = h * scale + bias
    h = L.linear(h, model.linear1)
    if model.bn3 is not None:
        scale, bias = L.bn_eval_affine(model.bn3)
        h = h * scale + bias
    h = torch.relu(h)
    return torch.sigmoid(L.linear(h, model.linear2))[:, 0]


def _shifted_pool(m: torch.Tensor, t_dil: int, out_rows: int, length: int) -> torch.Tensor:
    """[..., C, H] freq-pooled map -> [out_rows, ..., C, length]: pooled row
    r at position i is the mean over q < POOL of m[..., i + t_dil*(POOL*r + q)]."""
    pieces = []
    for r in range(out_rows):
        acc = 0
        for q in range(POOL):
            off = t_dil * (POOL * r + q)
            acc = acc + m[..., off : off + length]
        pieces.append(acc / POOL)
    return torch.stack(pieces, dim=0)


#: Blocks per dispatch of :func:`fully_conv_probs_blocked`: 64 blocks of
#: 1,024 rows (~11 min of audio) bound the live activations whatever the
#: track's length (a one-hour channel is ~352 blocks).
MAX_BLOCKS = 64


def fully_conv_probs_blocked(
    model: ResNetFamily,
    feats: torch.Tensor,
    window: int = 100,
    block: int = 1024,
    max_blocks: int = MAX_BLOCKS,
) -> torch.Tensor:
    """[T_in, F] -> [T_in] probabilities, equal to :func:`fully_conv_probs`.

    The track is cut into ``block``-row segments with receptive-field
    halos, R = 54 rows of dilated-conv context before and R + 88 rows (the
    head's pooling extent at time stride 8) after, and the stack runs VALID
    in time over [n, block + 196, F] batches of at most ``max_blocks``
    segments.  Halos come from the real track, so interior outputs equal
    the unblocked computation.  The first R and last R + 88 output rows see
    the track edge, where the unblocked conv zero-pads at every layer;
    those rows are recomputed with two small unblocked prefix/suffix
    segments and spliced in, which is exact because a segment's interior
    rows never read its far edge."""
    # Receptive radius of the dilated stack: per stage, first conv at the
    # incoming dilation + three convs at the outgoing one.
    t_dil, radius = 1, 1  # stem conv
    for s in STRIDES:
        radius += t_dil + 3 * (t_dil * s)
        t_dil *= s
    pool = POOL
    out_rows = ((window - 1) // t_dil + 1) // pool  # 3 for window 100
    if out_rows < 1:
        raise NotImplementedError(
            f"fused_conv head needs window >= {pool * t_dil}; got {window}"
        )
    if max_blocks < 1:
        raise ValueError(f"max_blocks must be >= 1, got {max_blocks}")
    # pool offsets 0 .. pool*out_rows-1 at stride t_dil
    head_extent = t_dil * (pool * out_rows - 1)
    halo_l, halo_r = radius, radius + head_extent

    t_in = feats.shape[0]
    seg = 2 * (halo_l + halo_r)  # prefix/suffix segment for exact track edges
    if t_in <= 2 * seg:
        return fully_conv_probs(model, feats, window)
    nb = -(-t_in // block)
    # Right padding covers: block rounding, the per-window zero-pad tail
    # (window - 1, within halo_r's reach beyond t_in), and the halo.
    ptrack = F.pad(feats, (0, 0, halo_l, nb * block - t_in + halo_r))
    xb = ptrack.unfold(0, block + halo_l + halo_r, block)  # [nb, F, rows]

    def blocks_probs(xg: torch.Tensor) -> torch.Tensor:
        x = _stack(model, xg.transpose(1, 2)[:, None], valid_t=True)
        # x: [n, C, block + head_extent, Wf]; freq-pool like fully_conv_probs.
        n, c, wf = x.shape[0], x.shape[1], x.shape[3]
        if wf // pool != 1:
            raise NotImplementedError(
                f"fused_conv head needs a single pooled frequency column "
                f"(got Wf {wf}); use mode='windows' for other geometries"
            )
        m = x[:, :, :, : pool * (wf // pool)].reshape(
            n, c, x.shape[2], wf // pool, pool
        ).mean(dim=-1)[:, :, :, 0]  # [n, C, H]
        pooled = _shifted_pool(m, t_dil, out_rows, block)  # [out_rows, n, C, block]
        # torch .view flatten order over [C, H=out_rows, W=1]: c*out_rows + r.
        flat = pooled.permute(1, 3, 2, 0).reshape(n * block, c * out_rows)
        return _head(flat, model)

    probs = torch.cat([blocks_probs(xb[g : g + max_blocks]) for g in range(0, nb, max_blocks)])

    # Splice in the exact track edges (see docstring): rows < halo_l read
    # the left track edge, rows >= t_in - halo_r can read beyond the
    # window-pad tail; both segments' spliced rows are interior to their
    # own far edge, so they equal the unblocked whole-track values.
    pre = fully_conv_probs(model, feats[:seg], window)[:halo_l]
    suf = fully_conv_probs(model, feats[t_in - seg :], window)[seg - halo_r :]
    return torch.cat([pre, probs[halo_l : t_in - halo_r], suf])


def fully_conv_probs(
    model: ResNetFamily,
    feats: torch.Tensor,
    window: int = 100,
) -> torch.Tensor:
    """[T_in, F] feature track -> [T_in] per-frame laughter probabilities
    (one per window start, like the per-window pipeline).

    The track is right-padded internally by ``window - 1`` zero frames so
    tail windows match the per-window zero-pad semantics
    (reference datasets.py:85-92).
    """
    t_in = feats.shape[0]
    x = _stack(model, F.pad(feats, (0, 0, 0, window - 1))[None, None])

    # x: [1, C, T, Wf] at full time resolution; the total replaced time
    # stride is 8.  Frequency followed the original striding, so Wf is the
    # reference window's final width; the strided window map's row m for
    # window i is x[:, :, i + t_dil*m, :].
    t_dil = 1
    for s in STRIDES:
        t_dil *= s
    c = x.shape[1]
    wf = x.shape[3]
    pool = POOL
    # Reference head: AvgPool2d(4) on the [13, Wf] window map -> rows r pool
    # window-map rows 4r+q (q<4), cols 0..3 (floor; Wf=6 -> 1 col).
    n_rows = ((window - 1) // t_dil + 1)  # 13 for window 100, stride 8
    out_rows = n_rows // pool  # 3
    if out_rows < 1 or wf // pool != 1:
        # The head mirrors AvgPool2d(4)+.view for the ICSI geometry (one
        # pooled frequency column); silently collapsing extra columns
        # would feed the head something the reference never computes.
        raise NotImplementedError(
            f"fused_conv head needs window >= {pool * t_dil} and a single "
            f"pooled frequency column (got window {window}, Wf {wf}); "
            "use mode='windows' for other geometries"
        )
    m = x[0, :, :, : pool * (wf // pool)].reshape(c, x.shape[2], wf // pool, pool).mean(dim=-1)
    m = m[:, :, 0]  # [C, T] freq-pooled

    # Slice length: the largest offset is head_extent = t_dil*(pool*out_rows
    # - 1), so total - head_extent positions exist for every offset.  Since
    # pool*out_rows - 1 <= (window-1)//t_dil, this is always >= t_in.
    slice_len = x.shape[2] - t_dil * (pool * out_rows - 1)
    pooled = _shifted_pool(m, t_dil, out_rows, slice_len)  # [out_rows, C, T']

    # torch .view flatten order over [C, H=out_rows, W=1]: index = c*out_rows + r
    flat = pooled.permute(2, 1, 0).reshape(pooled.shape[2], c * out_rows)
    return _head(flat, model)[:t_in]
