"""Shared-stem sliding-window inference: exact per-window semantics at
~4.5x fewer FLOPs than the naive window batch.

The port of the JAX package's ``models/shared_stem.py`` (single-channel
parts).  Adjacent 100-frame windows share 99 rows, and for the stride-1
prefix of the ResNet family (stem conv + stage 1: 5 stacked 3x3 convs) the
activations at a window's interior rows equal one conv pass over the whole
track; only DEPTH = 5 rows at each window edge see the window's own zero
padding.  So per chunk of windows:

1. ``stem_track`` — stem + stage 1 once over the whole [T, F] track;
2. ``_band_stem`` — the contaminated edge rows, batched over windows, by
   convs with one-sided zero padding whose heights telescope 10 -> 5;
3. splice bands + interior rows into the stage-1 output and run the strided
   tail (``ResNetFamily.tail``, the counterpart of JAX's ``tail_probs``).

``stem_track2`` / ``_band2`` / ``chunk_probs_from_track2`` share stage 2 as
well (à-trous over the track, DEPTH2 = 6 exact edge rows per window).

Layouts: tracks are time-major [T, C, F] as in the JAX package; the convs
run on NCHW views (an explicit permute where JAX convolves NHCW).  The
memory under those views follows the model's conv weights: with NCHW
weights every activation is NCHW and a track is a contiguous [T, C, F];
with channels-last weights (the bf16 classify step on the card,
``inference.channels_last_classify``) cuDNN writes every conv's output
NHWC, a track is the [T, C, F] view of [T, F, C] memory, and the gathers,
pads and splices here keep NHWC, so no conv transposes its input or output
and nothing is copied to change layout.  The band convs pad in time on the
window-edge side only; each band conv's epilogue writes its result with
the zero row the next band conv reads (``L.conv_bn_act``'s ``pad_rows``),
so no band activation is padded by a pass of its own.  BatchNorm is the
eval expression of models/layers.py on every path, so the shared and naive
computations round alike.  Valid for ResNetBigger / ResNet / ResNetNoBN (stage-1 stride
1, 3x3 'same' convs).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from laughter_detection_icsi_tpu_torch.models import layers as L
from laughter_detection_icsi_tpu_torch.models.zoo import ResNetFamily

#: stride-1 3x3 convs before the first stride-2 conv: stem conv1 + two
#: residual blocks of stage 1 (2 convs each) = receptive-field radius 5.
DEPTH = 5

#: contaminated rows per window edge at the stage-2 output: the stride-2
#: conv maps the 5 stage-1 rows onto floor(DEPTH/2) + 1 = 3 rows, and the
#: three following effective-dilation-2 convs add one row each -> 6.
DEPTH2 = 6

#: models whose architecture satisfies the validity conditions above.
SUPPORTED_MODELS = ("ResNetBigger", "ResNet", "ResNetNoBN")


def resolve_shared_stem(setting, model_name: str, window: int) -> bool:
    """Resolve an ``InferenceSettings.shared_stem`` value: ``None``
    auto-enables when valid; an explicit ``True`` on an unsupported
    configuration raises instead of computing garbage."""
    supported = model_name in SUPPORTED_MODELS and window > 2 * DEPTH
    if setting is None:
        return supported
    if setting and not supported:
        raise ValueError(
            "shared_stem=True requires a ResNet-family model "
            f"({'/'.join(SUPPORTED_MODELS)}) and window > {2 * DEPTH}; "
            f"got model {model_name!r} with window {window}"
        )
    return bool(setting)


def supports_track2(window: int) -> bool:
    """Stage-2 sharing needs an EVEN window (the splice assumes a stage-2
    height of exactly window/2, and the bottom band's stride-2 centers touch
    no zero pad only for even windows) with a non-empty interior at half
    resolution."""
    return window % 2 == 0 and window // 2 > 2 * DEPTH2


def _conv_rows(xp: torch.Tensor, conv, bn, pad_out: Tuple[int, int] = (0, 0),
               **kw) -> torch.Tensor:
    """3x3 conv of a band ``xp`` that already holds its one-sided time
    padding (the zero row on the window-edge side), with 'same' padding in
    F; then ``L.conv_bn_act``'s BN, residual and ReLU (``kw``), its result
    with ``pad_out`` zero rows around it for the next such conv."""
    return L.conv_bn_act(xp, conv, bn, padding=(0, 1), pad_rows=pad_out, **kw)


def _interior(vp: torch.Tensor, pad: Tuple[int, int]) -> torch.Tensor:
    """The rows of a band padded by ``pad`` without its zero rows: a view."""
    return vp[:, :, pad[0]: vp.shape[2] - pad[1]]


def _conv_dil(x: torch.Tensor, conv, bn, **kw) -> torch.Tensor:
    """3x3 conv, stride 1, time dilation 2 ('same' in time), then
    ``L.conv_bn_act``'s BN, residual and ReLU (``kw``)."""
    return L.conv_bn_act(x, conv, bn, padding=(2, 1), dilation=(2, 1), **kw)


def _track(x: torch.Tensor) -> torch.Tensor:
    """A whole-track conv output [1, C, T, F] as the track [T, C, F]: a
    copy into [T, C, F] memory from NCHW, the permuted view itself from
    NHWC (its [T, F, C] memory is what the gathers and the convs read)."""
    track = x[0].permute(1, 0, 2)
    return track if x.is_contiguous(memory_format=torch.channels_last) else track.contiguous()


def stem_track(model: ResNetFamily, feats: torch.Tensor) -> torch.Tensor:
    """Stem + stage 1 over the whole track: [T, F] -> [T, C, F].  Row t
    equals the stage-1 output row r of any window w with w + r = t and
    DEPTH <= r < window - DEPTH (interior rows)."""
    return _track(model.block1(model.stem(feats[None, None])))


def _band_stem(model: ResNetFamily, x: torch.Tensor, top: bool) -> torch.Tensor:
    """The contaminated window-edge rows of the stage-1 output.

    x: [B, 1, 2*DEPTH, F], the first (``top``) or last 2*DEPTH feature rows
    of each window.  Each conv zero-pads only the window-edge side and stays
    'valid' on the interior side, so heights telescope 2*DEPTH -> DEPTH and
    every surviving row is the window's own computation.  Each conv but the
    last writes its result with the zero row the next one reads.  Returns
    [B, C, DEPTH, F]."""
    pad = (1, 0) if top else (0, 1)

    def crop(vp, n):
        # Align a residual input (a padded band's rows, height h) with an
        # output of height h - n (rows are edge-aligned: drop n rows from
        # the interior side).  A view of the band.
        v = _interior(vp, pad)
        return v[:, :, : v.shape[2] - n] if top else v[:, :, n:]

    # The 1-channel feature rows are the one input padded by a pass of its own.
    xp = _conv_rows(F.pad(x, (0, 0, *pad)), model.conv1, model.bn1, pad)
    for i, blk in enumerate(model.block1):
        out = _conv_rows(xp, blk.conv1, blk.bn1, pad)
        sc = crop(xp, 2)
        if blk.shortcut is not None:
            sc = L.conv_bn_act(sc, blk.shortcut[0], blk.shortcut_bn(), relu=False, padding=0)
        last = i == len(model.block1) - 1
        xp = _conv_rows(out, blk.conv2, blk.bn2, (0, 0) if last else pad, residual=sc)
    return xp


def stem_track2(model: ResNetFamily, track1: torch.Tensor) -> torch.Tensor:
    """Stage 2 over the whole track, à-trous: [T, C1, F] -> [T, C2, F//2].

    The window's stride-2-in-time convs become stride-1 convs evaluated at
    every track position (frequency keeps its stride), and the following
    convs are time-dilated by 2: position t equals the stage-2 output row m
    of any window w with w + 2m = t, wherever the receptive field stays in
    the window interior (DEPTH2 <= m < H2 - DEPTH2)."""
    b0, b1 = model.block2
    x = track1.permute(1, 0, 2)[None]  # [1, C1, T, F], NHWC from an NHWC track
    out = L.conv_bn_act(x, b0.conv1, b0.bn1, stride=(1, 2))
    # The stride-2 first block always has its shortcut (models/zoo.py).
    sc = L.conv_bn_act(x, b0.shortcut[0], b0.shortcut_bn(), relu=False, stride=(1, 2),
                       padding=0)
    x = _conv_dil(out, b0.conv2, b0.bn2, residual=sc)

    out = _conv_dil(x, b1.conv1, b1.bn1)
    return _track(_conv_dil(out, b1.conv2, b1.bn2, residual=x))  # [T, C2, F2]


def _band2(model: ResNetFamily, band1: torch.Tensor, strip: torch.Tensor,
           top: bool) -> torch.Tensor:
    """Exact stage-2 output rows at one window edge.

    band1: [B, C1, DEPTH, F] from ``_band_stem``; strip: the adjacent
    interior stage-1 rows gathered from the track, [B, S, C1, F] (S =
    2*DEPTH2 + 1 for the top edge, 2*DEPTH2 + 2 for the bottom).  Heights
    telescope 18 -> 9 -> 8 -> 7 -> 6 (top; bottom 19 -> 9 -> ...), every
    conv padding only the window-edge side; each conv but the last writes
    its result with the zero row the next one reads.  Returns [B, C2,
    DEPTH2, F//2]."""
    b0, b1 = model.block2
    strip = strip.permute(0, 2, 1, 3)  # [B, C1, S, F]: NHWC from an NHWC track
    x = torch.cat([band1, strip] if top else [strip, band1], dim=2)  # [B, C1, H, F]

    pad = (1, 0) if top else (0, 1)
    # The top edge's stride-2 centers read the zero row above the window;
    # the bottom's touch no zero pad.
    out = L.conv_bn_act(F.pad(x, (0, 0, 1, 0)) if top else x, b0.conv1, b0.bn1, stride=2,
                        padding=(0, 1), pad_rows=pad)  # rows: 9, and the zero row
    # Stride-2 1x1 shortcut: even window rows only — local rows 0, 2, ..
    # for the top edge; the bottom edge's even rows start at local row 3.
    sc = L.conv_bn_act(x if top else x[:, :, 3:], b0.shortcut[0], b0.shortcut_bn(),
                       relu=False, stride=2, padding=0)
    rows = out.shape[2] - 2  # the next conv's output: 9 -> 8
    sc = sc[:, :, :rows] if top else sc[:, :, -rows:]
    xp = _conv_rows(out, b0.conv2, b0.bn2, pad, residual=sc)  # [B, C2, 8, F2], padded

    out = _conv_rows(xp, b1.conv1, b1.bn1, pad)  # 8 -> 7
    x = _interior(xp, pad)
    return _conv_rows(out, b1.conv2, b1.bn2,  # 7 -> 6
                      residual=x[:, :, :-2] if top else x[:, :, 2:])


def _rows(base: torch.Tensor, offset: int, n: int, step: int = 1) -> torch.Tensor:
    """[B, n] row indices ``base + offset + step*i`` for a [B, 1] column of
    window starts."""
    return base + offset + step * torch.arange(n, device=base.device)[None, :]


def chunk_probs_from_track(model: ResNetFamily, track: torch.Tensor,
                           feats: torch.Tensor, start: int, count: int,
                           window: int = 100) -> torch.Tensor:
    """Probabilities for windows ``start .. start+count-1``.

    track: [T, C, F] = ``stem_track(model, feats)``; feats: [T, F] with
    T >= start + count + window - 1.  Returns [count] probs."""
    d = DEPTH
    w0 = start + torch.arange(count, device=feats.device)[:, None]
    interior = track[_rows(w0, d, window - 2 * d)]  # [B, L, C, F]
    top = _band_stem(model, feats[_rows(w0, 0, 2 * d)][:, None], top=True)
    bot = _band_stem(model, feats[_rows(w0, window - 2 * d, 2 * d)][:, None], top=False)
    x = torch.cat([top, interior.permute(0, 2, 1, 3), bot], dim=2)
    return model.tail(x, first_stage=2)


def chunk_probs_from_track2(model: ResNetFamily, track1: torch.Tensor,
                            track2: torch.Tensor, feats: torch.Tensor,
                            start: int, count: int, window: int = 100) -> torch.Tensor:
    """Like :func:`chunk_probs_from_track`, with stage 2 also shared: the
    per-window tensor materializes at half resolution, windows read stage-2
    interiors from ``track2`` (= ``stem_track2(model, track1)``) and only
    the DEPTH2-row edge bands run per window."""
    if not supports_track2(window):
        # An odd window runs clean (splice height off by one) and returns
        # silently wrong probabilities; refuse it.
        raise ValueError(
            f"chunk_probs_from_track2 requires supports_track2(window) "
            f"(even, window // 2 > {2 * DEPTH2}); got window={window}"
        )
    d, d2 = DEPTH, DEPTH2
    h2 = window // 2
    w0 = start + torch.arange(count, device=feats.device)[:, None]
    band1t = _band_stem(model, feats[_rows(w0, 0, 2 * d)][:, None], top=True)
    band1b = _band_stem(model, feats[_rows(w0, window - 2 * d, 2 * d)][:, None], top=False)
    # Stage-1 interior strips adjacent to each band.
    strip_t = track1[_rows(w0, d, 2 * d2 + 1)]
    blo = 2 * (h2 - d2 - 3) - 1
    strip_b = track1[_rows(w0, blo, window - d - blo)]
    # Stage-2 interior: window row m at half resolution = track position
    # w + 2m, for m in [DEPTH2, H2 - DEPTH2).
    interior = track2[_rows(w0, 2 * d2, h2 - 2 * d2, step=2)]
    band2t = _band2(model, band1t, strip_t, top=True)
    band2b = _band2(model, band1b, strip_b, top=False)
    x = torch.cat([band2t, interior.permute(0, 2, 1, 3), band2b], dim=2)
    return model.tail(x, first_stage=3)
