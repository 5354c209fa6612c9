"""Host-side framing geometry: Kaldi frame counts, snip_edges=False
reflection padding, the bucket buffer length, and the host prep of an
exported e2e artifact's inputs (``bucket_inputs``).  The clips mode (the
AST preset) frames with ``snip_edges`` and reads each bucket with
``clip_frames - hop_frames`` frames of context around its blocks
(``bucket_start``, ``clip_bounds``): the port's own, without a JAX twin.

A copy of the JAX package's ``host_prep.py`` (numpy + config only), so the
port's bucket plan is the same arithmetic as the reference pipeline's.  A
host that only runs exported artifacts needs this module, the port's
``config`` and ``export.load``, and no model code.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from laughter_detection_icsi_tpu_torch.config import FEAT, FeatConfig


def num_frames(num_samples: int, cfg: FeatConfig = FEAT) -> int:
    """Frame count for a waveform of ``num_samples`` samples."""
    shift = cfg.frame_shift_samples
    if cfg.snip_edges:
        if num_samples < cfg.frame_length_samples:
            return 0
        return 1 + (num_samples - cfg.frame_length_samples) // shift
    return (num_samples + shift // 2) // shift


def pad_amounts(num_samples: int, cfg: FeatConfig = FEAT) -> Tuple[int, int]:
    """(left, right) symmetric padding for snip_edges=False framing.

    ``left`` follows Kaldi's FirstSampleOfFrame with PER-TERM integer
    truncation: frame 0 begins at ``shift/2 - flen/2``, so the left pad is
    ``flen//2 - shift//2``.

    ``right`` may be NEGATIVE for short-frame geometries (flen <= 2*shift):
    the last frame then ends BEFORE the waveform does and Kaldi never reads
    the tail samples — consumers must truncate to ``num_samples + right``.
    """
    shift = cfg.frame_shift_samples
    flen = cfg.frame_length_samples
    t = num_frames(num_samples, cfg)
    new_len = (t - 1) * shift + flen
    npad = new_len - num_samples
    npad_left = flen // 2 - shift // 2
    return npad_left, npad - npad_left


def snip_cfg(cfg: FeatConfig) -> FeatConfig:
    """The snip_edges=True twin of ``cfg`` (bucket buffers are padded on
    host, so the featurizer frames them with simple strides)."""
    return dataclasses.replace(cfg, snip_edges=True)


def host_pad_waveform(
    wave: np.ndarray, cfg: FeatConfig = FEAT
) -> Tuple[np.ndarray, int]:
    """Apply Kaldi's snip_edges=False symmetric padding on host.

    Returns (padded_wave, num_frames): framing the padded wave with simple
    strides reproduces the exact reference frames.  Dtype-preserving (int16
    PCM stays int16 for the cheap device transfer).
    """
    if cfg.snip_edges:
        raise ValueError(
            "host_pad_waveform implements snip_edges=False reflection "
            "padding; a snip_edges=True FeatConfig must not reach it"
        )
    n = len(wave)
    t = num_frames(n, cfg)
    if t == 0:
        return np.zeros(0, dtype=wave.dtype), 0
    left, right = pad_amounts(n, cfg)
    if right < 0:
        wave = wave[: n + right]
        right = 0
    # mode='symmetric' == Kaldi's edge mirroring, and stays well-defined
    # (repeated mirroring) when a pad exceeds the wave length.
    padded = np.pad(wave, (left, right), mode="symmetric")
    return padded, t


@dataclasses.dataclass(frozen=True)
class BucketGeometry:
    """The two knobs of bucket shape, free of model code.

    Defaults MUST equal inference.InferenceSettings' (window, bucket_frames)
    defaults — an exported artifact and its host prep have to agree on the
    buffer length with neither side importing the other.  Pinned by
    tests/test_torch_export.py.  Any object with these two attributes (e.g. an
    ``InferenceSettings``) is accepted wherever a BucketGeometry is.
    """

    window: int = 100
    bucket_frames: int = 6144

    def __post_init__(self):
        # Same guard its twin InferenceSettings has: 0/negatives
        # would crash far away (ZeroDivisionError in the bucket loop, a
        # silently wrong wave_len buffer) instead of at construction.
        for name in ("window", "bucket_frames"):
            v = getattr(self, name)
            if v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")


def is_clips(settings) -> bool:
    return getattr(settings, "mode", "windows") == "clips"


def halo_frames(settings) -> int:
    """Frames a bucket reads past its own: ``window - 1``, or in the clips
    mode a clip's context on both sides, ``clip_frames - hop_frames``."""
    if is_clips(settings):
        return settings.clip_frames - settings.hop_frames
    return settings.window - 1


def clip_context(settings) -> int:
    """Frames a clip holds on each side of its block of ``hop_frames``."""
    return (settings.clip_frames - settings.hop_frames) // 2


def bucket_wave_len(settings, feat_cfg: FeatConfig = FEAT) -> int:
    """Samples one bucket reads: ``bucket + halo`` frames (the bucket plus
    its ``window - 1`` halo, or its clips' context) under snip_edges
    geometry.  ``settings`` is anything with ``bucket_frames``/``window``
    attributes (and the clip sizes in the clips mode)."""
    cfg = snip_cfg(feat_cfg)
    ext = settings.bucket_frames + halo_frames(settings)
    return (ext - 1) * cfg.frame_shift_samples + cfg.frame_length_samples


def host_pad(wave: np.ndarray, cfg: FeatConfig, settings) -> Tuple[np.ndarray, int]:
    """The mode's host prep: (the track as its buckets read it, its frame
    count).  :func:`host_pad_waveform` pads it, except in the clips mode,
    whose frames fit inside the audio (``cfg`` must say ``snip_edges``):
    the track is read as it is, from :func:`bucket_start`."""
    if not is_clips(settings):
        return host_pad_waveform(wave, cfg)
    if not cfg.snip_edges:
        raise ValueError("the clips mode frames with snip_edges=True; got a snip_edges=False "
                         "FeatConfig")
    return wave, num_frames(len(wave), cfg)


def bucket_start(k: int, settings, feat_cfg: FeatConfig = FEAT) -> int:
    """The sample of the host-prepared track (:func:`host_pad`) at which
    bucket ``k``'s buffer starts: ``k * bucket * shift``, less a clip's
    context in the clips mode, so the first bucket's buffer starts before
    the track (its frame ``j`` is the track's frame ``k * bucket + j -
    context``); :func:`copy_bucket` fills what lies outside with zeros."""
    start = k * settings.bucket_frames
    if is_clips(settings):
        start -= clip_context(settings)
    return start * snip_cfg(feat_cfg).frame_shift_samples


def copy_bucket(buf: np.ndarray, track: np.ndarray, start: int) -> None:
    """``buf[:] = track[start : start + len(buf)]``, where ``start`` may be
    negative; the rest of ``buf`` (a zeroed buffer) is left as it is."""
    at = max(-start, 0)
    src = track[start + at : max(start + len(buf), 0)]
    buf[at : at + len(src)] = src


def clip_bounds(t: int, k: int, settings) -> Tuple[int, int]:
    """[lo, hi): the frames of bucket ``k``'s buffer (``bucket +
    halo`` of them) that lie in a track of ``t`` frames, in the clips
    mode's geometry; lo == hi for none."""
    ext = settings.bucket_frames + halo_frames(settings)
    at = clip_context(settings) - k * settings.bucket_frames
    return int(np.clip(at, 0, ext)), int(np.clip(at + t, 0, ext))


def bucket_slices(padded: np.ndarray, t: int, settings, feat_cfg: FeatConfig = FEAT):
    """Yield ``(buf, valid, keep)`` per bucket of a recording padded by
    :func:`host_pad_waveform` to ``t`` frames: ``k * bucket * shift``
    slicing, zero-filled to :func:`bucket_wave_len` in ``padded``'s dtype;
    ``valid`` is the bucket's valid-frame count (its frames and their halo;
    in the clips mode, on the track :func:`host_pad` prepares, the
    :func:`clip_bounds` pair), ``keep`` how many leading output rows are its
    frames.  The one bucket plan of the offline pipeline
    (``LaughterPipeline.bucket_buffers``) and of the e2e artifact's host
    prep (:func:`bucket_inputs`)."""
    wave_len = bucket_wave_len(settings, feat_cfg)
    bucket = settings.bucket_frames
    for k in range(-(-t // bucket)):
        buf = np.zeros(wave_len, dtype=padded.dtype)
        copy_bucket(buf, padded, bucket_start(k, settings, feat_cfg))
        valid = (clip_bounds(t, k, settings) if is_clips(settings)
                 else min(t - k * bucket, bucket + settings.window - 1))
        yield buf, valid, min(bucket, t - k * bucket)


def bucket_inputs(
    wave, feat_cfg: Optional[FeatConfig] = None, settings=None
):
    """Host-side prep for the e2e artifact: yield ``(buf, valid, n_out)``
    per bucket for a whole recording.

    Pure numpy — the bucket loop of ``LaughterPipeline.probs_for_waveform_device``
    (Kaldi reflection padding via :func:`host_pad_waveform`, then
    :func:`bucket_slices`, which the pipeline runs too), so
    ``concat(artifact.call(buf, valid)[:n_out] for each bucket)`` equals the
    live pipeline's probabilities (pinned by tests/test_torch_export.py).

    Input contract (same as the live pipeline's): 1-D PCM, int16 or
    float32/float64 in [-1, 1]; float64 is narrowed to float32 exactly as
    ``probs_for_waveform`` does.  ``buf`` then preserves the working dtype
    (int16 stays int16 — feed it to an int16 artifact); ``valid`` is the
    bucket's valid-frame count (int32); ``n_out`` how many leading output
    rows are that bucket's frames.

    ``settings`` is anything with ``bucket_frames``/``window`` attributes;
    default :class:`BucketGeometry` (== InferenceSettings' defaults).
    """
    # Plain function wrapping an inner generator: the input validation
    # fires at CALL time like probs_for_waveform_device's (a generator
    # would defer it to first iteration — after the expensive artifact
    # load, or never, if the consumer zips against an empty iterable).
    feat_cfg = feat_cfg if feat_cfg is not None else FEAT
    settings = settings if settings is not None else BucketGeometry()
    wave = np.asarray(wave)
    if wave.ndim != 1:
        raise ValueError(
            f"bucket_inputs wants 1-D PCM, got shape {wave.shape}; "
            "pass one channel at a time"
        )
    if wave.dtype == np.float64:
        wave = wave.astype(np.float32)
    if wave.dtype not in (np.int16, np.float32):
        raise TypeError(
            f"bucket_inputs wants int16 or float32/float64 PCM, "
            f"got {wave.dtype}"
        )

    def _buckets():
        padded, t = host_pad_waveform(wave, feat_cfg)
        for buf, valid, keep in bucket_slices(padded, t, settings, feat_cfg):
            yield buf, np.int32(valid), keep

    return _buckets()
