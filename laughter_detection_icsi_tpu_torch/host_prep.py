"""Host-side framing geometry: Kaldi frame counts, snip_edges=False
reflection padding, and the bucket buffer length.

A copy of the JAX package's ``host_prep.py`` (numpy + config only), so the
port's bucket plan is the same arithmetic as the reference pipeline's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

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


def bucket_wave_len(settings, feat_cfg: FeatConfig = FEAT) -> int:
    """Samples one bucket reads: ``bucket + window - 1`` frames (the bucket
    plus its window-1 halo) under snip_edges geometry.  ``settings`` is
    anything with ``bucket_frames``/``window`` attributes."""
    cfg = snip_cfg(feat_cfg)
    ext = settings.bucket_frames + settings.window - 1
    return (ext - 1) * cfg.frame_shift_samples + cfg.frame_length_samples
