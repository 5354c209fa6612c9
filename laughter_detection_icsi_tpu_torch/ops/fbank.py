"""Kaldi-compatible log-mel filterbank (Fbank) featurizer in plain PyTorch.

The plain version of the fbank kernel (ops/fbank_cuda.py): the CPU path,
and the reference the kernel is held against on the card.  It re-derives
the JAX package's numpy bases (``_mel_banks``, ``_window_fn``,
``_effective_bases``) and computes the same two formulations:

- the default folded path (``_fbank_folded``): DC removal, preemphasis 0.97
  and the povey window are linear in the frame, so they are folded into
  the cos/sin DFT bases once on host (float64), and frame r = wave[160r :
  160r + 400] is read as rows r, r+1 and the head of row r+2 of the
  [*, 160] wave view — three matmuls per basis, no gather;
- the sequential path (``fold_preproc=False``): framing by gather, then
  each preprocessing step in order, as Kaldi writes it.

Kaldi semantics (matching Lhotse FbankConfig defaults): snip_edges=False
framing with symmetric edge padding, T = (n + shift//2) // shift frames;
power spectrum over FFT bins 0..255 of a 512-point DFT (the Nyquist bin's
mel weights are zero); Kaldi mel scale 1127*ln(1+f/700), 20 Hz to
Nyquist-400 Hz; ``log(max(mel, energy_floor))``.  dither must be 0.

Input: float waveform in [-1, 1], ``[..., n]``; output ``[..., T, F]``.
Matmuls run in float32 on whatever device the waveform lies on; on a card
call it inside ``inference.strict_fp32()`` so TF32 stays off.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from laughter_detection_icsi_tpu_torch.config import FEAT, FeatConfig
from laughter_detection_icsi_tpu_torch.host_prep import num_frames, pad_amounts

# --------------------------------------------------------------------------- #
# Host-side bases (numpy, float64 then float32; cached per config)
# --------------------------------------------------------------------------- #


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


@functools.lru_cache(maxsize=8)
def _mel_banks(cfg: FeatConfig) -> np.ndarray:
    """Kaldi triangular mel filterbank, shape [fft//2 + 1, num_filters].
    The Nyquist row is all-zero (Kaldi computes bins over fft_size//2)."""
    nfft = cfg.fft_size
    num_bins = cfg.num_filters
    nyquist = cfg.sampling_rate / 2.0
    high_freq = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    mel_low = mel_scale(cfg.low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    num_fft_bins = nfft // 2
    fft_freqs = np.arange(num_fft_bins, dtype=np.float64) * (
        cfg.sampling_rate / nfft
    )
    mel = mel_scale(fft_freqs)[:, None]  # [num_fft_bins, 1]

    left = mel_low + np.arange(num_bins, dtype=np.float64) * mel_delta
    center = left + mel_delta
    right = center + mel_delta
    up = (mel - left[None, :]) / (center - left)[None, :]
    down = (right[None, :] - mel) / (right - center)[None, :]
    weights = np.where(
        (mel > left[None, :]) & (mel <= center[None, :]),
        up,
        np.where((mel > center[None, :]) & (mel < right[None, :]), down, 0.0),
    )
    out = np.zeros((nfft // 2 + 1, num_bins), dtype=np.float32)
    out[:num_fft_bins] = weights.astype(np.float32)
    return out


@functools.lru_cache(maxsize=8)
def _window_fn(cfg: FeatConfig) -> np.ndarray:
    n = cfg.frame_length_samples
    a = 2.0 * math.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(a * i)
    if cfg.window_type == "povey":
        w = hann**0.85
    elif cfg.window_type == "hanning":
        w = hann
    elif cfg.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif cfg.window_type == "rectangular":
        w = np.ones(n)
    else:
        raise ValueError(f"unknown window_type {cfg.window_type!r}")
    return w.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_bases(nfft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real-DFT cos/sin bases, each [nfft, nfft//2 + 1] (float32)."""
    k = np.arange(nfft // 2 + 1, dtype=np.float64)
    n = np.arange(nfft, dtype=np.float64)
    angle = 2.0 * math.pi * np.outer(n, k) / nfft
    return np.cos(angle).astype(np.float32), (-np.sin(angle)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _effective_bases(cfg: FeatConfig) -> Tuple[np.ndarray, np.ndarray]:
    """DFT bases with the per-frame preprocessing folded in:
    ``spectral = frame @ (M^T @ basis)`` with ``M = diag(win) @ P @ D``
    (window, banded preemphasis with Kaldi's edge row, DC removal),
    computed once in float64.  Returns (cos_eff, sin_eff), each
    [frame_length_samples, nfft//2 + 1]."""
    flen = cfg.frame_length_samples
    nfft = cfg.fft_size
    m = np.eye(flen, dtype=np.float64)
    if cfg.remove_dc_offset:
        m = m - np.full((flen, flen), 1.0 / flen)
    if cfg.preemph_coeff != 0.0:
        p = np.eye(flen, dtype=np.float64)
        idx = np.arange(1, flen)
        p[idx, idx - 1] = -cfg.preemph_coeff
        p[0, 0] = 1.0 - cfg.preemph_coeff
        m = p @ m
    m = np.diag(_window_fn(cfg).astype(np.float64)) @ m
    k = np.arange(nfft // 2 + 1, dtype=np.float64)
    n = np.arange(flen, dtype=np.float64)
    angle = 2.0 * math.pi * np.outer(n, k) / nfft
    cos_b, sin_b = np.cos(angle), -np.sin(angle)
    return (
        (m.T @ cos_b).astype(np.float32),
        (m.T @ sin_b).astype(np.float32),
    )


@functools.lru_cache(maxsize=16)
def _device_bases(cfg: FeatConfig, device: torch.device):
    """The folded bases and the mel bank as tensors on ``device``, uploaded
    once per (config, device)."""
    cos_eff, sin_eff = _effective_bases(cfg)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return as_t(cos_eff), as_t(sin_eff), as_t(_mel_banks(cfg))


# --------------------------------------------------------------------------- #
# Framing
# --------------------------------------------------------------------------- #


def symmetric_pad(wave: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """numpy's ``mode='symmetric'`` padding of the last axis, including
    repeated mirroring when a pad exceeds the length: the padded signal is
    the 2n-periodic extension [x, reversed(x), x, ...]."""
    n = wave.shape[-1]
    idx = torch.arange(-left, n + right, device=wave.device) % (2 * n)
    idx = torch.where(idx >= n, 2 * n - 1 - idx, idx)
    return wave[..., idx]


def _pad_for_framing(waveform: torch.Tensor, cfg: FeatConfig) -> torch.Tensor:
    """snip_edges=False symmetric padding (no-op when snip_edges)."""
    if cfg.snip_edges:
        return waveform
    n = waveform.shape[-1]
    left, right = pad_amounts(n, cfg)
    if right < 0:
        # Short-frame geometry (see pad_amounts): drop the tail samples
        # Kaldi never reads.
        waveform = waveform[..., : n + right]
        right = 0
    return symmetric_pad(waveform, left, right)


def frame_waveform(waveform: torch.Tensor, cfg: FeatConfig = FEAT) -> torch.Tensor:
    """[..., n] float waveform -> [..., T, frame_length_samples] frames."""
    n = waveform.shape[-1]
    shift = cfg.frame_shift_samples
    flen = cfg.frame_length_samples
    t = num_frames(n, cfg)
    if t == 0:
        return waveform.new_zeros((*waveform.shape[:-1], 0, flen))
    padded = _pad_for_framing(waveform, cfg)
    dev = waveform.device
    idx = (
        torch.arange(t, device=dev)[:, None] * shift
        + torch.arange(flen, device=dev)[None, :]
    )
    return padded[..., idx]


# --------------------------------------------------------------------------- #
# The featurizer
# --------------------------------------------------------------------------- #


def _fbank_folded(waveform: torch.Tensor, cfg: FeatConfig) -> torch.Tensor:
    """Matmul-only featurizer against the folded bases: frame r decomposes
    into rows r, r+1 and the head of row r+2 of the [*, shift] wave view
    (valid while 2*shift < flen <= 3*shift, the Kaldi 25 ms / 10 ms
    geometry)."""
    shift = cfg.frame_shift_samples
    flen = cfg.frame_length_samples
    tail = flen - 2 * shift
    t = num_frames(waveform.shape[-1], cfg)
    padded = _pad_for_framing(waveform.float(), cfg)
    need = (t + 2) * shift
    pad = need - padded.shape[-1]
    if pad > 0:
        padded = torch.nn.functional.pad(padded, (0, pad))
    rows = padded[..., :need].reshape(*padded.shape[:-1], t + 2, shift)
    p1 = rows[..., :t, :]
    p2 = rows[..., 1 : t + 1, :]
    p3 = rows[..., 2 : t + 2, :tail]

    cos_eff, sin_eff, mel_banks = _device_bases(cfg, waveform.device)
    re = (
        p1 @ cos_eff[:shift]
        + p2 @ cos_eff[shift : 2 * shift]
        + p3 @ cos_eff[2 * shift :]
    )
    im = (
        p1 @ sin_eff[:shift]
        + p2 @ sin_eff[shift : 2 * shift]
        + p3 @ sin_eff[2 * shift :]
    )
    power = re * re + im * im
    mel = power @ mel_banks
    return torch.log(torch.clamp(mel, min=cfg.energy_floor))


def fbank(
    waveform: torch.Tensor, cfg: FeatConfig = FEAT, fold_preproc: bool = True
) -> torch.Tensor:
    """Log-mel features: [..., n] waveform -> [..., T, num_filters] float32.

    The default path folds the per-frame preprocessing into the DFT bases
    (``_fbank_folded``); ``fold_preproc=False`` keeps the sequential
    reference ops (also the path for non-Kaldi frame geometries)."""
    if cfg.dither:
        # A deterministic featurizer by design; dropping the knob silently
        # would fake parity with a dithering extractor.
        raise NotImplementedError(
            "dither != 0 is not implemented (features are deterministic)"
        )
    shift = cfg.frame_shift_samples
    flen = cfg.frame_length_samples
    if (
        fold_preproc
        and 2 * shift < flen <= 3 * shift
        and num_frames(waveform.shape[-1], cfg) > 0
    ):
        return _fbank_folded(waveform, cfg)
    frames = frame_waveform(waveform.float(), cfg)
    if cfg.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if cfg.preemph_coeff != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - cfg.preemph_coeff * prev
    dev = frames.device
    frames = frames * torch.from_numpy(_window_fn(cfg)).to(dev)

    cos_b, sin_b = _dft_bases(cfg.fft_size)
    # Frames are zero beyond flen, so contract only the first flen rows.
    re = frames @ torch.from_numpy(cos_b[:flen]).to(dev)
    im = frames @ torch.from_numpy(sin_b[:flen]).to(dev)
    power = re * re + im * im
    mel = power @ torch.from_numpy(_mel_banks(cfg)).to(dev)
    return torch.log(torch.clamp(mel, min=cfg.energy_floor))
