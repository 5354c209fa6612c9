"""Kaldi log-mel filterbank features in plain PyTorch, in float64.

The plain reference of the features a sweep classifies.  Kaldi's
``compute-fbank-feats`` semantics with Lhotse's ``Fbank`` defaults, which
the laughter-detection recipe featurizes with (the configuration file's
``features`` group gives the numbers):

- ``snip_edges`` false: ``T = (n + shift // 2) // shift`` frames, frame
  ``t`` starting at sample ``t * shift + shift // 2 - length // 2`` of the
  signal mirrored at both ends (sample ``-1`` is sample ``0``);
- per frame: the mean removed, preemphasis (each sample minus ``coeff``
  times the one before it, the first minus ``coeff`` times itself), the
  povey window (a Hann window to the power 0.85), zeros to the FFT size;
- the power spectrum, a bank of triangular filters evenly spaced on
  Kaldi's mel scale ``1127 ln(1 + f / 700)`` between ``low_hz`` and
  Nyquist plus ``high_hz`` (negative: below Nyquist), over the FFT's
  bins below Nyquist;
- the natural log, floored at ``energy_floor``; no dither.

16-bit PCM is scaled by 1 / 32768.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def mel_banks(feat: dict) -> np.ndarray:
    """[fft_size // 2 + 1, num_filters] triangular filters (float64); the
    Nyquist bin's row is zero."""
    sr, nfft, nmel = feat["sampling_rate"], feat["fft_size"], feat["num_filters"]
    mel = lambda f: 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)
    high = feat["high_hz"] if feat["high_hz"] > 0 else sr / 2 + feat["high_hz"]
    lo, hi = mel(feat["low_hz"]), mel(high)
    step = (hi - lo) / (nmel + 1)
    out = np.zeros((nfft // 2 + 1, nmel))
    m = mel(np.arange(nfft // 2) * sr / nfft)
    for j in range(nmel):
        left, center, right = lo + j * step, lo + (j + 1) * step, lo + (j + 2) * step
        rise = (m > left) & (m <= center)
        fall = (m > center) & (m < right)
        out[: nfft // 2][rise, j] = (m[rise] - left) / (center - left)
        out[: nfft // 2][fall, j] = (right - m[fall]) / (right - center)
    return out


def num_frames(n: int, feat: dict) -> int:
    shift = feat["frame_shift_samples"]
    return (n + shift // 2) // shift


def fbank(pcm, feat: dict, device="cpu", block: int = 8192) -> torch.Tensor:
    """One channel of int16 (or float in [-1, 1]) PCM -> [T, num_filters]
    float64 log-mel features on ``device``, ``block`` frames at a time."""
    x = torch.as_tensor(np.asarray(pcm)).to(device)
    x = x.double() / 32768.0 if x.dtype == torch.int16 else x.double()
    n = x.shape[0]
    shift, length, nfft = feat["frame_shift_samples"], feat["frame_length_samples"], feat["fft_size"]
    t = num_frames(n, feat)
    first = shift // 2 - length // 2
    i = torch.arange(length, device=device)
    hann = 0.5 - 0.5 * torch.cos(2.0 * math.pi * i / (length - 1))
    window = hann.double() ** 0.85
    banks = torch.from_numpy(mel_banks(feat)).to(device)
    out = []
    for lo in range(0, t, block):
        starts = torch.arange(lo, min(lo + block, t), device=device) * shift + first
        idx = starts[:, None] + i[None, :]
        idx = torch.where(idx < 0, -idx - 1, idx)  # mirror the head
        idx = torch.where(idx >= n, 2 * n - 1 - idx, idx)  # and the tail
        frames = x[idx]
        frames = frames - frames.mean(dim=1, keepdim=True)
        prev = torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
        frames = (frames - feat["preemph_coeff"] * prev) * window
        power = torch.fft.rfft(frames, n=nfft).abs() ** 2
        out.append(torch.log(torch.clamp(power @ banks, min=feat["energy_floor"])))
    return torch.cat(out) if out else torch.zeros((0, feat["num_filters"]), dtype=torch.float64,
                                                  device=device)


def windows_at(feats: torch.Tensor, frames, window: int) -> torch.Tensor:
    """The classifier's input for each frame in ``frames``: the ``window``
    feature rows starting at it, rows past the last frame zero -> [len(frames),
    1, window, F]."""
    t, f = feats.shape
    padded = torch.cat([feats, feats.new_zeros((window - 1, f))])
    idx = torch.as_tensor(np.asarray(frames), device=feats.device)[:, None] + torch.arange(
        window, device=feats.device)[None, :]
    return padded[idx][:, None]
