"""The one traffic generator: meetings of PCM and training splits from a
seed and a traffic file's parameters.

``speech_like_pcm`` is a frozen copy of the port's bench generator
(``laughter_detection_icsi_tpu_torch/bench.py``, as it stood when this
benchmark was written): close-talk-like int16 audio, a 2-pole resonator
around 500 Hz over white noise, gains by 250 ms segment (60% a silent
floor, 35% speech, 5% loud) with 10 ms ramps, and a microphone floor.
``meeting_pool`` builds a sweep's meetings with that structure in bulk:
the channels of all meetings read one resonated source and one floor at
offsets drawn from the seed, each channel with segment gains of its own.
``train_split`` draws a resident split of 1 s log-mel-like windows, half
of them labelled laughter, and ``batch_orders`` an epoch's shuffle after
another.  The same seed gives the same traffic; every seed gives the same
sizes.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


def speech_like_pcm(seconds: int, sr: int = 16000, seed: int = 23) -> np.ndarray:
    """Synthetic close-talk meeting audio with ICSI-like structure: mostly
    near-silence broken by speech bursts, plus occasional loud
    (laughter-like) events, as int16."""
    n = sr * seconds
    rng = np.random.default_rng(seed)
    theta = 2 * np.pi * 500 / sr
    a1, a2 = -2 * 0.92 * np.cos(theta), 0.92**2
    e = rng.standard_normal(n).astype(np.float32)
    taps = 1024  # |h| < 1e-7 past ~200 taps at r=0.92
    h = np.zeros(taps)
    h[0] = 1.0
    h[1] = -a1
    for i in range(2, taps):
        h[i] = -a1 * h[i - 1] - a2 * h[i - 2]
    size = 1 << int(n + taps - 1).bit_length()
    x = np.fft.irfft(np.fft.rfft(e, size) * np.fft.rfft(h, size), size)[:n]
    x = x.astype(np.float32)
    x /= np.abs(x).max()
    seg = sr // 4
    n_segs = -(-n // seg)
    kind = rng.choice(3, size=n_segs, p=[0.60, 0.35, 0.05])
    gain_by_kind = np.array([0.002, 0.08, 0.30], dtype=np.float32)
    gains = np.repeat(gain_by_kind[kind], seg)[:n]
    ramp = np.ones(sr // 100, dtype=np.float32) / (sr // 100)
    gains = np.convolve(gains, ramp, mode="same")
    mic_floor = rng.standard_normal(n).astype(np.float32) * 0.0015
    wave = np.clip(x * gains + mic_floor, -1.0, 1.0)
    return (wave * 32767.0).astype(np.int16)


def _resonated(n: int, sr: int, hz: float, r: float, rng) -> np.ndarray:
    """White noise through the 2-pole resonator, scaled to peak 1: the
    convolution of ``speech_like_pcm`` (its impulse response cut at 1,024
    taps), by torch's FFT on the host."""
    import torch

    theta = 2 * np.pi * hz / sr
    a1, a2 = -2 * r * np.cos(theta), r**2
    h = np.zeros(1024)
    h[0], h[1] = 1.0, -a1
    for i in range(2, len(h)):
        h[i] = -a1 * h[i - 1] - a2 * h[i - 2]
    e = torch.from_numpy(rng.standard_normal(n, dtype=np.float32))
    size = 1 << int(n + len(h) - 1).bit_length()
    spec = torch.fft.rfft(e, size) * torch.fft.rfft(torch.from_numpy(h.astype(np.float32)), size)
    x = torch.fft.irfft(spec, size)[:n].numpy()
    return x / np.abs(x).max()


def segment_gains(levels: np.ndarray, kind: np.ndarray, seg: int, n: int, ramp: int) -> np.ndarray:
    """Gains by segment, each change a linear ramp of ``ramp`` samples
    centred on it and the two ends faded over half of one: exactly
    ``np.convolve(np.repeat(levels[kind], seg)[:n], box(ramp), 'same')`` of
    ``speech_like_pcm``, for ``ramp`` up to ``seg``."""
    g = np.repeat(levels[kind], seg)[:n]
    half = ramp // 2
    off = np.arange(-half, ramp - half)
    w = ((off + ramp - half) / ramp).astype(np.float32)
    b = np.arange(1, len(kind)) * seg
    b = b[b + off[-1] < n]
    u, v = levels[kind[: len(b)]], levels[kind[1 : len(b) + 1]]
    g[b[:, None] + off[None, :]] = u[:, None] + (v - u)[:, None] * w[None, :]
    g[:half] *= ((np.arange(half) + ramp - half) / ramp).astype(np.float32)
    g[n - (ramp - half) + 1:] *= ((np.arange(ramp - half - 1, 0, -1) + half) / ramp).astype(np.float32)
    return g


def meeting_pool(tr: dict, seed: int) -> List[np.ndarray]:
    """``tr['pool_meetings']`` meetings, each int16 [channels, seconds x sr]."""
    sr, n = tr["sampling_rate"], tr["sampling_rate"] * tr["meeting_seconds"]
    rng = np.random.default_rng([seed, 0])
    spare = sr * tr["offset_max_seconds"]
    source = _resonated(n + spare, sr, tr["resonator_hz"], tr["resonator_r"], rng)
    floor = rng.standard_normal(n + spare, dtype=np.float32) * np.float32(tr["mic_floor"])
    seg = int(round(sr * tr["segment_seconds"]))
    n_segs = -(-n // seg)
    mix = [tr["segment_mix"][k] for k in ("floor", "speech", "loud")]
    levels = np.asarray(tr["segment_gains"], dtype=np.float32)
    pool = []
    for _ in range(tr["pool_meetings"]):
        pcm = np.empty((tr["channels"], n), dtype=np.int16)
        for c in range(tr["channels"]):
            a, b = rng.integers(0, spare, size=2)
            gains = segment_gains(levels, rng.choice(3, size=n_segs, p=mix), seg, n, sr // 100)
            wave = np.clip(source[a:a + n] * gains + floor[b:b + n], -1.0, 1.0)
            pcm[c] = wave * np.float32(32767.0)
        pool.append(pcm)
    return pool


def train_split(tr: dict, seed: int):
    """(features [rows, window, bins] float32, labels [rows] float32): log-mel
    like rows (a level per bin, unit-scale noise), half labelled laughter,
    whose rows carry a seeded offset per bin."""
    rng = np.random.default_rng([seed, 1])
    rows, w, f = tr["rows"], tr["window"], tr["num_filters"]
    level = rng.uniform(*tr["bin_level_range"], size=f).astype(np.float32)
    shift = rng.normal(0.0, tr["laugh_shift_std"], size=f).astype(np.float32)
    feats = rng.standard_normal((rows, w, f), dtype=np.float32)
    feats *= np.float32(tr["noise_std"])
    feats += level
    labels = np.zeros(rows, dtype=np.float32)
    labels[rng.permutation(rows)[: rows // 2]] = 1.0
    feats += labels[:, None, None] * shift
    return feats, labels


def batch_orders(rows: int, batch: int, seed: int) -> Iterator[Iterator[np.ndarray]]:
    """Epoch after epoch, each a fresh shuffle of the rows in whole batches
    (the remainder dropped)."""
    epoch = 0
    while True:
        perm = np.random.default_rng([seed, 2, epoch]).permutation(rows)
        yield (perm[i:i + batch] for i in range(0, rows - rows % batch, batch))
        epoch += 1
