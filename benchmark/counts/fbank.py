"""The least work of the log-mel features, counted from the shapes.

Per frame: the frame's preprocessing (mean, preemphasis, window: four
operations a sample), a real FFT of ``fft_size`` points (the split-radix
count, ``2.5 n log2 n``), the power of each bin below Nyquist plus it
(three operations), the product with the mel filters' nonzero weights (two
operations each) and one log a filter.  Bytes: the op's float32 input read
once and its float32 features written once, whatever a kernel reads again.
"""

from __future__ import annotations

import math

import numpy as np


def flops_per_frame(feat: dict, mel_nonzero: int) -> float:
    n, length = feat["fft_size"], feat["frame_length_samples"]
    return 4 * length + 2.5 * n * math.log2(n) + 3 * (n // 2 + 1) + 2 * mel_nonzero \
        + feat["num_filters"]


def mel_nonzero(banks: np.ndarray) -> int:
    return int(np.count_nonzero(banks))


def launch_bounds(feat: dict, rows: int, samples: int, frames: int, mel_nnz: int,
                  flops_peak: float, bytes_peak: float):
    """(seconds bound by operations, seconds bound by bytes) of one launch
    over ``rows`` buffers of ``samples`` float32 samples, ``frames`` frames
    each."""
    flops = rows * frames * flops_per_frame(feat, mel_nnz)
    nbytes = rows * (samples + frames * feat["num_filters"]) * 4
    return flops / flops_peak, nbytes / bytes_peak
