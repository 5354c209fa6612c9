"""The fbank kernel: hand-written CUDA for Hopper, bound with ctypes and
registered as a custom op.

``fbank_cuda`` is the featurizer every port path calls.  It calls the
custom op ``torch.ops.laughter_icsi_torch.fbank`` (registered when this
module is imported), so the live pipeline and an exported graph
(``export.py``) take one route.  On a CUDA tensor the op launches
``csrc/fbank.cu`` (which replaces the JAX package's Pallas kernel
``ops/fbank_pallas.py:_fbank_kernel``; the source note there says what
bounds it and how it is laid out); on a CPU tensor it runs the plain
version, ``ops/fbank.fbank``.  There is no fallback between the two: a CUDA
tensor the kernel does not take raises.  The op's fake gives the output's
shape from the input's alone, which lets ``torch.export`` trace it.

The kernel is built on first use with ``nvcc`` (``ops/nvcc.py``) into
``build/torch_kernels/`` at the root of the checkout, as a shared library
with a plain C interface, and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import numpy as np
import torch

from laughter_detection_icsi_tpu_torch.config import FEAT, FeatConfig
from laughter_detection_icsi_tpu_torch.host_prep import num_frames
from laughter_detection_icsi_tpu_torch.ops import fbank as fbank_ops
from laughter_detection_icsi_tpu_torch.ops import nvcc

#: Kernel launches so far (the wrapper adds one per launch, nowhere else):
#: lets a run show that its main path went through the kernel.
launches = 0

#: Compile-time shape of the kernel (csrc/fbank.cu): 256 DFT bins (a
#: 512-point FFT), 16-row basis tiles (``fbank_launch`` refuses a basis
#: depth off this multiple).
N_BINS = 256
TILE_K = 16


def build() -> Path:
    """Compile ``csrc/fbank.cu`` unless this source is already built
    (``ops/nvcc.build``).  Returns the library's path."""
    return nvcc.build("fbank.cu")


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.fbank_launch.argtypes = [p, p, p, p, p, i, ll, i, i, i, i, f, p]
    lib.fbank_launch.restype = ctypes.c_int
    lib.fbank_frames_per_block.argtypes = []
    lib.fbank_frames_per_block.restype = ctypes.c_int
    return lib


def frames_per_block() -> int:
    """Frames one block of the kernel computes, as the built library
    reports it (builds the kernel on first use)."""
    return _library().fbank_frames_per_block()


@functools.lru_cache(maxsize=None)
def kernel_constants(cfg: FeatConfig, device: torch.device):
    """(basis [kpad, 512], mel [256, n_mels], mel_range [n_mels, 2]) on
    ``device``, made once for each configuration and card (unbounded: a
    process featurizes with two configurations, the buckets' and the
    feature cache's, so 16 entries would fill at 8 cards and evict from
    then on; an entry is ~0.9 MB): the preprocessing-folded cos and sin bases with the Nyquist
    bin dropped and their n8-tiles interleaved (columns 16j..16j+7 are cos
    bins 8j..8j+7, columns 16j+8..16j+15 sin bins 8j..8j+7, so re and im of
    a bin land in the same lane of the kernel's mma fragments), one float32
    copy (the kernel splits it into tf32 hi and lo in registers), zero rows
    up to a multiple of TILE_K; the mel bank without its (all-zero) Nyquist
    row, and each filter's nonzero bin range."""
    flen = cfg.frame_length_samples
    kpad = -(-flen // TILE_K) * TILE_K
    cos_eff, sin_eff = fbank_ops._effective_bases(cfg)
    basis = np.zeros((kpad, 2 * N_BINS), dtype=np.float32)
    tiles = basis[:flen].reshape(flen, N_BINS // 8, 2, 8)  # [k, bin group, cos|sin, 8]
    tiles[:, :, 0] = cos_eff[:, :N_BINS].reshape(flen, N_BINS // 8, 8)
    tiles[:, :, 1] = sin_eff[:, :N_BINS].reshape(flen, N_BINS // 8, 8)
    mel = np.ascontiguousarray(fbank_ops._mel_banks(cfg)[:N_BINS])
    mel_range = np.zeros((mel.shape[1], 2), dtype=np.int32)
    for m in range(mel.shape[1]):
        nz = np.nonzero(mel[:, m])[0]
        if nz.size:
            mel_range[m] = (nz[0], nz[-1] + 1)
    as_t = lambda a: torch.from_numpy(a).to(device)
    return as_t(basis), as_t(mel), as_t(mel_range)


def check_config(cfg: FeatConfig) -> None:
    """Raise on a configuration the kernel does not take: dither, a frame
    geometry outside 2*shift < frame_length <= 3*shift (the TPU kernel's
    limits), a shift that is not a multiple of 8 (an 8-deep k-step must not
    cross a row of the kernel's staged wave tile), or another DFT size than
    its fixed 256 bins."""
    if cfg.dither:
        raise NotImplementedError(
            "dither != 0 is not implemented (features are deterministic)"
        )
    shift = cfg.frame_shift_samples
    flen = cfg.frame_length_samples
    if not 2 * shift < flen <= 3 * shift:
        raise NotImplementedError(
            "fbank_cuda assumes 2*shift < frame_length <= 3*shift "
            f"(got shift={shift}, frame_length={flen})"
        )
    if shift % 8:
        raise NotImplementedError(
            f"fbank_cuda needs a frame shift that is a multiple of 8 samples "
            f"(got {shift}); use ops.fbank"
        )
    if cfg.fft_size // 2 != N_BINS:
        raise NotImplementedError(
            f"fbank_cuda is built for a {2 * N_BINS}-point DFT "
            f"(got fft_size={cfg.fft_size}); use ops.fbank"
        )


def fbank_cuda(waveform: torch.Tensor, cfg: FeatConfig = FEAT) -> torch.Tensor:
    """[..., n] float32 waveform -> [..., T, num_filters] log-mel, with the
    semantics of ``ops.fbank.fbank`` (snip_edges=False padding applied here,
    on the device, when ``cfg`` asks for it), through the custom op.

    A CPU tensor runs the plain version.  A CUDA tensor launches the kernel
    once for the whole batch: leading dims flatten onto the grid, so every
    batch row is computed exactly as it would be alone."""
    return torch.ops.laughter_icsi_torch.fbank(waveform, *op_args(cfg))


def op_args(cfg: FeatConfig) -> tuple:
    """``cfg``'s fields in order: the op's arguments after the waveform
    (an op takes plain ints, floats, bools and strings, not a dataclass)."""
    return dataclasses.astuple(cfg)


@torch.library.custom_op("laughter_icsi_torch::fbank", mutates_args=(), device_types="cpu")
def _fbank_op(
    waveform: torch.Tensor, num_samples: int, num_filters: int, sampling_rate: int,
    frame_length: float, preemph_coeff: float, remove_dc_offset: bool, window_type: str,
    dither: float, snip_edges: bool, energy_floor: float, low_freq: float, high_freq: float,
    round_to_power_of_two: bool,
) -> torch.Tensor:
    """The op on a CPU tensor: the plain featurizer."""
    cfg = FeatConfig(num_samples, num_filters, sampling_rate, frame_length, preemph_coeff,
                     remove_dc_offset, window_type, dither, snip_edges, energy_floor,
                     low_freq, high_freq, round_to_power_of_two)
    return fbank_ops.fbank(waveform, cfg)


@_fbank_op.register_kernel("cuda")
def _fbank_launch(waveform: torch.Tensor, *fields) -> torch.Tensor:
    """The op on a CUDA tensor: one launch of the kernel (built on first
    use), counted in ``launches``."""
    global launches
    cfg = FeatConfig(*fields)
    check_config(cfg)
    if waveform.dtype != torch.float32:
        raise TypeError(f"fbank_cuda wants float32, got {waveform.dtype}")
    if not waveform.is_contiguous():
        raise ValueError("fbank_cuda wants a contiguous waveform")
    batch_shape = waveform.shape[:-1]
    t = num_frames(waveform.shape[-1], cfg)
    if t == 0:
        return waveform.new_zeros((*batch_shape, 0, cfg.num_filters))
    wave = fbank_ops._pad_for_framing(waveform, cfg)
    wave = wave.reshape(-1, wave.shape[-1]).contiguous()
    basis, mel, mel_range = kernel_constants(cfg, waveform.device)
    out = torch.empty(
        (wave.shape[0], t, cfg.num_filters), dtype=torch.float32,
        device=waveform.device,
    )
    lib = _library()
    with torch.cuda.device(waveform.device):
        err = lib.fbank_launch(
            wave.data_ptr(), basis.data_ptr(), mel.data_ptr(),
            mel_range.data_ptr(), out.data_ptr(), wave.shape[0], wave.shape[-1],
            t, cfg.frame_shift_samples, basis.shape[0], cfg.num_filters,
            cfg.energy_floor, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fbank kernel launch failed (cudaError {err})")
    launches += 1
    return out.reshape(*batch_shape, t, cfg.num_filters)


@_fbank_op.register_fake
def _fbank_fake(waveform: torch.Tensor, *fields) -> torch.Tensor:
    """[..., T, num_filters] float32 from the input's shape alone."""
    cfg = FeatConfig(*fields)
    t = num_frames(waveform.shape[-1], cfg)
    return waveform.new_empty((*waveform.shape[:-1], t, cfg.num_filters), dtype=torch.float32)
