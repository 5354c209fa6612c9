"""The fbank kernel's host side and its precision argument, on the CPU.

csrc/fbank.cu computes the DFT on the tensor cores in 3xTF32: each operand
x is split into hi = tf32(x) (``cvt.rna``) and lo = tf32(x - hi), and the
product is hi*hi + hi*lo + lo*hi.  Here a numpy emulation of that
arithmetic (tf32 operands, float32 products and sums, then power, mel and
log) is held against the JAX package's ``fbank_jit`` at the feature
tolerance atol 2e-4 / rtol 1e-4 (tests/test_fbank_pallas.py), and a single
TF32 product is shown to miss it: that is why the kernel splits.
"""

import dataclasses

import numpy as np
import pytest
import torch

from laughter_detection_icsi_tpu.config import FEAT as JFEAT
from laughter_detection_icsi_tpu.ops import fbank as jfb
from laughter_detection_icsi_tpu_torch import host_prep
from laughter_detection_icsi_tpu_torch.config import FEAT
from laughter_detection_icsi_tpu_torch.ops import fbank as tfb
from laughter_detection_icsi_tpu_torch.ops import fbank_cuda

TOL = dict(atol=2e-4, rtol=1e-4)
SNIP = host_prep.snip_cfg(FEAT)


def tf32_split(x: np.ndarray):
    """The kernel's operand split (``split_tf32`` in csrc/fbank.cu), in
    numpy: ``hi = tf32(x)`` rounded to nearest with ties away from zero
    (``cvt.rna.tf32.f32``: 10 mantissa bits kept, the low 13 zeroed) and
    ``lo = tf32(x - hi)``, both float32."""

    def rna(v):
        bits = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
        return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)

    x = np.asarray(x, dtype=np.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def test_tf32_split_rounds_and_reconstructs(rng):
    x = np.concatenate([
        (rng.standard_normal(100_000) * 10.0 ** rng.integers(-8, 4, 100_000)),
        [0.0, 1.0, -1.0, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11],  # ties round away
    ]).astype(np.float32)
    hi, lo = tf32_split(x)
    assert hi.dtype == lo.dtype == np.float32
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    np.testing.assert_array_equal(hi[-5:], [0.0, 1.0, -1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-9])
    # hi is x rounded to nearest at 10 mantissa bits; hi + lo is x to 2^-22.
    np.testing.assert_array_less(np.abs(x - hi), 2.0**-11 * np.abs(x) + 1e-45)
    err = np.abs(hi.astype(np.float64) + lo - x)
    np.testing.assert_array_less(err, 2.0**-22 * np.abs(x) + 1e-45)


def test_interleaved_basis_deinterleaves():
    # 344-sample frames: the basis pads with 8 zero rows to a whole K-tile
    # (test_torch_fbank.py::test_kernel_constants_layout has the 400 case).
    cfg = dataclasses.replace(FEAT, frame_length=0.0215)
    basis, _, _ = fbank_cuda.kernel_constants(cfg, torch.device("cpu"))
    basis = basis.numpy()
    cos_eff, sin_eff = tfb._effective_bases(cfg)
    flen = cfg.frame_length_samples
    assert basis.shape == (-(-flen // fbank_cuda.TILE_K) * fbank_cuda.TILE_K, 512)
    tiles = basis.reshape(basis.shape[0], 32, 2, 8)  # [k, bin group, cos|sin, 8]
    np.testing.assert_array_equal(tiles[:flen, :, 0].reshape(flen, 256), cos_eff[:, :256])
    np.testing.assert_array_equal(tiles[:flen, :, 1].reshape(flen, 256), sin_eff[:, :256])
    assert not basis[flen:].any()


def _emulated(wave: np.ndarray, split: bool) -> np.ndarray:
    """The kernel's arithmetic in numpy under the snip geometry: tf32
    operands, exact products summed in float32, then power, the mel
    projection and the log."""
    t = host_prep.num_frames(wave.shape[-1], SNIP)
    shift, flen = SNIP.frame_shift_samples, SNIP.frame_length_samples
    frames = np.lib.stride_tricks.sliding_window_view(wave, flen)[::shift][:t]
    basis, mel, _ = fbank_cuda.kernel_constants(SNIP, torch.device("cpu"))
    a_hi, a_lo = tf32_split(frames)
    b_hi, b_lo = tf32_split(basis.numpy()[:flen])
    spec = a_hi @ b_hi
    if split:
        spec = a_lo @ b_hi + a_hi @ b_lo + spec
    tiles = spec.reshape(t, 32, 2, 8)
    power = (tiles[:, :, 0] ** 2 + tiles[:, :, 1] ** 2).reshape(t, 256)
    return np.log(np.maximum(power @ mel.numpy(), SNIP.energy_floor))


def _jax_snip(wave: np.ndarray) -> np.ndarray:
    return np.asarray(jfb.fbank_jit(wave, dataclasses.replace(JFEAT, snip_edges=True)))


@pytest.mark.parametrize("amplitude", [0.1, 1e-3], ids=["short", "quiet"])
def test_3xtf32_emulation_matches_jax(rng, amplitude):
    wave = (rng.standard_normal(16000) * amplitude).astype(np.float32)
    got = _emulated(wave, split=True)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, _jax_snip(wave), **TOL)


def test_1xtf32_misses_the_tolerance(rng):
    # The negative control: one TF32 product per term is not enough.
    wave = (rng.standard_normal(16000) * 0.1).astype(np.float32)
    ref = _jax_snip(wave)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_emulated(wave, split=False), ref, **TOL)


def test_check_config_refuses_shift_off_8():
    cfg = dataclasses.replace(FEAT, num_samples=99)  # shift 162 samples
    assert cfg.frame_shift_samples % 8 and 2 * 162 < cfg.frame_length_samples <= 3 * 162
    with pytest.raises(NotImplementedError, match="multiple of 8"):
        fbank_cuda.check_config(cfg)
