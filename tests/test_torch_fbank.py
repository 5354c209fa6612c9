"""The port's featurizer (laughter_detection_icsi_tpu_torch/ops/fbank.py)
against the JAX package's, and the fbank kernel wrapper's CPU contract.

Tolerance atol 2e-4 / rtol 1e-4 on log-mel, the one the JAX package holds
its Pallas kernel to (tests/test_fbank_pallas.py): float32 matmuls summed
in another order than XLA's.  The kernel itself (CUDA) runs only on the
card: tests/test_torch_cuda.py compares it with the plain version there.
"""

import dataclasses

import numpy as np
import pytest
import torch

from laughter_detection_icsi_tpu.config import FEAT as JFEAT
from laughter_detection_icsi_tpu.ops import fbank as jfb
from laughter_detection_icsi_tpu.ops.fbank_pallas import BLOCK, fbank_pallas
from laughter_detection_icsi_tpu_torch import host_prep
from laughter_detection_icsi_tpu_torch.config import FEAT
from laughter_detection_icsi_tpu_torch.ops import fbank as tfb
from laughter_detection_icsi_tpu_torch.ops import fbank_cuda

TOL = dict(atol=2e-4, rtol=1e-4)
LENGTHS = [16000, 16000 * 3 + 777, 399, 80]


def _wave(rng, shape):
    return (rng.standard_normal(shape) * 0.1).astype(np.float32)


def test_configs_match():
    assert dataclasses.asdict(FEAT) == dataclasses.asdict(JFEAT)


def test_host_bases_equal_jax():
    # Same float64 derivations -> bit-identical float32 tables.
    for a, b in zip(tfb._effective_bases(FEAT), jfb._effective_bases(JFEAT)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tfb._mel_banks(FEAT), jfb._mel_banks(JFEAT))
    np.testing.assert_array_equal(tfb._window_fn(FEAT), jfb._window_fn(JFEAT))


@pytest.mark.parametrize("n_samples", LENGTHS)
def test_plain_matches_jax(rng, n_samples):
    w = _wave(rng, n_samples)
    ref = np.asarray(jfb.fbank_jit(w))
    got = tfb.fbank(torch.from_numpy(w)).numpy()
    assert got.shape == ref.shape
    if ref.size:
        np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("n_samples", [16000, (BLOCK * 2 + 37) * 160, 80])
def test_plain_matches_pallas_interpret(rng, n_samples):
    w = _wave(rng, n_samples)
    ref = np.asarray(fbank_pallas(w, interpret=True))
    got = tfb.fbank(torch.from_numpy(w)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


def test_plain_batched_matches_jax(rng):
    batch = _wave(rng, (3, 16000 + 777))
    got = tfb.fbank(torch.from_numpy(batch)).numpy()
    assert got.shape == (3, host_prep.num_frames(16777), FEAT.num_filters)
    np.testing.assert_allclose(got, np.asarray(jfb.fbank_jit(batch)), **TOL)


@pytest.mark.parametrize("n_samples", [16000, 399])
def test_sequential_path_matches_jax(rng, n_samples):
    w = _wave(rng, n_samples)
    ref = np.asarray(jfb.fbank(w, fold_preproc=False))
    got = tfb.fbank(torch.from_numpy(w), fold_preproc=False).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    # ... and the two port formulations agree with each other.
    np.testing.assert_allclose(got, tfb.fbank(torch.from_numpy(w)).numpy(), **TOL)


def test_snip_geometry_matches_jax(rng):
    # The pipeline featurizes host-padded buckets under the snip twin.
    w = _wave(rng, 16000)
    cfg = host_prep.snip_cfg(FEAT)
    ref = np.asarray(jfb.fbank_jit(w, dataclasses.replace(JFEAT, snip_edges=True)))
    got = tfb.fbank(torch.from_numpy(w), cfg).numpy()
    assert got.shape == ref.shape == (host_prep.num_frames(16000, cfg), 44)
    np.testing.assert_allclose(got, ref, **TOL)


def test_zero_frames():
    got = tfb.fbank(torch.zeros(0))
    assert got.shape == (0, FEAT.num_filters)
    got = fbank_cuda.fbank_cuda(torch.zeros(2, 100), host_prep.snip_cfg(FEAT))
    assert got.shape == (2, 0, FEAT.num_filters)


def test_dither_refused():
    cfg = dataclasses.replace(FEAT, dither=1.0)
    with pytest.raises(NotImplementedError, match="dither"):
        tfb.fbank(torch.zeros(16000), cfg)
    with pytest.raises(NotImplementedError, match="dither"):
        fbank_cuda.check_config(cfg)


@pytest.mark.parametrize("n", [1, 2, 3, 80])
def test_symmetric_pad_matches_numpy(n):
    a = np.arange(n, dtype=np.float32)
    for left, right in [(120, 200), (3, 7), (0, 5), (300, 1)]:
        got = tfb.symmetric_pad(torch.from_numpy(a), left, right).numpy()
        np.testing.assert_array_equal(got, np.pad(a, (left, right), mode="symmetric"))


def test_cpu_tensor_runs_plain_version(rng):
    # On the CPU the wrapper is the plain version, bit for bit, and never
    # counts a launch.
    w = torch.from_numpy(_wave(rng, (2, 16777)))
    before = fbank_cuda.launches
    np.testing.assert_array_equal(
        fbank_cuda.fbank_cuda(w).numpy(), tfb.fbank(w).numpy()
    )
    assert fbank_cuda.launches == before


def test_kernel_guards_refuse_odd_geometry():
    with pytest.raises(NotImplementedError, match="assumes"):
        fbank_cuda.check_config(dataclasses.replace(FEAT, frame_length=0.05))
    with pytest.raises(NotImplementedError, match="DFT"):
        fbank_cuda.check_config(dataclasses.replace(FEAT, round_to_power_of_two=False))
    fbank_cuda.check_config(FEAT)
    fbank_cuda.check_config(host_prep.snip_cfg(FEAT))


def test_kernel_constants_layout():
    basis, mel, rng_ = fbank_cuda.kernel_constants(FEAT, torch.device("cpu"))
    cos_eff, sin_eff = tfb._effective_bases(FEAT)
    assert basis.shape == (400, 512) and basis.shape[0] % fbank_cuda.TILE_K == 0
    np.testing.assert_array_equal(basis[:, :256].numpy(), cos_eff[:, :256])
    np.testing.assert_array_equal(basis[:, 256:].numpy(), sin_eff[:, :256])
    # Summing each filter over its nonzero range only is exact.
    mel = mel.numpy()
    for m, (lo, hi) in enumerate(rng_.numpy()):
        assert lo < hi
        assert not mel[:lo, m].any() and not mel[hi:, m].any()
