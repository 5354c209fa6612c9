"""The port on the card: the fbank kernel against its plain version, and
the pipeline's launch count.  Marked ``cuda``; each test skips without a
card.  This file imports neither JAX nor the JAX package, so it runs on a
machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from laughter_detection_icsi_tpu_torch import host_prep, inference
from laughter_detection_icsi_tpu_torch.config import FEAT
from laughter_detection_icsi_tpu_torch.models import zoo
from laughter_detection_icsi_tpu_torch.ops import fbank as tfb
from laughter_detection_icsi_tpu_torch.ops import fbank_cuda

TOL = dict(atol=2e-4, rtol=1e-4)  # tests/test_fbank_pallas.py's feature tolerance


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _wave(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [16000, 48777, 399, 80, (2 * 256 + 37) * 160, (3, 16777)])
def test_kernel_matches_plain(card, shape):
    x = torch.from_numpy(_wave(shape)).to(card)
    before = fbank_cuda.launches
    with inference.strict_fp32():
        got = fbank_cuda.fbank_cuda(x, FEAT)
        want = tfb.fbank(x, FEAT)
    assert fbank_cuda.launches == before + 1
    torch.testing.assert_close(got, want, **TOL)
    if x.ndim == 2:  # batch rows are computed exactly as each row alone
        for c in range(x.shape[0]):
            assert torch.equal(got[c], fbank_cuda.fbank_cuda(x[c].contiguous(), FEAT))


@pytest.mark.cuda
def test_kernel_main_path_bucket(card):
    cfg = host_prep.snip_cfg(FEAT)
    x = torch.from_numpy(_wave(host_prep.bucket_wave_len(inference.InferenceSettings()))).to(card)
    with inference.strict_fp32():
        got = fbank_cuda.fbank_cuda(x, cfg)
        want = tfb.fbank(x, cfg)
    assert got.shape == (6243, FEAT.num_filters)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    with pytest.raises(TypeError, match="float32"):
        fbank_cuda.fbank_cuda(torch.zeros(16000, dtype=torch.float64, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        fbank_cuda.fbank_cuda(torch.zeros(2, 16000, device=card)[:, ::2])


@pytest.mark.cuda
def test_pipeline_launches_once_per_bucket(card):
    model = zoo.build("ResNetBigger", linear_layer_size=24, filter_sizes=(8, 8, 8, 8))
    settings = inference.InferenceSettings(chunk=128, bucket_frames=256)
    pipe = inference.LaughterPipeline(model, settings=settings)  # device None = cuda
    wave = (_wave(16000 * 6 + 777) * 32767 / 4).astype(np.int16)
    before = fbank_cuda.launches
    probs = pipe.probs_for_waveform(wave)
    assert fbank_cuda.launches - before == 3
    cpu = inference.LaughterPipeline(model, settings=settings, device="cpu")
    np.testing.assert_allclose(probs, cpu.probs_for_waveform(wave), rtol=0, atol=1e-5)
