"""The port's pipeline against the JAX package's, on the same numpy-seeded
weights and inputs (CPU, small sizes: a narrow ResNetBigger, 256-frame
buckets, 128-window chunks, a few seconds of audio spanning several
buckets).  Smoothing and the segment CLI: tests/test_torch_segment.py.

Tolerance: probabilities within 1e-5 (features within 2e-4 feed float32
convs summed in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from laughter_detection_icsi_tpu import host_prep as jhp
from laughter_detection_icsi_tpu import inference as jinf
from laughter_detection_icsi_tpu_torch import host_prep as thp
from laughter_detection_icsi_tpu_torch import inference as tinf
from laughter_detection_icsi_tpu_torch.data import audio as taudio
from tests.fixtures.torch_weights import SMALL, both_models

SIZES = dict(chunk=128, bucket_frames=256)
N_SAMPLES = 16000 * 6 + 777  # 605 frames: three 256-frame buckets, the last partial


@pytest.fixture(scope="module")
def models():
    return both_models("ResNetBigger", seed=5, head_gain=8.0, **SMALL)


@pytest.fixture(scope="module")
def jax_pipes(models):
    jmodel, params, state, _ = models
    return {
        shared: jinf.LaughterPipeline(
            jmodel, params, state,
            settings=jinf.InferenceSettings(**SIZES, shared_stem=shared),
        )
        for shared in (True, False)
    }


def _port_pipe(models, shared=None):
    settings = tinf.InferenceSettings(**SIZES, shared_stem=shared)
    return tinf.LaughterPipeline(models[3], settings=settings, device="cpu")


def _wave(n, dtype, seed=11):
    w = np.random.default_rng(seed).standard_normal(n) * 0.2
    w = np.clip(w, -1, 1)
    if dtype == "int16":
        return (w * 32767).astype(np.int16)
    return w.astype(np.float32)


def test_host_prep_matches_jax():
    for n in (0, 1, 50, 80, 399, 400, 16000, N_SAMPLES):
        assert thp.num_frames(n) == jhp.num_frames(n)
        assert thp.pad_amounts(n) == jhp.pad_amounts(n)
        w = _wave(n, "int16")
        got, t = thp.host_pad_waveform(w)
        want, jt = jhp.host_pad_waveform(w)
        assert t == jt and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for geo in (jinf.InferenceSettings(**SIZES), jinf.InferenceSettings()):
        assert thp.bucket_wave_len(geo) == jhp.bucket_wave_len(geo)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "naive"])
@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_probs_match_jax(models, jax_pipes, shared, dtype):
    wave = _wave(N_SAMPLES, dtype)
    want = jax_pipes[shared].probs_for_waveform(wave)
    pipe = _port_pipe(models, shared)
    assert pipe.shared_stem is shared
    got = pipe.probs_for_waveform(wave)
    assert got.shape == want.shape == (605,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_short_and_empty_waves_match_jax(models, jax_pipes):
    pipe = _port_pipe(models)
    for n in (399, 100):
        wave = _wave(n, "float32")
        np.testing.assert_allclose(
            pipe.probs_for_waveform(wave),
            jax_pipes[True].probs_for_waveform(wave), rtol=0, atol=1e-5,
        )
    assert pipe.probs_for_waveform(np.zeros(0, np.int16)).shape == (0,)


def test_bucket_plan_matches_jax(models, jax_pipes):
    wave = _wave(N_SAMPLES, "int16")
    padded, t = thp.host_pad_waveform(wave)
    got = list(_port_pipe(models).bucket_buffers(padded, t))
    want = list(jax_pipes[True].bucket_buffers(padded, t))
    assert len(got) == len(want) == 3
    for (b1, v1, k1), (b2, v2, k2) in zip(got, want):
        assert (v1, k1) == (v2, k2)
        np.testing.assert_array_equal(b1, b2)


def test_input_guards(models, tmp_path):
    pipe = _port_pipe(models)
    with pytest.raises(ValueError, match="1-D"):
        pipe.probs_for_waveform(np.zeros((2, 16000), np.float32))
    with pytest.raises(TypeError, match="dtype"):
        pipe.probs_for_waveform(np.zeros(16000, np.int32))
    path = str(tmp_path / "8k.wav")
    taudio.write_wav(path, np.zeros(8000, np.float32), 8000)
    with pytest.raises(ValueError, match="sample rate"):
        pipe.probs_for_file(path)


def test_unported_features_are_refused(models, monkeypatch):
    # bf16 is ported (tests/test_torch_precision.py): it constructs and runs.
    bf16 = tinf.InferenceSettings(chunk=128, bucket_frames=256, precision="bfloat16")
    probs = tinf.LaughterPipeline(models[3], settings=bf16, device="cpu").probs_for_waveform(
        _wave(16000, "int16"))
    assert probs.shape == (100,) and probs.dtype == np.float32
    for codec in ("packed", "auto"):  # ported: they construct
        assert tinf.InferenceSettings(transfer_codec=codec).transfer_codec == codec
    from laughter_detection_icsi_tpu_torch.parallel import sharded_inference as tsi

    # Inside a process group of two ranks the pipeline holds its block of
    # the channels, and what would hand every channel to one process
    # raises, as JAX's (the two processes: tests/test_torch_distributed.py).
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 1)
    pipe = tsi.ShardedPipeline(models[3], device="cpu")
    assert pipe.local_channel_indices(3) == [2] and pipe.local_channel_indices(4) == [2, 3]
    with pytest.raises(RuntimeError, match="multi-process mesh cannot do"):
        pipe.probs_for_waveforms([_wave(16000, "int16")])
    with pytest.raises(NotImplementedError, match="single-process"):
        tsi.ShardedStreamingSession(pipe, 2)
    with pytest.raises(ValueError, match="unknown mode"):
        tinf.InferenceSettings(mode="dilated")
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        tinf.InferenceSettings(chunk=0)


def test_device_defaults(models, monkeypatch):
    cpu = tinf.settings_from_flags(device="cpu")
    card = tinf.settings_from_flags()
    assert (cpu.chunk, cpu.bucket_frames, cpu.precision) == (1024, 1024, "float32")
    # bf16 on the card, as the JAX package's default on an accelerator.
    assert (card.chunk, card.bucket_frames, card.precision) == (6144, 6144, "bfloat16")
    # Same field names and defaults as the JAX settings, less the kernel
    # switch (the port picks its featurizer by the tensor's device), plus
    # the clips mode's geometry (the port's own: AST has no JAX twin).
    jfields = {f.name: f.default for f in dataclasses.fields(jinf.InferenceSettings)}
    tfields = {f.name: f.default for f in dataclasses.fields(tinf.InferenceSettings)}
    clips = {"clip_frames": 1024, "hop_frames": 100, "clip_batch": 60}
    assert tfields == {**{k: v for k, v in jfields.items() if k != "use_pallas_fbank"}, **clips}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinf.LaughterPipeline(models[3])
