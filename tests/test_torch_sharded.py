"""The port's multichannel pipeline (parallel/sharded_inference.py, one
device) against the JAX package's ShardedPipeline on the 8-device virtual
CPU mesh the JAX tests use, on the same numpy-seeded weights.

Tolerance: probabilities within 1e-5 of JAX's (tests/test_sharded_inference.py).
Inside the port, ShardedStreamingSession equals the offline batch bit for
bit.
"""

import struct

import numpy as np
import pytest

from laughter_detection_icsi_tpu import inference as jinf
from laughter_detection_icsi_tpu.data import audio as jaudio
from laughter_detection_icsi_tpu.parallel import ShardedPipeline as JaxSharded
from laughter_detection_icsi_tpu.parallel import make_mesh
from laughter_detection_icsi_tpu_torch import host_prep as thp
from laughter_detection_icsi_tpu_torch import inference as tinf
from laughter_detection_icsi_tpu_torch.parallel import sharded_inference as tsi
from tests.fixtures.torch_weights import few_torch_threads, SMALL, both_models  # noqa: F401

SIZES = dict(chunk=128, bucket_frames=256)
ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    return both_models("ResNetBigger", seed=2, head_gain=8.0, **SMALL)


@pytest.fixture(scope="module")
def jax_pipes(models):
    jmodel, params, state, _ = models
    return {
        mode: JaxSharded(model=jmodel, params=params, state=state, mesh=make_mesh(8),
                         settings=jinf.InferenceSettings(**SIZES, mode=mode))
        for mode in ("windows", "fused_conv")
    }


def _port(models, **kw):
    return tsi.ShardedPipeline(models[3], settings=tinf.InferenceSettings(**SIZES, **kw),
                               device="cpu")


def _noise(n, seed):
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


def _batch(kind):
    # Ragged lengths; the longest spans three 256-frame buckets.
    waves = [_noise(16000 * 2, 1), _noise(16000 + 800, 2), _noise(16000 * 5 + 5000, 3)]
    to16 = lambda w: (np.clip(w, -1, 1) * 32767).astype(np.int16)
    if kind == "int16":
        return [to16(w) for w in waves]
    if kind == "mixed":
        return [to16(waves[0]), waves[1], to16(waves[2])]
    return waves


@pytest.mark.parametrize("mode, kind", [
    ("windows", "float32"), ("windows", "int16"), ("windows", "mixed"),
    ("fused_conv", "float32"), ("fused_conv", "int16"),
])
def test_probs_match_jax(models, jax_pipes, mode, kind):
    waves = _batch(kind)
    got = _port(models, mode=mode).probs_for_waveforms(waves)
    want = jax_pipes[mode].probs_for_waveforms(waves)
    assert [g.shape for g in got] == [w.shape for w in want] == [(200,), (105,), (531,)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shared", [None, False], ids=["shared", "naive"])
def test_rows_match_single_channel_pipeline(models, shared):
    """Each row equals the single-channel pipeline's run of that channel,
    through the shared stem and the naive window batch, at the
    single-channel chunk whatever the channel count."""
    sharded = _port(models, shared_stem=shared)
    waves = [_noise(16000 + 777 * i, 10 + i) for i in range(9)]
    single = tinf.LaughterPipeline(
        models[3], settings=tinf.InferenceSettings(**SIZES, shared_stem=shared), device="cpu"
    )
    for w, g in zip(waves, sharded.probs_for_waveforms(waves)):
        np.testing.assert_allclose(g, single.probs_for_waveform(w), rtol=0, atol=ATOL)


def test_bucket_batches_match_jax(models, jax_pipes):
    waves = _batch("int16")
    padded, ts = zip(*(thp.host_pad_waveform(w) for w in waves))
    got = list(_port(models).bucket_batches(padded, ts, int16_in=True))
    want = list(jax_pipes["windows"].bucket_batches(padded, ts, int16_in=True))
    assert len(got) == len(want) == 3
    for (b1, v1, k1), (b2, v2, k2) in zip(got, want):
        assert k1 == k2
        np.testing.assert_array_equal(v1, v2[: len(v1)])  # JAX pads 3 rows to 8
        np.testing.assert_array_equal(b1, b2[: len(b1)])
        assert not b2[len(b1):].any()


def test_probs_for_meeting_on_written_files(models, jax_pipes, tmp_path):
    """16-bit SPHERE channels decode to int16 (thread pool); a float WAV
    meeting decodes per channel through data/audio.read."""
    waves = [_noise(16000 * 2, 20), _noise(16000 * 2, 21)]
    sph = [str(tmp_path / f"chan{i}.sph") for i in range(2)]
    flt = [str(tmp_path / f"chan{i}.wav") for i in range(2)]
    for w, p, q in zip(waves, sph, flt):
        jaudio.write_sphere(p, w, 16000)
        with open(q, "wb") as f:  # 32-bit float WAV: not int16-eligible
            data = w.tobytes()
            f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
                    + struct.pack("<IHHIIHH", 16, 3, 1, 16000, 64000, 4, 32)
                    + b"data" + struct.pack("<I", len(data)) + data)
    port = _port(models)
    for paths in (sph, flt):
        probs, durations = port.probs_for_meeting(paths)
        assert durations == [pytest.approx(2.0)] * 2
        want, _ = jax_pipes["windows"].probs_for_meeting(paths)
        for g, w in zip(probs, want):
            assert g.shape == (200,)
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    assert port.probs_for_meeting_device([]) == ((None, []), [])
    p8 = str(tmp_path / "sr8.wav")
    jaudio.write_wav(p8, _noise(8000, 22), 8000)
    with pytest.raises(ValueError, match="sample rate"):
        port.probs_for_meeting([p8])


def test_streaming_session_equals_offline_batch(models):
    sharded = _port(models)
    n = 16000 * 7 + 900
    waves = [_noise(n, 30 + i) for i in range(3)]
    want = sharded.probs_for_waveforms(waves)
    sess = tsi.ShardedStreamingSession(sharded, n_channels=3)
    got = [sess.feed([w[lo : lo + 20000] for w in waves]) for lo in range(0, n, 20000)]
    full = np.concatenate(got + [sess.finish()], axis=1)
    assert full.shape == (3, len(want[0]))
    for row, w in zip(full, want):
        np.testing.assert_array_equal(row, w)
    # Streams shorter than a frame take the offline batch whole.
    tiny = [_noise(300, 40 + i) for i in range(3)]
    sess = tsi.ShardedStreamingSession(sharded, n_channels=3)
    sess.feed([t[:100] for t in tiny])
    sess.feed([t[100:] for t in tiny])
    np.testing.assert_array_equal(sess.finish(), np.stack(sharded.probs_for_waveforms(tiny)))


def test_guards_and_device_rows(models):
    sharded = _port(models, mode="fused_conv")
    probs, ts = sharded.probs_for_waveforms_device([_noise(16000, 50)])
    assert tuple(probs.shape) == (1, 100) and ts == [100]  # the bias-leak tail is cut
    assert sharded.probs_for_waveforms([]) == []
    assert sharded.probs_for_waveforms([np.zeros(40, np.float32)])[0].shape == (0,)
    with pytest.raises(ValueError, match="1-D PCM"):
        sharded.probs_for_waveforms([np.zeros((2, 32000), np.float32)])
    with pytest.raises(TypeError, match="dtype"):
        sharded.probs_for_waveforms([np.zeros(16000, np.int32)])
    sess = tsi.ShardedStreamingSession(_port(models), n_channels=2)
    with pytest.raises(ValueError):
        sess.feed([np.zeros(100, np.float32)])  # wrong channel count
    with pytest.raises(ValueError):
        sess.feed([np.zeros(100, np.float32), np.zeros(99, np.float32)])
    sess.finish()
    with pytest.raises(RuntimeError):
        sess.feed([np.zeros(4, np.float32), np.zeros(4, np.float32)])
