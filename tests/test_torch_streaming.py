"""The port's streaming session and streaming event detector.

Inside the port, StreamingSession must equal the offline pipeline bit for
bit (a bucket runs through the pipeline's own ``_bucket_probs`` once every
sample it reads is final; the end-of-stream reflection pad comes in
finish()), as tests/test_streaming.py pins it for JAX.  Against JAX's
StreamingSession on the same numpy-seeded weights: within 1e-5.
"""

import dataclasses

import numpy as np
import pytest

from laughter_detection_icsi_tpu import inference as jinf
from laughter_detection_icsi_tpu.ops import smoothing as jsm
from laughter_detection_icsi_tpu_torch import inference as tinf
from laughter_detection_icsi_tpu_torch.ops import smoothing as tsm
from tests.fixtures.torch_weights import few_torch_threads, SMALL, both_models  # noqa: F401

SIZES = dict(chunk=256, bucket_frames=512)


@pytest.fixture(scope="module")
def models():
    return both_models("ResNetBigger", seed=7, head_gain=8.0, **SMALL)


@pytest.fixture(scope="module")
def pipe(models):
    return tinf.LaughterPipeline(models[3], settings=tinf.InferenceSettings(**SIZES), device="cpu")


def _noise(n, seed=23, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _stream(session, wave, size):
    out = [session.feed(wave[lo : lo + size]) for lo in range(0, len(wave), size)]
    out.append(session.finish())
    return np.concatenate(out)


@pytest.mark.parametrize("chunk_size", [1000, 16000, 16384, 100_000])
def test_streaming_equals_offline(pipe, chunk_size):
    wave = _noise(16000 * 7 + 1234)  # several buckets + a ragged tail
    want = pipe.probs_for_waveform(wave)
    got = _stream(tinf.StreamingSession(pipe), wave, chunk_size)
    np.testing.assert_array_equal(got, want)


def test_streaming_int16_and_jax(models, pipe):
    """int16 feeds equal the offline int16 run; the port's stream agrees
    with JAX's StreamingSession within 1e-5."""
    jmodel, params, state, _ = models
    wave = (_noise(16000 * 6, seed=5) * 30000).astype(np.int16)
    got = _stream(tinf.StreamingSession(pipe), wave, 7000)
    np.testing.assert_array_equal(got, pipe.probs_for_waveform(wave))
    jpipe = jinf.LaughterPipeline(jmodel, params, state, settings=jinf.InferenceSettings(**SIZES))
    want = _stream(jinf.StreamingSession(jpipe), wave, 7000)
    assert got.shape == want.shape == (600,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_streaming_emits_incrementally(pipe):
    sess = tinf.StreamingSession(pipe)
    wave = _noise(16000 * 12, seed=6)
    out = sess.feed(wave)
    assert len(out) >= 512  # at least one bucket final before finish()
    np.testing.assert_array_equal(np.concatenate([out, sess.finish()]),
                                  pipe.probs_for_waveform(wave))


def test_tiny_and_empty_streams(pipe):
    for n in (0, 50, 119, 120, 121, 4000):
        wave = _noise(n, seed=n)
        sess = tinf.StreamingSession(pipe)
        got = np.concatenate([sess.feed(wave[: n // 2]), sess.feed(wave[n // 2 :]), sess.finish()])
        np.testing.assert_array_equal(got, pipe.probs_for_waveform(wave))


def test_mixed_dtype_rules(pipe):
    """int16 into a float stream is scaled exactly; floats into an int16
    stream are refused; unknown dtypes are refused."""
    f = _noise(30000, seed=1)
    i = (_noise(30000, seed=2) * 30000).astype(np.int16)
    sess = tinf.StreamingSession(pipe)
    sess.feed(f)
    sess.feed(i)
    want = pipe.probs_for_waveform(np.concatenate([f, i.astype(np.float32) / 32768.0]))
    np.testing.assert_array_equal(sess.finish(), want)
    sess = tinf.StreamingSession(pipe)
    sess.feed(i)
    with pytest.raises(TypeError):
        sess.feed(f)
    with pytest.raises(TypeError):
        tinf.StreamingSession(pipe).feed(np.zeros(100, dtype=np.int32))


def test_lifecycle_errors_and_refusals(models, pipe):
    sess = tinf.StreamingSession(pipe)
    sess.finish()
    with pytest.raises(RuntimeError):
        sess.feed(np.zeros(10, np.float32))
    with pytest.raises(RuntimeError):
        sess.finish()
    with pytest.raises(ValueError, match="1-D"):
        tinf.StreamingSession(pipe).feed(np.zeros((100, 2), np.float32))
    fused = tinf.LaughterPipeline(
        models[3], settings=tinf.InferenceSettings(**SIZES, mode="fused_conv"), device="cpu"
    )
    with pytest.raises(ValueError, match="mode='windows'"):
        tinf.StreamingSession(fused)
    snip = tinf.LaughterPipeline(
        models[3], feat_cfg=dataclasses.replace(pipe.feat_cfg, snip_edges=True),
        settings=pipe.settings, device="cpu",
    )
    with pytest.raises(ValueError, match="snip_edges"):
        tinf.StreamingSession(snip)


def test_memory_stays_bounded(pipe):
    """Consumed samples are dropped after each bucket: over a minute of
    audio the buffer stays about one bucket span."""
    sess = tinf.StreamingSession(pipe)
    frames = max_buf = 0
    for k in range(60):
        frames += len(sess.feed(_noise(16000, seed=k)))
        held = (sess._bufs[0].nbytes if sess._bufs else 0) + sum(
            c.nbytes for c in sess._pending[0]
        )
        max_buf = max(max_buf, held)
    frames += len(sess.finish())
    assert frames == 6000
    # A 512-frame bucket span is ~82k samples plus a feed; a minute of
    # float32 audio held whole would be 3.8 MB.
    assert max_buf < 2_000_000, max_buf


def test_reused_feed_buffer_is_not_aliased(pipe):
    wave = _noise(16000 * 7, seed=4)
    sess = tinf.StreamingSession(pipe)
    buf = np.empty(4000, dtype=np.float32)
    outs = []
    for lo in range(0, len(wave), 4000):
        buf[:] = wave[lo : lo + 4000]
        outs.append(sess.feed(buf))
    outs.append(sess.finish())
    np.testing.assert_array_equal(np.concatenate(outs), pipe.probs_for_waveform(wave))


@pytest.mark.parametrize("chunking", [1, 7, 100, 1000, 10_000])
def test_event_detector_matches_jax(chunking):
    """Events over any chunking equal JAX's detector and the offline scan,
    including runs open at a chunk's end and at the stream's end, probs at
    0 and above 1, and a fractional fps."""
    rng = np.random.default_rng(chunking)
    probs = rng.random(3000).astype(np.float32)
    probs[probs < 0.05] = 0.0
    probs[:40] = 1.5  # a run from frame 0
    probs[-25:] = 0.9  # a run still open at the end
    fps = 3000 / 30.07
    for thr, min_l in ((0.5, 0.0), (0.3, 0.05), (0.0, 0.2)):
        port = tsm.StreamingEventDetector(thr, min_l, fps=fps)
        ref = jsm.StreamingEventDetector(thr, min_l, fps=fps)
        got, want = [], []
        for lo in range(0, len(probs), chunking):
            got += port.feed(probs[lo : lo + chunking])
            want += ref.feed(probs[lo : lo + chunking])
        got += port.finish()
        want += ref.finish()
        assert got == want
        offline = tsm.get_laughter_instances(probs, [thr], [min_l], fps=fps)[(thr, min_l)]
        assert got == offline
    with pytest.raises(RuntimeError):
        port.finish()
