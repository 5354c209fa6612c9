"""The port's packed-PCM codec (ops/pcm_pack.py) against the JAX package's,
and the packed upload through the port's pipelines.

Tolerance 0 throughout: the packer must give the JAX numpy packer's words,
widths and delta flag; the torch decoder must give back the packed int16
values (and the JAX decoder's); probabilities from a packed upload must be
bit-equal to the raw upload's, since both feed the same float32 wave to the
same featurizer.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from laughter_detection_icsi_tpu.ops import pcm_pack as jpk
from laughter_detection_icsi_tpu_torch import inference as tinf
from laughter_detection_icsi_tpu_torch.models import zoo
from laughter_detection_icsi_tpu_torch.ops import pcm_pack as tpk
from laughter_detection_icsi_tpu_torch.parallel import sharded_inference as tsi
from tests.fixtures.torch_weights import few_torch_threads, SMALL, numpy_weights  # noqa: F401
from laughter_detection_icsi_tpu_torch.train.checkpoint import state_dict_from_jax

LENGTHS = (1, 4095, 4096, 4097, 1_000_000)


def _signal(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    if kind == "speech":  # a slow random walk under a 200 Hz tone: deltas win
        t = np.arange(n) / 16000
        w = 3000 * np.sin(2 * np.pi * 200 * t) + np.cumsum(rng.standard_normal(n)) * 20
        return np.clip(w, -32768, 32767).astype(np.int16)
    if kind == "noise":  # full-scale white noise: direct wins
        return rng.integers(-32768, 32768, n).astype(np.int16)
    if kind == "silence":  # width 0 everywhere
        return np.zeros(n, np.int16)
    return np.where(np.arange(n) % 2, 32767, -32768).astype(np.int16)  # alternating


def _torch_decode(packed, wire=None):
    wire = tpk.widen(tpk.wire_tensor(packed.wire() if wire is None else wire))
    widths, words = tpk.split_wire(wire, len(packed.widths))
    return tpk.unpack_pcm(words, widths, packed.n, packed.delta)


@pytest.mark.parametrize("kind", ["speech", "noise", "silence", "alternating"])
@pytest.mark.parametrize("n", LENGTHS)
def test_pack_and_unpack_match_jax(kind, n):
    x = _signal(kind, n)
    got = tpk.pack_pcm(x)
    want = jpk.pack_pcm(x, use_native=False)
    assert got.delta == want.delta
    assert np.array_equal(got.widths, want.widths) and got.widths.dtype == want.widths.dtype
    assert np.array_equal(got.words, want.words) and got.words.dtype == want.words.dtype
    assert np.array_equal(got.wire(), want.wire())
    if kind == "noise" and n >= 4096:
        assert not got.delta  # direct wins on full-scale noise
    if kind == "silence":
        assert not got.widths.any()
    dec = _torch_decode(got)
    assert dec.dtype == torch.int32 and dec.shape == (n,)
    assert np.array_equal(dec.numpy(), x.astype(np.int32))
    jdec = jpk.unpack_pcm(jnp.asarray(want.words), jnp.asarray(want.widths), n, want.delta)
    assert np.array_equal(dec.numpy(), np.asarray(jdec))


def test_straddle_and_guard_at_widths_0_and_17():
    """Forced deltas of alternating full scale need 17 bits (words
    straddle at most shifts), beside all-zero blocks (w = 0, the
    `(32 - shift) & 31` guard) and a w = 0 block last, whose next-word
    gather points one past the stream."""
    x = np.zeros(4 * tpk.BLOCK, np.int16)
    x[tpk.BLOCK : 2 * tpk.BLOCK] = _signal("alternating", tpk.BLOCK)
    x[2 * tpk.BLOCK + 7] = -5
    packed = tpk.pack_pcm(x, mode="delta")
    want = jpk.pack_pcm(x, mode="delta", use_native=False)
    assert np.array_equal(packed.words, want.words)
    assert packed.delta and packed.widths[[0, 1, 3]].tolist() == [0, 17, 0]
    assert np.array_equal(_torch_decode(packed).numpy(), x.astype(np.int32))
    # The stream's tail padding cut to the one word _finish guarantees.
    n_words = int(packed.widths.sum()) * tpk.BLOCK // 32
    tight = np.concatenate([packed.widths.view(np.uint32), packed.words[: n_words + 1]])
    assert np.array_equal(_torch_decode(packed, tight).numpy(), x.astype(np.int32))


def test_pack_rejects_bad_input():
    with pytest.raises(TypeError, match="int16"):
        tpk.pack_pcm(np.zeros(10, np.float32))
    with pytest.raises(TypeError, match="1-D"):
        tpk.pack_pcm(np.zeros((2, 10), np.int16))
    with pytest.raises(ValueError, match="mode"):
        tpk.pack_pcm(np.zeros(10, np.int16), mode="zip")


# --------------------------------------------------------------------------- #
# Through the pipelines
# --------------------------------------------------------------------------- #

SIZES = dict(chunk=128, bucket_frames=256)


@pytest.fixture(scope="module")
def model():
    _, params, state = numpy_weights("ResNetBigger", seed=2, head_gain=8.0, **SMALL)
    m = zoo.build("ResNetBigger", dropout_rate=0.0, **SMALL)
    m.load_state_dict(state_dict_from_jax(params, state), strict=True)
    return m


def _settings(**kw):
    return tinf.InferenceSettings(**SIZES, **kw)


def _speech(seconds: float, seed: int) -> np.ndarray:
    return _signal("speech", int(16000 * seconds) + seed)


def test_laughter_pipeline_packed_equals_raw(model):
    wave = _speech(6.3, 0)
    raw = tinf.LaughterPipeline(model, settings=_settings(), device="cpu")
    packed = tinf.LaughterPipeline(model, settings=_settings(transfer_codec="packed"), device="cpu")
    buf = next(raw.bucket_buffers(*tinf.host_prep.host_pad_waveform(wave)))[0]
    assert packed._maybe_pack(buf) is not None
    want = raw.probs_for_waveform(wave)
    got = packed.probs_for_waveform(wave)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_sharded_pipeline_packed_equals_raw(model):
    waves = [_speech(6.3, 0), _speech(4.1, 1), np.zeros(16000 * 3, np.int16)]
    raw = tsi.ShardedPipeline(model, settings=_settings(), device="cpu")
    packed = tsi.ShardedPipeline(model, settings=_settings(transfer_codec="packed"), device="cpu")
    batch = next(raw.bucket_batches(*zip(*map(tinf.host_prep.host_pad_waveform, waves)),
                                    int16_in=True))[0]
    wires, deltas = packed._maybe_pack(batch)
    assert wires.shape[0] == 3 and wires.dtype == np.uint32
    # Each row in its own smaller mode: the silent row's widths are all 0
    # either way, and direct wins a tie.
    assert deltas == [True, True, False]
    for got, want in zip(packed.probs_for_waveforms(waves), raw.probs_for_waveforms(waves)):
        assert got.shape == want.shape and np.array_equal(got, want)


def test_auto_uploads_noise_raw(model):
    noise = _signal("noise", 16000 * 3)
    pipe = tinf.LaughterPipeline(model, settings=_settings(transfer_codec="auto"), device="cpu")
    spipe = tsi.ShardedPipeline(model, settings=_settings(transfer_codec="auto"), device="cpu")
    buf = next(pipe.bucket_buffers(*tinf.host_prep.host_pad_waveform(noise)))[0]
    assert pipe._maybe_pack(buf) is None
    assert spipe._maybe_pack(np.stack([buf, buf])) is None
    # Speech saves more than 10% and packs.
    speech = next(pipe.bucket_buffers(*tinf.host_prep.host_pad_waveform(_speech(3, 0))))[0]
    assert pipe._maybe_pack(speech) is not None
    assert spipe._maybe_pack(np.stack([speech, speech])) is not None


def test_packed_with_fused_conv_raises():
    with pytest.raises(ValueError, match="packed"):
        tinf.InferenceSettings(mode="fused_conv", transfer_codec="packed")


def test_packed_on_float_input_warns(model):
    wave = (_speech(3, 0) / 32768.0).astype(np.float32)
    pipe = tinf.LaughterPipeline(model, settings=_settings(transfer_codec="packed"), device="cpu")
    spipe = tsi.ShardedPipeline(model, settings=_settings(transfer_codec="packed"), device="cpu")
    with pytest.warns(UserWarning, match="uploads raw"):
        got = pipe.probs_for_waveform(wave)
    want = tinf.LaughterPipeline(model, settings=_settings(), device="cpu").probs_for_waveform(wave)
    assert np.array_equal(got, want)
    with pytest.warns(UserWarning, match="uploads raw"):
        spipe.probs_for_waveforms([wave, wave])


def test_streaming_session_goes_packed(model, monkeypatch):
    wave = _speech(6.3, 0)
    packs = []
    real = tpk.pack_pcm
    monkeypatch.setattr(tpk, "pack_pcm", lambda *a, **k: packs.append(1) or real(*a, **k))
    pipe = tinf.LaughterPipeline(model, settings=_settings(transfer_codec="packed"), device="cpu")
    sess = tinf.StreamingSession(pipe)
    got = np.concatenate([sess.feed(wave[lo : lo + 4000]) for lo in range(0, len(wave), 4000)]
                         + [sess.finish()])
    want = tinf.LaughterPipeline(model, settings=_settings(), device="cpu").probs_for_waveform(wave)
    assert len(packs) == 3  # one per bucket: 630 frames in 256-frame buckets
    assert got.shape == want.shape and np.array_equal(got, want)
