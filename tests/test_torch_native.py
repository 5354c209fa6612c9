"""The port's native host runtime (runtime/native.py + runtime/csrc/) on the
CPU: the C++ shorten decoder against the port's numpy decoder and the JAX
package's native decoder, sample for sample; header parse, ranged and
batch reads, big-endian and WAV, the error codes; the C++ packer against
the numpy packer word for word; where the library is built."""

import hashlib
import shutil
import subprocess
import warnings
from pathlib import Path

import numpy as np
import pytest

from laughter_detection_icsi_tpu.runtime import native as jnative
from laughter_detection_icsi_tpu_torch.data import audio, shorten
from laughter_detection_icsi_tpu_torch.ops import pcm_pack
from laughter_detection_icsi_tpu_torch.runtime import native
from tests.fixtures.torch_weights import few_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def compiler():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native runtime")
    assert native.available()


def _speechlike(rng, n, scale=600.0):
    x = np.cumsum(rng.standard_normal(n) * scale)
    x -= np.linspace(0, x[-1], n)
    return np.clip(x, -32000, 32000).astype(np.int16)


@pytest.fixture(scope="module")
def wave():
    return _speechlike(np.random.default_rng(23), 40000)


def _write_shorten_sphere(path, x, **enc_kwargs):
    payload = shorten.encode(x, **enc_kwargs)
    n, nchan = (len(x), 1) if x.ndim == 1 else x.shape
    head = (
        f"NIST_1A\n{1024:7d}\nchannel_count -i {nchan}\nsample_count -i {n}\n"
        "sample_rate -i 16000\nsample_n_bytes -i 2\nsample_byte_format -s2 10\n"
        "sample_coding -s26 pcm,embedded-shorten-v2.00\nend_head\n"
    ).encode()
    with open(path, "wb") as f:
        f.write(head + b" " * (1024 - len(head)))
        f.write(payload)


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"nmean": 4}, {"use_qlpc": True, "force_fn": shorten.FN_QLPC},
     {"bitshift": 2}, {"blocksize": 100}, {"stereo": True}],
    ids=["default", "nmean", "qlpc", "bitshift", "blocksize", "stereo"],
)
def test_decode_shorten_equals_numpy_and_jax(tmp_path, wave, kwargs):
    kwargs = dict(kwargs)
    x = wave[:12000]
    if kwargs.pop("stereo", False):
        x = np.stack([x, wave[12000:24000]], axis=1)
    if kwargs.get("bitshift"):
        x = (x.astype(np.int32) & ~((1 << kwargs["bitshift"]) - 1)).astype(np.int16)
    path = str(tmp_path / "t.sph")
    _write_shorten_sphere(path, x, **kwargs)
    meta = audio.info(path)
    before = native.shorten_decodes
    got = native.decode_shorten(path, meta.num_samples, meta.num_channels)
    assert native.shorten_decodes == before + 1
    want = x if x.ndim == 2 else x[:, None]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, shorten.decode_file(path, meta.data_offset, max_frames=meta.num_samples))
    np.testing.assert_array_equal(
        got, jnative.decode_shorten(path, meta.num_samples, meta.num_channels))


def test_audio_read_goes_native_on_shorten(tmp_path, wave):
    path = str(tmp_path / "s.sph")
    audio.write_sphere_shorten(path, wave, 16000)
    audio._SHORTEN_CACHE.clear()
    before = native.shorten_decodes
    pcm16, _ = audio.read_int16(path, offset=0.5, duration=1.0)
    f32, _ = audio.read(path, offset=0.5, duration=1.0)
    assert native.shorten_decodes == before + 1  # once, then the cache
    np.testing.assert_array_equal(pcm16, wave[8000:24000])
    np.testing.assert_array_equal(f32, (wave[8000:24000].astype(np.float32) / 32768.0))


def test_numpy_fallback_warns_and_matches(tmp_path, wave, monkeypatch):
    path = str(tmp_path / "s.sph")
    audio.write_sphere_shorten(path, wave, 16000)

    def no_compiler(stem):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native, "build", no_compiler)
    native._load.cache_clear()
    audio._SHORTEN_CACHE.clear()
    try:
        with pytest.warns(RuntimeWarning, match="numpy shorten decoder"):
            got, _ = audio.read_int16(path)
        assert not native.available()
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # once per library, not per call
            assert native.decode_shorten(path, len(wave), 1) is None
        np.testing.assert_array_equal(got, wave)
    finally:
        monkeypatch.undo()
        native._load.cache_clear()
        audio._SHORTEN_CACHE.clear()
    assert native.available()


@pytest.fixture(scope="module")
def files(tmp_path_factory, wave):
    d = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(5)
    w = (rng.standard_normal(16000 * 2) * 0.3).astype(np.float32)
    out = {}
    for name, write in (
        ("le.sph", lambda p: audio.write_sphere(p, w, 16000)),
        ("be.sph", lambda p: audio.write_sphere(p, w, 16000, big_endian=True)),
        ("x.wav", lambda p: audio.write_wav(p, w, 16000)),
        ("s.sph", lambda p: audio.write_sphere_shorten(p, wave, 16000)),
    ):
        out[name] = str(d / name)
        write(out[name])
    return out


@pytest.mark.parametrize("name", ["le.sph", "be.sph", "x.wav", "s.sph"])
def test_info_and_read_match_numpy(files, name):
    p = files[name]
    assert native.info(p) == audio.info(p)
    a, sr_a = native.read(p)
    b, sr_b = audio.read(p)
    assert sr_a == sr_b == 16000
    np.testing.assert_array_equal(a, b)
    a, _ = native.read(p, offset=0.5, duration=0.25)
    b, _ = audio.read(p, offset=0.5, duration=0.25)
    assert len(a) == 4000
    np.testing.assert_array_equal(a, b)
    a, _ = native.read(p, offset=1.9, duration=5.0)  # clamps at the end
    assert len(a) == audio.info(p).num_samples - int(1.9 * 16000)


def test_read_batch_matches_numpy(files):
    paths = list(files.values())
    got = native.read_batch(paths, threads=3)
    assert len(got) == len(paths)
    for p, (w, sr) in zip(paths, got):
        np.testing.assert_array_equal(w, audio.read(p)[0])
    with pytest.raises(ValueError, match="channels"):
        native.read_batch(paths, channels=[0])
    assert native.read_batch([]) == []


def test_error_codes_raise(tmp_path, wave):
    junk = tmp_path / "junk.sph"
    junk.write_bytes(b"\x00\x01junkjunkjunk")
    with pytest.raises(ValueError, match="magic"):
        native.info(str(junk))
    stereo = tmp_path / "st.wav"
    audio.write_wav(str(stereo), np.zeros((100, 2), np.int16), 16000)
    with pytest.raises(ValueError, match="channel 5 out of range"):
        native.read(str(stereo), channel=5)
    trunc = tmp_path / "t.sph"
    _write_shorten_sphere(str(trunc), wave[:12000])
    trunc.write_bytes(trunc.read_bytes()[:1024 + 200])
    with pytest.raises(ValueError, match="shorten bitstream"):
        native.decode_shorten(str(trunc), 12000, 1)
    with pytest.raises(NotImplementedError, match="unsupported encoding"):
        native._raise_audio_error("x", -4)


@pytest.mark.parametrize("kind", ["speech", "noise", "silence"])
@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 1_000_000])
def test_native_packer_equals_numpy(kind, n):
    rng = np.random.default_rng(n)
    wave = {
        "speech": lambda: _speechlike(rng, n, scale=50.0),
        "noise": lambda: rng.integers(-32768, 32768, n).astype(np.int16),
        "silence": lambda: np.zeros(n, np.int16),
    }[kind]()
    for mode in ("auto", "direct", "delta"):
        a = pcm_pack.pack_pcm(wave, mode=mode, use_native=True)
        b = pcm_pack.pack_pcm(wave, mode=mode, use_native=False)
        np.testing.assert_array_equal(a.words, b.words)
        np.testing.assert_array_equal(a.widths, b.widths)
        assert (a.delta, a.n) == (b.delta, b.n)


def test_use_native_takes_effect(monkeypatch):
    calls = []
    real = native.pack_pcm_native
    monkeypatch.setattr(native, "pack_pcm_native",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    wave = np.arange(5000, dtype=np.int16)
    pcm_pack.pack_pcm(wave, use_native=False)
    assert calls == []
    pcm_pack.pack_pcm(wave)
    assert calls == [1]
    assert native.pack_pcm_native(wave, block=33) is None  # off the word alignment


def test_library_built_under_ignored_build_dir_keyed_on_source():
    for stem, src in (("audiodec", "audio_decoder.cpp"), ("pcmpack", "pcm_pack.cpp")):
        lib = native.library_path(stem)
        assert lib.parent == REPO / "build" / "torch_kernels"
        source = REPO / "laughter_detection_icsi_tpu_torch" / "runtime" / "csrc" / src
        key = hashlib.sha256(source.read_bytes() + " ".join(
            native.GXX_FLAGS + native._SOURCES[stem][1]).encode()).hexdigest()[:16]
        assert lib.name == f"lib{stem}_{key}.so"
        assert native._load(stem)._name == str(lib) and lib.is_file()
        ignored = subprocess.run(["git", "check-ignore", "-q", str(lib)], cwd=REPO)
        assert ignored.returncode == 0
    # The port carries its own copies of the JAX package's sources.
    jax_csrc = REPO / "laughter_detection_icsi_tpu" / "runtime" / "csrc"
    for src in ("audio_decoder.cpp", "pcm_pack.cpp"):
        port = REPO / "laughter_detection_icsi_tpu_torch" / "runtime" / "csrc" / src
        assert port.read_bytes() == (jax_csrc / src).read_bytes()
