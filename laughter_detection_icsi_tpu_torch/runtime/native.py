"""ctypes binding for the native (C++) host runtime: audio decode and PCM pack.

The port's twin of the JAX package's ``runtime/native.py``.  Two C++
sources, copies of the JAX package's, live in ``runtime/csrc/``:
``audio_decoder.cpp`` (SPHERE / WAV headers, ranged PCM reads, the
embedded-shorten decoder, a pthread pool for a meeting's channels) and
``pcm_pack.cpp`` (the packed-PCM wire codec's packer, ops/pcm_pack.py).

Each is built with ``g++ -O3 -shared -fPIC`` on first use into
``build/torch_kernels/`` at the root of the checkout, keyed on a hash of
the source and flags (the fbank kernel's rule, ops/fbank_cuda.py), through
a per-process temporary file and an atomic ``os.replace``, and loaded with
``ctypes``, which releases the GIL for the length of each call: a thread
pool decodes a meeting's channels concurrently.

Without a compiler the callers fall back to the numpy decoder and packer
(data/shorten.py, ops/pcm_pack.py); that is not silent: the first failed
build warns, and :func:`available` / :func:`library_path` say which path
runs (cli/sweep.py prints it).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from laughter_detection_icsi_tpu_torch.data import audio as py_audio

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_SOURCES = {  # library stem -> (source, extra link flags)
    "audiodec": ("audio_decoder.cpp", ("-lpthread",)),
    "pcmpack": ("pcm_pack.cpp", ()),
}

#: Whole-stream shorten decodes done by the native library so far (one per
#: :func:`decode_shorten` call that returned samples): lets a run show that
#: its shorten channels went through it.
shorten_decodes = 0
_count_lock = threading.Lock()
_build_lock = threading.Lock()

_ERRORS = {
    -1: "cannot open file",
    -2: "unrecognized container magic",
    -3: "malformed header",
    -4: "unsupported encoding/channel",
    -5: "IO error",
    -6: "malformed or unsupported shorten bitstream",
    -7: "malformed bitstream",
}


def _raise_audio_error(label: str, rc: int) -> None:
    msg = f"{label}: {_ERRORS.get(rc, f'error {rc}')}"
    if rc == -4:
        # The numpy parser's type for unsupported formats (data/audio.py):
        # a caller skipping them behaves alike with or without a compiler.
        raise NotImplementedError(msg)
    raise ValueError(msg)


class _AudioInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_int32),
        ("num_samples", ctypes.c_int64),
        ("num_channels", ctypes.c_int32),
        ("sample_bytes", ctypes.c_int32),
        ("encoding", ctypes.c_int32),
        ("big_endian", ctypes.c_int32),
        ("data_offset", ctypes.c_int64),
        ("is_wav", ctypes.c_int32),
    ]


def library_path(stem: str) -> Path:
    """Where the library ``stem`` ('audiodec' or 'pcmpack') is built:
    keyed on its source and the compiler flags."""
    src, extra = _SOURCES[stem]
    key = hashlib.sha256((_CSRC / src).read_bytes() + " ".join(GXX_FLAGS + extra).encode())
    return BUILD_DIR / f"lib{stem}_{key.hexdigest()[:16]}.so"


def build(stem: str) -> Path:
    """Compile the library ``stem`` unless this source is already built;
    returns its path.  Raises ``OSError`` (no compiler) or
    ``subprocess.CalledProcessError`` (the compile failed)."""
    lib = library_path(stem)
    if lib.is_file():
        return lib
    src, extra = _SOURCES[stem]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(_CSRC / src), "-o", tmp, *extra],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def _load(stem: str) -> Optional[ctypes.CDLL]:
    """The built library ``stem``, or None (warned once) where it cannot be
    built or loaded."""
    with _build_lock:
        try:
            lib = ctypes.CDLL(str(build(stem)))
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", None) or e
            warnings.warn(
                f"the native {stem} library could not be built or loaded ({detail}); "
                "falling back to the numpy " + ("shorten decoder" if stem == "audiodec"
                                                 else "PCM packer"),
                RuntimeWarning, stacklevel=3,
            )
            return None
    if stem == "audiodec":
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        lib.audio_info.restype = ctypes.c_int
        lib.audio_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(_AudioInfo)]
        lib.audio_read_f32.restype = i64
        lib.audio_read_f32.argtypes = [ctypes.c_char_p, i64, i64, i32,
                                       ctypes.POINTER(ctypes.c_float)]
        lib.audio_read_batch.restype = ctypes.c_int
        lib.audio_read_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(i64), ctypes.POINTER(i64),
            ctypes.POINTER(i32), ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(i64), ctypes.c_int, ctypes.c_int,
        ]
        lib.audio_decode_shorten_i16.restype = i64
        lib.audio_decode_shorten_i16.argtypes = [ctypes.c_char_p,
                                                 ctypes.POINTER(ctypes.c_int16), i64, i32]
    else:
        lib.pcm_pack.restype = ctypes.c_int64
        lib.pcm_pack.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
    return lib


def available() -> bool:
    """Is the native audio decoder built and loaded (builds it on first use)?"""
    return _load("audiodec") is not None


def pack_pcm_native(
    wave: np.ndarray, block: int, mode: int = -1
) -> Optional[Tuple[np.ndarray, np.ndarray, bool, int]]:
    """Native bit-pack of int16 PCM (the layout is ops/pcm_pack.py's).

    Returns (words, widths, delta, n_words) with ``words`` sized to the
    worst case (the caller trims and pads), or None without the native
    library (the caller falls back to the numpy packer)."""
    lib = _load("pcmpack")
    if lib is None:
        return None
    if block <= 0 or block % 32:
        return None  # the C side refuses the same (word alignment)
    wave = np.ascontiguousarray(wave, dtype=np.int16)
    if wave.ndim != 1:
        # n below would count rows of a 2-D buffer.
        raise ValueError(f"pack_pcm_native wants 1-D int16 PCM, got {wave.shape}")
    n = len(wave)
    n_blocks = max(1, -(-n // block))
    words = np.zeros(n_blocks * (block // 32) * 17 + 1, dtype=np.uint32)
    widths = np.empty(n_blocks, dtype=np.int32)
    delta = ctypes.c_int32(0)
    n_words = lib.pcm_pack(
        wave.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), n, block, mode,
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        widths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ctypes.byref(delta),
    )
    if n_words < 0:
        return None
    return words, widths, bool(delta.value), int(n_words)


def info(path: str) -> py_audio.AudioInfo:
    """Native header parse, as data/audio.info reports it (the numpy
    parser without the native library)."""
    lib = _load("audiodec")
    if lib is None:
        return py_audio.info(path)
    out = _AudioInfo()
    rc = lib.audio_info(path.encode(), ctypes.byref(out))
    if rc:
        _raise_audio_error(path, rc)
    return py_audio.AudioInfo(
        sample_rate=out.sample_rate,
        num_samples=out.num_samples,
        num_channels=out.num_channels,
        sample_bytes=out.sample_bytes,
        encoding={0: "pcm", 1: "ulaw", 2: "float", 3: "shorten"}[out.encoding],
        big_endian=bool(out.big_endian),
        data_offset=out.data_offset,
        container="wav" if out.is_wav else "sphere",
    )


def decode_shorten(path: str, num_frames: int, num_channels: int) -> Optional[np.ndarray]:
    """Whole-stream shorten decode to (frames, nchan) int16, or None
    without the native library (the caller falls back to data/shorten.py)."""
    global shorten_decodes
    lib = _load("audiodec")
    if lib is None:
        return None
    out = np.empty((num_frames, num_channels), dtype=np.int16)
    # num_channels is the buffer's layout: the C side enforces it against
    # the stream rather than trusting its own header re-parse.
    got = lib.audio_decode_shorten_i16(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        num_frames, num_channels,
    )
    if got < 0:
        _raise_audio_error(path, int(got))
    with _count_lock:
        shorten_decodes += 1
    if int(got) < num_frames:
        return out[: int(got)].copy()  # a view would pin the header-sized buffer
    return out


def read(path: str, offset: float = 0.0, duration: Optional[float] = None,
         channel: int = 0) -> Tuple[np.ndarray, int]:
    """Ranged decode to float32 [-1, 1], as data/audio.read; shorten goes
    through data/audio's whole-file cache (itself decoded natively)."""
    lib = _load("audiodec")
    if lib is None:
        return py_audio.read(path, offset=offset, duration=duration, channel=channel)
    meta = info(path)
    # Validated here: the C side folds a bad channel and an unsupported
    # format into one code, which the two error types tell apart.
    channel = py_audio._check_channel(path, meta, channel)
    if meta.encoding == "shorten":
        return py_audio.read(path, offset=offset, duration=duration, channel=channel)
    start, count = py_audio.resolve_range(meta.num_samples, meta.sample_rate, offset, duration)
    out = np.empty(count, dtype=np.float32)
    got = lib.audio_read_f32(path.encode(), start, count, channel,
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if got < 0:
        _raise_audio_error(path, int(got))
    return out[: int(got)], meta.sample_rate


def read_batch(paths: Sequence[str], channels: Optional[Sequence[int]] = None,
               threads: int = 8) -> List[Tuple[np.ndarray, int]]:
    """Decode whole files concurrently (a meeting's channels in one call)
    to float32 [-1, 1]."""
    if channels is not None and len(channels) != len(paths):
        raise ValueError(f"read_batch got {len(paths)} paths but {len(channels)} channels")
    chans = list(channels) if channels is not None else [0] * len(paths)
    lib = _load("audiodec")
    if lib is None:
        return [read(p, channel=c) for p, c in zip(paths, chans)]
    n = len(paths)
    if n == 0:
        return []
    metas = [info(p) for p in paths]
    chans = [py_audio._check_channel(p, m, c) for p, m, c in zip(paths, metas, chans)]
    outs = [np.empty(m.num_samples, dtype=np.float32) for m in metas]
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_starts = (ctypes.c_int64 * n)(*([0] * n))
    c_counts = (ctypes.c_int64 * n)(*[m.num_samples for m in metas])
    c_chans = (ctypes.c_int32 * n)(*chans)
    c_outs = (ctypes.POINTER(ctypes.c_float) * n)(
        *[o.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for o in outs])
    c_res = (ctypes.c_int64 * n)()
    rc = lib.audio_read_batch(c_paths, c_starts, c_counts, c_chans, c_outs, c_res, n, threads)
    if rc:
        # A batch-level failure writes no per-file result: the zeroed
        # results would otherwise read as n empty waveforms.
        raise MemoryError(f"audio_read_batch failed: {_ERRORS.get(int(rc), f'error {rc}')}")
    results = []
    for i in range(n):
        got = int(c_res[i])
        if got < 0:
            _raise_audio_error(paths[i], got)
        results.append((outs[i][:got], metas[i].sample_rate))
    return results
