"""Audio decoding: NIST SPHERE (.sph) and RIFF WAV, dependency-free.

Owns the roles the reference delegates to librosa/audioread/soundfile and the
``sph2pipe`` binary (reference segment_laughter.py:134, utils/audio_utils.py:7-9,
analysis/output_processing/laughs_to_wav.py:42-60): header parsing, PCM
decode, segment cutting, and WAV writing.  A copy of the JAX package's
``data/audio.py`` for the PyTorch port: shorten streams decode through the
native C++ decoder (runtime/native.py), or in numpy (data/shorten.py)
where it cannot be built.

Supported encodings: 16-bit/8-bit linear PCM (either endianness), mu-law,
and embedded-shorten v2 (the compression the ICSI corpus actually ships —
decoded in-framework by data/shorten.py, replacing the reference's
sph2pipe dependency).  Shorten is a sequential codec, so ranged reads decode the
whole file once and serve slices from a small in-process cache.
"""

from __future__ import annotations

import dataclasses
import struct
import threading
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class AudioInfo:
    sample_rate: int
    num_samples: int
    num_channels: int
    sample_bytes: int
    encoding: str  # 'pcm' | 'ulaw' | 'float' | 'shorten'
    big_endian: bool
    data_offset: int
    container: str  # 'sphere' | 'wav'

    @property
    def duration(self) -> float:
        return self.num_samples / self.sample_rate


# --------------------------------------------------------------------------- #
# SPHERE
# --------------------------------------------------------------------------- #


def _parse_sphere_header(path: str) -> AudioInfo:
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"NIST_1A":
            raise ValueError(f"{path}: not a NIST SPHERE file (magic {magic!r})")
        header_size = int(f.readline().strip())
        f.seek(0)
        header = f.read(header_size).decode("ascii", errors="replace")

    fields = {}
    for line in header.splitlines()[2:]:
        line = line.strip()
        if line == "end_head":
            break
        parts = line.split(None, 2)
        if len(parts) != 3:
            continue
        name, ftype, value = parts
        if ftype.startswith("-i"):
            fields[name] = int(value)
        elif ftype.startswith("-r"):
            fields[name] = float(value)
        else:
            fields[name] = value

    coding = str(fields.get("sample_coding", "pcm"))
    if "shorten" in coding:
        encoding = "shorten"
    elif "ulaw" in coding:
        encoding = "ulaw"
    elif coding.startswith("pcm") or coding == "raw":
        encoding = "pcm"
    else:
        raise NotImplementedError(f"{path}: unsupported sample_coding {coding!r}")

    byte_format = str(fields.get("sample_byte_format", "01"))
    big_endian = byte_format == "10"
    if "sample_rate" not in fields or "sample_count" not in fields:
        # a bare KeyError is not the documented malformed-header ValueError
        raise ValueError(f"{path}: SPHERE header missing sample_rate/sample_count")
    channels = int(fields.get("channel_count", 1))
    sample_bytes = int(fields.get("sample_n_bytes", 2))
    if (
        int(fields["sample_rate"]) <= 0
        or int(fields["sample_count"]) < 0
        # zero/negative would ZeroDivisionError or negative-seek far from
        # here; >4 bytes is no PCM we read.  Mirrors the C decoder's
        # AERR_HEADER bounds so the twins agree with or without a compiler.
        or channels <= 0
        or channels > 4096
        or sample_bytes <= 0
        or sample_bytes > 4
    ):
        raise ValueError(f"{path}: malformed SPHERE header fields")
    return AudioInfo(
        sample_rate=int(fields["sample_rate"]),
        num_samples=int(fields["sample_count"]),
        num_channels=channels,
        sample_bytes=sample_bytes,
        encoding=encoding,
        big_endian=big_endian,
        data_offset=header_size,
        container="sphere",
    )


# --------------------------------------------------------------------------- #
# WAV
# --------------------------------------------------------------------------- #


def _parse_wav_header(path: str) -> AudioInfo:
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        while True:
            chunk_header = f.read(8)
            if len(chunk_header) < 8:
                raise ValueError(f"{path}: no data chunk found")
            cid, csize = chunk_header[:4], struct.unpack("<I", chunk_header[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(csize)
                if csize % 2:
                    f.read(1)
            elif cid == b"data":
                data_offset = f.tell()
                data_size = csize
                break
            else:
                f.seek(csize + (csize % 2), 1)
    if fmt is None:
        raise ValueError(f"{path}: missing fmt chunk")
    if len(fmt) < 16:
        # struct.error is not a ValueError; keep the malformed-header
        # contract uniform
        raise ValueError(f"{path}: WAV fmt chunk truncated ({len(fmt)} bytes)")
    audio_format, channels, sample_rate, _, _, bits = struct.unpack(
        "<HHIIHH", fmt[:16]
    )
    if audio_format == 0xFFFE:
        # WAVE_FORMAT_EXTENSIBLE: the real format is the first two bytes of
        # the SubFormat GUID in the extension (fmt bytes 24-25); treating
        # extensible float WAVs as integer PCM would decode bit patterns as
        # noise.
        if len(fmt) < 26:
            raise ValueError(f"{path}: extensible WAV without SubFormat GUID")
        audio_format = struct.unpack("<H", fmt[24:26])[0]
    if audio_format == 7:
        encoding, sample_bytes = "ulaw", 1
    elif audio_format == 1:
        encoding, sample_bytes = "pcm", bits // 8
    elif audio_format == 3:
        encoding, sample_bytes = "float", bits // 8
        if sample_bytes not in (4, 8):
            # match the C twin's parse-time AERR_UNSUPPORTED — deferring to
            # read() surfaced a bare KeyError from the f4/f8 dtype map
            raise NotImplementedError(
                f"{path}: {bits}-bit float WAV unsupported (want 32/64)"
            )
    else:
        raise NotImplementedError(f"{path}: unsupported WAV format {audio_format}")
    if channels <= 0 or sample_bytes <= 0 or sample_rate <= 0:
        # a corrupt fmt chunk (channels=0, bits<8, or rate=0) would
        # otherwise raise ZeroDivisionError here or in every downstream
        # duration computation instead of the ValueError malformed-header
        # contract every other path keeps (the C decoder rejects this too)
        raise ValueError(f"{path}: malformed WAV fmt chunk")
    num_samples = data_size // (sample_bytes * channels)
    return AudioInfo(
        sample_rate=sample_rate,
        num_samples=num_samples,
        num_channels=channels,
        sample_bytes=sample_bytes,
        encoding=encoding,
        big_endian=False,
        data_offset=data_offset,
        container="wav",
    )


# --------------------------------------------------------------------------- #
# Public API
# --------------------------------------------------------------------------- #

_ULAW_TABLE: Optional[np.ndarray] = None


def _ulaw_table() -> np.ndarray:
    global _ULAW_TABLE
    if _ULAW_TABLE is None:
        u = np.arange(256, dtype=np.uint8)
        u = ~u
        sign = np.where(u & 0x80, -1, 1)
        exponent = (u >> 4) & 0x07
        mantissa = u & 0x0F
        magnitude = ((mantissa.astype(np.int32) << 3) + 0x84) << exponent
        _ULAW_TABLE = (sign * (magnitude - 0x84)).astype(np.int16)
    return _ULAW_TABLE


# Shorten is sequential (no ranged decode), so whole-file decodes are cached:
# key -> (frames, nchan) int16.  Two entries cover the common access pattern
# (a meeting channel being windowed, plus one neighbour).  The lock guards
# the check-then-evict (meeting channels decode concurrently from thread
# pools, e.g. parallel/sharded_inference.py — unsynchronized eviction could
# pop from an already-emptied dict); decodes themselves run OUTSIDE the
# lock so concurrent different-file decodes still parallelize (the rare
# same-file race costs a duplicate decode, never a crash).
_SHORTEN_CACHE: "dict[tuple, np.ndarray]" = {}
_SHORTEN_CACHE_MAX = 2
_SHORTEN_CACHE_LOCK = threading.Lock()


def _decode_shorten_cached(path: str, meta: AudioInfo) -> np.ndarray:
    import os

    st = os.stat(path)
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    with _SHORTEN_CACHE_LOCK:
        hit = _SHORTEN_CACHE.pop(key, None)
        if hit is not None:
            # re-insert on hit: dict order is insertion order, so eviction
            # below becomes LRU, not FIFO — otherwise the pattern A,B,A,C
            # evicts the hot A and re-decodes the whole meeting channel
            _SHORTEN_CACHE[key] = hit
    if hit is not None:
        return hit
    from laughter_detection_icsi_tpu_torch.runtime import native

    try:  # the native decoder, where it builds (runtime/csrc/audio_decoder.cpp)
        pcm = native.decode_shorten(path, meta.num_samples, meta.num_channels)
    except (ValueError, NotImplementedError):
        pcm = None  # the numpy decoder below reports the stream's fault itself
    if pcm is None:
        from laughter_detection_icsi_tpu_torch.data import shorten as _shorten

        pcm = _shorten.decode_file(path, meta.data_offset, max_frames=meta.num_samples)
    with _SHORTEN_CACHE_LOCK:
        while len(_SHORTEN_CACHE) >= _SHORTEN_CACHE_MAX:
            _SHORTEN_CACHE.pop(next(iter(_SHORTEN_CACHE)))
        _SHORTEN_CACHE[key] = pcm
    return pcm


def info(path: str) -> AudioInfo:
    """Parse the header of a .sph or .wav file."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"NIST":
        return _parse_sphere_header(path)
    if magic == b"RIFF":
        return _parse_wav_header(path)
    raise ValueError(f"{path}: unrecognized audio container (magic {magic!r})")


def get_audio_length(path: str) -> float:
    """Duration in seconds (reference utils/audio_utils.py:7-9)."""
    return info(path).duration


def find_track_audio(
    signals_dir: str, meeting_id: str, chan_id: str
) -> Optional[str]:
    """``<signals>/<meeting>/<chan>.sph``, falling back to ``.wav`` — THE
    corpus track-file resolution rule (shared by the train and sweep CLIs
    so the probe order and supported containers cannot drift)."""
    import os

    for ext in (".sph", ".wav"):
        p = os.path.join(signals_dir, meeting_id, chan_id + ext)
        if os.path.isfile(p):
            return p
    return None


def _check_channel(path: str, meta: AudioInfo, channel: int) -> int:
    """Mono files ignore ``channel`` (matched by the C decoder — the two
    twins must behave identically whether or not a compiler was present);
    multichannel files require a valid index, uniformly across encodings."""
    if meta.num_channels == 1:
        return 0
    if not 0 <= channel < meta.num_channels:
        raise ValueError(
            f"{path}: channel {channel} out of range for "
            f"{meta.num_channels}-channel audio"
        )
    return channel


def resolve_range(
    num_samples: int,
    sample_rate: int,
    offset: float,
    duration: Optional[float],
) -> Tuple[int, int]:
    """(start, count) sample range for an offset/duration request.

    THE single owner of the range arithmetic — read()/read_int16() both
    call it, so they cannot drift.  Negative offsets clamp to 0 like the C decoder: an unclamped
    start seeked before the data chunk (OSError / header bytes decoded as
    audio) on the PCM path and silently sliced from the ARRAY TAIL on the
    shorten path.
    """
    start = max(int(round(offset * sample_rate)), 0)
    count = (
        num_samples - start
        if duration is None
        else min(int(round(duration * sample_rate)), num_samples - start)
    )
    return start, max(count, 0)


def read(
    path: str,
    offset: float = 0.0,
    duration: Optional[float] = None,
    channel: int = 0,
    dtype=np.float32,
) -> Tuple[np.ndarray, int]:
    """Decode audio to float in [-1, 1].  Returns (samples, sample_rate).

    ``offset``/``duration`` are in seconds; reads only the needed byte range
    (the reference's librosa path decodes whole files; see
    misc_scripts/check_librosa_loading_times.py for why that hurt).
    """
    meta = info(path)
    channel = _check_channel(path, meta, channel)
    sr = meta.sample_rate
    start, count = resolve_range(meta.num_samples, sr, offset, duration)
    if meta.encoding == "shorten":
        pcm = _decode_shorten_cached(path, meta)
        sl = pcm[start : start + count, channel]
        return (sl.astype(dtype) / 32768.0).astype(dtype), sr
    frame_bytes = meta.sample_bytes * meta.num_channels
    with open(path, "rb") as f:
        f.seek(meta.data_offset + start * frame_bytes)
        raw = f.read(count * frame_bytes)
    count = len(raw) // frame_bytes
    raw = raw[: count * frame_bytes]

    if meta.encoding == "ulaw":
        data = _ulaw_table()[np.frombuffer(raw, dtype=np.uint8)]
        scale = 32768.0
    elif meta.encoding == "float":
        fmt = {4: "<f4", 8: "<f8"}[meta.sample_bytes]
        data = np.frombuffer(raw, dtype=fmt)
        scale = 1.0
    else:  # pcm
        if meta.sample_bytes == 2:
            fmt = ">i2" if meta.big_endian else "<i2"
            scale = 32768.0
        elif meta.sample_bytes == 1:
            # WAV stores 8-bit PCM UNSIGNED (midpoint 0x80); SPHERE is
            # signed.  Decoding WAV as signed would wrap mid-scale (silence
            # at -1.0).
            if meta.container == "wav":
                data = np.frombuffer(raw, dtype=np.uint8).astype(np.int16) - 128
                if meta.num_channels > 1:
                    data = data.reshape(-1, meta.num_channels)[:, channel]
                return (data.astype(dtype) / 128.0).astype(dtype), sr
            fmt = "i1"
            scale = 128.0
        elif meta.sample_bytes == 4:
            fmt = ">i4" if meta.big_endian else "<i4"
            scale = 2147483648.0
        else:
            raise NotImplementedError(
                f"{path}: {meta.sample_bytes}-byte PCM unsupported"
            )
        data = np.frombuffer(raw, dtype=fmt)

    if meta.num_channels > 1:
        data = data.reshape(-1, meta.num_channels)[:, channel]
    return (data.astype(dtype) / scale).astype(dtype), sr


def read_int16(
    path: str,
    offset: float = 0.0,
    duration: Optional[float] = None,
    channel: int = 0,
    meta: Optional[AudioInfo] = None,
) -> Tuple[np.ndarray, int]:
    """Raw int16 PCM samples (no float scaling) — the cheap device-transfer
    path: scale-by-1/32768 happens on device and matches :func:`read`
    bit-for-bit.  Only valid for 16-bit PCM sources.

    ``meta``: pass the already-parsed :func:`info` result to skip the
    second header parse (batch callers parse headers for the transfer-
    eligibility check first).
    """
    meta = meta if meta is not None else info(path)
    channel = _check_channel(path, meta, channel)
    if meta.encoding not in ("pcm", "shorten") or meta.sample_bytes != 2:
        raise ValueError(
            f"{path}: read_int16 requires 16-bit PCM "
            f"(got {meta.encoding}/{meta.sample_bytes * 8}-bit)"
        )
    sr = meta.sample_rate
    start, count = resolve_range(meta.num_samples, sr, offset, duration)
    if meta.encoding == "shorten":
        pcm = _decode_shorten_cached(path, meta)
        # .copy(), not ascontiguousarray: a mono slice is already contiguous
        # and would alias the module-level cache — a caller mutating its
        # buffer would poison every later read of this file.
        return pcm[start : start + count, channel].copy(), sr
    frame_bytes = 2 * meta.num_channels
    with open(path, "rb") as f:
        f.seek(meta.data_offset + start * frame_bytes)
        raw = f.read(count * frame_bytes)
    count = len(raw) // frame_bytes
    fmt = ">i2" if meta.big_endian else "<i2"
    data = np.frombuffer(raw[: count * frame_bytes], dtype=fmt)
    if meta.num_channels > 1:
        data = data.reshape(-1, meta.num_channels)[:, channel]
    # Native byte order for the device transfer
    return np.ascontiguousarray(data, dtype=np.int16), sr


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write float [-1, 1] (or int16) samples as 16-bit PCM WAV
    (replaces the reference's scipy.io.wavfile + sph2pipe outputs)."""
    samples = np.asarray(samples)
    if samples.dtype != np.int16:
        samples = np.clip(samples, -1.0, 1.0)
        samples = (samples * 32767.0).astype(np.int16)
    if samples.ndim == 1:
        samples = samples[:, None]
    n, ch = samples.shape
    data = samples.astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVEfmt ")
        f.write(
            struct.pack(
                "<IHHIIHH", 16, 1, ch, sample_rate, sample_rate * ch * 2, ch * 2, 16
            )
        )
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)


def write_sphere(
    path: str, samples: np.ndarray, sample_rate: int, big_endian: bool = False
) -> None:
    """Write 16-bit PCM SPHERE (for tests and tooling round-trips).
    1-D mono or 2-D [frames, channels] interleaved — like write_wav."""
    samples = np.asarray(samples)
    if samples.dtype != np.int16:
        samples = (np.clip(samples, -1.0, 1.0) * 32767.0).astype(np.int16)
    if samples.ndim == 1:
        samples = samples[:, None]
    if samples.ndim != 2:
        raise ValueError(f"write_sphere wants 1-D or 2-D samples, got {samples.shape}")
    n_frames, n_chan = samples.shape
    header_size = 1024
    fields = [
        ("channel_count", "-i", str(n_chan)),
        ("sample_count", "-i", str(n_frames)),
        ("sample_rate", "-i", str(sample_rate)),
        ("sample_n_bytes", "-i", "2"),
        ("sample_byte_format", "-s2", "10" if big_endian else "01"),
        ("sample_coding", "-s3", "pcm"),
    ]
    lines = ["NIST_1A", f"{header_size:7d}"]
    lines += [f"{n} {t} {v}" for n, t, v in fields]
    lines.append("end_head")
    header = ("\n".join(lines) + "\n").encode("ascii")
    header = header + b" " * (header_size - len(header))
    data = samples.astype(">i2" if big_endian else "<i2").tobytes()
    with open(path, "wb") as f:
        f.write(header)
        f.write(data)


def write_sphere_shorten(
    path: str,
    samples: np.ndarray,
    sample_rate: int,
    blocksize: int = 256,
    big_endian: bool = True,
) -> None:
    """Write an embedded-shorten-v2.00 SPHERE file (the format LDC ships the
    ICSI corpus in; replaces the reference's reliance on pre-decompressed
    inputs).  The original PCM-style header travels inside the stream as
    FN_VERBATIM chunks, exactly like files produced by `shorten` itself."""
    from laughter_detection_icsi_tpu_torch.data import shorten as _shorten

    samples = np.asarray(samples)
    if samples.dtype != np.int16:
        samples = (np.clip(samples, -1.0, 1.0) * 32767.0).astype(np.int16)
    if samples.ndim == 1:
        samples = samples[:, None]
    n, nchan = samples.shape
    header_size = 1024
    ftype = _shorten.TYPE_S16HL if big_endian else _shorten.TYPE_S16LH
    byte_format = "10" if big_endian else "01"

    def _header(coding: str) -> bytes:
        lines = ["NIST_1A", f"{header_size:7d}"]
        lines += [
            f"channel_count -i {nchan}",
            f"sample_count -i {n}",
            f"sample_rate -i {sample_rate}",
            "sample_n_bytes -i 2",
            f"sample_byte_format -s2 {byte_format}",
            f"sample_coding -s{len(coding)} {coding}",
            "end_head",
        ]
        head = ("\n".join(lines) + "\n").encode("ascii")
        return head + b" " * (header_size - len(head))

    payload = _shorten.encode(
        samples, blocksize=blocksize, ftype=ftype, verbatim=_header("pcm")
    )
    with open(path, "wb") as f:
        f.write(_header("pcm,embedded-shorten-v2.00"))
        f.write(payload)


def cut_segments(
    path: str, segments, channel: int = 0
) -> Tuple[np.ndarray, int]:
    """Concatenate the audio of [(start_s, end_s), ...] cuts
    (reference laugh_segmenter.py:35-42 cut_laughter_segments)."""
    parts = []
    sr = info(path).sample_rate
    for start, end in segments:
        wav, _ = read(path, offset=start, duration=end - start, channel=channel)
        parts.append(wav)
    if not parts:
        return np.zeros(0, dtype=np.float32), sr
    return np.concatenate(parts), sr
