"""Shorten (v2) lossless audio codec: pure-Python decoder + encoder.

The ICSI corpus ships "embedded-shorten-v2.00" SPHERE files (the reference
shells out to the ``sph2pipe`` binary to decompress them —
reference analysis/output_processing/laughs_to_wav.py:42-60 and the
librosa/audioread stack in segment_laughter.py:134); this module owns that
decode in-framework so ``get_icsi_data`` downloads feed the pipeline
directly.  A copy of the JAX package's ``data/shorten.py``: the PyTorch
port keeps its own pure-numpy decoder (the JAX package's C++ twin in
``runtime/csrc/audio_decoder.cpp`` is not ported yet), plus the encoder
used to build test fixtures and compressed outputs.  "The C++ twin" in the
comments below is that JAX-package decoder, whose limits this one mirrors.

Format (shorten 2.x, T. Robinson, SoftSound; same subset ffmpeg/sph2pipe
interoperate on): after the 5-byte magic ``ajkg\\x02`` comes an MSB-first
bitstream of Rice/Golomb codes —

- ``uvar(k)``: unary count of 0-bits terminated by a 1, then ``k`` literal
  low bits; value = ``(unary << k) | low``.
- ``ulong``: ``nbits = uvar(2)`` then ``uvar(nbits)``.
- ``var(k)`` (signed): ``u = uvar(k+1)``; odd ``u`` → ``-(u>>1)-1``, even →
  ``u>>1``.

Header: ftype, nchan, blocksize, maxnlpc, nmean, nskip (all ulong; nskip
bytes follow as uvar(7) each).  Then commands ``fn = uvar(2)``:
DIFF0..3 / QLPC / ZERO decode one channel block (residuals ``var(resn)``
where ``resn = uvar(3)`` — v2 carries the Rice parameter verbatim; only
version 0 streams decrement it), BLOCKSIZE / BITSHIFT change state, VERBATIM
(len = uvar(5), bytes = uvar(8)) carries the embedded original SPHERE
header, QUIT ends the stream.  Predictors:

    DIFF0: x[i] = res + coffset          DIFF2: x[i] = res + 2x[i-1] - x[i-2]
    DIFF1: x[i] = res + x[i-1]           DIFF3: x[i] = res + 3(x[i-1]-x[i-2]) + x[i-3]
    QLPC:  x[i] = res + ((2^(q-1) + sum_j c_j * (x[i-1-j]-coffset)) >> q), q=5,
           then += coffset
    ZERO:  x[i] = 0

``coffset`` is the rounded mean of the last ``nmean`` block means (shifted
down by ``bitshift``); history wraps ``max(3, maxnlpc)`` samples across
blocks (pre-bitshift domain); decoded blocks are left-shifted by
``bitshift`` on output.  Only the ICSI-relevant linear 16-bit profile
(ftype S16HL/S16LH) is supported; ulaw/alaw shorten profiles are rejected.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

MAGIC = b"ajkg"
VERSION = 2

# ftype codes (shorten's TYPE_*)
TYPE_AU1 = 0
TYPE_S8 = 1
TYPE_U8 = 2
TYPE_S16HL = 3
TYPE_U16HL = 4
TYPE_S16LH = 5
TYPE_U16LH = 6
TYPE_ULAW = 7
TYPE_AU2 = 8
TYPE_AU3 = 9
TYPE_ALAW = 10

_SUPPORTED_FTYPES = (TYPE_S16HL, TYPE_S16LH)

# Code sizes (bit widths of the uvar low parts)
_FNSIZE = 2
_ULONGSIZE = 2
_ENERGYSIZE = 3
_BITSHIFTSIZE = 2
_LPCQSIZE = 2
_LPCQUANT = 5
_XBYTESIZE = 7
_VERBATIM_CKSIZE_SIZE = 5
_VERBATIM_BYTE_SIZE = 8
_NWRAP = 3

# Function (command) codes
FN_DIFF0 = 0
FN_DIFF1 = 1
FN_DIFF2 = 2
FN_DIFF3 = 3
FN_QUIT = 4
FN_BLOCKSIZE = 5
FN_BITSHIFT = 6
FN_QLPC = 7
FN_ZERO = 8
FN_VERBATIM = 9

_MAX_CHANNELS = 64
_MAX_BLOCKSIZE = 65535
_MAX_NLPC = 1024
_MAX_NMEAN = 65536


def _c_div(a: int, b: int) -> int:
    """C-style integer division (truncate toward zero; shorten.c uses `/`)."""
    q = a // b
    if q < 0 and q * b != a:
        q += 1
    return q


def _rounded_shift_down(x: int, n: int) -> int:
    """shorten's ROUNDEDSHIFTDOWN: round-half-up arithmetic shift."""
    return x if n == 0 else ((x >> (n - 1)) + 1) >> 1


@dataclasses.dataclass
class ShortenStream:
    """Decoded stream: interleaved samples + the stream's own metadata."""

    samples: np.ndarray  # (frames, nchan) int32 (pre-clip domain)
    nchan: int
    ftype: int
    verbatim: bytes  # concatenated FN_VERBATIM payload (embedded header)


class _BitReader:
    """MSB-first bit reader over a byte buffer (shorten pads the tail with
    zero bits to a 32-bit word boundary, so a clean stream always ends with
    FN_QUIT before the data runs out)."""

    __slots__ = ("bits", "ones", "pos", "n")

    def __init__(self, data: bytes):
        if len(data) * 8 >= 2**31:
            # int32 one-positions below; larger payloads would wrap the
            # index silently.  (~268 MB compressed ≈ 4+ hours of 16 kHz
            # audio — far beyond any ICSI channel; the C++ decoder has no
            # such bound.)
            raise ValueError(
                "shorten: payload too large for the Python decoder "
                f"({len(data)} bytes)"
            )
        arr = np.frombuffer(data, dtype=np.uint8)
        self.bits = np.unpackbits(arr)
        # int32 positions: shorten payloads are far below 2^31 bits, and the
        # index must stay memory-proportional to the payload (a full int64
        # prefix-sum over every bit cost ~64x the payload and OOM'd on
        # hour-long meeting channels).
        self.ones = np.flatnonzero(self.bits).astype(np.int32)
        self.pos = 0
        self.n = len(self.bits)

    def _next_one(self, pos: int) -> int:
        """Index in ``ones`` of the first one-bit at or after ``pos``.  The
        key is cast to the index's int32: a Python-int key makes numpy cast
        the whole index to int64 on every call, which turns the decode
        quadratic (~3.5 ms a call on a 30 s channel's 3.4M one-bits).
        Positions past int32 lie past every one-bit and clamp."""
        return int(np.searchsorted(self.ones, np.int32(min(pos, 2**31 - 1))))

    def _low(self, k: int) -> int:
        if k == 0:
            return 0
        p = self.pos
        if p + k > self.n:
            raise ValueError("shorten: bitstream truncated")
        v = 0
        for b in self.bits[p : p + k]:
            v = (v << 1) | int(b)
        self.pos = p + k
        return v

    def uvar(self, k: int) -> int:
        i = self._next_one(self.pos)
        if i >= len(self.ones):
            raise ValueError("shorten: bitstream truncated (unary run)")
        one = int(self.ones[i])
        unary = one - self.pos
        self.pos = one + 1
        return (unary << k) | self._low(k)

    def ulong(self) -> int:
        nbits = self.uvar(_ULONGSIZE)
        if nbits > 32:
            # ulongs are 32-bit; match the C++ twin's rejection (there a
            # corrupt nbits would be shift-width UB).
            raise ValueError(f"shorten: bad ulong width {nbits}")
        return self.uvar(nbits)

    def var(self, k: int) -> int:
        u = self.uvar(k + 1)
        return (u >> 1) ^ -(u & 1)

    def block_uvar(self, count: int, k: int) -> np.ndarray:
        """Decode `count` consecutive uvar(k) values, vectorised.

        The unary-terminator chain is sequential, but with the global 1-bit
        index (`ones`) each step is one binary search:
        ``next_terminator = first one-position >= previous_end``.
        The low bits are then gathered in one fancy-index.
        """
        if count == 0:
            return np.zeros(0, dtype=np.int64)
        ones = self.ones
        i = self._next_one(self.pos)
        terms = np.empty(count, dtype=np.int64)
        starts = np.empty(count, dtype=np.int64)
        pos = self.pos
        n_ones = len(ones)
        step = 1 + k
        for j in range(count):
            if i >= n_ones:
                raise ValueError("shorten: bitstream truncated (block)")
            t = int(ones[i])
            terms[j] = t
            starts[j] = pos
            pos = t + step
            i = self._next_one(pos)
        if pos > self.n:
            raise ValueError("shorten: bitstream truncated (block tail)")
        self.pos = pos
        unary = terms - starts
        if k == 0:
            return unary
        lows = self.bits[terms[:, None] + 1 + np.arange(k)].astype(np.int64)
        low = lows @ (1 << np.arange(k - 1, -1, -1, dtype=np.int64))
        return (unary << k) | low

    def block_var(self, count: int, k: int) -> np.ndarray:
        u = self.block_uvar(count, k + 1)
        return (u >> 1) ^ -(u & 1)


def decode(data: bytes, max_frames: Optional[int] = None) -> ShortenStream:
    """Decode a complete shorten stream (the bytes after the SPHERE header).

    Returns int32 samples shaped (frames, nchan).  ``max_frames`` bounds the
    output (decode stops once reached); the SPHERE header's sample_count is
    the natural bound.
    """
    if len(data) < 5 or data[:4] != MAGIC:
        raise ValueError(
            f"shorten: bad magic {data[:5]!r} (expected {MAGIC!r} + version)"
        )
    version = data[4]
    if version != VERSION:
        raise NotImplementedError(
            f"shorten: version {version} unsupported (only v2)"
        )
    br = _BitReader(data[5:])

    ftype = br.ulong()
    if ftype not in _SUPPORTED_FTYPES:
        raise NotImplementedError(
            f"shorten: ftype {ftype} unsupported (linear 16-bit only)"
        )
    nchan = br.ulong()
    if not 0 < nchan <= _MAX_CHANNELS:
        raise ValueError(f"shorten: bad channel count {nchan}")
    blocksize = br.ulong()
    if not 0 < blocksize <= _MAX_BLOCKSIZE:
        raise ValueError(f"shorten: bad blocksize {blocksize}")
    maxnlpc = br.ulong()
    if maxnlpc > _MAX_NLPC:
        raise ValueError(f"shorten: bad maxnlpc {maxnlpc}")
    nmean = br.ulong()
    if nmean > _MAX_NMEAN:
        raise ValueError(f"shorten: bad nmean {nmean}")
    nskip = br.ulong()
    if nskip * 8 > br.n - br.pos:
        raise ValueError(f"shorten: nskip {nskip} exceeds payload")
    for _ in range(nskip):
        br.uvar(_XBYTESIZE)

    nwrap = max(_NWRAP, maxnlpc)
    history = [np.zeros(nwrap, dtype=np.int64) for _ in range(nchan)]
    offsets = [[0] * max(1, nmean) for _ in range(nchan)]
    bitshift = 0
    chan = 0
    chunks = []  # per-channel decoded blocks awaiting a full group
    group: list = [None] * nchan
    frames_out = 0
    verbatim = bytearray()

    while True:
        fn = br.uvar(_FNSIZE)
        if fn == FN_QUIT:
            break
        if fn == FN_BLOCKSIZE:
            if chan != 0:
                # A change mid-channel-group would interleave unequal block
                # lengths; real encoders only resize at a group start (the
                # C++ twin rejects this identically).
                raise ValueError("shorten: blocksize change mid channel group")
            blocksize = br.ulong()
            if not 0 < blocksize <= _MAX_BLOCKSIZE:
                raise ValueError(f"shorten: bad blocksize {blocksize}")
            continue
        if fn == FN_BITSHIFT:
            bitshift = br.uvar(_BITSHIFTSIZE)
            if bitshift > 31:
                # No sane stream shifts past the sample width; unchecked, a
                # corrupt unary run makes the int64 `<<` silently produce 0
                # (numpy wraps shifts >= 64) -> all-zero "decoded" audio.
                raise ValueError(f"shorten: bad bitshift {bitshift}")
            continue
        if fn == FN_VERBATIM:
            n = br.uvar(_VERBATIM_CKSIZE_SIZE)
            if n * 9 > br.n - br.pos:
                # each byte costs >= 9 bits; an unbounded n is a corrupt
                # stream demanding billions of skip iterations
                raise ValueError(f"shorten: verbatim length {n} exceeds payload")
            verbatim.extend(br.uvar(_VERBATIM_BYTE_SIZE) for _ in range(n))
            continue
        if fn not in (FN_ZERO, FN_DIFF0, FN_DIFF1, FN_DIFF2, FN_DIFF3, FN_QLPC):
            raise ValueError(f"shorten: unknown function code {fn}")

        hist = history[chan]
        offs = offsets[chan]
        if fn == FN_ZERO:
            block = np.zeros(blocksize, dtype=np.int64)
        else:
            # v2 streams carry the Rice parameter verbatim: shorten.c only
            # decrements for version 0 ("hack as version 0 differed in
            # definition of var_get").  Verified against libavcodec's
            # decoder (tests/test_shorten.py ffmpeg differential) — an
            # erroneous decrement here desyncs on every real LDC/ICSI file.
            resn = br.uvar(_ENERGYSIZE)
            if resn > 31:
                # 16-bit audio residuals never need k > ~17; past 31 the
                # C++ twin's uint32 shifts would be UB.
                raise ValueError(f"shorten: bad residual size {resn}")
            if nmean == 0:
                coffset = offs[0]
            else:
                s = nmean // 2 + sum(offs)
                coffset = _rounded_shift_down(_c_div(s, nmean), bitshift)

            if fn == FN_QLPC:
                nlpc = br.uvar(_LPCQSIZE)
                if nlpc > maxnlpc:
                    # Real encoders never exceed the declared maxnlpc; the
                    # C++ twin sizes its coefficient buffer by it.
                    raise ValueError(f"shorten: nlpc {nlpc} > maxnlpc {maxnlpc}")
                qlpc = [br.var(_LPCQUANT) for _ in range(nlpc)]
                res = br.block_var(blocksize, resn)
                # History enters the predictor coffset-subtracted — and the
                # subtraction is IN PLACE, exactly as in shorten.c: if a
                # following wrap copies from these history slots (blocksize
                # < nwrap), it sees the subtracted values.  The C++ twin
                # mirrors this; diverging here would desync the decoders.
                hist = hist.copy()
                if nlpc:
                    hist[nwrap - nlpc :] -= coffset
                work = np.empty(nwrap + blocksize, dtype=np.int64)
                work[:nwrap] = hist
                lpcqoffset = 1 << (_LPCQUANT - 1)
                for i in range(blocksize):
                    acc = lpcqoffset
                    for j in range(nlpc):
                        acc += qlpc[j] * int(work[nwrap + i - 1 - j])
                    work[nwrap + i] = int(res[i]) + (acc >> _LPCQUANT)
                block = work[nwrap:]
                if coffset != 0:
                    block += coffset
            else:
                res = br.block_var(blocksize, resn)
                if fn == FN_DIFF0:
                    block = res + coffset
                elif fn == FN_DIFF1:
                    block = np.cumsum(res) + hist[-1]
                elif fn == FN_DIFF2:
                    d = np.cumsum(res) + (hist[-1] - hist[-2])
                    block = np.cumsum(d) + hist[-1]
                else:  # FN_DIFF3
                    e = np.cumsum(res) + (hist[-1] - 2 * hist[-2] + hist[-3])
                    d = np.cumsum(e) + (hist[-1] - hist[-2])
                    block = np.cumsum(d) + hist[-1]

        if nmean > 0:
            s = blocksize // 2 + int(block.sum())
            offs.pop(0)
            offs.append(_c_div(s, blocksize) << bitshift)

        # Wrap history (pre-bitshift domain), then apply bitshift to output.
        if blocksize >= nwrap:
            history[chan] = block[blocksize - nwrap :].copy()
        else:
            history[chan] = np.concatenate([hist[blocksize:], block])
        out_block = block << bitshift if bitshift else block

        group[chan] = out_block
        chan += 1
        if chan == nchan:
            chan = 0
            frames = len(group[0])
            take = frames
            if max_frames is not None:
                take = min(take, max_frames - frames_out)
            if take > 0:
                # int32 at append time: post-bitshift samples are 16-bit
                # range, and carrying int64 chunks to the final concatenate
                # doubles peak memory TWICE on hour-long channels (the same
                # OOM class _BitReader's int32 ones-index works around).
                interleaved = np.stack(
                    [g[:take] for g in group], axis=1
                ).astype(np.int32, copy=False)
                chunks.append(interleaved)
                frames_out += take
            group = [None] * nchan
            if max_frames is not None and frames_out >= max_frames:
                break

    if chunks:
        samples = np.concatenate(chunks, axis=0)  # chunks are int32 already
    else:
        samples = np.zeros((0, nchan), dtype=np.int32)
    return ShortenStream(
        samples=samples, nchan=nchan, ftype=ftype, verbatim=bytes(verbatim)
    )


# --------------------------------------------------------------------------- #
# Encoder (fixture/tooling path; mirrors the decoder's integer math exactly)
# --------------------------------------------------------------------------- #


class _BitWriter:
    __slots__ = ("buf", "acc", "nacc")

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nacc = 0

    def put_bits(self, value: int, n: int) -> None:
        if n:
            self.acc = (self.acc << n) | (value & ((1 << n) - 1))
            self.nacc += n
            while self.nacc >= 8:
                self.nacc -= 8
                self.buf.append((self.acc >> self.nacc) & 0xFF)
            self.acc &= (1 << self.nacc) - 1

    def uvar(self, value: int, k: int) -> None:
        high = value >> k
        # Unary: `high` zeros then a 1 (chunked so huge values stay cheap).
        while high >= 32:
            self.put_bits(0, 32)
            high -= 32
        self.put_bits(1, high + 1)
        self.put_bits(value, k)

    def ulong(self, value: int) -> None:
        nbits = value.bit_length()
        self.uvar(nbits, _ULONGSIZE)
        self.uvar(value, nbits)

    def var(self, value: int, k: int) -> None:
        u = (value << 1) if value >= 0 else (-value << 1) - 1
        self.uvar(u, k + 1)

    def getvalue(self) -> bytes:
        # Flush and pad with zero bits to a 32-bit word boundary (shorten
        # writes whole big-endian words).
        if self.nacc:
            self.put_bits(0, 8 - self.nacc)
        while len(self.buf) % 4:
            self.buf.append(0)
        return bytes(self.buf)


def _uvar_cost(u: np.ndarray, k: int) -> int:
    return int((u >> k).sum()) + len(u) * (1 + k)


def _var_cost(res: np.ndarray, k: int) -> int:
    u = np.where(res >= 0, res << 1, (-res << 1) - 1)
    return _uvar_cost(u, k + 1)


def _best_k(res: np.ndarray) -> Tuple[int, int]:
    """Smallest-cost Rice parameter for signed residuals (exact search)."""
    best_k, best_cost = 0, _var_cost(res, 0)
    for k in range(1, 16):
        c = _var_cost(res, k)
        if c < best_cost:
            best_k, best_cost = k, c
    return best_k, best_cost


def encode(
    samples: np.ndarray,
    blocksize: int = 256,
    nmean: int = 0,
    ftype: int = TYPE_S16HL,
    verbatim: Optional[bytes] = None,
    use_qlpc: bool = False,
    bitshift: int = 0,
    force_fn: Optional[int] = None,
) -> bytes:
    """Encode int16 PCM to a shorten v2 stream the decoder round-trips
    bit-exactly.  ``samples``: (n,) mono or (n, nchan).  ``verbatim`` bytes
    are embedded as FN_VERBATIM chunks (how SPHERE headers travel inside
    LDC's embedded-shorten files).  ``use_qlpc`` adds a fixed 2-tap LPC
    candidate; ``bitshift`` encodes samples sharing that many low zero bits
    via FN_BITSHIFT; ``force_fn`` pins every block to one predictor (tests
    use it to exercise each decode path deterministically)."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    if samples.dtype != np.int16:
        raise TypeError("shorten.encode expects int16 samples")
    if ftype not in _SUPPORTED_FTYPES:
        raise NotImplementedError(f"shorten: ftype {ftype} unsupported")
    n, nchan = samples.shape
    # Mirror decode()'s bounds: blocksize <= 0 spins the encode loop
    # forever (pos never advances), and out-of-range blocksize/nchan would
    # encode "successfully" into a stream this decoder and the C++ twin
    # both reject — an undecodable fixture written with no error.
    if not 0 < blocksize <= _MAX_BLOCKSIZE:
        raise ValueError(f"shorten: bad blocksize {blocksize}")
    if not 0 < nchan <= _MAX_CHANNELS:
        raise ValueError(f"shorten: bad channel count {nchan}")
    data = samples.astype(np.int64)
    if bitshift:
        if not 0 < bitshift <= 15:
            raise ValueError("bitshift out of range")
        if np.any(data & ((1 << bitshift) - 1)):
            raise ValueError("bitshift requires all samples divisible")
        data = data >> bitshift

    maxnlpc = 2 if use_qlpc else 0
    nwrap = max(_NWRAP, maxnlpc)
    w = _BitWriter()
    out = bytearray(MAGIC)
    out.append(VERSION)
    w.ulong(ftype)
    w.ulong(nchan)
    w.ulong(blocksize)
    w.ulong(maxnlpc)
    w.ulong(nmean)
    w.ulong(0)  # nskip

    if verbatim:
        for i in range(0, len(verbatim), 256):
            chunk = verbatim[i : i + 256]
            w.uvar(FN_VERBATIM, _FNSIZE)
            w.uvar(len(chunk), _VERBATIM_CKSIZE_SIZE)
            for byte in chunk:
                w.uvar(byte, _VERBATIM_BYTE_SIZE)

    if bitshift:
        w.uvar(FN_BITSHIFT, _FNSIZE)
        w.uvar(bitshift, _BITSHIFTSIZE)

    history = [np.zeros(nwrap, dtype=np.int64) for _ in range(nchan)]
    offsets = [[0] * max(1, nmean) for _ in range(nchan)]
    cur_bs = blocksize
    pos = 0
    # Fixed 2-tap predictor ≈ 2·x[i-1] − 1·x[i-2] in Q5.
    qlpc_coeffs = [64, -32]

    while pos < n:
        size = min(cur_bs, n - pos)
        if size != cur_bs:
            w.uvar(FN_BLOCKSIZE, _FNSIZE)
            w.ulong(size)
            cur_bs = size
        for chan in range(nchan):
            x = data[pos : pos + size, chan]
            hist = history[chan]
            offs = offsets[chan]
            if nmean == 0:
                coffset = offs[0]
            else:
                s = nmean // 2 + sum(offs)
                coffset = _rounded_shift_down(_c_div(s, nmean), bitshift)

            if not np.any(x):
                w.uvar(FN_ZERO, _FNSIZE)
            else:
                prev = np.concatenate([hist[-3:], x])
                cands = [
                    (FN_DIFF0, x - coffset, None),
                    (FN_DIFF1, np.diff(prev[2:]), None),
                    (FN_DIFF2, np.diff(prev[1:], n=2), None),
                    (FN_DIFF3, np.diff(prev, n=3), None),
                ]
                if use_qlpc:
                    work = np.concatenate([hist.copy(), x])
                    work[nwrap - 2 : nwrap] -= coffset
                    lpcqoffset = 1 << (_LPCQUANT - 1)
                    res_q = np.empty(size, dtype=np.int64)
                    for i in range(size):
                        acc = lpcqoffset
                        for j, c in enumerate(qlpc_coeffs):
                            acc += c * int(work[nwrap + i - 1 - j])
                        pred = acc >> _LPCQUANT
                        res_q[i] = int(x[i]) - coffset - pred
                        work[nwrap + i] = int(x[i]) - coffset
                    cands.append((FN_QLPC, res_q, qlpc_coeffs))
                best = None
                for fn, res, extra in cands:
                    if force_fn is not None and fn != force_fn:
                        continue
                    k, cost = _best_k(res)
                    over = 0 if extra is None else (
                        _LPCQSIZE + 3  # nlpc uvar + coeff codes, approx
                    )
                    if best is None or cost + over < best[3]:
                        best = (fn, res, k, cost + over, extra)
                if best is None:
                    raise ValueError(f"force_fn {force_fn} has no candidate")
                fn, res, k, _, extra = best
                if fn == FN_QLPC:
                    # Mirror the decoder's in-place history subtraction so a
                    # following short-block wrap sees identical state.
                    hist = hist.copy()
                    hist[nwrap - len(extra) :] -= coffset
                w.uvar(fn, _FNSIZE)
                w.uvar(k, _ENERGYSIZE)  # v2: Rice k verbatim (no v0 hack)
                if fn == FN_QLPC:
                    w.uvar(len(extra), _LPCQSIZE)
                    for c in extra:
                        w.var(c, _LPCQUANT)
                for r in res:
                    w.var(int(r), k)

            if nmean > 0:
                s = size // 2 + int(x.sum())
                offs.pop(0)
                offs.append(_c_div(s, size) << bitshift)
            if size >= nwrap:
                history[chan] = x[size - nwrap :].copy()
            else:
                history[chan] = np.concatenate([hist[size:], x])
        pos += size

    w.uvar(FN_QUIT, _FNSIZE)
    out.extend(w.getvalue())
    return bytes(out)


def decode_file(path: str, data_offset: int, max_frames: Optional[int] = None):
    """Decode the shorten payload of a SPHERE file to (frames, nchan) int16."""
    with open(path, "rb") as f:
        f.seek(data_offset)
        payload = f.read()
    stream = decode(payload, max_frames=max_frames)
    return stream.samples.astype(np.int16)
