"""Lossless packed-PCM transfer codec: fewer host->device bytes per second
of audio.

The port of the JAX package's ``ops/pcm_pack.py``.  16-bit PCM is
redundant: speech is spectrally tilted (adjacent-sample deltas are several
bits narrower than the samples) and close-talk channels are mostly
near-silence.  The host packs decoded PCM for the wire in a fixed geometry
that plain vector ops decode on the device (no entropy coding):

* the waveform is split into blocks of ``BLOCK`` samples;
* per block, samples (or first-order deltas: one flag for the buffer,
  whichever is smaller) are stored as ``w_b``-bit two's complement, where
  ``w_b`` is the narrowest width that holds every value in block ``b``
  (``w_b = 0`` for all-zero blocks, e.g. zero-padded tails);
* ``BLOCK`` is a multiple of 32, so every block occupies exactly
  ``BLOCK * w_b / 32`` uint32 words and blocks stay word-aligned: the
  stream is a dense bit-concatenation with no per-block headers.

The host side (``pack_pcm`` and its helpers) is a copy of the JAX
package's: the native C++ packer (runtime/native.py) where it builds, the
numpy packer word for word beside it.  The device side
(``split_wire``, ``unpack_pcm``) is plain torch ops, as the JAX decoder is
plain ``jnp`` that XLA compiles (not a Pallas kernel): two gathers into the
word stream, per-sample shifts and masks, a sign-extend and, in delta mode,
one integer ``cumsum``.  torch's ``uint32`` has no shifts on CUDA, so the
words travel as int32 and are carried as int64 (``& 0xFFFFFFFF``), shifted
and masked there.  The round trip is bit-exact for any int16 input.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: samples per width block.  Must be a multiple of 32 (word alignment).
#: 4096 samples = 256 ms at 16 kHz: short enough that silence / speech /
#: transients land in different blocks, long enough that the width table
#: is negligible (4 bytes per block = 0.05% of raw PCM).
BLOCK = 4096

#: the word stream is zero-padded to a multiple of this many uint32 words
#: (64 KiB), so few distinct wire shapes serve all buffers; on a ~2 MB
#: bucket the padding is <= 3% of the raw PCM.
WORD_PAD = 16384


@dataclasses.dataclass(frozen=True)
class PackedPCM:
    """A bit-packed int16 waveform (see module docstring for the layout)."""

    words: np.ndarray  # uint32 [>= n_words + 1], zero-padded (see WORD_PAD)
    widths: np.ndarray  # int32 [n_blocks]: bits per value in each block
    n: int  # true sample count
    delta: bool  # values are first-order deltas (d[0] = x[0])

    @property
    def packed_bytes(self) -> int:
        """Wire bytes: padded word stream + width table."""
        return self.words.nbytes + self.widths.nbytes

    @property
    def raw_bytes(self) -> int:
        return 2 * self.n

    def wire(self) -> np.ndarray:
        """One contiguous uint32 buffer for a SINGLE host->device transfer
        (each transfer pays fixed link latency): width table first, then
        the word stream.  Split with :func:`split_wire`."""
        return np.concatenate([self.widths.view(np.uint32), self.words])


def block_count(n: int) -> int:
    """Width blocks (the wire's width-table length) of an ``n``-sample
    buffer."""
    return max(1, -(-n // BLOCK))


def split_wire(wire: torch.Tensor, n_blocks: int):
    """Device-side inverse of :meth:`PackedPCM.wire` on a wire carried as
    int64: (widths, words)."""
    return wire[:n_blocks], wire[n_blocks:]


def _block_widths(vals: np.ndarray, n_blocks: int) -> np.ndarray:
    """Per-block two's-complement bit width for int32 ``vals`` (length
    ``n_blocks * BLOCK``).  Width 0 <=> the block is all zeros."""
    # u = v for v >= 0 else ~v: the magnitude that must fit in w-1 bits.
    u = np.where(vals >= 0, vals, ~vals).reshape(n_blocks, BLOCK)
    maxu = u.max(axis=1)
    widths = np.empty(n_blocks, dtype=np.int32)
    for b, m in enumerate(maxu):  # n_blocks scalars — trivial
        widths[b] = int(m).bit_length() + 1
    # All-zero blocks store nothing at all.
    zero = ~np.any(vals.reshape(n_blocks, BLOCK), axis=1)
    widths[zero] = 0
    return widths


def _pack_stream(vals: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """Bit-concatenate ``vals`` (int32, [n_blocks * BLOCK]) at per-block
    widths into a uint32 stream.  Vectorized per distinct width: within a
    width class, each group of 32 samples maps to exactly ``w`` words with
    static shift patterns, scattered to precomputed word offsets."""
    n_blocks = len(widths)
    groups_per_block = BLOCK // 32
    words_per_block = groups_per_block * widths.astype(np.int64)
    block_word_start = np.concatenate(([0], np.cumsum(words_per_block)))
    total_words = int(block_word_start[-1])
    out = np.zeros(total_words, dtype=np.uint32)

    group_w = np.repeat(widths, groups_per_block)  # width of each group
    group_in_block = np.tile(np.arange(groups_per_block), n_blocks)
    group_word_start = (
        np.repeat(block_word_start[:-1], groups_per_block)
        + group_in_block * group_w
    )
    grouped = vals.reshape(-1, 32)

    for w in np.unique(widths):
        w = int(w)
        if w == 0:
            continue
        sel = np.nonzero(group_w == w)[0]
        g = grouped[sel].astype(np.uint32) & np.uint32((1 << w) - 1)
        words = np.zeros((len(sel), w), dtype=np.uint32)
        for k in range(32):
            bit = k * w
            j, s = bit >> 5, bit & 31
            words[:, j] |= g[:, k] << np.uint32(s)
            if s + w > 32:
                words[:, j + 1] |= g[:, k] >> np.uint32(32 - s)
        idx = group_word_start[sel][:, None] + np.arange(w)[None, :]
        out[idx] = words
    return out


def _finish(stream: np.ndarray, n_words: int, widths, n, delta) -> PackedPCM:
    # +1: the decoder's second gather may touch one word past the stream;
    # pad to WORD_PAD multiples so few wire shapes serve all sizes.
    padded_len = -(-(n_words + 1) // WORD_PAD) * WORD_PAD
    words = np.zeros(padded_len, dtype=np.uint32)
    words[:n_words] = stream[:n_words]
    return PackedPCM(words=words, widths=widths, n=n, delta=delta)


#: pack_pcm encoding modes -> the native packer's mode int.
_MODES = {"auto": -1, "direct": 0, "delta": 1}


def pack_pcm(
    wave: np.ndarray, mode: str = "auto", use_native: bool = True
) -> PackedPCM:
    """Pack an int16 waveform for transfer.  mode='auto' measures both
    width tables and keeps the smaller encoding (deltas almost always win
    on audio; direct wins on e.g. white noise near full scale);
    'delta'/'direct' force one (batched decoders need every channel on the
    same mode).  Uses the native packer (runtime/csrc/pcm_pack.cpp) where
    it builds and ``use_native`` is set, else the numpy packer below; the
    two give the same words."""
    if mode not in _MODES:
        raise ValueError(f"unknown pack mode {mode!r}")
    wave = np.ascontiguousarray(wave)
    if wave.dtype != np.int16:
        raise TypeError(f"pack_pcm wants int16 PCM, got {wave.dtype}")
    if wave.ndim != 1:
        raise TypeError(f"pack_pcm wants a 1-D waveform, got shape {wave.shape}")
    n = len(wave)
    n_blocks = block_count(n)

    if use_native:
        from laughter_detection_icsi_tpu_torch.runtime import native

        got = native.pack_pcm_native(wave, BLOCK, mode=_MODES[mode])
        if got is not None:
            stream, widths, use_delta, n_words = got
            return _finish(stream, n_words, widths, n, use_delta)

    padded = np.zeros(n_blocks * BLOCK, dtype=np.int32)
    padded[:n] = wave
    candidates = []
    if mode in ("auto", "direct"):
        candidates.append((False, _block_widths(padded, n_blocks)))
    if mode in ("auto", "delta"):
        deltas = np.empty_like(padded)
        deltas[0] = padded[0]
        np.subtract(padded[1:], padded[:-1], out=deltas[1:])
        candidates.append((True, _block_widths(deltas, n_blocks)))
        delta_vals = deltas
    use_delta, widths = min(candidates, key=lambda c: int(c[1].sum()))
    vals = delta_vals if use_delta else padded

    stream = _pack_stream(vals, widths)
    return _finish(stream, len(stream), widths, n, use_delta)


def wire_tensor(wire: np.ndarray) -> torch.Tensor:
    """A uint32 wire (any shape) as an int32 host tensor, ready for one
    upload: torch's uint32 has no shifts on CUDA, so the bits travel as
    int32 and :func:`widen` carries them as int64 on the device."""
    return torch.from_numpy(np.ascontiguousarray(wire).view(np.int32))


def widen(wire: torch.Tensor) -> torch.Tensor:
    """int32 wire -> int64 holding the uint32 values."""
    return wire.to(torch.int64) & 0xFFFFFFFF


def unpack_pcm(
    words: torch.Tensor,
    widths: torch.Tensor,
    n: int,
    delta: bool,
) -> torch.Tensor:
    """Device-side decode of int64-carried ``words`` and ``widths`` ->
    int32 [n] with exactly the packed int16 values, on their device.
    ``words`` may carry any zero padding past the true stream."""
    dev = words.device
    n_blocks = widths.shape[0]
    groups_per_block = BLOCK // 32
    block_word_start = torch.cat(
        [torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(widths * groups_per_block, 0)]
    )

    i = torch.arange(n_blocks * BLOCK, dtype=torch.int64, device=dev)
    b = i // BLOCK
    k = i - b * BLOCK
    w = widths[b]
    bit = k * w
    word = block_word_start[b] + (bit >> 5)
    shift = bit & 31

    lo = words[word] >> shift
    # Bits that straddle into the next word: present iff shift + w > 32.
    # (32 - shift) & 31 keeps the shift defined when shift == 0, and the
    # mask below kills what it contributes.  The index is clamped: a w = 0
    # tail block points one past the stream (JAX's gather clamps too), and
    # contributes nothing there.
    nxt = words[torch.clamp(word + 1, max=words.shape[0] - 1)]
    hi = torch.where(shift + w > 32, nxt << ((32 - shift) & 31), 0)
    mask = torch.where(w > 0, (1 << w) - 1, 0)
    v = (lo | hi) & mask

    # Sign-extend w-bit two's complement (w = 0 blocks decode to 0).
    w_safe = torch.clamp(w, min=1)
    sign = (v >> (w_safe - 1)) & 1
    vals = v - (sign << w_safe)

    if delta:
        vals = torch.cumsum(vals, 0)
    return vals[:n].to(torch.int32)
