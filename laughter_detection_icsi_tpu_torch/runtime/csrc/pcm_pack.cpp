// Native packer for the lossless packed-PCM transfer codec
// (ops/pcm_pack.py — see that module for the layout contract).
//
// The Python/numpy packer is the portable fallback; this one exists because
// packing sits on the host critical path of streamed inference (one bucket
// packs while the device chews the previous one), so it must be far cheaper
// than the upload it replaces.  Single scan for width analysis, single scan
// with a 64-bit cursor for packing: ~GB/s on one core.
//
// Layout (must match ops/pcm_pack.py exactly, pinned by
// tests/test_pcm_pack.py::test_native_packer_matches_numpy):
//   * blocks of `block` samples (multiple of 32), values are samples or
//     first-order deltas (one global flag; d[0] = x[0]);
//   * block b stores each value as widths[b]-bit two's complement,
//     bit-concatenated; widths[b] = 0 iff the block is all zero;
//   * blocks are word-aligned because 32 | block.

#include <cstdint>
#include <cstring>

namespace {

// Two's-complement width for the extremes of a block: the value that must
// fit in w-1 magnitude bits is v for v >= 0, ~v for v < 0.
static inline int32_t width_for(int32_t min_v, int32_t max_v) {
  uint32_t m = 0;
  if (max_v > 0 && (uint32_t)max_v > m) m = (uint32_t)max_v;
  if (min_v < 0) {
    uint32_t u = (uint32_t)(~min_v);
    if (u > m) m = u;
  }
  if (min_v == 0 && max_v == 0) return 0;
  int32_t bits = 0;
  while (m) {
    ++bits;
    m >>= 1;
  }
  return bits + 1;  // sign bit
}

}  // namespace

extern "C" {

// Analyze + pack in one call.
//   x        : int16 samples, length n (virtually zero-padded to a block
//              multiple).
//   n        : sample count.
//   block    : samples per width block (multiple of 32).
//   mode     : 0 = direct, 1 = delta, -1 = auto (fewer total bits wins;
//              ties go to direct).
//   words    : out, capacity >= ceil(n/block)*block/32*17 words (worst
//              case: 17-bit deltas).  Written words beyond the stream are
//              untouched — the caller zero-pads its buffer beforehand.
//   widths   : out, one int32 per block.
//   delta_out: out, the mode actually used (0/1).
// Returns the number of words written, or -1 on bad arguments.
int64_t pcm_pack(const int16_t* x, int64_t n, int32_t block, int32_t mode,
                 uint32_t* words, int32_t* widths, int32_t* delta_out) {
  if (n < 0 || block <= 0 || block % 32 != 0) return -1;
  int64_t n_blocks = (n + block - 1) / block;
  if (n_blocks == 0) n_blocks = 1;

  // Pass 1: per-block min/max for both encodings in one scan.
  int64_t direct_bits = 0, delta_bits = 0;
  int32_t prev = 0;
  // Stack-free two-pass over blocks; widths for the losing mode are
  // recomputed cheaply in the pack scan's chosen mode only, so stash both.
  // (17 bits max -> int8 would do; int32 keeps the ABI simple.)
  for (int64_t b = 0; b < n_blocks; ++b) {
    int32_t dmin = 0, dmax = 0, emin = 0, emax = 0;
    int64_t lo = b * block, hi = lo + block;
    for (int64_t i = lo; i < hi; ++i) {
      int32_t v = (i < n) ? x[i] : 0;
      int32_t d = v - prev;
      prev = v;
      if (v < dmin) dmin = v;
      if (v > dmax) dmax = v;
      if (d < emin) emin = d;
      if (d > emax) emax = d;
    }
    int32_t wd = width_for(dmin, dmax);
    int32_t we = width_for(emin, emax);
    direct_bits += wd;
    delta_bits += we;
    // Temporarily stash both widths: direct in the low 8 bits, delta in
    // the next 8 (both <= 17 < 256).
    widths[b] = wd | (we << 8);
  }

  int use_delta = (mode == -1) ? (delta_bits < direct_bits) : (mode != 0);
  *delta_out = use_delta;

  // Pass 2: pack with a 64-bit cursor.
  uint64_t acc = 0;
  int32_t acc_bits = 0;
  int64_t w_out = 0;
  prev = 0;
  for (int64_t b = 0; b < n_blocks; ++b) {
    int32_t w = use_delta ? ((widths[b] >> 8) & 0xff) : (widths[b] & 0xff);
    widths[b] = w;
    if (w == 0) {
      // all-zero block stores nothing; keep the delta chain state
      if (!use_delta) continue;
      int64_t hi = b * block + block;
      prev = (hi - 1 < n) ? x[hi - 1] : 0;
      continue;
    }
    const uint32_t mask = (w >= 32) ? 0xffffffffu : ((1u << w) - 1u);
    int64_t lo = b * block, hi = lo + block;
    for (int64_t i = lo; i < hi; ++i) {
      int32_t v = (i < n) ? x[i] : 0;
      int32_t out_v = use_delta ? (v - prev) : v;
      prev = v;
      acc |= (uint64_t)((uint32_t)out_v & mask) << acc_bits;
      acc_bits += w;
      if (acc_bits >= 32) {
        words[w_out++] = (uint32_t)acc;
        acc >>= 32;
        acc_bits -= 32;
      }
    }
    // block is a multiple of 32 samples and every sample adds w bits, so
    // block * w bits is a whole number of words: the cursor drains here.
  }
  if (acc_bits > 0) words[w_out++] = (uint32_t)acc;  // unreachable by layout
  return w_out;
}

}  // extern "C"
