// Native audio decode runtime: NIST SPHERE + RIFF WAV -> float32 PCM.
//
// Owns the host-side decode path the reference delegates to
// libsndfile/audioread/sph2pipe (reference segment_laughter.py:134,
// utils/audio_utils.py:7-9, analysis/output_processing/laughs_to_wav.py:42-60).
// Design target: feed the TPU featurizer at hundreds-of-x realtime — ranged
// pread()s (no whole-file decode), zero-copy int16->float conversion into
// caller-provided pinned buffers, and a pthread pool for batch decode of a
// meeting's channels (data/audio.py is the always-available pure-Python
// fallback with identical semantics; tests pin them together).
//
// C ABI (ctypes-friendly):
//   audio_info(path, *info)                 -> 0 / negative errno-style code
//   audio_read_f32(path, start, count, chan, *out) -> samples written or <0
//   audio_read_batch(...)                   -> threaded multi-file decode
//
// Build: g++ -O3 -march=native -shared -fPIC audio_decoder.cpp -o libaudiodec.so -lpthread

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <cerrno>
#include <fcntl.h>
#include <unistd.h>
#include <pthread.h>

extern "C" {

enum AudioEncoding { ENC_PCM = 0, ENC_ULAW = 1, ENC_FLOAT = 2, ENC_SHORTEN = 3 };

enum AudioError {
  AERR_OPEN = -1,
  AERR_MAGIC = -2,
  AERR_HEADER = -3,
  AERR_UNSUPPORTED = -4,
  AERR_IO = -5,
  AERR_SHORTEN = -6,   // malformed/unsupported shorten bitstream
  AERR_BITSTREAM = -7,
};

typedef struct {
  int32_t sample_rate;
  int64_t num_samples;
  int32_t num_channels;
  int32_t sample_bytes;
  int32_t encoding;    // AudioEncoding
  int32_t big_endian;  // 0/1
  int64_t data_offset; // bytes
  int32_t is_wav;      // container: 1 = RIFF/WAVE, 0 = NIST SPHERE
} audio_info_t;

// ---------------------------------------------------------------------- //
// Header parsing
// ---------------------------------------------------------------------- //

static int parse_sphere(int fd, audio_info_t* info) {
  char head[1025];
  ssize_t got = pread(fd, head, sizeof(head) - 1, 0);
  if (got < 16) return AERR_HEADER;
  head[got] = 0;  // strtol must not run off the end of a short file
  if (memcmp(head, "NIST_1A", 7) != 0) return AERR_MAGIC;
  long header_size = strtol(head + 8, nullptr, 10);
  if (header_size <= 0 || header_size > 1 << 20) return AERR_HEADER;

  char* hdr = (char*)malloc(header_size + 1);
  got = pread(fd, hdr, header_size, 0);
  if (got < header_size) { free(hdr); return AERR_HEADER; }
  hdr[header_size] = 0;

  info->sample_rate = 0;
  info->num_samples = 0;
  info->num_channels = 1;
  info->sample_bytes = 2;
  info->encoding = ENC_PCM;
  info->big_endian = 0;
  info->data_offset = header_size;
  info->is_wav = 0;

  int rc = 0;
  char* save = nullptr;
  for (char* line = strtok_r(hdr, "\n", &save); line;
       line = strtok_r(nullptr, "\n", &save)) {
    if (strncmp(line, "end_head", 8) == 0) break;
    char name[128], type[32], value[512];
    if (sscanf(line, "%127s %31s %511s", name, type, value) != 3) continue;
    if (!strcmp(name, "sample_rate")) info->sample_rate = atoi(value);
    else if (!strcmp(name, "sample_count")) info->num_samples = atoll(value);
    else if (!strcmp(name, "channel_count")) info->num_channels = atoi(value);
    else if (!strcmp(name, "sample_n_bytes")) info->sample_bytes = atoi(value);
    else if (!strcmp(name, "sample_byte_format"))
      info->big_endian = (strcmp(value, "10") == 0);
    else if (!strcmp(name, "sample_coding")) {
      if (strstr(value, "shorten")) info->encoding = ENC_SHORTEN;
      else if (strstr(value, "ulaw")) info->encoding = ENC_ULAW;
      else if (strncmp(value, "pcm", 3) && strcmp(value, "raw"))
        rc = AERR_UNSUPPORTED;
    }
  }
  free(hdr);
  if (rc) return rc;
  // Field sanity: zero channels/sample_bytes would divide-by-zero (SIGFPE)
  // in every consumer below; bound sample_bytes at the widest PCM we read.
  if (info->sample_rate <= 0) return AERR_HEADER;
  if (info->num_samples < 0) return AERR_HEADER;
  if (info->num_channels <= 0 || info->num_channels > 4096) return AERR_HEADER;
  if (info->sample_bytes <= 0 || info->sample_bytes > 4) return AERR_HEADER;
  return 0;
}

static int parse_wav(int fd, audio_info_t* info) {
  unsigned char riff[12];
  if (pread(fd, riff, 12, 0) != 12) return AERR_HEADER;
  if (memcmp(riff, "RIFF", 4) || memcmp(riff + 8, "WAVE", 4)) return AERR_MAGIC;
  int64_t pos = 12;
  bool have_fmt = false;
  uint16_t fmt_code = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  for (;;) {
    unsigned char ch[8];
    if (pread(fd, ch, 8, pos) != 8) return AERR_HEADER;
    uint32_t size;
    memcpy(&size, ch + 4, 4);
    pos += 8;
    if (!memcmp(ch, "fmt ", 4)) {
      unsigned char f[26];
      if (size < 16 || pread(fd, f, 16, pos) != 16) return AERR_HEADER;
      memcpy(&fmt_code, f, 2);
      memcpy(&channels, f + 2, 2);
      memcpy(&rate, f + 4, 4);
      memcpy(&bits, f + 14, 2);
      if (fmt_code == 0xFFFE) {
        // WAVE_FORMAT_EXTENSIBLE: real format = first 2 bytes of the
        // SubFormat GUID (fmt bytes 24-25).
        if (size < 26 || pread(fd, f, 26, pos) != 26) return AERR_HEADER;
        memcpy(&fmt_code, f + 24, 2);
      }
      have_fmt = true;
      pos += size + (size & 1);
    } else if (!memcmp(ch, "data", 4)) {
      if (!have_fmt) return AERR_HEADER;
      info->sample_rate = (int32_t)rate;
      info->num_channels = channels;
      info->big_endian = 0;
      info->data_offset = pos;
      info->is_wav = 1;
      if (fmt_code == 7) { info->encoding = ENC_ULAW; info->sample_bytes = 1; }
      else if (fmt_code == 1) {
        info->encoding = ENC_PCM; info->sample_bytes = bits / 8;
      } else if (fmt_code == 3) {
        info->encoding = ENC_FLOAT; info->sample_bytes = bits / 8;
      } else return AERR_UNSUPPORTED;
      // A malformed fmt chunk with channels=0 or bits<8 would SIGFPE the
      // whole process on the division below; rate=0 would ZeroDivisionError
      // every duration computation downstream.
      if ((int32_t)rate <= 0 || channels == 0 || info->sample_bytes <= 0)
        return AERR_HEADER;
      if (info->encoding == ENC_FLOAT) {
        // IEEE float WAVs: f32 and f64, matching the pure-Python twin
        // (data/audio.py fmt map {4:'<f4', 8:'<f8'}).  Other widths are
        // well-formed-but-unsupported, not malformed.
        if (info->sample_bytes != 4 && info->sample_bytes != 8)
          return AERR_UNSUPPORTED;
      } else if (info->sample_bytes > 4) {
        return AERR_HEADER;
      }
      info->num_samples = (int64_t)size / (info->sample_bytes * channels);
      return 0;
    } else {
      pos += size + (size & 1);
    }
  }
}

int audio_info(const char* path, audio_info_t* info) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return AERR_OPEN;
  char magic[4];
  int rc = AERR_MAGIC;
  if (pread(fd, magic, 4, 0) == 4) {
    if (!memcmp(magic, "NIST", 4)) rc = parse_sphere(fd, info);
    else if (!memcmp(magic, "RIFF", 4)) rc = parse_wav(fd, info);
  }
  close(fd);
  return rc;
}

// ---------------------------------------------------------------------- //
// Decode
// ---------------------------------------------------------------------- //

static int16_t ULAW[256];
static pthread_once_t ulaw_once = PTHREAD_ONCE_INIT;
static void init_ulaw() {
  for (int i = 0; i < 256; i++) {
    uint8_t u = ~(uint8_t)i;
    int sign = (u & 0x80) ? -1 : 1;
    int exponent = (u >> 4) & 0x07;
    int mantissa = u & 0x0F;
    int magnitude = ((mantissa << 3) + 0x84) << exponent;
    ULAW[i] = (int16_t)(sign * (magnitude - 0x84));
  }
}

static inline uint16_t bswap16(uint16_t v) { return __builtin_bswap16(v); }
static inline uint32_t bswap32(uint32_t v) { return __builtin_bswap32(v); }

// ---------------------------------------------------------------------- //
// Shorten v2 decode (the ICSI corpus's "embedded-shorten" SPHERE payload).
// Spec of record: data/shorten.py (pure-Python twin; tests pin the two
// bit-exact).  Linear 16-bit profile only (TYPE_S16HL/S16LH).
// ---------------------------------------------------------------------- //

namespace shorten {

constexpr int FNSIZE = 2, ULONGSIZE = 2, ENERGYSIZE = 3, BITSHIFTSIZE = 2;
constexpr int LPCQSIZE = 2, LPCQUANT = 5, XBYTESIZE = 7;
constexpr int VERBATIM_CKSIZE_SIZE = 5, VERBATIM_BYTE_SIZE = 8, NWRAP = 3;
constexpr int FN_DIFF0 = 0, FN_DIFF1 = 1, FN_DIFF2 = 2, FN_DIFF3 = 3,
              FN_QUIT = 4, FN_BLOCKSIZE = 5, FN_BITSHIFT = 6, FN_QLPC = 7,
              FN_ZERO = 8, FN_VERBATIM = 9;
constexpr int TYPE_S16HL = 3, TYPE_S16LH = 5;
constexpr int MAX_CHANNELS = 64;
constexpr long MAX_BLOCKSIZE = 65535, MAX_NLPC = 1024, MAX_NMEAN = 65536;

struct BitReader {
  const uint8_t* d;
  size_t len, pos;   // byte position
  uint64_t acc;      // pending bits in the low `nacc` bits
  int nacc;
  bool overrun;

  explicit BitReader(const uint8_t* data, size_t n)
      : d(data), len(n), pos(0), acc(0), nacc(0), overrun(false) {}

  inline void fill() {
    while (nacc <= 56) {
      uint8_t b = 0;
      if (pos < len) b = d[pos];
      else overrun = true;
      pos++;
      acc = (acc << 8) | b;
      nacc += 8;
    }
  }
  // True once the decoder has CONSUMED bits past the end of the buffer.
  // `overrun` alone only means fill() buffered ahead of the end — which is
  // normal for the final gulp of a valid stream; consumed-bit accounting
  // (pos*8 bytes pulled in, nacc still pending) is what distinguishes a
  // truncated bitstream.  The old `pos > len + 8/16` guards were
  // unreachable: uvar's early-return froze pos inside (len+8, len+16], so
  // a truncated file silently decoded to a zero tail.
  inline bool past_end() const {
    return pos * 8 > len * 8 + (size_t)nacc;
  }
  inline uint32_t bits(int n) {  // n <= 32
    if (nacc < n) fill();
    nacc -= n;
    return n ? (uint32_t)((acc >> nacc) & ((1ull << n) - 1)) : 0;
  }
  inline uint32_t uvar(int k) {
    uint32_t unary = 0;
    for (;;) {
      if (nacc == 0) fill();
      if (past_end()) return 0;  // zero tail: caller checks past_end()
      // Count leading zeros in the pending bits in one step.
      uint64_t pending = acc & ((nacc == 64) ? ~0ull : ((1ull << nacc) - 1));
      if (pending == 0) { unary += nacc; nacc = 0; continue; }
      int top = 63 - __builtin_clzll(pending);  // highest set bit position
      int zeros = nacc - 1 - top;
      unary += zeros;
      nacc = top;  // consume the zeros AND the terminating 1
      break;
    }
    // 64-bit shift: k can legitimately be 32 (ulong nbits), where a
    // uint32 `unary << k` would be shift-width UB.
    return (uint32_t)(((uint64_t)unary << k) | bits(k));
  }
  inline uint32_t ulong_get() {
    uint32_t nbits = uvar(ULONGSIZE);
    // ulongs are 32-bit; a corrupt nbits would be shift UB downstream.
    // All-ones fails every caller's range check.
    if (nbits > 32) return 0xFFFFFFFFu;
    return uvar((int)nbits);
  }
  inline int32_t var(int k) {
    uint32_t u = uvar(k + 1);
    return (int32_t)((u >> 1) ^ (~(u & 1) + 1));
  }
};

static inline long c_div(long a, long b) { return a / b; }  // C trunc division
static inline long rounded_shift_down(long x, int n) {
  return n == 0 ? x : ((x >> (n - 1)) + 1) >> 1;
}

// Decode a complete shorten stream into interleaved int16.
// `expect_nchan`: the caller's output buffer is sized for this many
// channels (from the SPHERE header); a stream claiming a different count
// is rejected (writing with the stream's own nchan would overflow the
// buffer).  Returns frames decoded, or a negative AudioError.
static int64_t decode_stream(const uint8_t* data, size_t len, int16_t* out,
                             int64_t max_frames, long expect_nchan,
                             int32_t* out_nchan) {
  if (len < 5 || memcmp(data, "ajkg", 4) != 0) return AERR_SHORTEN;
  if (data[4] != 2) return AERR_SHORTEN;  // v2 only (what LDC/ICSI ships)
  BitReader br(data + 5, len - 5);

  long ftype = br.ulong_get();
  if (ftype != TYPE_S16HL && ftype != TYPE_S16LH) return AERR_UNSUPPORTED;
  long nchan = br.ulong_get();
  if (nchan <= 0 || nchan > MAX_CHANNELS) return AERR_SHORTEN;
  if (expect_nchan > 0 && nchan != expect_nchan) return AERR_SHORTEN;
  long blocksize = br.ulong_get();
  if (blocksize <= 0 || blocksize > MAX_BLOCKSIZE) return AERR_SHORTEN;
  long maxnlpc = br.ulong_get();
  if (maxnlpc < 0 || maxnlpc > MAX_NLPC) return AERR_SHORTEN;
  long nmean = br.ulong_get();
  if (nmean < 0 || nmean > MAX_NMEAN) return AERR_SHORTEN;
  long nskip = br.ulong_get();
  if (nskip < 0 || (size_t)nskip > len) return AERR_SHORTEN;
  for (long i = 0; i < nskip; i++) br.uvar(XBYTESIZE);

  const long nwrap = maxnlpc > NWRAP ? maxnlpc : NWRAP;
  // Per-channel sample buffer with nwrap history slots in front.
  long* bufs = (long*)calloc(nchan * (nwrap + MAX_BLOCKSIZE), sizeof(long));
  long* offs = (long*)calloc(nchan * (nmean > 0 ? nmean : 1), sizeof(long));
  long* qlpc = (long*)calloc(maxnlpc > 0 ? maxnlpc : 1, sizeof(long));
  if (!bufs || !offs || !qlpc) { free(bufs); free(offs); free(qlpc); return AERR_IO; }
  const long noff = nmean > 0 ? nmean : 1;

  int bitshift = 0;
  long chan = 0;
  int64_t frames = 0;
  int64_t rc = AERR_SHORTEN;  // result if we exit abnormally

  for (;;) {
    long fn;
    if (br.past_end()) goto done_err;  // truncated bitstream
    fn = br.uvar(FNSIZE);
    if (fn == FN_QUIT) { rc = frames; break; }
    if (fn == FN_BLOCKSIZE) {
      // Mid-channel-group changes would make the interleave below read
      // past the earlier channels' written samples; real encoders only
      // change blocksize at a group start (the Python twin errors too).
      if (chan != 0) goto done_err;
      blocksize = br.ulong_get();
      if (blocksize <= 0 || blocksize > MAX_BLOCKSIZE) goto done_err;
      continue;
    }
    if (fn == FN_BITSHIFT) {
      bitshift = br.uvar(BITSHIFTSIZE);
      // Sample-width bound: larger shifts are corrupt and would be
      // shift-width UB on `long` below.
      if (bitshift < 0 || bitshift > 31) goto done_err;
      continue;
    }
    if (fn == FN_VERBATIM) {
      long n = br.uvar(VERBATIM_CKSIZE_SIZE);
      // Each verbatim byte costs >= 9 bits, so n can never exceed the
      // payload length; an unbounded n is a corrupt stream demanding up
      // to 2^37 skip iterations (minutes of spin) before overrun fires.
      if (n < 0 || (size_t)n > br.len) goto done_err;
      for (long i = 0; i < n; i++) br.uvar(VERBATIM_BYTE_SIZE);
      continue;
    }
    if (fn != FN_ZERO && fn != FN_DIFF0 && fn != FN_DIFF1 && fn != FN_DIFF2 &&
        fn != FN_DIFF3 && fn != FN_QLPC)
      goto done_err;

    {
      long* cbuf = bufs + chan * (nwrap + MAX_BLOCKSIZE) + nwrap;
      long* coff = offs + chan * noff;
      long i;
      if (fn == FN_ZERO) {
        for (i = 0; i < blocksize; i++) cbuf[i] = 0;
      } else {
        // v2 carries the Rice parameter verbatim: shorten.c only
        // decrements for version 0 ("hack as version 0 differed in
        // definition of var_get") — verified against libavcodec.  Bound:
        // 16-bit audio never needs k > ~17; past 31, var(k+1) would be
        // shift UB.
        int resn = (int)br.uvar(ENERGYSIZE);
        if (resn > 31) goto done_err;
        long coffset;
        if (nmean == 0) {
          coffset = coff[0];
        } else {
          long sum = nmean / 2;
          for (i = 0; i < nmean; i++) sum += coff[i];
          coffset = rounded_shift_down(c_div(sum, nmean), bitshift);
        }
        switch (fn) {
          case FN_DIFF0:
            for (i = 0; i < blocksize; i++) cbuf[i] = br.var(resn) + coffset;
            break;
          case FN_DIFF1:
            for (i = 0; i < blocksize; i++) cbuf[i] = br.var(resn) + cbuf[i - 1];
            break;
          case FN_DIFF2:
            for (i = 0; i < blocksize; i++)
              cbuf[i] = br.var(resn) + 2 * cbuf[i - 1] - cbuf[i - 2];
            break;
          case FN_DIFF3:
            for (i = 0; i < blocksize; i++)
              cbuf[i] = br.var(resn) + 3 * (cbuf[i - 1] - cbuf[i - 2]) + cbuf[i - 3];
            break;
          case FN_QLPC: {
            long nlpc = br.uvar(LPCQSIZE);
            // nlpc must fit the qlpc allocation (maxnlpc); a corrupt stream
            // claiming more would overflow it (nwrap >= maxnlpc >= nlpc).
            if (nlpc > maxnlpc) goto done_err;
            long j;
            for (j = 0; j < nlpc; j++) qlpc[j] = br.var(LPCQUANT);
            for (j = 0; j < nlpc; j++) cbuf[j - nlpc] -= coffset;
            for (i = 0; i < blocksize; i++) {
              long sum = 1 << (LPCQUANT - 1);  // v2 lpcqoffset
              for (j = 0; j < nlpc; j++) sum += qlpc[j] * cbuf[i - j - 1];
              cbuf[i] = br.var(resn) + (sum >> LPCQUANT);
            }
            if (coffset != 0)
              for (i = 0; i < blocksize; i++) cbuf[i] += coffset;
            break;
          }
        }
      }
      if (br.past_end()) goto done_err;  // truncated bitstream

      if (nmean > 0) {
        long sum = blocksize / 2;
        for (i = 0; i < blocksize; i++) sum += cbuf[i];
        for (i = 1; i < nmean; i++) coff[i - 1] = coff[i];
        coff[nmean - 1] = c_div(sum, blocksize) << bitshift;
      }
      for (i = -nwrap; i < 0; i++) cbuf[i] = cbuf[i + blocksize];
      if (bitshift != 0)
        for (i = 0; i < blocksize; i++) cbuf[i] <<= bitshift;

      chan++;
      if (chan == nchan) {
        chan = 0;
        long take = blocksize;
        if (frames + take > max_frames) take = max_frames - frames;
        for (long f = 0; f < take; f++)
          for (long c = 0; c < nchan; c++)
            out[(frames + f) * nchan + c] =
                (int16_t)bufs[c * (nwrap + MAX_BLOCKSIZE) + nwrap + f];
        frames += take;
        if (frames >= max_frames) { rc = frames; break; }
      }
    }
    continue;
  done_err:
    rc = AERR_SHORTEN;
    break;
  }

  free(bufs); free(offs); free(qlpc);
  if (rc >= 0 && out_nchan) *out_nchan = (int32_t)nchan;
  return rc;
}

// Read the whole shorten payload of `path` (SPHERE data fork) and decode.
// `expect_nchan` > 0 is the channel count the CALLER sized `out` for; it is
// authoritative over this function's own header re-parse (the file could
// change between the caller's parse and this one — TOCTOU — and the buffer
// size is the caller's).
static int64_t decode_file(const char* path, int16_t* out, int64_t max_frames,
                           long expect_nchan, int32_t* out_nchan) {
  audio_info_t info;
  int hrc = audio_info(path, &info);
  if (hrc) return hrc;
  if (info.encoding != ENC_SHORTEN) return AERR_UNSUPPORTED;
  if (expect_nchan <= 0) expect_nchan = info.num_channels;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return AERR_OPEN;
  off_t end = lseek(fd, 0, SEEK_END);
  if (end < info.data_offset) { close(fd); return AERR_HEADER; }
  size_t len = end - info.data_offset;
  uint8_t* raw = (uint8_t*)malloc(len ? len : 1);
  if (!raw) { close(fd); return AERR_IO; }
  ssize_t got = pread(fd, raw, len, info.data_offset);
  close(fd);
  if (got < 0 || (size_t)got != len) { free(raw); return AERR_IO; }
  if (max_frames > info.num_samples) max_frames = info.num_samples;
  int64_t rc = decode_stream(raw, len, out, max_frames,
                             expect_nchan, out_nchan);
  free(raw);
  return rc;
}

}  // namespace shorten

// Decode a shorten SPHERE file to interleaved int16 (whole stream; the codec
// is sequential so there is no ranged fast path).  `out` must hold
// max_frames * expect_nchan values; `expect_nchan` (the caller's buffer
// layout) is enforced against the stream's own channel count.  Returns
// frames, or a negative AudioError.
int64_t audio_decode_shorten_i16(const char* path, int16_t* out,
                                 int64_t max_frames, int32_t expect_nchan) {
  return shorten::decode_file(path, out, max_frames, expect_nchan, nullptr);
}

// Decode `count` mono samples of `channel` starting at sample `start`.
// Returns samples written into out[], or a negative AudioError.
int64_t audio_read_f32(const char* path, int64_t start, int64_t count,
                       int32_t channel, float* out) {
  audio_info_t info;
  int rc = audio_info(path, &info);
  if (rc) return rc;
  if (start < 0) start = 0;
  if (start >= info.num_samples) return 0;
  if (count < 0 || start + count > info.num_samples)
    count = info.num_samples - start;
  // Mono files ignore the channel argument, matching the pure-Python twin
  // (data/audio.py applies `channel` only when num_channels > 1) — the two
  // decoders must behave identically whether or not a compiler was present.
  if (info.num_channels == 1) channel = 0;
  if (channel < 0 || channel >= info.num_channels) return AERR_UNSUPPORTED;

  if (info.encoding == ENC_SHORTEN) {
    // Sequential codec: decode the whole stream, then slice the range.
    int64_t total = info.num_samples * info.num_channels;
    int16_t* pcm = (int16_t*)malloc((total ? total : 1) * sizeof(int16_t));
    if (!pcm) return AERR_IO;
    int64_t frames =
        shorten::decode_file(path, pcm, info.num_samples, info.num_channels,
                             nullptr);
    if (frames < 0) { free(pcm); return frames; }
    if (start >= frames) { free(pcm); return 0; }
    if (start + count > frames) count = frames - start;
    const int nch = info.num_channels;
    for (int64_t i = 0; i < count; i++)
      out[i] = pcm[(start + i) * nch + channel] * (1.0f / 32768.0f);
    free(pcm);
    return count;
  }

  const int frame_bytes = info.sample_bytes * info.num_channels;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return AERR_OPEN;

  const int64_t nbytes = count * frame_bytes;
  unsigned char* raw = (unsigned char*)malloc(nbytes ? nbytes : 1);
  if (!raw) { close(fd); return AERR_IO; }
  ssize_t got = pread(fd, raw, nbytes, info.data_offset + start * frame_bytes);
  close(fd);
  if (got < 0) { free(raw); return AERR_IO; }
  int64_t frames = got / frame_bytes;

  const int ch = channel, nch = info.num_channels;
  if (info.encoding == ENC_ULAW) {
    pthread_once(&ulaw_once, init_ulaw);
    for (int64_t i = 0; i < frames; i++)
      out[i] = ULAW[raw[i * nch + ch]] * (1.0f / 32768.0f);
  } else if (info.encoding == ENC_FLOAT && info.sample_bytes == 4) {
    const float* p = (const float*)raw;
    for (int64_t i = 0; i < frames; i++) out[i] = p[i * nch + ch];
  } else if (info.encoding == ENC_FLOAT && info.sample_bytes == 8) {
    const double* p = (const double*)raw;
    for (int64_t i = 0; i < frames; i++) out[i] = (float)p[i * nch + ch];
  } else if (info.encoding == ENC_PCM && info.sample_bytes == 2) {
    const uint16_t* p = (const uint16_t*)raw;
    if (info.big_endian)
      for (int64_t i = 0; i < frames; i++)
        out[i] = (int16_t)bswap16(p[i * nch + ch]) * (1.0f / 32768.0f);
    else
      for (int64_t i = 0; i < frames; i++)
        out[i] = (int16_t)p[i * nch + ch] * (1.0f / 32768.0f);
  } else if (info.encoding == ENC_PCM && info.sample_bytes == 1) {
    if (info.is_wav) {
      // WAV 8-bit PCM is UNSIGNED (midpoint 0x80); signed decode would
      // wrap mid-scale.  SPHERE 8-bit stays signed.
      const uint8_t* p = (const uint8_t*)raw;
      for (int64_t i = 0; i < frames; i++)
        out[i] = ((int)p[i * nch + ch] - 128) * (1.0f / 128.0f);
    } else {
      const int8_t* p = (const int8_t*)raw;
      for (int64_t i = 0; i < frames; i++)
        out[i] = p[i * nch + ch] * (1.0f / 128.0f);
    }
  } else if (info.encoding == ENC_PCM && info.sample_bytes == 4) {
    const uint32_t* p = (const uint32_t*)raw;
    if (info.big_endian)
      for (int64_t i = 0; i < frames; i++)
        out[i] = (int32_t)bswap32(p[i * nch + ch]) * (1.0f / 2147483648.0f);
    else
      for (int64_t i = 0; i < frames; i++)
        out[i] = (int32_t)p[i * nch + ch] * (1.0f / 2147483648.0f);
  } else {
    free(raw);
    return AERR_UNSUPPORTED;
  }
  free(raw);
  return frames;
}

// ---------------------------------------------------------------------- //
// Threaded batch decode (one meeting's channels in parallel)
// ---------------------------------------------------------------------- //

typedef struct {
  const char* path;
  int64_t start, count;
  int32_t channel;
  float* out;
  int64_t result;
} batch_item_t;

typedef struct {
  batch_item_t* items;
  int n;
  int next;
  pthread_mutex_t lock;
} batch_state_t;

static void* batch_worker(void* arg) {
  batch_state_t* st = (batch_state_t*)arg;
  for (;;) {
    pthread_mutex_lock(&st->lock);
    int i = st->next++;
    pthread_mutex_unlock(&st->lock);
    if (i >= st->n) return nullptr;
    batch_item_t* it = &st->items[i];
    it->result = audio_read_f32(it->path, it->start, it->count, it->channel, it->out);
  }
}

// Decode n files concurrently with up to `threads` workers.
// results[i] receives the per-file sample count or error code.
int audio_read_batch(const char** paths, const int64_t* starts,
                     const int64_t* counts, const int32_t* channels,
                     float** outs, int64_t* results, int n, int threads) {
  if (n <= 0) return 0;
  batch_item_t* items = (batch_item_t*)malloc(n * sizeof(batch_item_t));
  if (!items) return AERR_IO;
  for (int i = 0; i < n; i++)
    items[i] = {paths[i], starts[i], counts[i], channels[i], outs[i], 0};
  batch_state_t st = {items, n, 0, PTHREAD_MUTEX_INITIALIZER};
  if (threads > n) threads = n;
  if (threads < 1) threads = 1;
  pthread_t* tids = (pthread_t*)malloc(threads * sizeof(pthread_t));
  if (!tids) { free(items); return AERR_IO; }
  // pthread_create can fail under thread exhaustion (EAGAIN); join only
  // the threads that actually started.  With zero started threads, run the
  // queue inline — the work must still complete.
  int started = 0;
  for (int t = 0; t < threads; t++) {
    if (pthread_create(&tids[started], nullptr, batch_worker, &st) == 0)
      started++;
  }
  if (started == 0) batch_worker(&st);
  for (int t = 0; t < started; t++) pthread_join(tids[t], nullptr);
  for (int i = 0; i < n; i++) results[i] = items[i].result;
  free(tids);
  free(items);
  return 0;
}

}  // extern "C"
