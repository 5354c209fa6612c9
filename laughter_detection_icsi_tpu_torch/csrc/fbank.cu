// Kaldi log-mel filterbank for Hopper (sm_90a): reflection-padded float32
// wave [B, n] -> log-mel [B, T, n_mels], the DFT on the tensor cores in
// 3xTF32 (float32 accuracy), the mel projection and the log on CUDA cores.
//
// Replaces laughter_detection_icsi_tpu/ops/fbank_pallas.py:_fbank_kernel
// (the TPU kernel: per 256-frame block, six HIGHEST-precision f32 MXU
// matmuls of three row-shifted wave views against the folded cos/sin
// bases, power spectrum, mel projection, log).  This kernel computes the
// same function but is laid out for an SM, not carried over block by block.
//
// What bounds it: operations.  Per main-path bucket (T = 6,243 frames) the
// DFT is 2*T*400*512 = 2.557 GFLOP and the mel projection 0.006 GFLOP,
// against about 6 MB of compulsory traffic.  A single TF32 product keeps
// ~3 decimal digits, and the features must hold 2e-4 against the float32
// reference, so each operand x is split once into hi = tf32(x) and
// lo = tf32(x - hi) and the DFT is hi*hi + hi*lo + lo*hi (lo*lo, ~2^-22
// relative, is dropped): three m16n8k8 TF32 mma.sync per tile, 7.67 GFLOP
// of tensor-core work against the 495 TFLOP/s dense TF32 peak.
//
// Design, so that nothing intermediate touches device memory:
// - one block owns 48 consecutive frames of one batch row, so a main-path
//   bucket is 131 blocks on the H100's 132 SMs: one even wave, one block per
//   SM (the shared memory below admits no second).  The mel epilogue needs
//   all 256 bins of a frame, so N is never split across blocks;
// - the frames overlap (shift 160 < length 400).  The block stages the
//   samples they span once (cp.async, zero past the row end), as rows of
//   `shift` samples at a pitch of shift + 4 floats: frame f, sample k sits
//   at row f + k / shift, column k % shift.  An 8-deep k-step never crosses
//   a row (shift % 8 == 0), and the A-fragment reads (frames g = 0..7,
//   k = q = 0..3: banks 4g + q) are conflict-free, where a flat tile would
//   put all eight frames on one bank;
// - the preprocessing-folded basis [kpad, 512] is one float32 copy in
//   device memory, laid out on the host with cos and sin n8-tiles
//   interleaved (tile 2j = cos bins 8j..8j+7, tile 2j+1 = sin bins
//   8j..8j+7).  It streams through a 3-stage cp.async ring of 16-row
//   K-tiles at a row pitch of 520 floats (banks 8q + g: conflict-free);
// - 8 warps split N: a warp owns all 48 frames (3 m16-tiles) x 64 columns
//   (8 n8-tiles, 96 accumulators a lane).  Splitting costs ALU issue slots
//   beside the mma.sync, so each value is split once where it is used most:
//   a B fragment serves 3 m-tiles, an A fragment 8 n-tiles.  re and im of a
//   bin land in the same lane, so the power spectrum is formed in registers;
// - power goes to shared memory (reusing the tile buffers).  Each
//   (frame, filter) output then sums its filter's nonzero bins (the mel
//   bank is triangular: skipping its zero rows adds only exact zeros) and
//   takes log(max(., floor)); a warp takes one filter at a time and its
//   lanes the frames, so the bin range and the weights are warp-uniform
//   loads, and the block's [48, n_mels] run of output is written as one
//   contiguous stretch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;              // 256
constexpr int kMTiles = 3;                         // m16-tiles a warp
constexpr int kTileFrames = 16 * kMTiles;          // 48 frames per block
constexpr int kBins = 256;                         // DFT bins kept
constexpr int kCols = 2 * kBins;                   // cos|sin, n8-interleaved
constexpr int kWarpTiles = kCols / 8 / kWarps;     // 8 n8-tiles a warp
constexpr int kTileK = 16;                         // basis rows per stage
constexpr int kStages = 3;                         // cp.async ring depth
constexpr int kBasisPitch = kCols + 8;             // 520 = 8 (mod 32)
constexpr int kStageFloats = kTileK * kBasisPitch;
constexpr int kStageVec4 = kTileK * kCols / 4;     // 16-byte copies a stage
constexpr int kPowerPitch = kBins + 3;             // odd: frame-per-lane reads conflict-free

static_assert(kTileK % 8 == 0, "a stage holds whole k-steps");
static_assert(kWarpTiles % 2 == 0, "a warp holds whole (cos, sin) tile pairs");
static_assert(kStageVec4 % kThreads == 0, "a stage splits evenly over the threads");

// The staged wave tile: rows of `shift` samples at pitch shift + 4.
__host__ __device__ inline int wave_rows(int shift, int kpad) {
  return kTileFrames + (kpad - 1) / shift;
}

__host__ __device__ inline int wave_pitch(int shift) { return shift + 4; }

// cvt.rna.tf32.f32 for every finite x: round to nearest, ties away from
// zero, at tf32's 10 mantissa bits, the low 13 bits zero.  ptxas expands
// the PTX instruction on sm_90a into an add, an inf/NaN test and a select;
// the audio and the bases are finite, so the add and a mask do.
// tests/test_torch_fbank_tf32.py:tf32_split emulates this split in numpy.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|), both tf32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem));
}

// Copies `bytes` (4 or 0) and zero-fills the rest of the 4-byte word.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Basis rows [kt*kTileK, (kt+1)*kTileK) into ring stage `dst`.
__device__ __forceinline__ void load_basis_tile(float* dst, const float* basis, int kt,
                                                int tid) {
  const float* src = basis + static_cast<long long>(kt) * kTileK * kCols;
#pragma unroll
  for (int it = 0; it < kStageVec4 / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / (kCols / 4);
    cp_async16(dst + r * kBasisPitch + 4 * (i - r * (kCols / 4)), src + 4 * i);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fbank_kernel(const float* __restrict__ wave, const float* __restrict__ basis,
             const float* __restrict__ mel, const int* __restrict__ mel_range,
             float* __restrict__ out, long long n, int t, int shift, int kpad,
             int n_mels, float log_floor) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int pitch = wave_pitch(shift);
  const int rows = wave_rows(shift, kpad);
  float* wave_s = smem;
  float* basis_s = smem + rows * pitch;  // 16-byte aligned: pitch % 4 == 0

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row / column group
  const int q = lane & 3;   // fragment k index
  const int f0 = blockIdx.x * kTileFrames;
  const long long row = blockIdx.y;
  const float* wave_row = wave + row * n;

  // Group 0: basis stage 0 and the wave tile; groups 1..: later stages.
  const int n_ktiles = kpad / kTileK;
  load_basis_tile(basis_s, basis, 0, tid);
  const long long s0 = static_cast<long long>(f0) * shift;
  for (int r = warp; r < rows; r += kWarps)
    for (int c = lane; c < shift; c += 32) {
      const long long src = s0 + static_cast<long long>(r) * shift + c;
      cp_async4(wave_s + r * pitch + c, src < n ? wave_row + src : wave_row, src < n ? 4 : 0);
    }
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < kStages - 1; ++s) {
    if (s < n_ktiles) load_basis_tile(basis_s + s * kStageFloats, basis, s, tid);
    cp_async_commit();
  }

  float acc[kMTiles][kWarpTiles][4];
#pragma unroll
  for (int m = 0; m < kMTiles; ++m)
#pragma unroll
    for (int j = 0; j < kWarpTiles; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][j][c] = 0.0f;

  const float* wave_w = wave_s + g * pitch + q;
  int k_row = 0, k_col = 0;  // where the k-step's samples start in wave_s
  int stage = 0;
  for (int kt = 0; kt < n_ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile kt landed
    __syncthreads();               // everyone's; and tile kt-1's stage is free
    const int next = kt + kStages - 1;
    if (next < n_ktiles) {
      const int next_stage = stage == 0 ? kStages - 1 : stage - 1;
      load_basis_tile(basis_s + next_stage * kStageFloats, basis, next, tid);
    }
    cp_async_commit();
    const float* bs = basis_s + stage * kStageFloats + q * kBasisPitch + warp * kWarpTiles * 8 + g;
#pragma unroll
    for (int kk = 0; kk < kTileK / 8; ++kk) {
      const float* a_ptr = wave_w + k_row * pitch + k_col;
      uint32_t a_hi[kMTiles][4], a_lo[kMTiles][4];
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) {
        const float* a = a_ptr + 16 * m * pitch;
        split_tf32(a[0], a_hi[m][0], a_lo[m][0]);              // (g,     q)
        split_tf32(a[8 * pitch], a_hi[m][1], a_lo[m][1]);      // (g + 8, q)
        split_tf32(a[4], a_hi[m][2], a_lo[m][2]);              // (g,     q + 4)
        split_tf32(a[8 * pitch + 4], a_hi[m][3], a_lo[m][3]);  // (g + 8, q + 4)
      }
      const float* b_ptr = bs + kk * 8 * kBasisPitch;
#pragma unroll
      for (int j = 0; j < kWarpTiles; ++j) {
        uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
        split_tf32(b_ptr[j * 8], b0_hi, b0_lo);                    // (k = q,     n = g)
        split_tf32(b_ptr[j * 8 + 4 * kBasisPitch], b1_hi, b1_lo);  // (k = q + 4, n = g)
#pragma unroll
        for (int m = 0; m < kMTiles; ++m) {
          mma_tf32(acc[m][j], a_lo[m], b0_hi, b1_hi);
          mma_tf32(acc[m][j], a_hi[m], b0_lo, b1_lo);
          mma_tf32(acc[m][j], a_hi[m], b0_hi, b1_hi);
        }
      }
      k_col += 8;
      if (k_col == shift) {
        k_col = 0;
        ++k_row;
      }
    }
    stage = stage + 1 == kStages ? 0 : stage + 1;
  }

  cp_async_wait<0>();
  __syncthreads();  // every warp is done with wave_s / basis_s
  // Tile 2i holds re and tile 2i+1 im of bins 8i + 2q, 8i + 2q + 1, for
  // frames g (c0, c1) and g + 8 (c2, c3) of each m-tile.
  float* power_s = smem;  // [kTileFrames][kPowerPitch]
#pragma unroll
  for (int m = 0; m < kMTiles; ++m)
#pragma unroll
    for (int i = 0; i < kWarpTiles / 2; ++i) {
      const float* re = acc[m][2 * i];
      const float* im = acc[m][2 * i + 1];
      float* p = power_s + (16 * m + g) * kPowerPitch + (warp * kWarpTiles / 2 + i) * 8 + 2 * q;
      p[0] = re[0] * re[0] + im[0] * im[0];
      p[1] = re[1] * re[1] + im[1] * im[1];
      p[8 * kPowerPitch] = re[2] * re[2] + im[2] * im[2];
      p[8 * kPowerPitch + 1] = re[3] * re[3] + im[3] * im[3];
    }
  __syncthreads();

  // A warp takes a filter at a time, its lanes the frames (lane, lane + 32):
  // the filter's bin range and weights are the same across the warp.  Each
  // output sums its bins in ascending order, then goes to shared memory so
  // that the block's [frames, n_mels] run is written out contiguously.
  float* logmel_s = power_s + kTileFrames * kPowerPitch;  // [kTileFrames][n_mels]
  const bool two = lane + 32 < kTileFrames;
  const float* pa = power_s + lane * kPowerPitch;
  const float* pb = power_s + (two ? lane + 32 : lane) * kPowerPitch;
  for (int m = warp; m < n_mels; m += kWarps) {
    const int lo = __ldg(mel_range + 2 * m);
    const int hi = __ldg(mel_range + 2 * m + 1);
    float sa = 0.0f, sb = 0.0f;
    for (int bin = lo; bin < hi; ++bin) {
      const float w = __ldg(mel + bin * n_mels + m);
      sa = fmaf(pa[bin], w, sa);
      sb = fmaf(pb[bin], w, sb);
    }
    logmel_s[lane * n_mels + m] = logf(fmaxf(sa, log_floor));
    if (two) logmel_s[(lane + 32) * n_mels + m] = logf(fmaxf(sb, log_floor));
  }
  __syncthreads();
  const int n_out = min(kTileFrames, t - f0) * n_mels;
  float* dst = out + (row * t + f0) * n_mels;
  for (int i = tid; i < n_out; i += kThreads) dst[i] = logmel_s[i];
}

}  // namespace

// Frames one block computes: block-boundary tests read the tile from here.
extern "C" int fbank_frames_per_block() { return kTileFrames; }

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// wave [batch, n] f32, basis [kpad, 512] f32 with cos and sin n8-tiles
// interleaved (kpad % 16 == 0, rows past the frame length zero), mel
// [256, n_mels] f32, mel_range [n_mels, 2] int32 (nonzero bin range of
// each filter), out [batch, t, n_mels] f32; every frame r < t reads
// wave[r*shift : r*shift + kpad]; shift % 8 == 0.
extern "C" int fbank_launch(const float* wave, const float* basis, const float* mel,
                            const int* mel_range, float* out, int batch, long long n,
                            int t, int shift, int kpad, int n_mels, float log_floor,
                            void* stream) {
  if (batch < 1 || t < 1 || shift < 8 || shift % 8 != 0 || kpad < kTileK ||
      kpad % kTileK != 0 || n_mels < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile_floats = wave_rows(shift, kpad) * wave_pitch(shift) + kStages * kStageFloats;
  const int power_floats = kTileFrames * (kPowerPitch + n_mels);
  const size_t smem = sizeof(float) * (tile_floats > power_floats ? tile_floats : power_floats);
  const cudaError_t e = cudaFuncSetAttribute(
      fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((t + kTileFrames - 1) / kTileFrames, batch);
  fbank_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      wave, basis, mel, mel_range, out, n, t, shift, kpad, n_mels, log_floor);
  return static_cast<int>(cudaGetLastError());
}
