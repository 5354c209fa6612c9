// Kaldi log-mel filterbank for Hopper (sm_90a): reflection-padded float32
// wave [B, n] -> log-mel [B, T, n_mels], strict FP32 FMA on CUDA cores.
//
// Replaces laughter_detection_icsi_tpu/ops/fbank_pallas.py:_fbank_kernel
// (the TPU kernel: per 256-frame block, six HIGHEST-precision f32 MXU
// matmuls of three row-shifted wave views against the folded cos/sin
// bases, power spectrum, mel projection, log).  This kernel computes the
// same function but is laid out for an SM, not carried over block by block.
//
// What bounds it: operations.  Per main-path bucket (T = 6,243 frames) it
// does 2*2*T*400*256 FLOP for the DFT plus 2*T*256*44 for the mel
// projection, about 2.70 GFLOP, against about 5.9 MB of compulsory traffic
// (4.0 MB of wave in, 0.8 MB of bases, 1.1 MB of features out): some 460
// FLOP per byte, far above the card's float32 ridge.  TF32 would be ~8x
// faster on the tensor cores but keeps ~3 decimal digits; the features
// must hold 2e-4 against the float32 reference, so every product is an
// fp32 FMA.
//
// Design, so that nothing intermediate touches device memory:
// - one block owns a tile of 32 consecutive frames of one batch row.  The
//   tile's frames overlap (shift 160 < length 400), so the block copies the
//   31*shift + kpad wave samples they span into shared memory once and
//   reads every frame straight from there at offset f*shift: no framed or
//   row-shifted copy of the wave is ever built;
// - the preprocessing-folded basis [kpad, 512] (cos bins 0..255 | sin bins
//   0..255, Nyquist dropped, rows past the frame length zero) streams
//   through shared memory in 8-row K-tiles, the next tile prefetched into
//   registers while the current one is consumed;
// - each warp owns 4 frames and all 512 columns: lane l accumulates columns
//   l + 32j (j < 16), so a warp's basis reads hit 32 consecutive words
//   (no bank conflicts) and its wave reads are broadcasts.  re and im of a
//   bin land in the same thread, so the power spectrum is formed in
//   registers;
// - power goes to shared memory (reusing the tile buffers), then each
//   (frame, filter) output sums its filter's nonzero bins (the mel bank is
//   triangular: skipping its zero rows adds only exact zeros), takes
//   log(max(., floor)) and is written once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFramesPerWarp = 4;
constexpr int kTileFrames = kWarps * kFramesPerWarp;  // 32 frames per block
constexpr int kBins = 256;                            // DFT bins kept
constexpr int kCols = 2 * kBins;                      // cos | sin
constexpr int kColsPerLane = kCols / 32;              // 16
constexpr int kTileK = 8;                             // basis rows per tile
constexpr int kTileVec4 = kTileK * kCols / 4;         // float4 per tile
constexpr int kVec4PerThread = kTileVec4 / kThreads;  // 4

static_assert(kTileVec4 % kThreads == 0, "tile load must split evenly");

__host__ __device__ inline int wave_tile_len(int shift, int kpad) {
  // Rounded up to a float4 so the basis tile that follows stays aligned.
  return ((kTileFrames - 1) * shift + kpad + 3) & ~3;
}

__global__ void __launch_bounds__(kThreads)
fbank_kernel(const float* __restrict__ wave, const float* __restrict__ basis,
             const float* __restrict__ mel, const int* __restrict__ mel_range,
             float* __restrict__ out, long long n, int t, int shift, int kpad,
             int n_mels, float log_floor) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int wave_len = wave_tile_len(shift, kpad);
  float* wave_s = smem;
  float* basis_s = smem + wave_len;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int f0 = blockIdx.x * kTileFrames;
  const long long row = blockIdx.y;
  const float* wave_row = wave + row * n;

  // The tile's samples; past the row end read as zero (those frames are
  // never written).
  const long long s0 = static_cast<long long>(f0) * shift;
  for (int i = tid; i < wave_len; i += kThreads) {
    const long long g = s0 + i;
    wave_s[i] = g < n ? wave_row[g] : 0.0f;
  }

  const float4* basis4 = reinterpret_cast<const float4*>(basis);
  float4* basis_s4 = reinterpret_cast<float4*>(basis_s);
  const int n_tiles = kpad / kTileK;
  float4 next[kVec4PerThread];
#pragma unroll
  for (int q = 0; q < kVec4PerThread; ++q) next[q] = __ldg(basis4 + tid + q * kThreads);

  float acc[kFramesPerWarp][kColsPerLane];
#pragma unroll
  for (int i = 0; i < kFramesPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) acc[i][j] = 0.0f;

  const float* wave_w = wave_s + warp * kFramesPerWarp * shift;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // the previous tile is consumed (first pass: wave_s is loaded)
#pragma unroll
    for (int q = 0; q < kVec4PerThread; ++q) basis_s4[tid + q * kThreads] = next[q];
    __syncthreads();
    if (kt + 1 < n_tiles) {
      const float4* src = basis4 + static_cast<long long>(kt + 1) * kTileVec4;
#pragma unroll
      for (int q = 0; q < kVec4PerThread; ++q) next[q] = __ldg(src + tid + q * kThreads);
    }
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const int k = kt * kTileK + kk;
      float a[kFramesPerWarp];
#pragma unroll
      for (int i = 0; i < kFramesPerWarp; ++i) a[i] = wave_w[i * shift + k];
      float b[kColsPerLane];
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) b[j] = basis_s[kk * kCols + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < kFramesPerWarp; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  __syncthreads();  // every warp is done with wave_s / basis_s
  float* power_s = smem;  // [kTileFrames][kBins]
#pragma unroll
  for (int i = 0; i < kFramesPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerLane / 2; ++j) {
      const float re = acc[i][j];
      const float im = acc[i][j + kColsPerLane / 2];
      power_s[(warp * kFramesPerWarp + i) * kBins + lane + 32 * j] = re * re + im * im;
    }
  __syncthreads();

  for (int idx = tid; idx < kTileFrames * n_mels; idx += kThreads) {
    const int f = idx / n_mels;
    const int m = idx - f * n_mels;
    const int frame = f0 + f;
    if (frame >= t) continue;
    const float* p = power_s + f * kBins;
    const int lo = mel_range[2 * m];
    const int hi = mel_range[2 * m + 1];
    float s = 0.0f;
    for (int bin = lo; bin < hi; ++bin) s = fmaf(p[bin], __ldg(mel + bin * n_mels + m), s);
    out[(row * t + frame) * n_mels + m] = logf(fmaxf(s, log_floor));
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// wave [batch, n] f32, basis [kpad, 512] f32 (kpad % 8 == 0), mel
// [256, n_mels] f32, mel_range [n_mels, 2] int32 (nonzero bin range of
// each filter), out [batch, t, n_mels] f32; every frame r < t reads
// wave[r*shift : r*shift + kpad].
extern "C" int fbank_launch(const float* wave, const float* basis, const float* mel,
                            const int* mel_range, float* out, int batch, long long n,
                            int t, int shift, int kpad, int n_mels, float log_floor,
                            void* stream) {
  if (batch < 1 || t < 1 || shift < 1 || kpad < kTileK || kpad % kTileK != 0 ||
      n_mels < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int wave_len = wave_tile_len(shift, kpad);
  const int tile_floats = wave_len + kTileK * kCols;
  const int power_floats = kTileFrames * kBins;
  const size_t smem = sizeof(float) * (tile_floats > power_floats ? tile_floats : power_floats);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((t + kTileFrames - 1) / kTileFrames, batch);
  fbank_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      wave, basis, mel, mel_range, out, n, t, shift, kpad, n_mels, log_floor);
  return static_cast<int>(cudaGetLastError());
}
