// The eval-mode epilogue of a conv of the classify step, in one pass over
// the conv's NCHW output y: the conv bias, eval BatchNorm, a residual and
// the ReLU, out = relu(bn(y + bias) + residual), each term optional.
//
// Replaces no Pallas kernel: XLA fused this chain for the JAX package.  In
// eager PyTorch the same chain is up to six full passes over y (the bias
// add, BN's subtract, multiply and add, the residual add, the ReLU), each a
// generic broadcasting kernel, plus about six tiny launches a call for BN's
// per-channel scale.
//
// What bounds it: bytes.  y and the residual are read once and the output
// written once (6 bytes an element in bf16 with a residual, 4 without), at
// 3.35 TB/s; the arithmetic is a few float32 operations an element.  So a
// thread moves 16 bytes at a time where the pointers allow (8 bf16 or 4
// float32, neighbouring threads on neighbouring addresses), and each block
// loads its elements before it computes the per-channel terms of the
// planes it covers, so the loads are in flight meanwhile.
//
// How it keeps the eager chain's bits: PyTorch's bf16 add, sub and mul
// compute in float32 and round once to bf16, so this kernel does the same
// float32 operations in the same order and rounds to the tensor's dtype
// after each (float32: no rounding step).  Every add, subtract and multiply
// is an explicit _rn intrinsic, so nothing is contracted into an FMA.  The
// per-channel scale is models/layers.py's expression, computed once a
// block from the raw BN tensors: bf16(weight * bf16(rsqrtf(bf16(var +
// eps)))), with the rsqrtf that ATen's CUDA rsqrt calls.  The ReLU is
// ATen's clamp_min(0): NaN passes, anything else is fmaxf(v, 0).  The
// output is a new tensor: y is left as it is.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

enum : int { kBias = 1, kNorm = 2, kResidual = 4, kRelu = 8 };

// A channel's terms: the conv bias, BN's mean, scale and shift.
struct alignas(16) Terms {
  float bias, mean, scale, shift;
};

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float get(float v) { return v; }
  static __device__ __forceinline__ float put(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float get(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 put(float v) { return __float2bfloat16_rn(v); }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

}  // namespace

// y and out contiguous [n, c, h, w]; total = n*c*h*w < 2^31.  The residual
// has y's shape at element strides rs; `dense` says it is laid out as y and
// aligned for VEC-wide loads.  bias, weight, shift, mean and var are [c].
template <typename T>
struct BnActArgs {
  const T* y;
  T* out;
  const T* bias;
  const T* weight;
  const T* shift;
  const T* mean;
  const T* var;
  const T* res;
  long long rs0, rs1, rs2, rs3;
  unsigned total, c, h, w, hw;
  int flags, dense;
  float eps;
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) bn_act_kernel(const BnActArgs<T> a) {
  extern __shared__ Terms terms[];  // one entry for each plane the block covers
  using N = Num<T>;
  const unsigned first = blockIdx.x * (kThreads * VEC);
  const unsigned e = first + threadIdx.x * VEC;
  const bool full = e + VEC <= a.total;

  float x[VEC], r[VEC];
  if (full) {
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(a.y + e);
#pragma unroll
    for (int k = 0; k < VEC; ++k) x[k] = N::get(p.v[k]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) x[k] = e + k < a.total ? N::get(a.y[e + k]) : 0.0f;
  }
  const unsigned plane = e / a.hw;  // n * c + channel
  unsigned off = e - plane * a.hw;  // within the plane
#pragma unroll
  for (int k = 0; k < VEC; ++k) r[k] = 0.0f;
  if (a.flags & kResidual) {
    if (full && a.dense) {
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(a.res + e);
#pragma unroll
      for (int k = 0; k < VEC; ++k) r[k] = N::get(p.v[k]);
    } else {
      unsigned n = plane / a.c, c = plane - n * a.c, i = off / a.w, j = off - i * a.w;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        if (e + k < a.total)
          r[k] = N::get(a.res[n * a.rs0 + c * a.rs1 + i * a.rs2 + j * a.rs3]);
        if (++j == a.w) {
          j = 0;
          if (++i == a.h) {
            i = 0;
            if (++c == a.c) { c = 0; ++n; }
          }
        }
      }
    }
  }

  // The terms of the planes this block covers, from the raw tensors.
  const unsigned first_plane = first / a.hw;
  const unsigned last = min(first + kThreads * VEC, a.total) - 1;
  const unsigned planes = last / a.hw - first_plane + 1;
  for (unsigned t = threadIdx.x; t < planes; t += kThreads) {
    const unsigned c = (first_plane + t) % a.c;
    Terms s{0.0f, 0.0f, 0.0f, 0.0f};
    if (a.flags & kBias) s.bias = N::get(a.bias[c]);
    if (a.flags & kNorm) {
      const float inv = N::round(rsqrtf(N::round(__fadd_rn(N::get(a.var[c]), a.eps))));
      s.scale = N::round(__fmul_rn(N::get(a.weight[c]), inv));
      s.mean = N::get(a.mean[c]);
      s.shift = N::get(a.shift[c]);
    }
    terms[t] = s;
  }
  __syncthreads();
  if (e >= a.total) return;

  Pack<T, VEC> o;
  unsigned t = plane - first_plane;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    if (!full && e + k >= a.total) break;
    const Terms s = terms[t];
    float v = x[k];
    if (a.flags & kBias) v = N::round(__fadd_rn(v, s.bias));
    if (a.flags & kNorm) {
      v = N::round(__fsub_rn(v, s.mean));
      v = N::round(__fmul_rn(v, s.scale));
      v = N::round(__fadd_rn(v, s.shift));
    }
    if (a.flags & kResidual) v = N::round(__fadd_rn(v, r[k]));
    if ((a.flags & kRelu) && !isnan(v)) v = fmaxf(v, 0.0f);
    o.v[k] = N::put(v);
    if (++off == a.hw) { off = 0; ++t; }
  }
  if (full) {
    *reinterpret_cast<Pack<T, VEC>*>(a.out + e) = o;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (e + k < a.total) a.out[e + k] = o.v[k];
  }
}

namespace {

template <typename T, int VEC>
int launch(const BnActArgs<T>& a, cudaStream_t stream) {
  constexpr unsigned per_block = kThreads * VEC;
  const unsigned blocks = (a.total + per_block - 1) / per_block;
  // A block's elements span at most this many planes.
  const size_t smem = sizeof(Terms) * ((per_block + a.hw - 1) / a.hw + 1);
  bn_act_kernel<T, VEC><<<blocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* y, void* out, const void* bias, const void* weight, const void* shift,
             const void* mean, const void* var, const void* res, int n, int c, int h, int w,
             long long rs0, long long rs1, long long rs2, long long rs3, int dense, int flags,
             float eps, int wide, cudaStream_t stream) {
  BnActArgs<T> a{static_cast<const T*>(y), static_cast<T*>(out),
                 static_cast<const T*>(bias), static_cast<const T*>(weight),
                 static_cast<const T*>(shift), static_cast<const T*>(mean),
                 static_cast<const T*>(var), static_cast<const T*>(res),
                 rs0, rs1, rs2, rs3,
                 static_cast<unsigned>(n) * c * h * w, static_cast<unsigned>(c),
                 static_cast<unsigned>(h), static_cast<unsigned>(w),
                 static_cast<unsigned>(h) * w, flags, dense, eps};
  constexpr int kWide = 16 / sizeof(T);
  return wide ? launch<T, kWide>(a, stream) : launch<T, 1>(a, stream);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// dtype 0 = float32, 1 = bfloat16.  y and out contiguous [n, c, h, w] with
// n*c*h*w in [1, 2^31); `wide` = y and out are 16-byte aligned (16-byte
// loads and stores); `dense` = the residual is laid out as y and 16-byte
// aligned.  flags: 1 bias, 2 BN, 4 residual, 8 ReLU; an unused pointer may
// be null.
extern "C" int bn_act_launch(int dtype, const void* y, void* out, const void* bias,
                             const void* weight, const void* shift, const void* mean,
                             const void* var, const void* res, int n, int c, int h, int w,
                             long long rs0, long long rs1, long long rs2, long long rs3,
                             int dense, int flags, float eps, int wide, void* stream) {
  const long long total = static_cast<long long>(n) * c * h * w;
  if (n < 1 || c < 1 || h < 1 || w < 1 || total >= (1LL << 31) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? dispatch<__nv_bfloat16>(y, out, bias, weight, shift, mean, var, res, n, c, h, w, rs0,
                                rs1, rs2, rs3, dense, flags, eps, wide, s)
      : dispatch<float>(y, out, bias, weight, shift, mean, var, res, n, c, h, w, rs0, rs1, rs2,
                        rs3, dense, flags, eps, wide, s);
}
