// The eval-mode epilogue of a conv of the classify step, in one pass over
// the conv's output y: the conv bias, eval BatchNorm, a residual and the
// ReLU, out = relu(bn(y + bias) + residual), each term optional.
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
// computes the per-channel terms it needs into shared memory once: in NCHW
// after it has issued its loads, so they are in flight meanwhile; in NHWC
// before (its registers, in bn_act below).
//
// Two layouts, one body: y dense in NCHW ([n, c, h, w] in memory,
// bn_act_kernel) or in NHWC (channels-last: [n, h, w, c] in memory, the
// layout of the bf16 classify step, whose cuDNN convs are NHWC kernels;
// bn_act_nhwc_kernel); the output takes y's.  The wrapper picks the form
// from y's strides.
// - NCHW: an element's channel is its plane's; a block covers a few planes
//   and keeps one entry of terms for each.
// - NHWC: an element's channel is its index modulo c, so a block keeps the
//   terms of the (up to) c channels it covers, each entry at a slot
//   swizzled within its group of 8 (slot = t ^ ((t >> 3) & 7)): the 8
//   threads of a quarter warp, each on 8 channels of its own pixel, then
//   read 8 distinct bank groups, not one.  Where c is a multiple of 8 a
//   16-byte pack is 8 channels of one pixel, so a residual whose channel
//   stride is 1 and whose other strides are multiples of 8 (a crop along h
//   or w of a channels-last tensor: the band convs' residuals) takes the
//   same 16-byte loads as y.
// A residual laid out as y takes 16-byte loads in either layout; any other
// residual, and y off 16-byte alignment, takes scalar loads.  The kernel
// never copies.
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
// layout changes none of this.  The output is a new tensor: y is left as
// it is.
//
// Zero rows above and below (pad_top, pad_bottom): the output is then
// [n, c, top + h + bottom, w] in y's layout, y's result in its interior
// and zeros in its pad rows, all written by this one launch, so that the
// next conv, which pads its input in time on one side (the shared stem's
// window-edge bands), reads the buffer as it is: no separate fill of the
// padded tensor and no copy of y's result into its interior.  A pad row is
// a whole row of each plane (NCHW) or of each image (NHWC: w * c elements),
// so an element's place in the output is its place in y moved down by
// (unit * (top + bottom) + top) rows, unit its plane or image.  The blocks
// past y's write the pad rows' zeros (+0.0, as a constant pad writes).
// Where a row is a whole number of 16-byte vectors the stores stay 16
// bytes wide; elsewhere they are scalar.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

enum : int { kBias = 1, kNorm = 2, kResidual = 4, kRelu = 8 };

// How the residual is read: at its own strides one element at a time; laid
// out as y and 16-byte aligned (flat index, 16-byte loads); or (NHWC) with
// channel stride 1, its other strides multiples of the vector and a
// 16-byte aligned base, c a multiple of the vector (16-byte loads, one
// pixel's channels at a time).
enum : int { kResStrided = 0, kResDense = 1, kResPixel = 2 };

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

// The NHWC table's slot of entry t: a permutation within each group of 8.
__device__ __forceinline__ unsigned swizzle(unsigned t) { return t ^ ((t >> 3) & 7u); }

}  // namespace

// y dense [n, c, h, w] in NCHW or NHWC memory order (`nhwc`); total =
// n*c*h*w < 2^31.  out is y's shape, or with pad_rows = top + bottom > 0
// [n, c, top + h + bottom, w] in the same order, fewer than 2^31 elements:
// a unit (an NCHW plane or an NHWC image) of y is `unit` elements, a row
// `row` (w, or w * c), and the out's pad rows hold `zeros` elements, which
// the blocks from `y_blocks` on write.  The residual has y's shape at
// element strides rs (in [n, c, h, w] order), read as `res_mode` says.
// bias, weight, shift, mean and var are [c].
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
  int flags, res_mode;
  float eps;
  unsigned top, pad_rows, row, unit, zeros, y_blocks;
  bool pad_wide;  // every row a whole number of VEC-element vectors
};

// Where y's element e lies in the padded output.
template <typename T>
__device__ __forceinline__ unsigned padded_index(const BnActArgs<T>& a, unsigned e) {
  return e + (e / a.unit * a.pad_rows + a.top) * a.row;
}

// A block past y's: VEC of the pad rows' zeros a thread, the z-th zero
// lying in unit z / (pad_rows * row), above the unit's rows of y while
// within its first top * row zeros, below them after.
template <typename T, int VEC>
__device__ __forceinline__ void zero_rows(const BnActArgs<T>& a) {
  const unsigned z = (blockIdx.x - a.y_blocks) * (kThreads * VEC) + threadIdx.x * VEC;
  if (z >= a.zeros) return;
  const unsigned per_unit = a.pad_rows * a.row;
  const auto at = [&a, per_unit](unsigned q) {
    const unsigned u = q / per_unit, k = q - u * per_unit;
    return u * (a.unit + per_unit) + (k < a.top * a.row ? k : k + a.unit);
  };
  if (a.pad_wide && z + VEC <= a.zeros) {
    Pack<T, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) o.v[k] = Num<T>::put(0.0f);
    *reinterpret_cast<Pack<T, VEC>*>(a.out + at(z)) = o;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (z + k < a.zeros) a.out[at(z + k)] = Num<T>::put(0.0f);
  }
}

template <typename T>
__device__ __forceinline__ Terms channel_terms(const BnActArgs<T>& a, unsigned c) {
  using N = Num<T>;
  Terms s{0.0f, 0.0f, 0.0f, 0.0f};
  if (a.flags & kBias) s.bias = N::get(a.bias[c]);
  if (a.flags & kNorm) {
    const float inv = N::round(rsqrtf(N::round(__fadd_rn(N::get(a.var[c]), a.eps))));
    s.scale = N::round(__fmul_rn(N::get(a.weight[c]), inv));
    s.mean = N::get(a.mean[c]);
    s.shift = N::get(a.shift[c]);
  }
  return s;
}

// The terms the block of elements [first, last] needs, from the raw tensors,
// into the shared table.  NCHW: one entry for each plane the block covers.
// NHWC: entry t holds channel (c0 + t) % c at its swizzled slot, for the
// min(c, span) channels the block covers from its first element's channel
// c0 on.
template <typename T, bool NHWC>
__device__ __forceinline__ void fill_terms(const BnActArgs<T>& a, Terms* terms, unsigned first,
                                           unsigned last) {
  if constexpr (NHWC) {
    const unsigned c0 = first % a.c;
    const unsigned entries = min(a.c, last - first + 1);
    for (unsigned u = threadIdx.x; u < entries; u += kThreads)
      terms[swizzle(u)] = channel_terms(a, c0 + u < a.c ? c0 + u : c0 + u - a.c);
  } else {
    const unsigned first_plane = first / a.hw;
    const unsigned planes = last / a.hw - first_plane + 1;
    for (unsigned u = threadIdx.x; u < planes; u += kThreads)
      terms[u] = channel_terms(a, (first_plane + u) % a.c);
  }
}

// One thread's VEC elements, in y's memory order; with PAD, the blocks
// past y's write the output's pad rows instead.
template <typename T, int VEC, bool NHWC, bool PAD>
__device__ __forceinline__ void bn_act(const BnActArgs<T>& a) {
  extern __shared__ Terms terms[];
  using N = Num<T>;
  if constexpr (PAD) {
    if (blockIdx.x >= a.y_blocks) {  // the whole block: before any barrier
      zero_rows<T, VEC>(a);
      return;
    }
  }
  const unsigned first = blockIdx.x * (kThreads * VEC);
  const unsigned last = min(first + kThreads * VEC, a.total) - 1;
  const unsigned e = first + threadIdx.x * VEC;
  const bool full = e + VEC <= a.total;

  // NCHW loads its elements before it fills the table, so the loads are in
  // flight meanwhile.  NHWC fills it first: its index arithmetic, live
  // across the fill beside the loaded values, would take 48 registers a
  // thread and leave room for five blocks an SM, where the bytes in flight
  // set the pace; filled first it takes at most 40 (six blocks), spills
  // nothing, and runs 4-5% faster at the sweep's shapes on an H100.
  if constexpr (NHWC) {
    fill_terms<T, NHWC>(a, terms, first, last);
    __syncthreads();
    if (e >= a.total) return;
  }
  Pack<T, VEC> px, pr;  // y's and the residual's elements, as loaded
  if (full) {
    px = *reinterpret_cast<const Pack<T, VEC>*>(a.y + e);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) px.v[k] = e + k < a.total ? a.y[e + k] : N::put(0.0f);
  }
  // Element e's place: channel c, row i and column j of image n; off is its
  // offset within its plane (NCHW) or its pixel's offset within its image
  // (NHWC, where c is e's index modulo the channel count).
  unsigned n, c, off;
  if constexpr (NHWC) {
    c = e % a.c;
  } else {
    const unsigned plane = e / a.hw;
    off = e - plane * a.hw;
    n = plane / a.c;
    c = plane - n * a.c;
  }
  if (a.flags & kResidual) {
    if constexpr (NHWC) {
      n = e / a.c / a.hw;
      off = e / a.c - n * a.hw;
    }
    unsigned i = off / a.w, j = off - i * a.w;
    if (full && a.res_mode == kResDense) {
      pr = *reinterpret_cast<const Pack<T, VEC>*>(a.res + e);
    } else if (NHWC && full && a.res_mode == kResPixel) {
      pr = *reinterpret_cast<const Pack<T, VEC>*>(a.res + (n * a.rs0 + i * a.rs2 + j * a.rs3 + c));
    } else {
      unsigned cc = c, nn = n;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        pr.v[k] = e + k < a.total ? a.res[nn * a.rs0 + cc * a.rs1 + i * a.rs2 + j * a.rs3]
                                  : N::put(0.0f);
        // The next element in memory order.
        if constexpr (NHWC) {
          if (++cc == a.c) {
            cc = 0;
            if (++j == a.w) {
              j = 0;
              if (++i == a.h) { i = 0; ++nn; }
            }
          }
        } else {
          if (++j == a.w) {
            j = 0;
            if (++i == a.h) {
              i = 0;
              if (++cc == a.c) { cc = 0; ++nn; }
            }
          }
        }
      }
    }
  }
  unsigned t;  // the table entry of this thread's first element
  if constexpr (NHWC) {
    const unsigned c0 = first % a.c;
    t = c >= c0 ? c - c0 : c + a.c - c0;
  } else {
    fill_terms<T, NHWC>(a, terms, first, last);
    __syncthreads();
    if (e >= a.total) return;
    t = n * a.c + c - first / a.hw;
  }

  Pack<T, VEC> o;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    if (!full && e + k >= a.total) break;
    const Terms s = terms[NHWC ? swizzle(t) : t];
    float v = N::get(px.v[k]);
    if (a.flags & kBias) v = N::round(__fadd_rn(v, s.bias));
    if (a.flags & kNorm) {
      v = N::round(__fsub_rn(v, s.mean));
      v = N::round(__fmul_rn(v, s.scale));
      v = N::round(__fadd_rn(v, s.shift));
    }
    if (a.flags & kResidual) v = N::round(__fadd_rn(v, N::get(pr.v[k])));
    if ((a.flags & kRelu) && !isnan(v)) v = fmaxf(v, 0.0f);
    o.v[k] = N::put(v);
    if constexpr (NHWC) {
      if (++t == a.c) t = 0;
    } else {
      if (++off == a.hw) { off = 0; ++t; }
    }
  }
  if constexpr (PAD) {
    if (full && a.pad_wide) {
      *reinterpret_cast<Pack<T, VEC>*>(a.out + padded_index(a, e)) = o;
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        if (e + k < a.total) a.out[padded_index(a, e + k)] = o.v[k];
    }
  } else if (full) {
    *reinterpret_cast<Pack<T, VEC>*>(a.out + e) = o;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (e + k < a.total) a.out[e + k] = o.v[k];
  }
}

template <typename T, int VEC, bool PAD>
__global__ void __launch_bounds__(kThreads) bn_act_kernel(const BnActArgs<T> a) {
  bn_act<T, VEC, false, PAD>(a);
}

template <typename T, int VEC, bool PAD>
__global__ void __launch_bounds__(kThreads) bn_act_nhwc_kernel(const BnActArgs<T> a) {
  bn_act<T, VEC, true, PAD>(a);
}

namespace {

template <typename T, int VEC, bool PAD>
void launch_form(const BnActArgs<T>& a, bool nhwc, unsigned blocks, cudaStream_t stream) {
  constexpr unsigned per_block = kThreads * VEC;
  if (nhwc) {
    // Up to min(c, per_block) entries, rounded up to whole groups of 8 for
    // the swizzle: at most 2,048 entries, 32 KB.
    const unsigned entries = ((a.c < per_block ? a.c : per_block) + 7) / 8 * 8;
    bn_act_nhwc_kernel<T, VEC, PAD><<<blocks, kThreads, sizeof(Terms) * entries, stream>>>(a);
  } else {
    // A block's elements span at most this many planes.
    const size_t smem = sizeof(Terms) * ((per_block + a.hw - 1) / a.hw + 1);
    bn_act_kernel<T, VEC, PAD><<<blocks, kThreads, smem, stream>>>(a);
  }
}

template <typename T, int VEC>
int launch(BnActArgs<T> a, bool nhwc, cudaStream_t stream) {
  constexpr unsigned per_block = kThreads * VEC;
  a.y_blocks = (a.total + per_block - 1) / per_block;
  a.pad_wide = a.row % VEC == 0;
  if (a.pad_rows == 0)
    launch_form<T, VEC, false>(a, nhwc, a.y_blocks, stream);
  else
    launch_form<T, VEC, true>(a, nhwc, a.y_blocks + (a.zeros + per_block - 1) / per_block,
                              stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* y, void* out, const void* bias, const void* weight, const void* shift,
             const void* mean, const void* var, const void* res, int n, int c, int h, int w,
             long long rs0, long long rs1, long long rs2, long long rs3, int res_mode, int flags,
             float eps, int wide, int nhwc, int top, int bottom, cudaStream_t stream) {
  const unsigned row = nhwc ? static_cast<unsigned>(w) * c : static_cast<unsigned>(w);
  const unsigned pad_rows = static_cast<unsigned>(top + bottom);
  BnActArgs<T> a{static_cast<const T*>(y), static_cast<T*>(out),
                 static_cast<const T*>(bias), static_cast<const T*>(weight),
                 static_cast<const T*>(shift), static_cast<const T*>(mean),
                 static_cast<const T*>(var), static_cast<const T*>(res),
                 rs0, rs1, rs2, rs3,
                 static_cast<unsigned>(n) * c * h * w, static_cast<unsigned>(c),
                 static_cast<unsigned>(h), static_cast<unsigned>(w),
                 static_cast<unsigned>(h) * w, flags, res_mode, eps,
                 static_cast<unsigned>(top), pad_rows, row, static_cast<unsigned>(h) * row,
                 (nhwc ? static_cast<unsigned>(n) : static_cast<unsigned>(n) * c) * pad_rows * row,
                 0u, false};
  constexpr int kWide = 16 / sizeof(T);
  return wide ? launch<T, kWide>(a, nhwc, stream) : launch<T, 1>(a, nhwc, stream);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// dtype 0 = float32, 1 = bfloat16.  y dense [n, c, h, w], NCHW in memory
// or, with `nhwc`, NHWC; n*c*h*w in [1, 2^31); out dense [n, c, top + h +
// bottom, w] in y's order, fewer than 2^31 elements, its top and bottom
// rows zeros (top, bottom >= 0); `wide` = y and out are 16-byte aligned
// (16-byte loads and stores).  The residual is read at
// its strides rs0..rs3 as `res_mode` says: 0 one element at a time, 1 laid
// out as y and 16-byte aligned, 2 (nhwc, wide) channel stride 1, the other
// strides multiples of 16 bytes' elements, a 16-byte aligned base and c a
// multiple of them.  flags: 1 bias, 2 BN, 4 residual, 8 ReLU; an unused
// pointer may be null.
extern "C" int bn_act_launch(int dtype, const void* y, void* out, const void* bias,
                             const void* weight, const void* shift, const void* mean,
                             const void* var, const void* res, int n, int c, int h, int w,
                             long long rs0, long long rs1, long long rs2, long long rs3,
                             int res_mode, int flags, float eps, int wide, int nhwc, int top,
                             int bottom, void* stream) {
  const long long total = static_cast<long long>(n) * c * h * w;
  if (n < 1 || c < 1 || h < 1 || w < 1 || total >= (1LL << 31) || (dtype != 0 && dtype != 1)
      || res_mode < 0 || res_mode > 2 || (res_mode == 2 && !(nhwc && wide)) || top < 0
      || bottom < 0 || static_cast<long long>(n) * c * (h + top + bottom) * w >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? dispatch<__nv_bfloat16>(y, out, bias, weight, shift, mean, var, res, n, c, h, w, rs0,
                                rs1, rs2, rs3, res_mode, flags, eps, wide, nhwc, top, bottom, s)
      : dispatch<float>(y, out, bias, weight, shift, mean, var, res, n, c, h, w, rs0, rs1, rs2,
                        rs3, res_mode, flags, eps, wide, nhwc, top, bottom, s);
}
