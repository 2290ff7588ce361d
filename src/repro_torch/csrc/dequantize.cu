// Decode of signed level indices, out = levels[|c|] * sign(c) * norm[bucket],
// and the fused decode-and-average of M gathered streams.
//
// dequantize replaces repro/kernels/dequantize.py::dequantize_pallas
// (_dequantize_kernel).  The TPU kernel looked levels up by a one-hot
// contraction over a tile of 8 buckets; here a table of signed levels sits in
// shared memory and each value gathers from it.
//
// dequantize_mean replaces no TPU kernel.  It is the reference's decode of
// the M gathered streams followed by its transport's mean_workers, fused as
// its sync.py describes ("one fused decode+average pass"): under XLA the
// plain decode fuses into the mean, while the port's kernel launch is a
// fusion barrier, so without it the wire's decode holds M x n float32.
//
// Bound on the H100: device memory.  dequantize reads 1, 2 or 4 bytes of code
// and writes 4 bytes a value; dequantize_mean reads M codes and writes one
// value.  Both run a persistent grid of a few blocks an SM, so a block stages
// its table once: each code's signed level, levels[|c|] * sign(c) (all 256
// int8 values, or the codes -(L-1)..L-1), in shared memory.  A value is then
// one table read and one product, and a term of the mean one more add, which
// keeps dequantize_mean's M terms a value under the memory's time.  Both walk
// the values in units of 4: a unit's codes (4, 8 or 16 bytes) are one load
// through the non-coherent path and its values one float4 store, neighbouring
// threads on neighbouring units, so a warp's stores are 512 contiguous bytes.
// (Sixteen int8 codes a thread, one 16-byte load, left each lane's 64 output
// bytes 64 bytes from the next lane's: every store touched 16 lines, and int8
// ran at a third of its bound.)  dequantize_mean's threads take kMeanUnits
// units a grid's width apart and issue kMeanBlock streams' loads of each
// before they add them, to keep enough bytes in flight.  A unit's bucket, and
// so its norm, follows the grid stride with no division at all (bucket sizes
// are whole units on this path).  Buckets that are not whole units, and
// pointers off a unit's alignment (row slices), take a scalar grid-stride
// path with one division a value.
//
// The products and sums are taken in the plain versions' order with explicit
// round-to-nearest intrinsics, so nvcc contracts nothing into an FMA and both
// kernels equal their plain versions bit for bit: (level * sign) * norm; the
// plain mean adds the M streams in worker order from 0 and then multiplies by
// the float32 reciprocal of M (the reference's mean_workers as XLA compiles
// it: its simplifier turns the division by the constant M into that product);
// the weighted means start from w[0] * v[0] and add w[m] * v[m], each product
// rounded, with an invalid bucket's value taken as 0 before its weight (it may
// decode to NaN).
#include <algorithm>

#include "common.cuh"

namespace repro {

// Modes of dequantize_mean, as kernels/dequantize.py names them.
enum MeanMode { kMeanPlain = 0, kMeanWeighted = 1, kMeanMasked = 2 };

// dequantize_mean's units a thread, and the streams whose loads it issues
// before it adds any of them.
constexpr int kMeanUnits = 2;
constexpr int kMeanBlock = 4;

// Entries of a block's signed level table: every int8 value, else the codes
// -(L-1)..L-1 of the largest table.
template <typename TCode>
__host__ __device__ constexpr int table_size() {
  return sizeof(TCode) == 1 ? 256 : 2 * kMaxLevels - 1;
}

// levels[|c|] * sign(c), rounded as the plain version rounds it.  A code
// outside the table (a corrupt symbol; the magnitude is taken unsigned, so
// INT_MIN is outside too) has magnitude 0, as the TPU kernel's one-hot lookup
// gives, and so a signed zero.
__device__ __forceinline__ float signed_level(int c, const float* levels, int L) {
  const unsigned a = c < 0 ? 0u - (unsigned)c : (unsigned)c;
  const float mag = a < (unsigned)L ? __ldg(levels + a) : 0.0f;
  return __fmul_rn(mag, (float)((c > 0) - (c < 0)));
}

// Stages the signed level table in shared memory: entry c & 255 of an int8
// code c, entry c + L - 1 of a wider one.  Synchronises the block.
template <typename TCode>
__device__ __forceinline__ void stage_table(float* tab, const float* levels, int L) {
  if (sizeof(TCode) == 1) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x)
      tab[i] = signed_level((int)(signed char)i, levels, L);
  } else {
    for (int i = threadIdx.x; i < 2 * L - 1; i += blockDim.x)
      tab[i] = signed_level(i - (L - 1), levels, L);
  }
  __syncthreads();
}

// One value, (level * sign) * norm in the plain version's order, its signed
// level read from the staged table (a wider code outside it is a signed 0).
template <typename TCode>
__device__ __forceinline__ float decode_one(int c, const float* tab, int L, float norm) {
  float level;
  if (sizeof(TCode) == 1) {
    level = tab[c & 255];
  } else {
    const unsigned i = (unsigned)(c + (L - 1));
    level = i < (unsigned)(2 * L - 1) ? tab[i] : (c < 0 ? -0.0f : 0.0f);
  }
  return __fmul_rn(level, norm);
}

// Worker m's decoded value x added to the running sum, as the transport's
// reduction takes it: the plain mean from 0, the weighted ones from the first
// product.
template <int MODE>
__device__ __forceinline__ float add_term(float acc, float x, int m, float w, bool ok) {
  if (MODE == kMeanPlain) return __fadd_rn(acc, x);
  if (MODE == kMeanMasked && !ok) x = 0.0f;
  const float t = __fmul_rn(w, x);
  return m == 0 ? t : __fadd_rn(acc, t);
}

// inv: the float32 reciprocal of M, __frcp_rn((float)M).
template <int MODE>
__device__ __forceinline__ float finish(float acc, float inv) {
  return MODE == kMeanPlain ? __fmul_rn(acc, inv) : acc;
}

// A unit's 4 codes as one load: 4, 8 or 16 bytes.
template <typename TCode> struct Raw;
template <> struct Raw<int8_t> { using T = int; };
template <> struct Raw<int16_t> { using T = int2; };
template <> struct Raw<int32_t> { using T = int4; };

// The unit at p (aligned to its size, read once).
template <typename TCode>
__device__ __forceinline__ typename Raw<TCode>::T load_unit(const TCode* p) {
  return __ldcs(reinterpret_cast<const typename Raw<TCode>::T*>(p));
}

// Code j of a unit, sign-extended.
template <typename TCode>
__device__ __forceinline__ int code_of(typename Raw<TCode>::T r, int j) {
  if constexpr (sizeof(TCode) == 1) {
    return (int)((unsigned)r << (24 - 8 * j)) >> 24;
  } else if constexpr (sizeof(TCode) == 2) {
    return (int)((unsigned)(j < 2 ? r.x : r.y) << (16 - 16 * (j % 2))) >> 16;
  } else {
    return j == 0 ? r.x : j == 1 ? r.y : j == 2 ? r.z : r.w;
  }
}

// Stores a unit's 4 values.
__device__ __forceinline__ void store_unit(float* out, long long u, float4 v) {
  reinterpret_cast<float4*>(out)[u] = v;
}

// Walks a thread's U units u + k T (k < U; T the grid's threads), u = start,
// start + U T, ..., with the bucket b[k] and place r[k] in it of each unit,
// advanced by U T's own quotient and remainder: U + 1 divisions a thread,
// none a unit.
template <int U>
struct UnitWalk {
  long long u, threads, b[U], db;
  int r[U], dr, upb;
  __device__ __forceinline__ UnitWalk(long long start, long long threads_, int upb_)
      : u(start), threads(threads_), db(U * threads_ / upb_), dr((int)(U * threads_ % upb_)),
        upb(upb_) {
#pragma unroll
    for (int k = 0; k < U; ++k) {
      b[k] = unit(k) / upb;
      r[k] = (int)(unit(k) % upb);
    }
  }
  __device__ __forceinline__ long long unit(int k) const { return u + k * threads; }
  __device__ __forceinline__ void next() {
    u += U * threads;
#pragma unroll
    for (int k = 0; k < U; ++k) {
      b[k] += db;
      r[k] += dr;
      if (r[k] >= upb) {
        r[k] -= upb;
        ++b[k];
      }
    }
  }
};

// dequantize over whole units: `units` units of 4 codes, upb of them a bucket.
template <typename TCode>
__global__ void dequantize_vec(const TCode* __restrict__ codes, const float* __restrict__ norms,
                               const float* __restrict__ levels, float* __restrict__ out,
                               long long units, int upb, int L) {
  __shared__ float tab[table_size<TCode>()];
  stage_table<TCode>(tab, levels, L);
  for (UnitWalk<1> w((long long)blockIdx.x * blockDim.x + threadIdx.x,
                     (long long)gridDim.x * blockDim.x, upb);
       w.u < units; w.next()) {
    const typename Raw<TCode>::T q = load_unit(codes + 4 * w.u);
    const float norm = __ldg(norms + w.b[0]);
    store_unit(out, w.u,
               make_float4(decode_one<TCode>(code_of<TCode>(q, 0), tab, L, norm),
                           decode_one<TCode>(code_of<TCode>(q, 1), tab, L, norm),
                           decode_one<TCode>(code_of<TCode>(q, 2), tab, L, norm),
                           decode_one<TCode>(code_of<TCode>(q, 3), tab, L, norm)));
  }
}

// dequantize value by value: any bucket size, any alignment.
template <typename TCode>
__global__ void dequantize_scalar(const TCode* __restrict__ codes, const float* __restrict__ norms,
                                  const float* __restrict__ levels, float* __restrict__ out,
                                  long long n, int bs, int L) {
  __shared__ float tab[table_size<TCode>()];
  stage_table<TCode>(tab, levels, L);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    out[i] = decode_one<TCode>((int)codes[i], tab, L, __ldg(norms + i / bs));
}

// dequantize_mean over whole units of one stream: M streams of n codes,
// (M, nb) norms, weights and validity; out holds one stream's values.  A
// thread takes kMeanUnits units and the streams kMeanBlock at a time: their
// loads first, then their terms.
template <typename TCode, int MODE>
__global__ void mean_vec(const TCode* __restrict__ codes, const float* __restrict__ norms,
                         const float* __restrict__ levels, const float* __restrict__ weights,
                         const unsigned char* __restrict__ valid, float* __restrict__ out,
                         long long units, int upb, long long n, long long nb, int M, int L) {
  constexpr int U = kMeanUnits, B = kMeanBlock;
  __shared__ float tab[table_size<TCode>()];
  stage_table<TCode>(tab, levels, L);
  const float inv = __frcp_rn((float)M);
  for (UnitWalk<U> w((long long)blockIdx.x * blockDim.x + threadIdx.x,
                     (long long)gridDim.x * blockDim.x, upb);
       w.u < units; w.next()) {
    float acc[U][4];
#pragma unroll
    for (int k = 0; k < U; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][j] = 0.0f;
    for (int m0 = 0; m0 < M; m0 += B) {
      typename Raw<TCode>::T q[B][U];
      float norm[B][U], wt[B][U];
      bool ok[B][U];
#pragma unroll
      for (int i = 0; i < B; ++i)
#pragma unroll
        for (int k = 0; k < U; ++k)
          if (m0 + i < M && w.unit(k) < units) {
            const long long mb = (m0 + i) * nb + w.b[k];
            q[i][k] = load_unit(codes + (m0 + i) * n + 4 * w.unit(k));
            norm[i][k] = __ldg(norms + mb);
            wt[i][k] = MODE == kMeanPlain ? 0.0f : __ldg(weights + mb);
            ok[i][k] = MODE == kMeanMasked ? valid[mb] != 0 : true;
          }
#pragma unroll
      for (int i = 0; i < B; ++i)
#pragma unroll
        for (int k = 0; k < U; ++k)
          if (m0 + i < M && w.unit(k) < units) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[k][j] = add_term<MODE>(
                  acc[k][j], decode_one<TCode>(code_of<TCode>(q[i][k], j), tab, L, norm[i][k]),
                  m0 + i, wt[i][k], ok[i][k]);
          }
    }
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (w.unit(k) < units)
        store_unit(out, w.unit(k),
                   make_float4(finish<MODE>(acc[k][0], inv), finish<MODE>(acc[k][1], inv),
                               finish<MODE>(acc[k][2], inv), finish<MODE>(acc[k][3], inv)));
  }
}

// dequantize_mean value by value: any bucket size, any alignment.
template <typename TCode, int MODE>
__global__ void mean_scalar(const TCode* __restrict__ codes, const float* __restrict__ norms,
                            const float* __restrict__ levels, const float* __restrict__ weights,
                            const unsigned char* __restrict__ valid, float* __restrict__ out,
                            long long n, long long nb, int bs, int M, int L) {
  __shared__ float tab[table_size<TCode>()];
  stage_table<TCode>(tab, levels, L);
  const float inv = __frcp_rn((float)M);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const long long b = i / bs;
    float acc = 0.0f;
    for (int m = 0; m < M; ++m) {
      const long long mb = m * nb + b;
      const float wt = MODE == kMeanPlain ? 0.0f : __ldg(weights + mb);
      const bool ok = MODE == kMeanMasked ? valid[mb] != 0 : true;
      acc = add_term<MODE>(acc, decode_one<TCode>((int)codes[m * n + i], tab, L,
                                                  __ldg(norms + mb)),
                           m, wt, ok);
    }
    out[i] = finish<MODE>(acc, inv);
  }
}

// Blocks of a persistent grid for `work` items of one thread each: enough to
// fill every SM with 2048 threads, no more than the work needs.  Blocks that
// registers keep from being resident at once run as a second wave, which a
// grid-stride walk tolerates.
static unsigned persistent_grid(long long work, int threads) {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 132;
  }();
  const long long need = (work + threads - 1) / threads;
  return (unsigned)std::max(1LL, std::min(need, (long long)sms * (2048 / threads)));
}

// Whether (nb, bs) codes of TCode at `codes` and f32 values at `out` can be
// walked as whole units: 4 codes, aligned to their size, and a float4.
template <typename TCode>
static bool in_units(const void* codes, const float* out, int bs) {
  return bs % 4 == 0 && !((uintptr_t)codes & (4 * sizeof(TCode) - 1)) &&
         !((uintptr_t)out & 15u);
}

static bool good_threads(int threads) {
  return threads >= 32 && threads <= 1024 && threads % 32 == 0;
}

template <typename TCode>
static int launch_dequantize(const void* codes_, const float* norms, const float* levels,
                             float* out, long long nb, int bs, int L, int threads,
                             cudaStream_t s) {
  const TCode* codes = (const TCode*)codes_;
  const long long n = nb * bs;
  if (in_units<TCode>(codes, out, bs)) {
    const long long units = n / 4;
    dequantize_vec<TCode><<<persistent_grid(units, threads), threads, 0, s>>>(
        codes, norms, levels, out, units, bs / 4, L);
  } else {
    dequantize_scalar<TCode><<<persistent_grid(n, threads), threads, 0, s>>>(codes, norms, levels,
                                                                              out, n, bs, L);
  }
  return (int)cudaGetLastError();
}

template <typename TCode, int MODE>
static int launch_mean(const void* codes_, const float* norms, const float* levels,
                       const float* weights, const unsigned char* valid, float* out, int M,
                       long long nb, int bs, int L, int threads, cudaStream_t s) {
  const TCode* codes = (const TCode*)codes_;
  const long long n = nb * bs;
  if (in_units<TCode>(codes, out, bs)) {
    const long long units = n / 4;
    mean_vec<TCode, MODE><<<persistent_grid(units / kMeanUnits, threads), threads, 0, s>>>(
        codes, norms, levels, weights, valid, out, units, bs / 4, n, nb, M, L);
  } else {
    mean_scalar<TCode, MODE><<<persistent_grid(n, threads), threads, 0, s>>>(
        codes, norms, levels, weights, valid, out, n, nb, bs, M, L);
  }
  return (int)cudaGetLastError();
}

template <typename TCode>
static int launch_mean_mode(const void* codes, const float* norms, const float* levels,
                            const float* weights, const unsigned char* valid, float* out, int M,
                            long long nb, int bs, int L, int threads, cudaStream_t s) {
  if (weights == nullptr)
    return launch_mean<TCode, kMeanPlain>(codes, norms, levels, weights, valid, out, M, nb, bs, L,
                                          threads, s);
  if (valid == nullptr)
    return launch_mean<TCode, kMeanWeighted>(codes, norms, levels, weights, valid, out, M, nb, bs,
                                             L, threads, s);
  return launch_mean<TCode, kMeanMasked>(codes, norms, levels, weights, valid, out, M, nb, bs, L,
                                         threads, s);
}

}  // namespace repro

// (nb, bs) codes + (nb,) norms + (L,) levels -> (nb, bs) f32 values, on a
// persistent grid of `threads`-thread blocks.  Returns the CUDA error of the
// launch (0 when it was accepted).
extern "C" int repro_dequantize(const void* codes, const float* norms, const float* levels,
                                float* out, long long nb, int bs, int L, int code_type,
                                int threads, void* stream) {
  using namespace repro;
  if (nb <= 0 || bs <= 0) return 0;
  if (L < 1 || L > kMaxLevels || !good_threads(threads)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (code_type == kI8)
    return launch_dequantize<int8_t>(codes, norms, levels, out, nb, bs, L, threads, s);
  if (code_type == kI16)
    return launch_dequantize<int16_t>(codes, norms, levels, out, nb, bs, L, threads, s);
  if (code_type == kI32)
    return launch_dequantize<int32_t>(codes, norms, levels, out, nb, bs, L, threads, s);
  return (int)cudaErrorInvalidValue;
}

// (M, nb, bs) codes + (M, nb) norms + (L,) levels [+ (M, nb) weights [+ (M,
// nb) validity bytes]] -> (nb, bs) f32: the plain mean over the M streams
// (weights null), the weighted sum (valid null) or the weighted sum with
// invalid buckets taken as 0.  Returns the CUDA error of the launch.
extern "C" int repro_dequantize_mean(const void* codes, const float* norms, const float* levels,
                                     const float* weights, const unsigned char* valid, float* out,
                                     int M, long long nb, int bs, int L, int code_type,
                                     int threads, void* stream) {
  using namespace repro;
  if (nb <= 0 || bs <= 0) return 0;
  if (M < 1 || L < 1 || L > kMaxLevels || !good_threads(threads) ||
      (valid != nullptr && weights == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (code_type == kI8)
    return launch_mean_mode<int8_t>(codes, norms, levels, weights, valid, out, M, nb, bs, L,
                                    threads, s);
  if (code_type == kI16)
    return launch_mean_mode<int16_t>(codes, norms, levels, weights, valid, out, M, nb, bs, L,
                                     threads, s);
  if (code_type == kI32)
    return launch_mean_mode<int32_t>(codes, norms, levels, weights, valid, out, M, nb, bs, L,
                                     threads, s);
  return (int)cudaErrorInvalidValue;
}
