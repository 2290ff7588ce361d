// Fused bucket norm + normalize + stochastic round: the encode kernel of the
// quantized all-gather, run once per worker on every step.
//
// Replaces repro/kernels/quantize.py::quantize_pallas (_quantize_kernel).
// The TPU kernel found each level index by a broadcast compare and looked the
// two neighbouring levels up by one-hot contractions; here the levels sit in
// shared memory and each element does a branchless binary search.
//
// Bound on the H100: device memory.  Every element reads its value (4 B f32 or
// 2 B bf16) and its uniform (4 B) and writes one code (1 B int8, 2 B int16):
// 9 B an element in f32 with int8 codes.  Its arithmetic (two IEEE divisions
// and a 3-step search at 3 bits, some 45 instructions) comes close enough to
// that bound that it has to overlap the loads.
//
// Design:
//  - Each element of v is read from device memory once.  At the bucket sizes
//    the repo runs (1024 and 8192), a block of THREADS threads holds the
//    whole bucket in registers, EPT elements a thread, loaded as back-to-back
//    16-byte vectors; the norm is reduced from those registers and the codes
//    come from them (quantize_regs).  Any other size, or a pointer or row
//    that is not 16-byte aligned, stages the bucket in shared memory by one
//    bulk async copy; only a bucket larger than shared memory is read twice
//    (quantize_any).
//  - The uniforms are loaded with evict-first hints right after the values,
//    before the norm's block reduction, so that they land while the block
//    waits at its barriers.
//  - Codes are packed into 4-, 8- or 16-byte stores with evict-first hints:
//    decode does not read them soon.
//  - The search table holds levels 0..L-2 and then +inf, padded to 2^LOGP
//    entries: LOGP = 3 up to 9 levels (3 bits), 4 up to 17, else 8 (the only
//    table of the other layouts and of int16 codes).  The search is LOGP
//    unrolled compare-and-step stages, which the compiler interleaves across
//    a thread's elements; (level, gap) pairs give a and max(c - a, 1e-30) in
//    one load.
//  - The per-element arithmetic is the plain version's, in its order:
//    r = clamp(|x| / safe, 0, 1), tau = #(levels <= r) - 1 clamped to
//    [0, L-2], rho = (r - a) / max(c - a, 1e-30), code = (tau + (u < rho))
//    * sign(x).  Only the norm's sum order differs.
//  - One block a bucket (block b on bucket b, up to 2^31 - 1 buckets), with
//    64-bit offsets.
#include "bucket.cuh"

namespace repro {

// The level tables of a launch in shared memory: `st` is searched, `ag`
// holds (level, max(next level - level, 1e-30)) for each lower index.
template <int LOGP>
struct LevelTables {
  float st[1 << LOGP];
  float2 ag[1 << LOGP];
};

template <int LOGP>
__device__ __forceinline__ void load_tables(const float* __restrict__ levels, int L,
                                            LevelTables<LOGP>& t) {
  for (int j = threadIdx.x; j < (1 << LOGP); j += blockDim.x) {
    float a = INFINITY, gap = 1.f;
    if (j < L - 1) {
      a = levels[j];
      gap = fmaxf(levels[j + 1] - a, 1e-30f);
    }
    t.st[j] = a;
    t.ag[j] = make_float2(a, gap);
  }
}

// One element's signed level index.
template <int LOGP>
__device__ __forceinline__ int encode(float x, float u, float safe, const LevelTables<LOGP>& t) {
  const float r = fminf(fmaxf(fabsf(x) / safe, 0.f), 1.f);
  // tau = #(levels <= r) - 1 clamped to [0, L-2]: the last index below L-1
  // whose level is <= r, or 0 (st[0] need not be probed)
  int tau = 0;
#pragma unroll
  for (int s = (1 << LOGP) >> 1; s > 0; s >>= 1) tau += t.st[tau + s] <= r ? s : 0;
  const float2 ag = t.ag[tau];
  const float rho = (r - ag.x) / ag.y;
  const int sign = (x > 0.f) - (x < 0.f);
  return (tau + (u < rho ? 1 : 0)) * sign;
}

// Stores N codes (4, 8 or 16 bytes, aligned to their size) in one
// evict-first store.
template <typename TCode, int N>
__device__ __forceinline__ void store_codes(TCode* dst, const int* c) {
  constexpr int PER = 4 / (int)sizeof(TCode);  // codes in a 32-bit word
  constexpr int W = N / PER;
  constexpr uint32_t MASK = sizeof(TCode) == 1 ? 0xffu : 0xffffu;
  static_assert(W == 1 || W == 2 || W == 4, "4, 8 or 16 bytes");
  uint32_t w[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    w[i] = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) w[i] |= ((uint32_t)c[i * PER + j] & MASK) << (8 * sizeof(TCode) * j);
  }
  if constexpr (W == 1) __stcs(reinterpret_cast<unsigned int*>(dst), w[0]);
  else if constexpr (W == 2) __stcs(reinterpret_cast<uint2*>(dst), make_uint2(w[0], w[1]));
  else __stcs(reinterpret_cast<uint4*>(dst), make_uint4(w[0], w[1], w[2], w[3]));
}

// Buckets of THREADS * EPT elements, held in registers.  v, u and codes are
// 16-byte aligned.
template <typename TIn, typename TCode, int NORM, int LOGP, int THREADS, int EPT>
__global__ void __launch_bounds__(THREADS)
    quantize_regs(const TIn* __restrict__ v, const float* __restrict__ u,
                  const float* __restrict__ levels, TCode* __restrict__ codes,
                  float* __restrict__ norms, int L) {
  constexpr int VEC = vec_of<TIn>();
  constexpr int NV = EPT / VEC;
  static_assert(EPT % VEC == 0, "a thread holds whole vectors");
  __shared__ LevelTables<LOGP> tab;
  __shared__ float scratch[32];
  load_tables(levels, L, tab);  // published by the norm's barriers
  const int64_t b = blockIdx.x;
  const int64_t base = b * (THREADS * EPT);
  float x[EPT], ur[EPT];
#pragma unroll
  for (int k = 0; k < NV; ++k) load16(v + base + (k * THREADS + threadIdx.x) * VEC, x + k * VEC);
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int h = 0; h < VEC; h += 4)
      load16_stream(u + base + (k * THREADS + threadIdx.x) * VEC + h, ur + k * VEC + h);
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < EPT; ++e) acc = norm_step<NORM>(acc, x[e]);
  const float norm = norm_of<NORM>(acc, scratch);
  if (threadIdx.x == 0) norms[b] = norm;
  const float safe = norm > 0.f ? norm : 1.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    int c[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) c[j] = encode(x[k * VEC + j], ur[k * VEC + j], safe, tab);
    store_codes<TCode, VEC>(codes + base + (k * THREADS + threadIdx.x) * VEC, c);
  }
}

// Buckets of any size and alignment: staged in shared memory (STAGE), or
// read twice from device memory when they do not fit.
template <typename TIn, typename TCode, int NORM, bool STAGE>
__global__ void quantize_any(const TIn* __restrict__ v, const float* __restrict__ u,
                             const float* __restrict__ levels, TCode* __restrict__ codes,
                             float* __restrict__ norms, int bs, int L) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ LevelTables<8> tab;
  __shared__ float scratch[32];
  __shared__ uint64_t bar;
  if (STAGE && threadIdx.x == 0) mbar_init(&bar);
  load_tables(levels, L, tab);
  __syncthreads();
  const int64_t b = blockIdx.x;
  const int64_t base = b * bs;
  const TIn* src = v + base;
  if constexpr (STAGE) src = stage_bucket(src, bs, dyn, &bar);
  float acc = 0.f;
  for (int i = threadIdx.x; i < bs; i += blockDim.x) acc = norm_step<NORM>(acc, to_f32(src[i]));
  const float norm = norm_of<NORM>(acc, scratch);
  if (threadIdx.x == 0) norms[b] = norm;
  const float safe = norm > 0.f ? norm : 1.f;
  const float* ub = u + base;
  TCode* cb = codes + base;
  // codes go four to a store between the first and the last 4-code boundary
  // of the bucket, one by one outside them
  const int head = min(bs, (int)((4 - ((uintptr_t)cb / sizeof(TCode)) % 4) % 4));
  const int groups = (bs - head) / 4;
  for (int i = threadIdx.x; i < head; i += blockDim.x)
    cb[i] = (TCode)encode(to_f32(src[i]), __ldcs(ub + i), safe, tab);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int i0 = head + 4 * g;
    int c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = encode(to_f32(src[i0 + j]), __ldcs(ub + i0 + j), safe, tab);
    store_codes<TCode, 4>(cb + i0, c);
  }
  for (int i = head + 4 * groups + threadIdx.x; i < bs; i += blockDim.x)
    cb[i] = (TCode)encode(to_f32(src[i]), __ldcs(ub + i), safe, tab);
}

struct QuantizeArgs {
  const void* v;
  const float* u;
  const float* levels;
  void* codes;
  float* norms;
  long long nb;
  int bs, L, layout, threads, ept, smem;
  cudaStream_t s;
};

template <typename TIn, typename TCode, int NORM, int LOGP>
static int run_regs(const QuantizeArgs& a) {
  return with_reg_shape(a.threads, a.ept, [&](auto t, auto e) {
    return launch_buckets(quantize_regs<TIn, TCode, NORM, LOGP, decltype(t)::value, decltype(e)::value>,
                          a.nb, a.threads, 0, a.s, (const TIn*)a.v, a.u, a.levels,
                          (TCode*)a.codes, a.norms, a.L);
  });
}

template <typename TIn, typename TCode, int NORM>
static int run_any(const QuantizeArgs& a) {
  auto k = &quantize_any<TIn, TCode, NORM, false>;
  if (a.layout == kSmem) k = &quantize_any<TIn, TCode, NORM, true>;
  return launch_buckets(k, a.nb, a.threads, a.smem, a.s, (const TIn*)a.v, a.u,
                        a.levels, (TCode*)a.codes, a.norms, a.bs, a.L);
}

// Picks the code type and, for registers, the smallest search table that
// holds levels 0..L-2.
template <typename TIn, int NORM>
static int run_codes(int code_type, const QuantizeArgs& a) {
  if (a.layout != kRegs)
    return code_type == kI8 ? run_any<TIn, int8_t, NORM>(a) : run_any<TIn, int16_t, NORM>(a);
  if (code_type == kI16) return run_regs<TIn, int16_t, NORM, 8>(a);
  if (a.L - 1 <= 8) return run_regs<TIn, int8_t, NORM, 3>(a);
  if (a.L - 1 <= 16) return run_regs<TIn, int8_t, NORM, 4>(a);
  return run_regs<TIn, int8_t, NORM, 8>(a);
}

template <typename TIn>
static int run_norm(int code_type, int norm_type, const QuantizeArgs& a) {
  if (a.layout == kRegs && !regs_fit<TIn>(a.bs, a.threads, a.ept, {a.v, a.u, a.codes}))
    return (int)cudaErrorInvalidValue;
  if (a.layout == kSmem && a.smem < a.bs * (int)sizeof(TIn) + 16) return (int)cudaErrorInvalidValue;
  return norm_type == kNormL2 ? run_codes<TIn, kNormL2>(code_type, a)
                              : run_codes<TIn, kNormLinf>(code_type, a);
}

}  // namespace repro

// Returns the CUDA error of the launch (0 when it was accepted).  The launch
// shape (layout, threads, ept, smem) comes from
// repro_torch/kernels/cuda.py::bucket_launch.
extern "C" int repro_quantize(const void* v, const float* u, const float* levels, void* codes,
                              float* norms, long long nb, int bs, int L, int in_type,
                              int code_type, int norm_type, int layout, int threads, int ept,
                              int smem, void* stream) {
  using namespace repro;
  if (nb <= 0) return 0;
  if (nb > kMaxBuckets || L < 2 || L > kMaxLevels || (in_type != kF32 && in_type != kBF16) ||
      (code_type != kI8 && code_type != kI16) || (code_type == kI8 && L > 128) ||
      (norm_type != kNormL2 && norm_type != kNormLinf) ||
      (layout != kRegs && layout != kSmem && layout != kStream))
    return (int)cudaErrorInvalidValue;
  const QuantizeArgs a{v,      u,       levels, codes, norms, nb,
                       bs,     L,       layout, threads, ept, smem, (cudaStream_t)stream};
  return in_type == kF32 ? run_norm<float>(code_type, norm_type, a)
                         : run_norm<__nv_bfloat16>(code_type, norm_type, a);
}
