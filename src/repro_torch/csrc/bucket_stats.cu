// Per-bucket sufficient statistics: the norm, mean(r) and
// max(mean(r^2) - mean(r)^2, 0) with r = |v| / norm.  Run on level-update
// steps, once per worker, ahead of the mixture fit.
//
// Replaces repro/kernels/bucket_stats.py::bucket_stats_pallas
// (_bucket_stats_kernel).
//
// Bound on the H100: device memory.  Each element is read once (4 B f32, 2 B
// bf16) and the kernel writes three floats a bucket; the arithmetic (one IEEE
// division and three adds an element) is far below the byte bound.
//
// Design: each element of v is read from device memory once.  At the bucket
// sizes the repo runs (1024 and 8192) a block holds the whole bucket in
// registers, loaded as back-to-back 16-byte vectors (stats_regs); any other
// size, or a pointer or row that is not 16-byte aligned, stages the bucket in
// shared memory by one bulk async copy, and only a bucket larger than shared
// memory is read twice (stats_any).  The norm is reduced first; then r is
// formed exactly as in the plain version, |v| / norm, and the sums of r and
// r^2 share one block reduction.  One block a bucket (block b on bucket b, up
// to 2^31 - 1 buckets), with 64-bit offsets.
#include "bucket.cuh"

namespace repro {

// Sums (a, b) over the block; the result is valid in thread 0.  `scratch`
// holds 64 floats.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  __syncthreads();  // a previous call may still be reading scratch
  if (lane == 0) {
    scratch[warp] = a;
    scratch[32 + warp] = b;
  }
  __syncthreads();
  a = lane < nwarps ? scratch[lane] : 0.f;
  b = lane < nwarps ? scratch[32 + lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  return make_float2(a, b);
}

__device__ __forceinline__ void write_stats(int64_t b, float norm, float2 s, int bs,
                                            float* norms, float* mu, float* var) {
  const float m = s.x / (float)bs;
  norms[b] = norm;
  mu[b] = m;
  var[b] = fmaxf(s.y / (float)bs - m * m, 0.f);
}

// Buckets of THREADS * EPT elements, held in registers; v is 16-byte aligned.
template <typename TIn, int NORM, int THREADS, int EPT>
__global__ void __launch_bounds__(THREADS)
    stats_regs(const TIn* __restrict__ v, float* __restrict__ norms, float* __restrict__ mu,
               float* __restrict__ var) {
  constexpr int VEC = vec_of<TIn>();
  constexpr int NV = EPT / VEC;
  static_assert(EPT % VEC == 0, "a thread holds whole vectors");
  __shared__ float scratch[64];
  const int64_t b = blockIdx.x;
  const int64_t base = b * (THREADS * EPT);
  float x[EPT];
#pragma unroll
  for (int k = 0; k < NV; ++k) load16(v + base + (k * THREADS + threadIdx.x) * VEC, x + k * VEC);
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < EPT; ++e) acc = norm_step<NORM>(acc, x[e]);
  const float norm = norm_of<NORM>(acc, scratch);
  const float safe = norm > 0.f ? norm : 1.f;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const float r = fabsf(x[e]) / safe;
    s1 += r;
    s2 += r * r;
  }
  const float2 s = block_sum2(s1, s2, scratch);
  if (threadIdx.x == 0) write_stats(b, norm, s, THREADS * EPT, norms, mu, var);
}

// Buckets of any size and alignment: staged in shared memory (STAGE), or
// read twice from device memory when they do not fit.
template <typename TIn, int NORM, bool STAGE>
__global__ void stats_any(const TIn* __restrict__ v, float* __restrict__ norms,
                          float* __restrict__ mu, float* __restrict__ var, int bs) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ float scratch[64];
  __shared__ uint64_t bar;
  if (STAGE && threadIdx.x == 0) mbar_init(&bar);
  __syncthreads();
  const int64_t b = blockIdx.x;
  const TIn* src = v + b * bs;
  if constexpr (STAGE) src = stage_bucket(src, bs, dyn, &bar);
  float acc = 0.f;
  for (int i = threadIdx.x; i < bs; i += blockDim.x) acc = norm_step<NORM>(acc, to_f32(src[i]));
  const float norm = norm_of<NORM>(acc, scratch);
  const float safe = norm > 0.f ? norm : 1.f;
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < bs; i += blockDim.x) {
    const float r = fabsf(to_f32(src[i])) / safe;
    s1 += r;
    s2 += r * r;
  }
  const float2 s = block_sum2(s1, s2, scratch);
  if (threadIdx.x == 0) write_stats(b, norm, s, bs, norms, mu, var);
}

struct StatsArgs {
  const void* v;
  float *norms, *mu, *var;
  long long nb;
  int bs, layout, threads, ept, smem;
  cudaStream_t s;
};

template <typename TIn, int NORM>
static int run(const StatsArgs& a) {
  if (a.layout == kRegs) {
    return with_reg_shape(a.threads, a.ept, [&](auto t, auto e) {
      return launch_buckets(stats_regs<TIn, NORM, decltype(t)::value, decltype(e)::value>, a.nb,
                            a.threads, 0, a.s, (const TIn*)a.v, a.norms, a.mu, a.var);
    });
  }
  auto k = &stats_any<TIn, NORM, false>;
  if (a.layout == kSmem) k = &stats_any<TIn, NORM, true>;
  return launch_buckets(k, a.nb, a.threads, a.smem, a.s, (const TIn*)a.v, a.norms, a.mu, a.var,
                        a.bs);
}

template <typename TIn>
static int run_norm(int norm_type, const StatsArgs& a) {
  if (a.layout == kRegs && !regs_fit<TIn>(a.bs, a.threads, a.ept, {a.v}))
    return (int)cudaErrorInvalidValue;
  if (a.layout == kSmem && a.smem < a.bs * (int)sizeof(TIn) + 16) return (int)cudaErrorInvalidValue;
  return norm_type == kNormL2 ? run<TIn, kNormL2>(a) : run<TIn, kNormLinf>(a);
}

}  // namespace repro

// Returns the CUDA error of the launch (0 when it was accepted).  The launch
// shape (layout, threads, ept, smem) comes from
// repro_torch/kernels/cuda.py::bucket_launch.
extern "C" int repro_bucket_stats(const void* v, float* norms, float* mu, float* var, long long nb,
                                  int bs, int in_type, int norm_type, int layout, int threads,
                                  int ept, int smem, void* stream) {
  using namespace repro;
  if (nb <= 0) return 0;
  if (nb > kMaxBuckets || (in_type != kF32 && in_type != kBF16) ||
      (norm_type != kNormL2 && norm_type != kNormLinf) ||
      (layout != kRegs && layout != kSmem && layout != kStream))
    return (int)cudaErrorInvalidValue;
  const StatsArgs a{v, norms, mu, var, nb, bs, layout, threads, ept, smem, (cudaStream_t)stream};
  return in_type == kF32 ? run_norm<float>(norm_type, a) : run_norm<__nv_bfloat16>(norm_type, a);
}
