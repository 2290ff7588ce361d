// Per-bucket sufficient statistics: the norm, mean(r) and
// max(mean(r^2) - mean(r)^2, 0) with r = |v| / norm.  Run on level-update
// steps, once per worker, ahead of the mixture fit.
//
// Replaces repro/kernels/bucket_stats.py::bucket_stats_pallas
// (_bucket_stats_kernel).
//
// Bound on the H100: device memory.  Each element reads its value once (4 B
// f32, 2 B bf16) and the kernel writes three floats a bucket.  One block
// handles one bucket: a block reduction gives the norm, then a second sweep
// (which re-reads the bucket, mostly from L2) sums r and r^2 with r formed
// exactly as in the plain version, |v| / norm.
#include "common.cuh"

namespace repro {

template <typename TIn, int NORM>
__global__ void bucket_stats_kernel(const TIn* __restrict__ v, float* __restrict__ norms,
                                    float* __restrict__ mu, float* __restrict__ var, int bs) {
  __shared__ float scratch[32];
  const TIn* vb = v + (int64_t)blockIdx.x * bs;
  const float norm = bucket_norm<NORM>(vb, bs, scratch);
  const float safe = norm > 0.f ? norm : 1.f;
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < bs; i += blockDim.x) {
    const float r = fabsf(to_f32(vb[i])) / safe;
    s1 += r;
    s2 += r * r;
  }
  s1 = block_reduce(s1, scratch, SumOp());
  s2 = block_reduce(s2, scratch, SumOp());
  if (threadIdx.x == 0) {
    const float m = s1 / (float)bs;
    norms[blockIdx.x] = norm;
    mu[blockIdx.x] = m;
    var[blockIdx.x] = fmaxf(s2 / (float)bs - m * m, 0.f);
  }
}

template <typename TIn>
static void launch_norm(int norm_type, dim3 grid, dim3 block, cudaStream_t s, const void* v,
                        float* norms, float* mu, float* var, int bs) {
  if (norm_type == kNormL2)
    bucket_stats_kernel<TIn, kNormL2><<<grid, block, 0, s>>>((const TIn*)v, norms, mu, var, bs);
  else
    bucket_stats_kernel<TIn, kNormLinf><<<grid, block, 0, s>>>((const TIn*)v, norms, mu, var, bs);
}

}  // namespace repro

// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int repro_bucket_stats(const void* v, float* norms, float* mu, float* var, long long nb,
                                  int bs, int in_type, int norm_type, int threads, void* stream) {
  using namespace repro;
  if (nb <= 0) return 0;
  if ((in_type != kF32 && in_type != kBF16) || (norm_type != kNormL2 && norm_type != kNormLinf))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nb), block((unsigned)threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (in_type == kF32) launch_norm<float>(norm_type, grid, block, s, v, norms, mu, var, bs);
  else launch_norm<__nv_bfloat16>(norm_type, grid, block, s, v, norms, mu, var, bs);
  return (int)cudaGetLastError();
}
