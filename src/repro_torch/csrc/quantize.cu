// Fused bucket norm + normalize + stochastic round: the encode kernel of the
// quantized all-gather, run once per worker on every step.
//
// Replaces repro/kernels/quantize.py::quantize_pallas (_quantize_kernel).
// The TPU kernel found each level index by a broadcast compare and looked the
// two neighbouring levels up by one-hot contractions; here the <= 256 levels
// sit in shared memory and each element does a binary search over them.
//
// Bound on the H100: device memory.  Every element reads its value (4 B f32 or
// 2 B bf16) and its uniform (4 B) and writes one code (1 B int8, 2 B int16):
// 9 B an element in f32 with int8 codes, against a few dozen arithmetic
// operations.  One block handles one bucket: a block reduction gives the norm,
// then a second sweep (which re-reads the bucket, mostly from L2) writes the
// codes.  The uniforms stay an explicit input so that the kernel is a pure
// function of its inputs, like the TPU kernel.
#include "common.cuh"

namespace repro {

template <typename TIn, typename TCode, int NORM>
__global__ void quantize_kernel(const TIn* __restrict__ v, const float* __restrict__ u,
                                const float* __restrict__ levels, TCode* __restrict__ codes,
                                float* __restrict__ norms, int bs, int L) {
  __shared__ float lv[kMaxLevels];
  __shared__ float scratch[32];
  const int64_t base = (int64_t)blockIdx.x * bs;
  const TIn* vb = v + base;
  const float* ub = u + base;
  TCode* cb = codes + base;
  for (int j = threadIdx.x; j < L; j += blockDim.x) lv[j] = levels[j];
  // bucket_norm synchronises the block, which also publishes lv
  const float norm = bucket_norm<NORM>(vb, bs, scratch);
  if (threadIdx.x == 0) norms[blockIdx.x] = norm;
  const float safe = norm > 0.f ? norm : 1.f;
  for (int i = threadIdx.x; i < bs; i += blockDim.x) {
    const float x = to_f32(vb[i]);
    const float r = fminf(fmaxf(fabsf(x) / safe, 0.f), 1.f);
    // tau = #(levels <= r) - 1: an upper-bound search over the sorted table
    int lo = 0, hi = L;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (lv[mid] <= r) lo = mid + 1;
      else hi = mid;
    }
    const int tau = min(max(lo - 1, 0), L - 2);
    const float a = lv[tau], c = lv[tau + 1];
    const float rho = (r - a) / fmaxf(c - a, 1e-30f);
    const int idx = tau + (ub[i] < rho ? 1 : 0);
    const int sign = (x > 0.f) - (x < 0.f);
    cb[i] = (TCode)(idx * sign);
  }
}

template <typename TIn, typename TCode>
static void launch_norm(int norm_type, dim3 grid, dim3 block, cudaStream_t s, const void* v,
                        const float* u, const float* levels, void* codes, float* norms, int bs,
                        int L) {
  if (norm_type == kNormL2)
    quantize_kernel<TIn, TCode, kNormL2><<<grid, block, 0, s>>>(
        (const TIn*)v, u, levels, (TCode*)codes, norms, bs, L);
  else
    quantize_kernel<TIn, TCode, kNormLinf><<<grid, block, 0, s>>>(
        (const TIn*)v, u, levels, (TCode*)codes, norms, bs, L);
}

template <typename TIn>
static void launch_code(int code_type, int norm_type, dim3 grid, dim3 block, cudaStream_t s,
                        const void* v, const float* u, const float* levels, void* codes,
                        float* norms, int bs, int L) {
  if (code_type == kI8)
    launch_norm<TIn, int8_t>(norm_type, grid, block, s, v, u, levels, codes, norms, bs, L);
  else
    launch_norm<TIn, int16_t>(norm_type, grid, block, s, v, u, levels, codes, norms, bs, L);
}

}  // namespace repro

// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int repro_quantize(const void* v, const float* u, const float* levels, void* codes,
                              float* norms, long long nb, int bs, int L, int in_type,
                              int code_type, int norm_type, int threads, void* stream) {
  using namespace repro;
  if (nb <= 0) return 0;
  if (L < 2 || L > kMaxLevels || (in_type != kF32 && in_type != kBF16) ||
      (code_type != kI8 && code_type != kI16) || (norm_type != kNormL2 && norm_type != kNormLinf))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nb), block((unsigned)threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (in_type == kF32)
    launch_code<float>(code_type, norm_type, grid, block, s, v, u, levels, codes, norms, bs, L);
  else
    launch_code<__nv_bfloat16>(code_type, norm_type, grid, block, s, v, u, levels, codes, norms,
                               bs, L);
  return (int)cudaGetLastError();
}
