// Decode of signed level indices: out = levels[|c|] * sign(c) * norm[bucket].
// Run once a step over every worker's gathered stream at once.
//
// Replaces repro/kernels/dequantize.py::dequantize_pallas (_dequantize_kernel).
// The TPU kernel looked levels up by a one-hot contraction; here the level
// table sits in shared memory and each element gathers from it.
//
// Bound on the H100: device memory.  Each element reads one code (1 B int8,
// 2 B int16 or 4 B int32) and writes one f32 value; the norm is read once a
// bucket.  One block walks one bucket row, so the norm is a single load and no
// element needs a 64-bit division to find its bucket.  The product is taken in
// the same order as the plain version, (level * sign) * norm, so the two agree
// bit for bit.
#include "common.cuh"

namespace repro {

template <typename TCode>
__global__ void dequantize_kernel(const TCode* __restrict__ codes, const float* __restrict__ norms,
                                  const float* __restrict__ levels, float* __restrict__ out,
                                  int bs, int L) {
  __shared__ float lv[kMaxLevels];
  for (int j = threadIdx.x; j < L; j += blockDim.x) lv[j] = levels[j];
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * bs;
  const float norm = norms[blockIdx.x];
  for (int i = threadIdx.x; i < bs; i += blockDim.x) {
    const int c = (int)codes[base + i];
    // a code outside the table (a corrupt symbol) decodes to 0, as the
    // TPU kernel's one-hot lookup gives
    const int a = abs(c);
    const float mag = a < L ? lv[a] : 0.0f;
    const float sign = (float)((c > 0) - (c < 0));
    out[base + i] = mag * sign * norm;
  }
}

}  // namespace repro

// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int repro_dequantize(const void* codes, const float* norms, const float* levels,
                                float* out, long long nb, int bs, int L, int code_type,
                                int threads, void* stream) {
  using namespace repro;
  if (nb <= 0) return 0;
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nb), block((unsigned)threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (code_type == kI8)
    dequantize_kernel<int8_t><<<grid, block, 0, s>>>((const int8_t*)codes, norms, levels, out, bs, L);
  else if (code_type == kI16)
    dequantize_kernel<int16_t><<<grid, block, 0, s>>>((const int16_t*)codes, norms, levels, out, bs,
                                                      L);
  else if (code_type == kI32)
    dequantize_kernel<int32_t><<<grid, block, 0, s>>>((const int32_t*)codes, norms, levels, out, bs,
                                                      L);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
