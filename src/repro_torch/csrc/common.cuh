// Shared helpers of the bucket kernels: input conversion and block reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Codes shared with the Python wrappers (repro_torch/kernels/cuda.py).
enum NormType { kNormL2 = 0, kNormLinf = 1 };
enum InType { kF32 = 0, kBF16 = 1 };
enum CodeType { kI8 = 0, kI16 = 1, kI32 = 2 };

// Level tables hold at most 256 entries (8-bit grids).
constexpr int kMaxLevels = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct SumOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};
struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// Reduces `x` over the whole block and returns the result in every thread.
// The identity of both ops on the values reduced here (sums, and maxima of
// magnitudes) is 0.  blockDim.x must be a multiple of 32; `scratch` holds 32
// floats and may be reused by the next call.
template <typename Op>
__device__ __forceinline__ float block_reduce(float x, float* scratch, Op op) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = op(x, __shfl_xor_sync(0xffffffffu, x, o));
  __syncthreads();  // a previous call may still be reading scratch
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  x = lane < nwarps ? scratch[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = op(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

}  // namespace repro
