// Shared pieces of the two kernels that read whole buckets, quantize and
// bucket_stats: the layouts a launch may give a bucket, 16-byte vector loads,
// staging a bucket in shared memory with one bulk async copy, the bucket
// norm, and the launch.
#pragma once

#include <climits>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace repro {

// Layout codes shared with the Python wrappers (repro_torch/kernels/cuda.py).
//   kRegs:   each thread keeps EPT elements of the bucket in registers,
//            loaded as 16-byte vectors; every element is read once.
//   kSmem:   the bucket is staged in dynamic shared memory (one bulk async
//            copy plus the unaligned ends); every element is read once.
//   kStream: a bucket too large for shared memory is read twice, once for
//            its norm and once for the rest.
enum Layout { kRegs = 0, kSmem = 1, kStream = 2 };

// Elements of TIn in one 16-byte vector.
template <typename TIn>
__host__ __device__ constexpr int vec_of() { return 16 / (int)sizeof(TIn); }

// Calls f(threads, ept) as compile-time constants for each register-resident
// shape (threads, elements a thread) the kernels are compiled for;
// repro_torch/kernels/cuda.py's REG_SHAPES names the same shapes.
template <typename F>
static int with_reg_shape(int threads, int ept, F&& f) {
  using std::integral_constant;
  if (threads == 128 && ept == 8) return f(integral_constant<int, 128>{}, integral_constant<int, 8>{});
  if (threads == 512 && ept == 16)
    return f(integral_constant<int, 512>{}, integral_constant<int, 16>{});
  return (int)cudaErrorInvalidValue;
}

// Whether buckets of bs elements can be held in registers as threads x ept
// elements of whole 16-byte vectors, with every pointer 16-byte aligned.
template <typename TIn>
static bool regs_fit(int bs, int threads, int ept, std::initializer_list<const void*> ptrs) {
  if (ept % vec_of<TIn>() != 0 || (long long)threads * ept != bs) return false;
  for (const void* p : ptrs)
    if ((uintptr_t)p & 15u) return false;
  return true;
}

// Loads the 16-byte vector at p (16-byte aligned) as floats.
__device__ __forceinline__ void load16(const float* p, float* x) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* x) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  // a bf16 is the top half of the float it widens to exactly
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The same for data read once and not again soon (evict-first).
__device__ __forceinline__ void load16_stream(const float* p, float* x) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
}

// One element's share of the bucket norm: a sum of squares or a max.
template <int NORM>
__device__ __forceinline__ float norm_step(float acc, float x) {
  return NORM == kNormL2 ? acc + x * x : fmaxf(acc, fabsf(x));
}

// The bucket's norm, in every thread, from each thread's share.
template <int NORM>
__device__ __forceinline__ float norm_of(float acc, float* scratch) {
  if (NORM == kNormL2) return sqrtf(block_reduce(acc, scratch, SumOp()));
  return block_reduce(acc, scratch, MaxOp());
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A shared-memory barrier with one arrival a phase; thread 0 initialises it
// before the block's first __syncthreads.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(1)
               : "memory");
  // make the initialised barrier visible to the bulk copy unit
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Waits until the barrier's first phase has completed.  A copy that has not
// landed after 2^26 polls (each of which may itself wait) is a fault: the
// kernel traps rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(0)
        : "memory");
  }
}

// Copies bucket g[0, bs) into the dynamic shared memory `dyn` (at least
// bs * sizeof(TIn) + 16 bytes, 16-byte aligned) and returns where element 0
// landed.  The whole 16-byte vectors between the bucket's unaligned ends go
// by one bulk async copy (TMA) that completes the first phase of `bar`; the
// ends, under 16 bytes each, are copied by the threads.  Called once a block;
// synchronises the block.
template <typename TIn>
__device__ __forceinline__ const TIn* stage_bucket(const TIn* g, int bs, unsigned char* dyn,
                                                   uint64_t* bar) {
  constexpr int A = vec_of<TIn>();
  const int head = min(bs, (int)(((16u - ((uint32_t)(uintptr_t)g & 15u)) & 15u) / sizeof(TIn)));
  const int body = (bs - head) / A * A;
  // s + head is 16-byte aligned, as the bulk copy's destination must be
  TIn* s = reinterpret_cast<TIn*>(dyn) + (A - head) % A;
  if (threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)body * sizeof(TIn);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
    if (body > 0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];" ::"r"(smem_addr(s + head)),
          "l"((unsigned long long)(uintptr_t)(g + head)), "r"(bytes), "r"(smem_addr(bar))
          : "memory");
  }
  for (int i = threadIdx.x; i < head; i += blockDim.x) s[i] = g[i];
  for (int i = head + body + threadIdx.x; i < bs; i += blockDim.x) s[i] = g[i];
  __syncthreads();
  mbar_wait(bar);
  return s;
}

// The most buckets a launch takes: one block a bucket, and a grid has at most
// 2^31 - 1 blocks.
constexpr long long kMaxBuckets = INT_MAX;

// Launches `kernel` over nb buckets (1 <= nb <= kMaxBuckets) on stream `s`,
// block b on bucket b, and returns the CUDA error of the launch (0 when it
// was accepted).  (A persistent grid of as many blocks as the card holds at
// once, each walking buckets, measured no faster on the H100.)
template <typename... P, typename... A>
static int launch_buckets(void (*kernel)(P...), long long nb, int threads, int smem,
                          cudaStream_t s, A... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)nb, threads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace repro
