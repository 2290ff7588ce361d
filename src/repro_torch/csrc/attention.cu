// Causal self-attention on the bf16 tensor cores, forward and backward:
// full, sliding window and (folded into the batch) chunked, GQA through a
// map from each q head to its kv head.
//
// Replaces no TPU kernel: the reference computes attention outside any
// kernel, as a blockwise loop in plain jnp (repro/models/attention.py::
// _flash), and the port's plain version is the same loop in PyTorch
// (repro_torch/models/attention.py::_flash).  That loop upcasts q, k and v
// to float32, so on the card every score and every product ran on the CUDA
// cores at 67 TFLOP/s, with about ten elementwise passes over each
// (rows, 512, 512) float32 tile and an autograd graph that kept them: most
// of a qwen3 grad.  These kernels take their place on the card, for bf16
// and for float32 tensors.
//
// Bound on the H100: a call's least time is the larger of its FLOPs over
// 989 TFLOP/s (2 hd for every (query, key) pair the causal mask and the
// window admit, in each of the products attention needs: 2 forward, 4
// backward) and its own bytes over 3.35 TB/s (forward: q, k, v in, O and
// the log-sum-exp out; backward: q, k, v, dO, O and the log-sum-exp in,
// dq, dk, dv out).  At qwen3-0.6b's shape (8 x 1024 tokens, 16 heads of
// 128 over 8 kv heads) the FLOPs bound both: 0.035 ms forward, 0.070 ms
// backward (bytes 0.030 and 0.060).  The kernels themselves run far more
// products (below), so the tensor cores' rate is what they are designed
// around.
//
// Precision: the same work as the float32 loop, not less.  bf16 q, k, v
// and dO are exact in the tensor cores, and every product accumulates in
// float32.  Where the loop multiplies float32 operands -- P in P V and
// P^T dO, dS in dS K and dS^T Q, and every operand when q, k and v are
// float32 -- the operand enters as three bf16 terms (bf16(x), then bf16 of
// what is left, twice), which hold all 24 bits of x; a product of two such
// operands is the six term products that reach 2^-24 of it, smallest
// first.  The tensor cores truncate what they add to an accumulator, so a
// sum carried across many MMAs drifts: each 16 x 16 block of such a
// product is summed in fresh registers and added to the running float32
// sum once, rounded to nearest (two terms, or one accumulator for a whole
// row, left the result 2-4 times farther from float64 than the float32
// loop at S = 1024).  Scores, the running max, the softmax sums, exp2 and
// the divisions stay float32 in registers.  The backward's D = rowsum(dO
// * O) is taken with the float32 O that the forward writes beside a bf16
// output.
//
// Design: FlashAttention-2's structure with mma.sync m16n8k16 and ldmatrix.
// Blocks are four warps.  The forward and the dq kernel take a 64-row q
// tile of one (batch, q head), a warp its 16 rows, and stream 64-row k and
// v tiles through two shared-memory stages (cp.async); tiles wholly past
// the causal diagonal or outside the window are skipped and edge tiles are
// masked.  The forward's softmax is online in registers; it writes O in
// the inputs' type (and in float32 beside a bf16 O when a backward will
// follow) and each row's log-sum-exp, in base 2 of the scaled scores.  The
// backward never adds across blocks, so it needs no atomics and two passes
// give the same bits: the dq kernel recomputes P from the log-sum-exp,
// writes D for its rows and sums dS K over its kv tiles; then the dkv
// kernel takes a 64-row kv tile of one (batch, kv head), a warp its 16
// rows, and sums P^T dO and dS^T Q over every q head of its group and
// every 32-row q step that sees the tile, in a fixed order.  Shared rows
// are padded by 16 bytes, so each 8 x 8 ldmatrix reads eight rows from
// eight bank groups.  float32 tiles sit in shared memory as they are and
// are split into their bf16 terms as each fragment is loaded (plain loads,
// not ldmatrix).  The heaviest tiles (the last q tiles, the first kv
// tiles) are launched first.  The map of kv heads travels in the kernels'
// arguments (__grid_constant__, read from the constant bank), so a call
// allocates and copies nothing for it.
#include <math.h>

#include "common.cuh"

namespace repro {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // four warps
constexpr int kTile = 64;      // rows of a forward or dq block's q tile, of a
                               // dkv block's kv tile, and of streamed tiles
constexpr int kQStep = 32;     // q rows a dkv block takes a step
constexpr int kMaxHeads = 256;
constexpr int kTerms = 3;      // bf16 terms of a float32 MMA operand

// Elements of T that pad each shared row: 16 bytes.
template <typename T>
constexpr int kPad = 16 / sizeof(T);
// bf16 terms of an operand of T: a bf16 value is its own.
template <typename T>
constexpr int kTermsOf = sizeof(T) == 2 ? 1 : kTerms;

struct Args {
  const void* q;  // q, k, v and dout in the inputs' type
  const void* k;
  const void* v;
  int kv_map[kMaxHeads];  // q head -> kv head
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int B, S, H, KV, window;
  float scale;       // hd^-0.5 in float32
  float scale_log2;  // scale * log2(e)
  // forward
  void* o;
  float* o32;
  float* lse;
  // backward
  const float* lse_in;
  const float* o_in;  // O in float32 (o32, or O itself when the inputs are float32)
  const void* dout;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8, float32) += a (16 x 16, bf16) b (16 x 8, bf16).
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b over the bf16 terms of a (TA of them, term i in a[4 i..4 i + 3])
// and of b (TB, term j in b[4 j] and b[4 j + 1]): the products of terms (i,
// j) with i + j < kTerms, smallest first.
template <int TA, int TB>
__device__ __forceinline__ void mma_terms(float c[4], const uint32_t* a, const uint32_t* b) {
#pragma unroll
  for (int s = kTerms - 1; s >= 0; --s)
#pragma unroll
    for (int i = 0; i <= s; ++i)
      if (i < TA && s - i < TB) mma(c, a + 4 * i, b[4 * (s - i)], b[4 * (s - i) + 1]);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// The bf16 terms of the float32 pair (x, y): t[0] = bf16(.), t[4] =
// bf16(. - t[0]), t[8] = bf16(. - t[0] - t[4]).  Each difference is exact
// in float32, and the three terms hold all 24 bits of a float32 value.
__device__ __forceinline__ void split(float x, float y, uint32_t* t) {
#pragma unroll
  for (int i = 0; i < kTerms; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 hf = __bfloat1622float2(h);
    t[4 * i] = as_u32(h);
    x = __fsub_rn(x, hf.x);
    y = __fsub_rn(y, hf.y);
  }
}

__device__ __forceinline__ void split2(const float* p, uint32_t* t) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  split(x.x, x.y, t);
}

// The A operand of an m16n8k16 MMA (rows of P or dS, keys as columns) from
// two neighbouring 16 x 8 accumulators, columns 0-7 in c0 and 8-15 in c1,
// as kTerms bf16 operands: a[4 * i + j] is register j of term i.
__device__ __forceinline__ void split_a(const float c0[4], const float c1[4],
                                        uint32_t a[4 * kTerms]) {
  split(c0[0], c0[1], a);
  split(c0[2], c0[3], a + 1);
  split(c1[0], c1[1], a + 2);
  split(c1[2], c1[3], a + 3);
}

// Copies a tile of R rows of HD elements of T (rows `stride` elements apart
// from `g`) into padded shared rows; rows from `valid` on are zero-filled.
// `g` must point into the tensor even when no row is valid.
template <int HD, int R, typename T>
__device__ __forceinline__ void load_tile(T* sm, const T* g, long long stride, int valid) {
  constexpr int kPer = 16 / sizeof(T);  // elements of a 16-byte piece
  constexpr int kChunks = HD / kPer;    // pieces of a row
#pragma unroll
  for (int it = 0; it < (R * kChunks + kThreads - 1) / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if ((R * kChunks) % kThreads != 0 && i >= R * kChunks) break;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < valid;
    cp_async16(sm + r * (HD + kPad<T>) + c * kPer, ok ? g + r * stride + c * kPer : g, ok);
  }
}

// Operand fragments from shared tiles, as kTermsOf<T> bf16 terms (term i
// in registers 4 i..4 i + 3).  A: rows r0..r0+15, columns c0..c0+15 of a
// row-major tile.
template <int LD>
__device__ __forceinline__ void ld_a(uint32_t a[4], const bf16* sm, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, sm + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}

template <int LD>
__device__ __forceinline__ void ld_a(uint32_t a[4 * kTerms], const float* sm, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  const float* p = sm + (r0 + (lane >> 2)) * LD + c0 + (lane & 3) * 2;
  split2(p, a);
  split2(p + 8 * LD, a + 1);
  split2(p + 8, a + 2);
  split2(p + 8 * LD + 8, a + 3);
}

// B operands of the two n-tiles n0.. and n0+8.. where B[k][n] = tile[n][k]
// (rows n0..n0+15, columns k0..k0+15): registers 0, 1 of a term for the
// first, 2, 3 for the second.
template <int LD>
__device__ __forceinline__ void ld_b_nk(uint32_t b[4], const bf16* sm, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, sm + (n0 + ((lane >> 4) << 3) + (lane & 7)) * LD + k0 + ((lane >> 3) & 1) * 8);
}

template <int LD>
__device__ __forceinline__ void ld_b_nk(uint32_t b[4 * kTerms], const float* sm, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const float* p = sm + (n0 + (lane >> 2)) * LD + k0 + (lane & 3) * 2;
  split2(p, b);
  split2(p + 8, b + 1);
  split2(p + 8 * LD, b + 2);
  split2(p + 8 * LD + 8, b + 3);
}

// The same where B[k][n] = tile[k][n] (rows k0..k0+15, columns n0..n0+15).
template <int LD>
__device__ __forceinline__ void ld_b_kn(uint32_t b[4], const bf16* sm, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, sm + (k0 + (((lane >> 3) & 1) << 3) + (lane & 7)) * LD + n0 + (lane >> 4) * 8);
}

template <int LD>
__device__ __forceinline__ void ld_b_kn(uint32_t b[4 * kTerms], const float* sm, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const float* p = sm + (k0 + (lane & 3) * 2) * LD + n0 + (lane >> 2);
  split(p[0], p[LD], b);
  split(p[8 * LD], p[9 * LD], b + 1);
  split(p[8], p[LD + 8], b + 2);
  split(p[8 * LD + 8], p[9 * LD + 8], b + 3);
}

// acc (16 x HD) = acc * corr + C (16 x 16 KK, float32, in the 2 KK
// accumulators of c) tile[0..16 KK - 1][:], corr0 on the rows of c[.][0..1]
// and corr1 on those of c[.][2..3]; C enters as kTerms bf16 operands.  The
// tensor cores truncate what they add to an accumulator, so a sum carried
// in one across many MMAs drifts towards 0 by about half an ulp an MMA:
// each 16 x 16 block of the product (its term products, smallest first)
// is summed in fresh registers and added to the tile's sum, and that to
// acc, rounded to nearest.
template <int HD, int KK, typename T>
__device__ __forceinline__ void mma_rows(float acc[][4], const float c[][4], const T* tile,
                                         float corr0, float corr1) {
  constexpr int TB = kTermsOf<T>;
  uint32_t a[KK][4 * kTerms];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) split_a(c[2 * kk], c[2 * kk + 1], a[kk]);
#pragma unroll
  for (int dp = 0; dp < HD / 16; ++dp) {
    float t[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t b[4 * TB];
      ld_b_kn<HD + kPad<T>>(b, tile, kk * 16, dp * 16);
      float u[2][4] = {};
      mma_terms<kTerms, TB>(u[0], a[kk], b);
      mma_terms<kTerms, TB>(u[1], a[kk], b + 2);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[h][e] = __fadd_rn(t[h][e], u[h][e]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* o = acc[2 * dp + h];
      o[0] = fmaf(o[0], corr0, t[h][0]);
      o[1] = fmaf(o[1], corr0, t[h][1]);
      o[2] = fmaf(o[2], corr1, t[h][2]);
      o[3] = fmaf(o[3], corr1, t[h][3]);
    }
  }
}

// s (16 x 8 NT tiles) = A (rows r0.. of ta) B^T (rows 0.. of tb), over HD.
// bf16 operands are exact, so their products share one accumulator;
// float32 ones (three terms each) are summed a 16-column block at a time
// in fresh registers, as in mma_rows.
template <int HD, int NT, typename T>
__device__ __forceinline__ void mma_nt(float s[][4], const T* ta, int r0, const T* tb) {
  constexpr int TT = kTermsOf<T>;
  constexpr int LD = HD + kPad<T>;
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4 * TT];
    ld_a<LD>(a, ta, r0, kk * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4 * TT];
      ld_b_nk<LD>(b, tb, np * 16, kk * 16);
      if constexpr (TT == 1) {
        mma(s[2 * np], a, b[0], b[1]);
        mma(s[2 * np + 1], a, b[2], b[3]);
      } else {
        float u[2][4] = {};
        mma_terms<TT, TT>(u[0], a, b);
        mma_terms<TT, TT>(u[1], a, b + 2);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[2 * np + h][e] = __fadd_rn(s[2 * np + h][e], u[h][e]);
      }
    }
  }
}

__device__ __forceinline__ bool visible(int qi, int ki, int window) {
  return ki <= qi && (window <= 0 || ki > qi - window);
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// The kv tiles that a q tile from q0 sees: [*lo, *hi].
__device__ __forceinline__ void kv_range(int q0, int S, int window, int* lo, int* hi) {
  *hi = (min(q0 + kTile, S) - 1) / kTile;
  *lo = window > 0 ? max(q0 - window + 1, 0) / kTile : 0;
}

// One block: 64 q rows of one (batch, q head).
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) attn_fwd(const __grid_constant__ Args a) {
  constexpr int LD = HD + kPad<T>;
  constexpr int DN = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kTile * LD;      // two stages
  T* sV = sK + 2 * kTile * LD;  // two stages

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int S = a.S, H = a.H, window = a.window;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int kvh = a.kv_map[h];
  const T* gq = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* gk = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* gv = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  int j_lo, j_hi;
  kv_range(q0, S, window, &j_lo, &j_hi);

  load_tile<HD, kTile>(sQ, gq + q0 * a.q_ss, a.q_ss, S - q0);
  load_tile<HD, kTile>(sK, gk + j_lo * kTile * a.k_ss, a.k_ss, S - j_lo * kTile);
  load_tile<HD, kTile>(sV, gv + j_lo * kTile * a.v_ss, a.v_ss, S - j_lo * kTile);
  cp_async_commit();

  float o[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float ms[2] = {-INFINITY, -INFINITY};  // running max, scaled to base 2
  float l[2] = {0.f, 0.f};               // this thread's part of the row sums
  const int row0 = q0 + warp * 16 + g;   // rows row0 and row0 + 8

  for (int j = j_lo; j <= j_hi; ++j) {
    const int st = (j - j_lo) & 1;
    if (j < j_hi) {
      const int n0 = (j + 1) * kTile;
      load_tile<HD, kTile>(sK + (st ^ 1) * kTile * LD, gk + n0 * a.k_ss, a.k_ss, S - n0);
      load_tile<HD, kTile>(sV + (st ^ 1) * kTile * LD, gv + n0 * a.v_ss, a.v_ss, S - n0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tk = sK + st * kTile * LD;
    const T* tv = sV + st * kTile * LD;

    float s[8][4];
    mma_nt<HD, 8>(s, sQ, warp * 16, tk);
    const int k0 = j * kTile;
    if (k0 + kTile - 1 > q0 || (window > 0 && k0 <= q0 + kTile - 1 - window)) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(row0 + (e >> 1) * 8, k0 + n * 8 + t * 2 + (e & 1), window))
            s[n][e] = -INFINITY;
    }

    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      const float m_new = fmaxf(ms[r], quad_max(mx) * a.scale_log2);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = exp2f(ms[r] - base);
      ms[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(fmaf(s[n][2 * r + e], a.scale_log2, -base));
          s[n][2 * r + e] = p;
          sum += p;
        }
      l[r] = l[r] * corr[r] + sum;
    }
    mma_rows<HD, 4>(o, s, tv, corr[0], corr[1]);
    __syncthreads();  // the stage is refilled next
  }

  T* out = static_cast<T*>(a.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    const float den = fmaxf(quad_sum(l[r]), 1e-30f);
    if (row >= S) continue;
    const long long at = ((static_cast<long long>(b) * S + row) * H + h) * HD + t * 2;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      const float x = o[n][2 * r] / den, y = o[n][2 * r + 1] / den;
      store2(out + at + n * 8, x, y);
      if (a.o32 != nullptr) store2(a.o32 + at + n * 8, x, y);
    }
    if (t == 0)
      a.lse[(static_cast<long long>(b) * H + h) * S + row] =
          (ms[r] == -INFINITY ? 0.f : ms[r]) + log2f(den);
  }
}

// One block: dQ of 64 q rows of one (batch, q head), and D of those rows.
template <int HD, typename T, typename OutT>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq(const __grid_constant__ Args a) {
  constexpr int LD = HD + kPad<T>;
  constexpr int DN = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sO = sQ + kTile * LD;      // dO
  T* sK = sO + kTile * LD;      // two stages
  T* sV = sK + 2 * kTile * LD;  // two stages

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int S = a.S, H = a.H, window = a.window;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int kvh = a.kv_map[h];
  const long long row_stride = static_cast<long long>(H) * HD;  // of dO, O and dQ
  const long long bh0 = (static_cast<long long>(b) * S) * H + h;
  const T* dout = static_cast<const T*>(a.dout);
  const T* gk = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* gv = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  int j_lo, j_hi;
  kv_range(q0, S, window, &j_lo, &j_hi);

  load_tile<HD, kTile>(sQ, static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + q0 * a.q_ss,
                       a.q_ss, S - q0);
  load_tile<HD, kTile>(sO, dout + (bh0 + static_cast<long long>(q0) * H) * HD, row_stride, S - q0);
  load_tile<HD, kTile>(sK, gk + j_lo * kTile * a.k_ss, a.k_ss, S - j_lo * kTile);
  load_tile<HD, kTile>(sV, gv + j_lo * kTile * a.v_ss, a.v_ss, S - j_lo * kTile);
  cp_async_commit();

  // D = rowsum(dO * O) with the float32 O, and the log-sum-exp, of rows
  // row0 and row0 + 8; D goes to `delta` for the dkv kernel.
  const int row0 = q0 + warp * 16 + g;
  float dl[2] = {0.f, 0.f}, lse[2];
  for (int i = 0; i < 16; ++i) {
    const int row = q0 + warp * 16 + i;
    float sum = 0.f;
    if (row < S) {
      const long long at = (bh0 + static_cast<long long>(row) * H) * HD;
#pragma unroll
      for (int d = lane; d < HD; d += 32) sum = fmaf(to_f32(dout[at + d]), a.o_in[at + d], sum);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (i == g) dl[0] = sum;
    if (i == g + 8) dl[1] = sum;
    if (lane == 0 && row < S) a.delta[(static_cast<long long>(b) * H + h) * S + row] = sum;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    lse[r] = row0 + r * 8 < S ? a.lse_in[(static_cast<long long>(b) * H + h) * S + row0 + r * 8]
                              : INFINITY;

  float dq[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int st = (j - j_lo) & 1;
    if (j < j_hi) {
      const int n0 = (j + 1) * kTile;
      load_tile<HD, kTile>(sK + (st ^ 1) * kTile * LD, gk + n0 * a.k_ss, a.k_ss, S - n0);
      load_tile<HD, kTile>(sV + (st ^ 1) * kTile * LD, gv + n0 * a.v_ss, a.v_ss, S - n0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tk = sK + st * kTile * LD;
    const T* tv = sV + st * kTile * LD;

    float s[8][4], dp[8][4];
    mma_nt<HD, 8>(s, sQ, warp * 16, tk);
    const int k0 = j * kTile;
    const bool edge = k0 + kTile - 1 > q0 || (window > 0 && k0 <= q0 + kTile - 1 - window);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool vis = !edge || visible(row0 + (e >> 1) * 8, k0 + n * 8 + t * 2 + (e & 1), window);
        s[n][e] = vis ? exp2f(fmaf(s[n][e], a.scale_log2, -lse[e >> 1])) : 0.f;
      }
    mma_nt<HD, 8>(dp, sO, warp * 16, tv);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= dp[n][e] - dl[e >> 1];
    mma_rows<HD, 4>(dq, s, tk, 1.f, 1.f);
    __syncthreads();  // the stage is refilled next
  }

  OutT* out = static_cast<OutT*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= S) continue;
    const long long at = (bh0 + static_cast<long long>(row) * H) * HD + t * 2;
#pragma unroll
    for (int n = 0; n < DN; ++n)
      store2(out + at + n * 8, dq[n][2 * r] * a.scale, dq[n][2 * r + 1] * a.scale);
  }
}

// One block: dK and dV of 64 kv rows of one (batch, kv head), summed over
// the q heads of its group in head order and over 32-row q steps in order.
template <int HD, typename T, typename OutT>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkv(const __grid_constant__ Args a) {
  constexpr int LD = HD + kPad<T>;
  constexpr int DN = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kTile * LD;
  T* sQ = sV + kTile * LD;        // two stages of kQStep rows
  T* sO = sQ + 2 * kQStep * LD;   // dO, two stages
  float* sL = reinterpret_cast<float*>(sO + 2 * kQStep * LD);  // log-sum-exp, two stages
  float* sD = sL + 2 * kQStep;                                   // D, two stages
  __shared__ int heads[kMaxHeads];
  __shared__ int n_heads;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int S = a.S, H = a.H, KV = a.KV, window = a.window;
  const int kvh = blockIdx.x % KV, b = blockIdx.x / KV;
  const int k0 = blockIdx.y * kTile;
  if (threadIdx.x == 0) {
    int n = 0;
    for (int hh = 0; hh < H; ++hh)
      if (a.kv_map[hh] == kvh) heads[n++] = hh;
    n_heads = n;
  }
  const T* gq = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  const T* gk = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* gv = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  load_tile<HD, kTile>(sK, gk + k0 * a.k_ss, a.k_ss, S - k0);
  load_tile<HD, kTile>(sV, gv + k0 * a.v_ss, a.v_ss, S - k0);
  cp_async_commit();
  __syncthreads();  // heads

  // the q steps that see the tile, for each head of the group
  const int i_lo = k0 / kQStep;
  const int q_hi = window > 0 ? min(S - 1, min(k0 + kTile, S) - 1 + window - 1) : S - 1;
  const int n_i = q_hi / kQStep - i_lo + 1;
  const int steps = n_heads * n_i;
  const long long row_stride = static_cast<long long>(H) * HD;  // of dO

  auto load_step = [&](int step, int stage) {
    const int hh = heads[step / n_i];
    const int s0 = (i_lo + step % n_i) * kQStep;
    load_tile<HD, kQStep>(sQ + stage * kQStep * LD, gq + b * a.q_sb + hh * a.q_sh + s0 * a.q_ss,
                          a.q_ss, S - s0);
    load_tile<HD, kQStep>(sO + stage * kQStep * LD,
                          dout + ((static_cast<long long>(b) * S + s0) * H + hh) * HD,
                          row_stride, S - s0);
    if (threadIdx.x < 2 * kQStep) {
      const int r = threadIdx.x % kQStep;
      const bool ok = s0 + r < S;
      const float* src = threadIdx.x < kQStep ? a.lse_in : a.delta;
      float* dst = (threadIdx.x < kQStep ? sL : sD) + stage * kQStep + r;
      cp_async4(dst, src + (static_cast<long long>(b) * H + hh) * S + (ok ? s0 + r : 0), ok);
    }
  };
  if (steps > 0) load_step(0, 0);
  cp_async_commit();

  float dk[DN][4], dv[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }
  const int kv0 = k0 + warp * 16 + g;  // kv rows kv0 and kv0 + 8

  for (int step = 0; step < steps; ++step) {
    const int st = step & 1;
    if (step + 1 < steps) {
      load_step(step + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s0 = (i_lo + step % n_i) * kQStep;
    const T* tq = sQ + st * kQStep * LD;
    const T* to = sO + st * kQStep * LD;
    const float* tl = sL + st * kQStep;
    const float* td = sD + st * kQStep;

    // P^T and dP^T: 16 kv rows x 32 q columns a warp
    float s[4][4], dp[4][4];
    mma_nt<HD, 4>(s, sK, warp * 16, tq);
    const bool edge = k0 + kTile - 1 > s0 || s0 + kQStep > S ||
                      (window > 0 && s0 + kQStep - 1 >= k0 + window);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + t * 2 + (e & 1);
        const bool vis =
            !edge || (s0 + c < S && visible(s0 + c, kv0 + (e >> 1) * 8, window));
        s[n][e] = vis ? exp2f(fmaf(s[n][e], a.scale_log2, -tl[c])) : 0.f;
      }
    mma_nt<HD, 4>(dp, sV, warp * 16, to);
    mma_rows<HD, 2>(dv, s, to, 1.f, 1.f);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= dp[n][e] - td[n * 8 + t * 2 + (e & 1)];
    mma_rows<HD, 2>(dk, s, tq, 1.f, 1.f);
    __syncthreads();  // the stage is refilled next
  }

  OutT* gdk = static_cast<OutT*>(a.dk);
  OutT* gdv = static_cast<OutT*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kv0 + r * 8;
    if (row >= S) continue;
    const long long at = ((static_cast<long long>(b) * S + row) * KV + kvh) * HD + t * 2;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      store2(gdk + at + n * 8, dk[n][2 * r] * a.scale, dk[n][2 * r + 1] * a.scale);
      store2(gdv + at + n * 8, dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <int HD, typename T>
constexpr size_t fwd_smem() { return 5 * kTile * (HD + kPad<T>) * sizeof(T); }
template <int HD, typename T>
constexpr size_t dq_smem() { return 6 * kTile * (HD + kPad<T>) * sizeof(T); }
template <int HD, typename T>
constexpr size_t dkv_smem() {
  return (2 * kTile + 4 * kQStep) * (HD + kPad<T>) * sizeof(T) + 4 * kQStep * sizeof(float);
}

// Launches `kernel` with `smem` bytes of dynamic shared memory (above 48
// KB only once allowed) and returns the CUDA error of the launch.
template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, const Args& a) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int HD, typename T>
int fwd(const Args& a, cudaStream_t s) {
  return launch(attn_fwd<HD, T>, dim3(a.B * a.H, (a.S + kTile - 1) / kTile), fwd_smem<HD, T>(), s,
                a);
}

template <typename T>
int fwd_hd(const Args& a, int hd, cudaStream_t s) {
  if (hd == 16) return fwd<16, T>(a, s);
  if (hd == 32) return fwd<32, T>(a, s);
  if (hd == 64) return fwd<64, T>(a, s);
  if (hd == 128) return fwd<128, T>(a, s);
  return (int)cudaErrorInvalidValue;
}

template <int HD, typename T, typename OutT>
int bwd(const Args& a, bool dkv, cudaStream_t s) {
  const int tiles = (a.S + kTile - 1) / kTile;
  if (!dkv)
    return launch(attn_bwd_dq<HD, T, OutT>, dim3(a.B * a.H, tiles), dq_smem<HD, T>(), s, a);
  return launch(attn_bwd_dkv<HD, T, OutT>, dim3(a.B * a.KV, tiles), dkv_smem<HD, T>(), s, a);
}

template <typename T, typename OutT>
int bwd_hd(const Args& a, int hd, bool dkv, cudaStream_t s) {
  if (hd == 16) return bwd<16, T, OutT>(a, dkv, s);
  if (hd == 32) return bwd<32, T, OutT>(a, dkv, s);
  if (hd == 64) return bwd<64, T, OutT>(a, dkv, s);
  if (hd == 128) return bwd<128, T, OutT>(a, dkv, s);
  return (int)cudaErrorInvalidValue;
}

// The backward in the inputs' type (bf16 inputs may also give float32
// gradients, which the precision tests read before their last rounding).
int bwd_types(const Args& a, int hd, bool dkv, int in_type, int out_type, cudaStream_t s) {
  if (in_type == kBF16 && out_type == kBF16) return bwd_hd<bf16, bf16>(a, hd, dkv, s);
  if (in_type == kBF16 && out_type == kF32) return bwd_hd<bf16, float>(a, hd, dkv, s);
  if (in_type == kF32 && out_type == kF32) return bwd_hd<float, float>(a, hd, dkv, s);
  return (int)cudaErrorInvalidValue;
}

// The arguments every entry point shares; false where the kernels do not
// take them.
bool make_args(Args* a, const void* q, const void* k, const void* v, const int* kv_map,
               long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
               long long k_sh, long long v_sb, long long v_ss, long long v_sh, int B, int S,
               int H, int KV, int hd, int window) {
  if (B <= 0 || S <= 0 || H <= 0 || H > kMaxHeads || KV <= 0 ||
      (hd != 16 && hd != 32 && hd != 64 && hd != 128) || (long long)B * H > 0x7fffffffLL ||
      (S + kTile - 1) / kTile > 65535)
    return false;
  *a = Args{};
  for (int h = 0; h < H; ++h) {
    if (kv_map[h] < 0 || kv_map[h] >= KV) return false;
    a->kv_map[h] = kv_map[h];
  }
  a->q = q;
  a->k = k;
  a->v = v;
  a->q_sb = q_sb, a->q_ss = q_ss, a->q_sh = q_sh;
  a->k_sb = k_sb, a->k_ss = k_ss, a->k_sh = k_sh;
  a->v_sb = v_sb, a->v_ss = v_ss, a->v_sh = v_sh;
  a->B = B, a->S = S, a->H = H, a->KV = KV, a->window = window;
  a->scale = (float)(1.0 / sqrt((double)hd));
  a->scale_log2 = (float)(1.4426950408889634 / sqrt((double)hd));
  return true;
}

}  // namespace
}  // namespace repro

// q (B, S, H, hd) and k, v (B, S, KV, hd) in in_type (bf16 or float32), read
// by their strides (in elements; the head dim contiguous), kv_map (H,) int32
// in host memory, the kv head of each q head, which the kernels get by
// value -> o (B, S, H, hd) in in_type, o32 (the same in float32 beside a
// bf16 o; may be null) and lse (B, H, S) float32, in base 2 of the scaled
// scores.  Returns the CUDA error of the launch.
extern "C" int repro_attention_fwd(const void* q, const void* k, const void* v, const int* kv_map,
                                   void* o, float* o32, float* lse, long long q_sb, long long q_ss,
                                   long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh, int B, int S,
                                   int H, int KV, int hd, int window, int in_type, void* stream) {
  using namespace repro;
  Args a;
  if (!make_args(&a, q, k, v, kv_map, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, B, S,
                 H, KV, hd, window))
    return (int)cudaErrorInvalidValue;
  a.o = o;
  a.o32 = o32;
  a.lse = lse;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_type == kBF16) return fwd_hd<bf16>(a, hd, s);
  if (in_type == kF32) return fwd_hd<float>(a, hd, s);
  return (int)cudaErrorInvalidValue;
}

// The backward's first kernel: dq (B, S, H, hd, in out_type) and delta (B,
// H, S) float32 = rowsum(dout * o), from the forward's float32 o and its
// lse and the contiguous dout (B, S, H, hd) in in_type.
extern "C" int repro_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const int* kv_map, const float* o32, const float* lse,
                                      const void* dout, float* delta, void* dq, long long q_sb,
                                      long long q_ss, long long q_sh, long long k_sb,
                                      long long k_ss, long long k_sh, long long v_sb,
                                      long long v_ss, long long v_sh, int B, int S, int H, int KV,
                                      int hd, int window, int in_type, int out_type,
                                      void* stream) {
  using namespace repro;
  Args a;
  if (!make_args(&a, q, k, v, kv_map, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, B, S,
                 H, KV, hd, window))
    return (int)cudaErrorInvalidValue;
  a.o_in = o32;
  a.lse_in = lse;
  a.dout = dout;
  a.delta = delta;
  a.dq = dq;
  return bwd_types(a, hd, false, in_type, out_type, (cudaStream_t)stream);
}

// The backward's second kernel, after the first: dk and dv (B, S, KV, hd,
// in out_type) from the forward's lse, the first kernel's delta and dout.
extern "C" int repro_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const int* kv_map, const float* lse, const float* delta,
                                       const void* dout, void* dk, void* dv, long long q_sb,
                                       long long q_ss, long long q_sh, long long k_sb,
                                       long long k_ss, long long k_sh, long long v_sb,
                                       long long v_ss, long long v_sh, int B, int S, int H,
                                       int KV, int hd, int window, int in_type, int out_type,
                                       void* stream) {
  using namespace repro;
  Args a;
  if (!make_args(&a, q, k, v, kv_map, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, B, S,
                 H, KV, hd, window))
    return (int)cudaErrorInvalidValue;
  a.lse_in = lse;
  a.delta = const_cast<float*>(delta);
  a.dout = dout;
  a.dk = dk;
  a.dv = dv;
  return bwd_types(a, hd, true, in_type, out_type, (cudaStream_t)stream);
}
