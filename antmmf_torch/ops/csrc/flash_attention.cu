// Blocked flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of antmmf_tpu/ops/pallas/flash_attention.py: the
// forward (_fwd_kernel_resident, _fwd_kernel), the dQ kernel
// (_dq_kernel_resident, _dq_kernel) and the dK/dV kernel
// (_dkv_kernel_resident, _dkv_kernel). The resident/grid split there is a
// VMEM workaround; one family stands for both forms here.
//
//   out[i] = sum_j softmax_j(q_i·k_j·scale + bias[j]) v_j      (keys j < Lk;
//            with causal, only keys j <= i, top-left aligned as in JAX)
//
// q is [B, H, Lq, D], k and v [B, H, Lk, D], all bfloat16 and addressed by
// element strides with a unit stride over D. bias is an fp32 key bias [B, Lk]
// (or none). The semantics are those of the JAX package's xla_attention_core:
// keys past Lk are masked by -inf inside the kernel and never enter the
// softmax, and a row whose keys all carry finfo(float32).min averages them
// uniformly (the Pallas kernel starts its running max at -1e30, which beats
// finfo.min, and returns 0 for such a row; the port does not copy that).
//
// The forward saves the output and the row statistics: lse kept as the
// unevaluated sum m + log(l) of two fp32 arrays (stats[0] = m, stats[1] =
// log l), because at m = finfo.min the rounded sum loses log(l) and the
// backward would no longer recompute the uniform row. The backward forms
// delta = rowsum(dO∘O) inside the dQ kernel (which writes it out for the
// dK/dV kernel, launched after it on the same stream) and recomputes
// P = exp((s - m) - log l) blockwise. The bias gets no gradient.
//
// What bounds it on an H100: at the cross-encoder's [64, 12, 430, 64] the
// forward does 4·B·H·Lq·Lk·D = 36.4 GFLOP (37 us at 989 TFLOP/s bf16) and
// moves 85 MB (25 us at 3.35 TB/s): tensor-core operations bound it, and the
// backward (2.5x the products) likewise. The design is FA2 on mma.sync:
//   * m16n8k16 bf16 tensor-core products with fp32 accumulators; one block of
//     four warps per 64 query rows (forward, dQ) or 64 keys (dK/dV), 16 rows
//     per warp, the warp's own operand kept in registers as A fragments;
//   * the other operand streams through shared memory in 64-row tiles
//     (rows padded by 16 bytes, so fragment loads hit 32 distinct banks);
//   * the score tile stays in registers: the accumulator layout of S is
//     reused as the A fragment of P·V (and of dS·K, dSᵀ·Q), so no [L, L]
//     tensor is written anywhere;
//   * causal blocks above the diagonal are skipped by the loop bounds.
// Single-buffered, synchronous tile loads: no cp.async, TMA or wgmma yet;
// those are the next steps for speed.
// P is rounded to bf16 before P·V and dS before dS·K, as the JAX kernels do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Mirrored by antmmf_torch/ops/flash_attention.py (_FlashArgs).
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;   // [B, Lk] fp32, or null
  void* o;             // [B, H, Lq, D]
  float* stats;        // [2, B, H, Lq]: m, log l
  const void* dout;    // [B, H, Lq, D]
  float* delta;        // [B, H, Lq]
  void* dq;
  void* dk;
  void* dv;
  long long q_s[3], k_s[3], v_s[3], o_s[3], do_s[3], dq_s[3], dk_s[3], dv_s[3];
  int B, H, Lq, Lk, D, causal;
  float scale;
};

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // four warps
constexpr int kRows = 64;      // query rows (forward, dQ) or keys (dK/dV) per block
constexpr int kTile = 64;      // keys per streamed tile (forward, dQ)

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 from two addresses into one register, the first in the low half
__device__ __forceinline__ uint32_t pack_pair(const bf16* lo, const bf16* hi) {
  return (uint32_t)*reinterpret_cast<const uint16_t*>(lo) |
         ((uint32_t)*reinterpret_cast<const uint16_t*>(hi) << 16);
}

__device__ __forceinline__ float2 unpack(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// c += a·b on the tensor cores: A 16x16 (row), B 16x8 (col), fp32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A fragments of a warp's 16 rows (r0 = row g, r1 = row g + 8) from device
// memory; rows at or past L read as zero.
template <int KD>
__device__ __forceinline__ void load_a(uint32_t (&f)[KD][4], const bf16* p, long long sl,
                                       int r0, int r1, int L, int t) {
  const bool v0 = r0 < L, v1 = r1 < L;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = kk * 16 + 2 * t;
    f[kk][0] = v0 ? ld32(p + r0 * sl + c) : 0u;
    f[kk][1] = v1 ? ld32(p + r1 * sl + c) : 0u;
    f[kk][2] = v0 ? ld32(p + r0 * sl + c + 8) : 0u;
    f[kk][3] = v1 ? ld32(p + r1 * sl + c + 8) : 0u;
  }
}

// rows [row0, row0 + ROWS) of a [L, D] operand into shared memory (row
// stride D + 8) with 16-byte loads; rows at or past L are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* p, long long sl, int row0, int L) {
  constexpr int SD = D + 8, CH = D / 8;
  for (int c = threadIdx.x; c < ROWS * CH; c += kThreads) {
    const int r = c / CH, part = c % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L) val = *reinterpret_cast<const uint4*>(p + (row0 + r) * sl + part * 8);
    *reinterpret_cast<uint4*>(s + r * SD + part * 8) = val;
  }
}

// s[nt] = (warp's 16 rows of A) · (rows nt*8.. of the tile)ᵀ, over D
template <int KD, int NT, int SD>
__device__ __forceinline__ void dot_tile(float (&s)[NT][4], const uint32_t (&a)[KD][4],
                                         const bf16* tile, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const bf16* r = tile + (nt * 8 + g) * SD + 2 * t;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) mma(s[nt], a[kk], ld32(r + kk * 16), ld32(r + kk * 16 + 8));
  }
}

// acc[nt] += p · tile, p the [16, 16·KT] register tile in accumulator layout
// (rounded to bf16 as the A operand), the tile [16·KT, D] in shared memory
template <int KT, int ND, int SD>
__device__ __forceinline__ void acc_tile(float (&acc)[ND][4], const float (&p)[2 * KT][4],
                                         const bf16* tile, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const uint32_t a[4] = {pack(p[2 * kk][0], p[2 * kk][1]), pack(p[2 * kk][2], p[2 * kk][3]),
                           pack(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const bf16* r = tile + (kk * 16 + 2 * t) * SD + g;
#pragma unroll
    for (int nt = 0; nt < ND; ++nt) {
      const bf16* c = r + nt * 8;
      mma(acc[nt], a, pack_pair(c, c + SD), pack_pair(c + 8 * SD, c + 9 * SD));
    }
  }
}

// scores of query rows r0/r1 against the tile's keys key0 + col: scale, key
// bias (-inf past Lk), causal mask
template <int NT>
__device__ __forceinline__ void mask_rows(float (&s)[NT][4], const float* sB, float scale,
                                          int causal, int key0, int r0, int r1, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = nt * 8 + 2 * t + (e & 1);
      float x = s[nt][e] * scale + sB[col];
      if (causal && key0 + col > (e < 2 ? r0 : r1)) x = -INFINITY;
      s[nt][e] = x;
    }
}

template <typename T>
__device__ __forceinline__ T* at(const void* base, const long long (&s)[3], int b, int h) {
  return static_cast<T*>(const_cast<void*>(base)) + b * s[0] + h * s[1];
}

// ------------------------------------------------------------------ forward
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FlashArgs a) {
  constexpr int SD = D + 8, KD = D / 16, ND = D / 8, NT = kTile / 8;
  __shared__ __align__(16) bf16 sK[kTile * SD];
  __shared__ __align__(16) bf16 sV[kTile * SD];
  __shared__ float sB[kTile];
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kRows + warp * 16 + g, r1 = r0 + 8;
  const bf16* k = at<const bf16>(a.k, a.k_s, b, h);
  const bf16* v = at<const bf16>(a.v, a.v_s, b, h);
  const float* bias = a.bias ? a.bias + (long long)b * a.Lk : nullptr;

  uint32_t qf[KD][4];
  load_a<KD>(qf, at<const bf16>(a.q, a.q_s, b, h), a.q_s[2], r0, r1, a.Lq, t);
  float o[ND][4];
#pragma unroll
  for (int nt = 0; nt < ND; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  int nkt = (a.Lk + kTile - 1) / kTile;
  if (a.causal) nkt = min(nkt, (min((int)blockIdx.x * kRows + kRows, a.Lq) - 1) / kTile + 1);
  for (int kt = 0; kt < nkt; ++kt) {
    const int key0 = kt * kTile;
    __syncthreads();  // the previous tile is consumed
    load_tile<D, kTile>(sK, k, a.k_s[2], key0, a.Lk);
    load_tile<D, kTile>(sV, v, a.v_s[2], key0, a.Lk);
    for (int j = threadIdx.x; j < kTile; j += kThreads)
      sB[j] = key0 + j < a.Lk ? (bias ? bias[key0 + j] : 0.f) : -INFINITY;
    __syncthreads();

    float s[NT][4];
    dot_tile<KD, NT, SD>(s, qf, sK, g, t);
    mask_rows<NT>(s, sB, a.scale, a.causal, key0, r0, r1, t);
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      x0 = fmaxf(x0, fmaxf(s[nt][0], s[nt][1]));
      x1 = fmaxf(x1, fmaxf(s[nt][2], s[nt][3]));
    }
    const float n0 = fmaxf(m0, quad_max(x0)), n1 = fmaxf(m1, quad_max(x1));
    // a row with no live key yet keeps max -inf; exponents then use 0
    const float u0 = n0 == -INFINITY ? 0.f : n0, u1 = n1 == -INFINITY ? 0.f : n1;
    const float al0 = expf(m0 - u0), al1 = expf(m1 - u1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = expf(s[nt][0] - u0);
      s[nt][1] = expf(s[nt][1] - u0);
      s[nt][2] = expf(s[nt][2] - u1);
      s[nt][3] = expf(s[nt][3] - u1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * al0 + rs0;  // per-thread partial sums; the quad reduces at the end
    l1 = l1 * al1 + rs1;
    m0 = n0;
    m1 = n1;
#pragma unroll
    for (int nt = 0; nt < ND; ++nt) {
      o[nt][0] *= al0;
      o[nt][1] *= al0;
      o[nt][2] *= al1;
      o[nt][3] *= al1;
    }
    acc_tile<NT / 2, ND, SD>(o, s, sV, g, t);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  bf16* out = at<bf16>(a.o, a.o_s, b, h);
  const long long ol = a.o_s[2];
  const float i0 = l0 > 0.f ? l0 : 1.f, i1 = l1 > 0.f ? l1 : 1.f;
#pragma unroll
  for (int nt = 0; nt < ND; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (r0 < a.Lq)
      *reinterpret_cast<uint32_t*>(out + r0 * ol + c) = pack(o[nt][0] / i0, o[nt][1] / i0);
    if (r1 < a.Lq)
      *reinterpret_cast<uint32_t*>(out + r1 * ol + c) = pack(o[nt][2] / i1, o[nt][3] / i1);
  }
  if (t == 0) {
    const long long row = (long long)bh * a.Lq, plane = (long long)a.B * a.H * a.Lq;
    if (r0 < a.Lq) {
      a.stats[row + r0] = m0 == -INFINITY ? 0.f : m0;
      a.stats[plane + row + r0] = l0 > 0.f ? logf(l0) : 0.f;
    }
    if (r1 < a.Lq) {
      a.stats[row + r1] = m1 == -INFINITY ? 0.f : m1;
      a.stats[plane + row + r1] = l1 > 0.f ? logf(l1) : 0.f;
    }
  }
}

// ----------------------------------------------------------------------- dQ
template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const FlashArgs a) {
  constexpr int SD = D + 8, KD = D / 16, ND = D / 8, NT = kTile / 8;
  __shared__ __align__(16) bf16 sK[kTile * SD];
  __shared__ __align__(16) bf16 sV[kTile * SD];
  __shared__ float sB[kTile];
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kRows + warp * 16 + g, r1 = r0 + 8;
  const bool v0 = r0 < a.Lq, v1 = r1 < a.Lq;
  const bf16* k = at<const bf16>(a.k, a.k_s, b, h);
  const bf16* v = at<const bf16>(a.v, a.v_s, b, h);
  const float* bias = a.bias ? a.bias + (long long)b * a.Lk : nullptr;

  uint32_t qf[KD][4], df[KD][4];
  load_a<KD>(qf, at<const bf16>(a.q, a.q_s, b, h), a.q_s[2], r0, r1, a.Lq, t);
  load_a<KD>(df, at<const bf16>(a.dout, a.do_s, b, h), a.do_s[2], r0, r1, a.Lq, t);

  // delta = rowsum(dO∘O) in fp32, written out for the dK/dV kernel. A
  // thread's fragments cover columns 2t, 2t+1 (+8, +16k) of rows r0 (even
  // registers) and r1 (odd); the quad completes the rows.
  float d0 = 0.f, d1 = 0.f;
  {
    uint32_t of[KD][4];
    load_a<KD>(of, at<const bf16>(a.o, a.o_s, b, h), a.o_s[2], r0, r1, a.Lq, t);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = unpack(df[kk][e]), y = unpack(of[kk][e]);
        if (e & 1) d1 += x.x * y.x + x.y * y.y;
        else d0 += x.x * y.x + x.y * y.y;
      }
  }
  d0 = quad_sum(d0);
  d1 = quad_sum(d1);
  const long long row = (long long)bh * a.Lq, plane = (long long)a.B * a.H * a.Lq;
  if (t == 0) {
    if (v0) a.delta[row + r0] = d0;
    if (v1) a.delta[row + r1] = d1;
  }
  const float m0 = v0 ? a.stats[row + r0] : 0.f, m1 = v1 ? a.stats[row + r1] : 0.f;
  const float g0 = v0 ? a.stats[plane + row + r0] : 0.f;
  const float g1 = v1 ? a.stats[plane + row + r1] : 0.f;

  float dq[ND][4];
#pragma unroll
  for (int nt = 0; nt < ND; ++nt) dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.f;
  int nkt = (a.Lk + kTile - 1) / kTile;
  if (a.causal) nkt = min(nkt, (min((int)blockIdx.x * kRows + kRows, a.Lq) - 1) / kTile + 1);
  for (int kt = 0; kt < nkt; ++kt) {
    const int key0 = kt * kTile;
    __syncthreads();
    load_tile<D, kTile>(sK, k, a.k_s[2], key0, a.Lk);
    load_tile<D, kTile>(sV, v, a.v_s[2], key0, a.Lk);
    for (int j = threadIdx.x; j < kTile; j += kThreads)
      sB[j] = key0 + j < a.Lk ? (bias ? bias[key0 + j] : 0.f) : -INFINITY;
    __syncthreads();

    float s[NT][4], dp[NT][4];
    dot_tile<KD, NT, SD>(s, qf, sK, g, t);
    mask_rows<NT>(s, sB, a.scale, a.causal, key0, r0, r1, t);
    dot_tile<KD, NT, SD>(dp, df, sV, g, t);  // dP = dO·Vᵀ
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {  // dS = P∘(dP - delta)·scale
      s[nt][0] = expf((s[nt][0] - m0) - g0) * (dp[nt][0] - d0) * a.scale;
      s[nt][1] = expf((s[nt][1] - m0) - g0) * (dp[nt][1] - d0) * a.scale;
      s[nt][2] = expf((s[nt][2] - m1) - g1) * (dp[nt][2] - d1) * a.scale;
      s[nt][3] = expf((s[nt][3] - m1) - g1) * (dp[nt][3] - d1) * a.scale;
    }
    acc_tile<NT / 2, ND, SD>(dq, s, sK, g, t);  // dQ += dS·K
  }

  bf16* out = at<bf16>(a.dq, a.dq_s, b, h);
  const long long ql = a.dq_s[2];
#pragma unroll
  for (int nt = 0; nt < ND; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (v0) *reinterpret_cast<uint32_t*>(out + r0 * ql + c) = pack(dq[nt][0], dq[nt][1]);
    if (v1) *reinterpret_cast<uint32_t*>(out + r1 * ql + c) = pack(dq[nt][2], dq[nt][3]);
  }
}

// -------------------------------------------------------------------- dK/dV
template <int D, int QT>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(const FlashArgs a) {
  constexpr int SD = D + 8, KD = D / 16, ND = D / 8, NT = QT / 8;
  __shared__ __align__(16) bf16 sQ[QT * SD];
  __shared__ __align__(16) bf16 sO[QT * SD];  // dO tile
  __shared__ float sM[QT], sG[QT], sDl[QT];
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kRows + warp * 16 + g, k1 = k0 + 8;  // this thread's keys
  const bf16* q = at<const bf16>(a.q, a.q_s, b, h);
  const bf16* dout = at<const bf16>(a.dout, a.do_s, b, h);
  const float* bias = a.bias ? a.bias + (long long)b * a.Lk : nullptr;
  const float bz0 = k0 < a.Lk ? (bias ? bias[k0] : 0.f) : -INFINITY;
  const float bz1 = k1 < a.Lk ? (bias ? bias[k1] : 0.f) : -INFINITY;
  const long long row = (long long)bh * a.Lq, plane = (long long)a.B * a.H * a.Lq;

  uint32_t kf[KD][4], vf[KD][4];
  load_a<KD>(kf, at<const bf16>(a.k, a.k_s, b, h), a.k_s[2], k0, k1, a.Lk, t);
  load_a<KD>(vf, at<const bf16>(a.v, a.v_s, b, h), a.v_s[2], k0, k1, a.Lk, t);
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int nt = 0; nt < ND; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

  const int nqt = (a.Lq + QT - 1) / QT;
  // causal: query rows below this block's first key see none of its keys
  for (int qt = a.causal ? (int)blockIdx.x * kRows / QT : 0; qt < nqt; ++qt) {
    const int q0 = qt * QT;
    __syncthreads();
    load_tile<D, QT>(sQ, q, a.q_s[2], q0, a.Lq);
    load_tile<D, QT>(sO, dout, a.do_s[2], q0, a.Lq);
    for (int j = threadIdx.x; j < QT; j += kThreads) {
      const bool ok = q0 + j < a.Lq;  // padded query rows get P = 0 through log l = inf
      sM[j] = ok ? a.stats[row + q0 + j] : 0.f;
      sG[j] = ok ? a.stats[plane + row + q0 + j] : INFINITY;
      sDl[j] = ok ? a.delta[row + q0 + j] : 0.f;
    }
    __syncthreads();

    float p[NT][4], dp[NT][4];
    dot_tile<KD, NT, SD>(p, kf, sQ, g, t);  // Sᵀ: rows are keys, columns queries
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        float x = p[nt][e] * a.scale + (e < 2 ? bz0 : bz1);
        if (a.causal && (e < 2 ? k0 : k1) > q0 + col) x = -INFINITY;
        p[nt][e] = expf((x - sM[col]) - sG[col]);
      }
    acc_tile<NT / 2, ND, SD>(dv, p, sO, g, t);  // dV += Pᵀ·dO
    dot_tile<KD, NT, SD>(dp, vf, sO, g, t);     // dPᵀ = V·dOᵀ
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        p[nt][e] = p[nt][e] * (dp[nt][e] - sDl[col]) * a.scale;
      }
    acc_tile<NT / 2, ND, SD>(dk, p, sQ, g, t);  // dK += dSᵀ·Q
  }

  bf16* gk = at<bf16>(a.dk, a.dk_s, b, h);
  bf16* gv = at<bf16>(a.dv, a.dv_s, b, h);
  const long long kl = a.dk_s[2], vl = a.dv_s[2];
#pragma unroll
  for (int nt = 0; nt < ND; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (k0 < a.Lk) {
      *reinterpret_cast<uint32_t*>(gk + k0 * kl + c) = pack(dk[nt][0], dk[nt][1]);
      *reinterpret_cast<uint32_t*>(gv + k0 * vl + c) = pack(dv[nt][0], dv[nt][1]);
    }
    if (k1 < a.Lk) {
      *reinterpret_cast<uint32_t*>(gk + k1 * kl + c) = pack(dk[nt][2], dk[nt][3]);
      *reinterpret_cast<uint32_t*>(gv + k1 * vl + c) = pack(dv[nt][2], dv[nt][3]);
    }
  }
}

bool takes(const FlashArgs* a) {
  return a->B >= 1 && a->H >= 1 && a->Lq >= 1 && a->Lk >= 1 && (long long)a->B * a->H <= 65535;
}

template <int D>
int launch(int which, const FlashArgs& a, cudaStream_t s) {
  const int L = which == 2 ? a.Lk : a.Lq;
  const dim3 grid((L + kRows - 1) / kRows, a.B * a.H);
  if (which == 0)
    flash_fwd_kernel<D><<<grid, kThreads, 0, s>>>(a);
  else if (which == 1)
    flash_dq_kernel<D><<<grid, kThreads, 0, s>>>(a);
  else
    flash_dkv_kernel<D, D == 128 ? 32 : 64><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(int which, const FlashArgs* a, void* stream) {
  if (!takes(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->D) {
    case 32: return launch<32>(which, *a, s);
    case 64: return launch<64>(which, *a, s);
    case 128: return launch<128>(which, *a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Each returns a cudaError_t; 0 means launched. Every pointer's rows must
// start on a 16-byte boundary and have a unit stride over D.
// Forward: reads q, k, v, bias; writes o and stats.
extern "C" int antmmf_flash_fwd(const FlashArgs* a, void* stream) { return dispatch(0, a, stream); }
// dQ: reads q, k, v, bias, o, stats, dout; writes delta and dq.
extern "C" int antmmf_flash_dq(const FlashArgs* a, void* stream) { return dispatch(1, a, stream); }
// dK/dV: reads q, k, v, bias, stats, dout and the delta written by dQ; writes dk, dv.
extern "C" int antmmf_flash_dkv(const FlashArgs* a, void* stream) { return dispatch(2, a, stream); }
