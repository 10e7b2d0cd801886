// Device helpers shared by the bf16 attention kernels (small_attention.cu,
// flash_attention.cu): tensor-core products, shared-memory matrix loads,
// asynchronous copies, fragment packing, and the masked-row rules.
//
// Fragment layouts (mma.sync.m16n8k16, lane = 4·g + t): the A operand and the
// fp32 accumulator hold rows g and g + 8, columns 2t, 2t + 1 (and + 8 for A's
// second half); the B operand holds k = 2t, 2t + 1 (+ 8) of column g. So the
// accumulator of S = Q·Kᵀ, rounded to bf16 pairs, is the A operand of P·V
// and the score tile never leaves registers.
//
// Shared-memory tiles are [rows][D + 8] bf16: the 16 bytes of padding put the
// eight 16-byte rows of one ldmatrix phase in distinct banks (a row stride of
// 80, 144 or 272 bytes is an odd multiple of 16).
//
// Scores are kept in log2 units: t = q·k·(scale·log2 e) + bias·log2 e, so a
// probability is one ex2 of a difference. finfo(float32).min times log2 e
// would overflow to -inf and a fully masked row would turn into NaN; the bias
// is clamped at -FLT_MAX, which absorbs q·k as finfo.min does, so such a row
// still sees equal scores and averages its keys uniformly.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace attn {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;  // keys per score tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// a kernel that uses more than 48 KB of dynamic shared memory has to ask for it
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// 2^x on the special-function unit; 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a key's additive bias in log2 units (see the head comment)
__device__ __forceinline__ float bias_log2(float b) { return fmaxf(b * kLog2e, -FLT_MAX); }

// c += a·b on the tensor cores: A 16x16 (row), B 16x8 (col), fp32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, and r[i] receives this lane's pair of matrix i
// (row g, columns 2t, 2t + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same with each matrix transposed: r[i] = rows 2t, 2t + 1 of column g.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16 bytes from device memory to a shared-memory address without passing
// through registers
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src) : "memory");
}

// the same, or with live false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool live) {
  const int n = live ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows [row0, row0 + rows) of a [L, D] operand into shared memory (row stride
// D + 8) by asynchronous 16-byte copies that nthr threads start; rows at or
// past L are zero-filled.
template <int D>
__device__ __forceinline__ void copy_rows_async(bf16* s, const bf16* p, long long sl, int row0,
                                                int rows, int L, int nthr) {
  constexpr int SD = D + 8, CH = D / 8;
  const uint32_t dst = smem_addr(s);
  for (int c = threadIdx.x; c < rows * CH; c += nthr) {
    const int r = c / CH, part = c % CH, row = row0 + r;
    cp_async16(dst + (r * SD + part * 8) * (int)sizeof(bf16),
               p + (long long)min(row, L - 1) * sl + part * 8, row < L);
  }
}

// A fragments of a warp's 16 query rows, from shared-memory rows that start at sQ
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[D / 16][4], const bf16* sQ, int lane) {
  constexpr int SD = D + 8;
  const bf16* p = sQ + (((lane >> 3) & 1) * 8 + (lane & 7)) * SD + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qf[kk], p + kk * 16);
}

// s[nt] = (the warp's 16 rows of Q) · (keys 8·nt.. of the K tile)ᵀ over D.
// One ldmatrix.x4 brings a key block's B fragments for 32 of D and feeds two
// products; the products of one step over D go to different accumulators
// back to back, so none waits for the one before it. Key blocks at or past
// nt_live stay 0.
template <int D>
__device__ __forceinline__ void score_tile(float (&s)[kTile / 8][4], const uint32_t (&qf)[D / 16][4],
                                           const bf16* sK, int nt_live, int lane) {
  constexpr int SD = D + 8, NT = kTile / 8;
  const bf16* p = sK + (lane & 7) * SD + (lane >> 3) * 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kp = 0; kp < D / 32; ++kp) {
    uint32_t kb[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      if (nt < nt_live) ldmatrix_x4(kb[nt], p + nt * 8 * SD + kp * 32);
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        if (nt < nt_live) mma(s[nt], qf[2 * kp + half], kb[nt][2 * half], kb[nt][2 * half + 1]);
  }
}

// s = s·c + the keys' biases (sB: this tile's 64 biases in log2 units, -inf
// for keys past the sequence)
__device__ __forceinline__ void scale_bias(float (&s)[kTile / 8][4], const float* sB, float c,
                                           int t) {
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    const float2 bz = *reinterpret_cast<const float2*>(sB + nt * 8 + 2 * t);
    s[nt][0] = fmaf(s[nt][0], c, bz.x);
    s[nt][1] = fmaf(s[nt][1], c, bz.y);
    s[nt][2] = fmaf(s[nt][2], c, bz.x);
    s[nt][3] = fmaf(s[nt][3], c, bz.y);
  }
}

// 16 keys of a probability tile, rounded to bf16, as an A fragment (the
// accumulator layout of key blocks 2·kk and 2·kk + 1)
template <int NT>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[4], const float (&p)[NT][4], int kk) {
  pa[0] = pack(p[2 * kk][0], p[2 * kk][1]);
  pa[1] = pack(p[2 * kk][2], p[2 * kk][3]);
  pa[2] = pack(p[2 * kk + 1][0], p[2 * kk + 1][1]);
  pa[3] = pack(p[2 * kk + 1][2], p[2 * kk + 1][3]);
}

// o += p · V tile: p is rounded to bf16 here, as the A operand; one
// transposed ldmatrix.x4 brings a 16-key block's B fragments for 16 of D.
// 16-key blocks at or past kk_live are skipped.
template <int D>
__device__ __forceinline__ void pv_tile(float (&o)[D / 8][4], const float (&p)[kTile / 8][4],
                                        const bf16* sV, int kk_live, int lane) {
  constexpr int SD = D + 8;
  const bf16* vp = sV + (((lane >> 3) & 1) * 8 + (lane & 7)) * SD + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    if (kk < kk_live) {
      uint32_t pa[4];
      pack_p(pa, p, kk);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vp + kk * 16 * SD + np * 16);
        mma(o[2 * np], pa, vb[0], vb[1]);
        mma(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
  }
}

// A warp's 16-row accumulator tile, rows g and g + 8 scaled by i0 and i1,
// rounded to bf16 into 16 shared-memory rows of the warp's own (sO), then to
// device memory rows row0.. by 16-byte stores; rows at or past L are skipped.
template <int D>
__device__ __forceinline__ void store_tile(const float (&o)[D / 8][4], float i0, float i1,
                                           bf16* sO, bf16* out, long long ol, int row0, int L,
                                           int lane) {
  constexpr int SD = D + 8, CH = D / 8;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    *reinterpret_cast<uint32_t*>(sO + g * SD + nt * 8 + 2 * t) = pack(o[nt][0] * i0, o[nt][1] * i0);
    *reinterpret_cast<uint32_t*>(sO + (g + 8) * SD + nt * 8 + 2 * t) =
        pack(o[nt][2] * i1, o[nt][3] * i1);
  }
  __syncwarp();
#pragma unroll
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, part = c % CH;
    if (row0 + r < L)
      *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * ol + part * 8) =
          *reinterpret_cast<const uint4*>(sO + r * SD + part * 8);
  }
}

}  // namespace attn
