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
// What bounds it on an H100: at the cross-encoder's [64, 12, 430, 64] q, k, v
// and the output are 42.3 MB each, 172 MB with the bias and the statistics
// (51.3 us at 3.35 TB/s), against 4·B·H·Lq·Lk·D = 36.4 GFLOP (36.8 us at 989
// TFLOP/s bf16): device-memory bytes bound the forward at D = 64. The backward
// kernels each move six such tensors plus the rows, about 258 MB (76.9 us),
// against 6 and 8·B·H·Lq·Lk·D operations (55 and 73.5 us): close to
// balanced, so loads and products have to overlap. All three are flash attention
// with the score tile kept in registers:
//   * bf16 tensor-core products with fp32 accumulators; a block of four warps
//     owns 64 rows of its own operand (query rows in the forward and dQ, keys
//     in dK/dV) and the other operand streams through shared memory in
//     64-row tiles;
//   * the accumulator layout of S is reused as the A operand of P·V (and of
//     dS·K, dSᵀ·Q), so no [L, L] tensor is written anywhere;
//   * causal blocks above the diagonal are skipped by the loop bounds.
// The forward is built for this card. K/V tiles arrive in a ring of two
// shared-memory stages by 16-byte asynchronous copies (cp.async) whose
// addressing is done once a thread, so tile kt + 1 loads while tile kt
// multiplies, with one block barrier a tile; the next tile's key biases are
// fetched into a register meanwhile. Scores are kept in log2 units, so a
// probability is one FMA and one ex2 (attention_common.cuh). Q is fetched
// once by cp.async and the output leaves through its shared-memory rows as
// 16-byte stores. At D = 64, the cross-encoder's width, the products are
// wgmma: the four warps are one warpgroup and the tensor cores read Q, K and V
// tiles straight from swizzled shared memory (see that kernel's comment for
// its limit). At D = 32 and 128 they are mma.sync m16n8k16 fed by ldmatrix.x4
// (K) and ldmatrix.x4.trans (V), one shared-memory load for two
// products; Pink's causal prefill at D = 128 is 32 blocks of two tiles, a
// matter of latency, where wgmma has nothing to add.
// At D = 64 and D = 128 (Pink's causal training step) the dQ and dK/dV
// kernels share that design (ring, wgmma, ex2; see "backward, D = 64" and
// "backward, D = 128", which also skips the key tiles whose keys are all
// masked). At D = 32, which no path trains at, they still load their tiles
// synchronously, single buffered, with scalar fragment loads on mma.sync.
// P is rounded to bf16 before P·V and dS before dS·K, as the JAX kernels do.

#include "attention_common.cuh"

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

using namespace attn;

constexpr int kThreads = 128;  // four warps
constexpr int kRows = 64;      // query rows (forward, dQ) or keys (dK/dV) per block

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 from two addresses into one register, the first in the low half
__device__ __forceinline__ uint32_t pack_pair(const bf16* lo, const bf16* hi) {
  return (uint32_t)*reinterpret_cast<const uint16_t*>(lo) |
         ((uint32_t)*reinterpret_cast<const uint16_t*>(hi) << 16);
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
// One thread's share of the asynchronous copies that bring 64-row tiles of a
// [L, D] operand into shared memory: the same rows and 16-byte chunk of every
// tile, so all addressing but the tile's offset is done once. SWZ selects the
// shared-memory layout: rows of D + 8 (padded, for ldmatrix) or 128-byte
// rows whose 16-byte chunks are XORed with the row's low three bits (the
// 128-byte swizzle that wgmma descriptors name), 64 columns a slab: at
// D = 128 columns 64..127 form a second [64][64] slab after the first.
template <int D, bool SWZ>
struct TileCopier {
  static constexpr int CH = D / 8, RSTEP = kThreads / CH, N = kTile / RSTEP;
  static constexpr int PITCH = (SWZ ? 64 : D + 8) * (int)sizeof(bf16);
  static_assert(!SWZ || (RSTEP % 8 == 0 && D % 64 == 0), "a thread's rows share one swizzle");
  const bf16* base;  // row 0 of the operand, read for nothing when a row is past L
  const bf16* src;   // this thread's chunk of its first row
  long long sl, step;
  int r0;
  uint32_t off;  // this thread's byte offset in a shared-memory tile

  __device__ __forceinline__ TileCopier(const bf16* p, long long row_stride)
      : base(p), sl(row_stride), step(RSTEP * row_stride), r0(threadIdx.x / CH) {
    const int part = threadIdx.x % CH;
    src = p + r0 * sl + part * 8;
    off = SWZ ? (part >> 3) * kTile * PITCH + r0 * PITCH + (((part & 7) ^ (r0 & 7)) << 4)
              : r0 * PITCH + (part << 4);
  }

  // rows [row0, row0 + 64) to the tile at shared address `tile`; rows at or
  // past L are zero-filled
  __device__ __forceinline__ void start(uint32_t tile, int row0, int L) const {
    const bf16* p = src + row0 * sl;
    const uint32_t dst = tile + off;
    if (row0 + kTile <= L) {
#pragma unroll
      for (int i = 0; i < N; ++i) cp_async16(dst + i * RSTEP * PITCH, p + i * step);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const bool live = row0 + r0 + i * RSTEP < L;
        cp_async16(dst + i * RSTEP * PITCH, live ? p + i * step : base, live);
      }
    }
  }
};

// -inf above the diagonal, for the tile's keys key0.. and a warp's 16 rows wrow..
__device__ __forceinline__ void causal_mask(float (&s)[kTile / 8][4], int key0, int wrow, int g,
                                            int t) {
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (key0 + nt * 8 + 2 * t + (e & 1) > wrow + g + (e >> 1) * 8) s[nt][e] = -INFINITY;
}

// One tile's step of the online softmax, scores in log2 units: the running
// max m and (per-thread partial) sum l of rows g and g + 8 move on, s becomes
// the unnormalised probabilities and the accumulator o is rescaled to the new
// max.
template <int ND>
__device__ __forceinline__ void softmax_step(float (&s)[kTile / 8][4], float (&o)[ND][4],
                                             float (&m)[2], float (&l)[2]) {
  constexpr int NT = kTile / 8;
  float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    x0 = fmaxf(x0, fmaxf(s[nt][0], s[nt][1]));
    x1 = fmaxf(x1, fmaxf(s[nt][2], s[nt][3]));
  }
  const float n0 = fmaxf(m[0], quad_max(x0)), n1 = fmaxf(m[1], quad_max(x1));
  // a row with no live key yet keeps max -inf; exponents then use 0
  const float u0 = n0 == -INFINITY ? 0.f : n0, u1 = n1 == -INFINITY ? 0.f : n1;
  const float al0 = ex2(m[0] - u0), al1 = ex2(m[1] - u1);
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = ex2(s[nt][0] - u0);
    s[nt][1] = ex2(s[nt][1] - u0);
    s[nt][2] = ex2(s[nt][2] - u1);
    s[nt][3] = ex2(s[nt][3] - u1);
    rs0 += s[nt][0] + s[nt][1];
    rs1 += s[nt][2] + s[nt][3];
  }
  l[0] = l[0] * al0 + rs0;  // the quad reduces its partial sums at the end
  l[1] = l[1] * al1 + rs1;
  m[0] = n0;
  m[1] = n1;
#pragma unroll
  for (int nt = 0; nt < ND; ++nt) {
    o[nt][0] *= al0;
    o[nt][1] *= al0;
    o[nt][2] *= al1;
    o[nt][3] *= al1;
  }
}

// The statistics of rows r and r + 8 (lanes with t = 0 write): m in
// natural-log units and log l apart. The clamped bias of a fully masked row
// goes out as finfo.min, which the backward's recomputed scores will equal.
__device__ __forceinline__ void store_stats(const FlashArgs& a, int bh, int r, const float (&m)[2],
                                            float l0, float l1) {
  const long long row = (long long)bh * a.Lq, plane = (long long)a.B * a.H * a.Lq;
  if (r < a.Lq) {
    a.stats[row + r] = m[0] == -INFINITY ? 0.f : (m[0] == -FLT_MAX ? m[0] : m[0] * kLn2);
    a.stats[plane + row + r] = l0 > 0.f ? logf(l0) : 0.f;
  }
  if (r + 8 < a.Lq) {
    a.stats[row + r + 8] = m[1] == -INFINITY ? 0.f : (m[1] == -FLT_MAX ? m[1] : m[1] * kLn2);
    a.stats[plane + row + r + 8] = l1 > 0.f ? logf(l1) : 0.f;
  }
}

// What the two forward kernels and dQ at D = 64 share: a block of four warps
// owns 64 query rows, 16 a warp, and walks the keys in 64-key tiles through a
// ring of two shared-memory stages (a K tile followed by a V tile), each with
// the tile's 64 key biases in log2 units (fp32, -inf for keys past Lk).
struct FwdBlock {
  const FlashArgs& a;
  int bh, b, h, warp, lane, g, t, row0, wrow, nkt;
  const float* bias;
  float c;  // scale in log2 units

  // head: the grid's y; row block: its x
  __device__ __forceinline__ explicit FwdBlock(const FlashArgs& args)
      : FwdBlock(args, blockIdx.y, blockIdx.x) {}

  __device__ __forceinline__ FwdBlock(const FlashArgs& args, int bh_, int rb) : a(args) {
    bh = bh_, b = bh / a.H, h = bh % a.H;
    warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    row0 = rb * kRows, wrow = row0 + warp * 16;
    bias = a.bias ? a.bias + (long long)b * a.Lk : nullptr;
    c = a.scale * kLog2e;
    nkt = (a.Lk + kTile - 1) / kTile;
    if (a.causal) nkt = min(nkt, (min(row0 + kRows, a.Lq) - 1) / kTile + 1);
  }

  __device__ __forceinline__ float key_bias(int j) const {
    return j < a.Lk ? (bias ? bias_log2(bias[j]) : 0.f) : -INFINITY;
  }
};

// D = 32 and 128: mma.sync. Shared memory, in order: Q [64][D + 8]; the two
// stages, tiles of [64][D + 8]; the two stages' biases.
template <int D>
constexpr size_t fwd_smem_bytes() {
  return (size_t)(kRows + 4 * kTile) * (D + 8) * sizeof(bf16) + 2 * kTile * sizeof(float);
}

// at D = 32 four blocks an SM hold the registers to 128 a thread
template <int D>
__global__ void __launch_bounds__(kThreads, D == 32 ? 4 : 1) flash_fwd_kernel(const FlashArgs a) {
  constexpr int SD = D + 8, KD = D / 16, ND = D / 8, NT = kTile / 8, TILE = kTile * SD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = sQ + kRows * SD;
  float* sB = reinterpret_cast<float*>(sKV + 4 * TILE);
  const FwdBlock f(a);
  const TileCopier<D, false> copy_k(at<const bf16>(a.k, a.k_s, f.b, f.h), a.k_s[2]);
  const TileCopier<D, false> copy_v(at<const bf16>(a.v, a.v_s, f.b, f.h), a.v_s[2]);
  const uint32_t ring = smem_addr(sKV);
  auto copy_kv = [&](int kt) {
    const uint32_t stage = ring + (kt & 1) * 2 * TILE * (int)sizeof(bf16);
    copy_k.start(stage, kt * kTile, a.Lk);
    copy_v.start(stage + TILE * (int)sizeof(bf16), kt * kTile, a.Lk);
    cp_async_commit();
  };

  copy_rows_async<D>(sQ, at<const bf16>(a.q, a.q_s, f.b, f.h), a.q_s[2], f.row0, kRows, a.Lq,
                     kThreads);
  copy_kv(0);
  if (threadIdx.x < kTile) sB[threadIdx.x] = f.key_bias(threadIdx.x);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KD][4];
  load_q_frags<D>(qf, sQ + f.warp * 16 * SD, f.lane);

  float o[ND][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < ND; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  for (int kt = 0; kt < f.nkt; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt has landed for every thread; tile kt - 1 is consumed
    const bool more = kt + 1 < f.nkt;
    float next_bias = 0.f;
    if (more) {  // the next tile loads while this one multiplies
      copy_kv(kt + 1);
      if (threadIdx.x < kTile) next_bias = f.key_bias((kt + 1) * kTile + threadIdx.x);
    }
    const bf16* sK = sKV + (kt & 1) * 2 * TILE;
    const int key0 = kt * kTile;

    float s[NT][4];
    score_tile<D>(s, qf, sK, NT, f.lane);
    scale_bias(s, sB + (kt & 1) * kTile, f.c, f.t);
    // only a tile that crosses this warp's diagonal needs the mask
    if (a.causal && key0 + kTile - 1 > f.wrow) causal_mask(s, key0, f.wrow, f.g, f.t);
    softmax_step<ND>(s, o, m, l);
    pv_tile<D>(o, s, sK + TILE, NT / 2, f.lane);
    // that stage's biases were last read in iteration kt - 1
    if (more && threadIdx.x < kTile) sB[((kt + 1) & 1) * kTile + threadIdx.x] = next_bias;
  }

  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  store_tile<D>(o, l0 > 0.f ? 1.f / l0 : 1.f, l1 > 0.f ? 1.f / l1 : 1.f, sQ + f.warp * 16 * SD,
                at<bf16>(a.o, a.o_s, f.b, f.h), a.o_s[2], f.wrow, a.Lq, f.lane);
  if (f.t == 0) store_stats(a, f.bh, f.wrow + f.g, m, l0, l1);
}

// ------------------------------------------------------- forward, D = 64, wgmma
// The same loop with the products on Hopper's warpgroup matrix multiply (wgmma):
// the block's four warps are one warpgroup and start S = Q·Kᵀ as four
// wgmma.m64n64k16 (A: the Q tile, B: the K tile, both read by the tensor
// cores straight from shared memory, K-major) and O += P·V as four more (A: P
// in registers, the accumulator layout of S; B: the V tile, MN-major, hence
// transposed by wgmma itself). No ldmatrix and no per-warp copy of K/V
// fragments: the tensor cores read each tile once a block, and the warps'
// scheduler slots go to the softmax. Tiles are stored with the 128-byte swizzle
// and named by matrix descriptors; a row of D = 64 bf16 is exactly one
// 128-byte swizzle row. Inside a block nothing overlaps: it waits for S, runs
// the softmax, waits for P·V. The overlap comes from the blocks that share an
// SM, so the kernel's speed follows their number: 96 registers a thread let
// five of them in. Every block re-reads its head's K and V from the L2 (677
// MB at the cross-encoder's shape, 3.9 times the bytes of the bound).
// (Q fragments kept in registers across the loop as the A operand did not
// survive the compiler, which reused their registers for P: hence Q by
// descriptor.)
constexpr int kWgTile = kTile * 64 * (int)sizeof(bf16);  // bytes of a [64][64] tile
constexpr int kWgMinBlocks = 5;

// byte offset of 16-byte chunk `part` of row `r` in a swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int part) { return r * 128 + ((part ^ (r & 7)) << 4); }

// descriptor of a 128-byte-swizzled tile at a 1024-byte aligned shared
// address (plus an offset along K): 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

// commits the products started so far and waits for them
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving uses of an accumulator across the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

#define ANTMMF_WGMMA_ACC(d)                                                                      \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),     \
      "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), \
      "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), \
      "+f"(d[7][2]), "+f"(d[7][3])
#define ANTMMF_WGMMA_M64N64K16                                                         \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "

// d = a·b (or d += a·b): a warpgroup's m64n64k16 with both operands by
// descriptor, K-major. d[nt][e] is the mma.sync accumulator layout of key
// block nt, each warp its 16 rows.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a, uint64_t b, int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" ANTMMF_WGMMA_M64N64K16
               "%32, %33, p, 1, 1, 0, 0;\n}\n"
               : ANTMMF_WGMMA_ACC(d)
               : "l"(a), "l"(b), "r"(accumulate));
}

// d += a·b with A from registers (each warp its 16 rows, the mma.sync A
// layout) and B MN-major, transposed by wgmma itself
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" ANTMMF_WGMMA_M64N64K16
               "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
               : ANTMMF_WGMMA_ACC(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The warpgroup's 64-row accumulator tile d, rows g and g + 8 scaled by i0
// and i1, rounded to bf16 into a swizzled [64][64] shared-memory tile (each
// warp its own 16 rows, so only the warp syncs) and from there to device
// memory rows row0.. by 16-byte stores; rows at or past L are skipped. No
// product may still read `tile`.
__device__ __forceinline__ void store_acc(const float (&d)[8][4], float i0, float i1,
                                          unsigned char* tile, bf16* out, long long ol, int row0,
                                          int L) {
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    *reinterpret_cast<uint32_t*>(tile + swz(wr + g, nt) + 4 * t) = pack(d[nt][0] * i0, d[nt][1] * i0);
    *reinterpret_cast<uint32_t*>(tile + swz(wr + g + 8, nt) + 4 * t) =
        pack(d[nt][2] * i1, d[nt][3] * i1);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = wr + i * 4 + (lane >> 3), part = lane & 7;
    if (row0 + r < L)
      *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * ol + part * 8) =
          *reinterpret_cast<const uint4*>(tile + swz(r, part));
  }
}

// Shared memory from a 1024-byte aligned base, in order: Q [64][64], the two
// stages, tiles of [64][64] (all swizzled); the two stages' biases. One KB
// more pays for the alignment.
constexpr size_t kWgSmemBytes = 1024 + 5 * kWgTile + 2 * kTile * sizeof(float);

__global__ void __launch_bounds__(kThreads, kWgMinBlocks) flash_fwd_wgmma_kernel(const FlashArgs a) {
  constexpr int D = 64, KD = D / 16, ND = D / 8, NT = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sQ = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t ring = sQ + kWgTile;
  unsigned char* aligned = smem + (sQ - smem_addr(smem));
  float* sB = reinterpret_cast<float*>(aligned + 5 * kWgTile);
  const FwdBlock f(a);
  const TileCopier<D, true> copy_k(at<const bf16>(a.k, a.k_s, f.b, f.h), a.k_s[2]);
  const TileCopier<D, true> copy_v(at<const bf16>(a.v, a.v_s, f.b, f.h), a.v_s[2]);
  auto copy_kv = [&](int kt) {
    const uint32_t stage = ring + (kt & 1) * 2 * kWgTile;
    copy_k.start(stage, kt * kTile, a.Lk);
    copy_v.start(stage + kWgTile, kt * kTile, a.Lk);
    cp_async_commit();
  };

  TileCopier<D, true>(at<const bf16>(a.q, a.q_s, f.b, f.h), a.q_s[2])
      .start(sQ, f.row0, a.Lq);
  copy_kv(0);
  if (threadIdx.x < kTile) sB[threadIdx.x] = f.key_bias(threadIdx.x);
  const uint64_t qd = tile_desc(sQ);

  float o[ND][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < ND; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  for (int kt = 0; kt < f.nkt; ++kt) {
    cp_async_wait<0>();
    // the copies wrote through the generic proxy; the tensor cores read
    // shared memory through the asynchronous one
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tile kt has landed for every thread; tile kt - 1 is consumed
    const bool more = kt + 1 < f.nkt;
    float next_bias = 0.f;
    if (more) {  // the next tile loads while this one multiplies
      copy_kv(kt + 1);
      if (threadIdx.x < kTile) next_bias = f.key_bias((kt + 1) * kTile + threadIdx.x);
    }
    const uint64_t kd = tile_desc(ring + (kt & 1) * 2 * kWgTile), vd = kd + (kWgTile >> 4);
    const int key0 = kt * kTile;

    float s[NT][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)  // 16 of D a step: 32 bytes along the swizzled rows
      wgmma_ss(s, qd + 2 * kk, kd + 2 * kk, kk > 0);
    wgmma_commit_wait();
    fence_regs(s);

    scale_bias(s, sB + (kt & 1) * kTile, f.c, f.t);
    if (a.causal && key0 + kTile - 1 > f.wrow) causal_mask(s, key0, f.wrow, f.g, f.t);
    softmax_step<ND>(s, o, m, l);

    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) pack_p(pa[kk], s, kk);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)  // 16 keys a step: two 8-row groups of the V tile
      wgmma_rs_tb(o, pa[kk], vd + kk * (2048 >> 4));
    wgmma_commit_wait();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)  // P's registers stay P's until the products are done
      asm volatile("" ::"r"(pa[kk][0]), "r"(pa[kk][1]), "r"(pa[kk][2]), "r"(pa[kk][3]));
    // that stage's biases were last read in iteration kt - 1
    if (more && threadIdx.x < kTile) sB[((kt + 1) & 1) * kTile + threadIdx.x] = next_bias;
  }

  // the output leaves through the warp's own 16 Q rows, swizzled alike, once
  // no product reads the Q tile any more
  __syncthreads();
  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  store_acc(o, l0 > 0.f ? 1.f / l0 : 1.f, l1 > 0.f ? 1.f / l1 : 1.f, aligned,
            at<bf16>(a.o, a.o_s, f.b, f.h), a.o_s[2], f.row0, a.Lq);
  if (f.t == 0) store_stats(a, f.bh, f.wrow + f.g, m, l0, l1);
}

// ------------------------------------------------------------ dQ, D = 32
// The first design, kept for D = 32, which no path trains at: tiles
// loaded synchronously into one buffer, scalar fragment loads, mma.sync.
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

// --------------------------------------------------------- dK/dV, D = 32
template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(const FlashArgs a) {
  constexpr int QT = kTile, SD = D + 8, KD = D / 16, ND = D / 8, NT = QT / 8;
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

// ------------------------------------------------------ backward, D = 64, wgmma
// Both kernels take the forward's design: one warpgroup a block owns 64 rows
// of its own operand, resident in swizzled shared memory, and the other
// operand streams through a ring of two cp.async stages with one block
// barrier a tile, so tile i + 1 loads while tile i multiplies. Every product
// is one of the forward's two wgmma forms: by descriptor with both tiles
// K-major (wgmma_ss), or A from registers (the accumulator layout of the
// scores, rounded to bf16) with B MN-major (wgmma_rs_tb). One swizzled copy of
// a [64][64] tile serves both forms. The two products that read only tiles
// start together; the register-A products start 16 deep at a time, as soon
// as their fragments are packed, so the tensor cores work while the next
// fragments are computed; two waits a tile. P is recomputed
// in log2 units, one FMA and one ex2 a score, from the row statistics m and
// log l kept apart (a fully masked row's m is finfo.min: its scaled term is
// clamped at -FLT_MAX as the bias is, so x - m is 0 and the row stays
// uniform; log l then divides). P and dS are rounded to bf16 as the A
// operands, where the JAX kernels round them.
// What holds them back on an H100 (knock-outs at [64, 12, 430, 64]): no
// single pipe. Inside a block the products, the P/dS arithmetic and the
// products that read it run in turn, and only the blocks an SM holds (4 for
// dQ at 128 registers, 3 for dK/dV at about 165) overlap them; the copies
// and barriers alone take about 130 us of L2 traffic (every block re-reads
// its head's other operand, 592 MB). A third ring stage was slower: shared
// memory then caps dQ at 3 blocks an SM, and dK/dV gained nothing.

// m and log l of a query row in log2 units; a row past Lq gets log l = +inf,
// hence P = 0
__device__ __forceinline__ float2 row_terms(const FlashArgs& a, long long row, long long plane,
                                            int r) {
  if (r >= a.Lq) return make_float2(0.f, INFINITY);
  return make_float2(fmaxf(a.stats[row + r] * kLog2e, -FLT_MAX), a.stats[plane + row + r] * kLog2e);
}

// keeps A fragments in their registers until the products that read them are
// waited for (see the forward)
template <int N>
__device__ __forceinline__ void pin(const uint32_t (&f)[N][4]) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk)
    asm volatile("" ::"r"(f[kk][0]), "r"(f[kk][1]), "r"(f[kk][2]), "r"(f[kk][3]));
}

constexpr int kDqMinBlocks = 4, kDkvMinBlocks = 3;  // blocks an SM, by registers

// dQ: 64 query rows a block; Q and dO resident, K/V tiles (with their key
// biases) through the ring. Shared memory from a 1024-byte aligned base: Q,
// dO, the two stages of K and V tiles, the two stages' biases.
constexpr size_t kDqSmemBytes = 1024 + 6 * kWgTile + 2 * kTile * sizeof(float);

__global__ void __launch_bounds__(kThreads, kDqMinBlocks) flash_dq_wgmma_kernel(const FlashArgs a) {
  constexpr int NT = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sQ = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t sDo = sQ + kWgTile, ring = sQ + 2 * kWgTile;
  unsigned char* aligned = smem + (sQ - smem_addr(smem));
  float* sB = reinterpret_cast<float*>(aligned + 6 * kWgTile);
  const FwdBlock f(a);
  const TileCopier<64, true> copy_k(at<const bf16>(a.k, a.k_s, f.b, f.h), a.k_s[2]);
  const TileCopier<64, true> copy_v(at<const bf16>(a.v, a.v_s, f.b, f.h), a.v_s[2]);
  auto copy_kv = [&](int kt) {
    const uint32_t stage = ring + (kt & 1) * 2 * kWgTile;
    copy_k.start(stage, kt * kTile, a.Lk);
    copy_v.start(stage + kWgTile, kt * kTile, a.Lk);
    cp_async_commit();
  };
  const bf16* dout = at<const bf16>(a.dout, a.do_s, f.b, f.h);
  TileCopier<64, true>(at<const bf16>(a.q, a.q_s, f.b, f.h), a.q_s[2]).start(sQ, f.row0, a.Lq);
  TileCopier<64, true>(dout, a.do_s[2]).start(sDo, f.row0, a.Lq);
  copy_kv(0);
  if (threadIdx.x < kTile) sB[threadIdx.x] = f.key_bias(threadIdx.x);

  // delta = rowsum(dO∘O) in fp32 for this thread's rows r0 = wrow + g and
  // r1 = r0 + 8 (the accumulator's), written out for the dK/dV kernel: a
  // quad's lanes take 16 columns each, read from device memory while the
  // tiles are in flight
  const int r0 = f.wrow + f.g, r1 = r0 + 8;
  float d[2];
  {
    const bf16* o = at<const bf16>(a.o, a.o_s, f.b, f.h);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = i ? r1 : r0;
      float acc = 0.f;
      if (r < a.Lq) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const uint4 x = *reinterpret_cast<const uint4*>(dout + r * a.do_s[2] + f.t * 16 + c * 8);
          const uint4 y = *reinterpret_cast<const uint4*>(o + r * a.o_s[2] + f.t * 16 + c * 8);
          const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 u = unpack(xs[e]), w = unpack(ys[e]);
            acc += u.x * w.x + u.y * w.y;
          }
        }
      }
      d[i] = quad_sum(acc);
    }
  }
  const long long row = (long long)f.bh * a.Lq, plane = (long long)a.B * a.H * a.Lq;
  if (f.t == 0) {
    if (r0 < a.Lq) a.delta[row + r0] = d[0];
    if (r1 < a.Lq) a.delta[row + r1] = d[1];
  }
  const float2 st0 = row_terms(a, row, plane, r0), st1 = row_terms(a, row, plane, r1);
  const float ds[2] = {d[0] * a.scale, d[1] * a.scale};  // delta·scale
  const uint64_t qd = tile_desc(sQ), dod = tile_desc(sDo);

  float dq[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.f;

  for (int kt = 0; kt < f.nkt; ++kt) {
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tile kt has landed for every thread; tile kt - 1 is consumed
    const bool more = kt + 1 < f.nkt;
    float next_bias = 0.f;
    if (more) {
      copy_kv(kt + 1);
      if (threadIdx.x < kTile) next_bias = f.key_bias((kt + 1) * kTile + threadIdx.x);
    }
    const int stage = kt & 1;
    const uint64_t kd = tile_desc(ring + stage * 2 * kWgTile), vd = kd + (kWgTile >> 4);
    const int key0 = kt * kTile;

    float s[NT][4], dp[NT][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(s, qd + 2 * kk, kd + 2 * kk, kk > 0);  // S = Q·Kᵀ
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(dp, dod + 2 * kk, vd + 2 * kk, kk > 0);  // dP = dO·Vᵀ
    wgmma_commit_wait();
    fence_regs(s);
    fence_regs(dp);

    scale_bias(s, sB + stage * kTile, f.c, f.t);
    if (a.causal && key0 + kTile - 1 > f.wrow) causal_mask(s, key0, f.wrow, f.g, f.t);
    uint32_t dsa[NT / 2][4];
    fence_regs(dq);
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {  // 16 keys a step; their product starts at once
#pragma unroll
      for (int nt = 2 * kk; nt < 2 * kk + 2; ++nt)  // dS = P∘(dP - delta)·scale, over dP
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 st = e < 2 ? st0 : st1;
          dp[nt][e] = ex2((s[nt][e] - st.x) - st.y) * fmaf(dp[nt][e], a.scale, -ds[e >> 1]);
        }
      pack_p(dsa[kk], dp, kk);
      wgmma_fence();
      wgmma_rs_tb(dq, dsa[kk], kd + kk * (2048 >> 4));  // dQ += dS·K, K MN-major
    }
    wgmma_commit_wait();
    fence_regs(dq);
    pin(dsa);
    // that stage's biases were last read in iteration kt - 1
    if (more && threadIdx.x < kTile) sB[(stage ^ 1) * kTile + threadIdx.x] = next_bias;
  }

  __syncthreads();  // no product reads the Q tile any more
  store_acc(dq, 1.f, 1.f, aligned, at<bf16>(a.dq, a.dq_s, f.b, f.h), a.dq_s[2], f.row0, a.Lq);
}

// dK/dV: 64 keys a block; K and V resident, Q and dO tiles through the ring,
// each stage with its 64 query rows' m, log l (log2 units) and delta·scale. The
// products are transposed: the block computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, whose
// accumulator rows are its keys, so Pᵀ and dSᵀ are already the A operands of
// dV += Pᵀ·dO and dK += dSᵀ·Q, and the Q and dO tiles serve K-major in the
// first two and MN-major in the last two. Shared memory from a 1024-byte
// aligned base: K, V, the two stages of Q and dO tiles, the two stages' rows.
constexpr size_t kDkvSmemBytes = 1024 + 6 * kWgTile + 2 * 3 * kTile * sizeof(float);

__global__ void __launch_bounds__(kThreads, kDkvMinBlocks) flash_dkv_wgmma_kernel(const FlashArgs a) {
  constexpr int NT = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sK = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t sV = sK + kWgTile, ring = sK + 2 * kWgTile;
  unsigned char* aligned = smem + (sK - smem_addr(smem));
  // [stage][m, log l, delta·scale][64]
  float* sRow = reinterpret_cast<float*>(aligned + 6 * kWgTile);
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int key0 = blockIdx.x * kRows, k0 = key0 + (threadIdx.x >> 5) * 16 + g, k1 = k0 + 8;
  const float* bias = a.bias ? a.bias + (long long)b * a.Lk : nullptr;
  auto key_bias = [&](int j) { return j < a.Lk ? (bias ? bias_log2(bias[j]) : 0.f) : -INFINITY; };
  const float bz0 = key_bias(k0), bz1 = key_bias(k1), c = a.scale * kLog2e;
  const long long row = (long long)bh * a.Lq, plane = (long long)a.B * a.H * a.Lq;

  const TileCopier<64, true> copy_q(at<const bf16>(a.q, a.q_s, b, h), a.q_s[2]);
  const TileCopier<64, true> copy_do(at<const bf16>(a.dout, a.do_s, b, h), a.do_s[2]);
  auto copy_qdo = [&](int qt) {
    const uint32_t stage = ring + (qt & 1) * 2 * kWgTile;
    copy_q.start(stage, qt * kTile, a.Lq);
    copy_do.start(stage + kWgTile, qt * kTile, a.Lq);
    cp_async_commit();
  };
  // a stage's rows: threads 0..63 fetch m and log l of one row, 64..127 its
  // delta·scale
  const int rj = threadIdx.x & (kTile - 1);
  auto fetch_rows = [&](int qt) {
    const int r = qt * kTile + rj;
    if (threadIdx.x < kTile) return row_terms(a, row, plane, r);
    return make_float2(r < a.Lq ? a.delta[row + r] * a.scale : 0.f, 0.f);
  };
  auto put_rows = [&](int qt, float2 x) {
    float* st = sRow + (qt & 1) * 3 * kTile;
    if (threadIdx.x < kTile) {
      st[rj] = x.x;
      st[kTile + rj] = x.y;
    } else {
      st[2 * kTile + rj] = x.x;
    }
  };

  const int nqt = (a.Lq + kTile - 1) / kTile;
  // causal: query rows below this block's first key see none of its keys
  const int qt0 = a.causal ? key0 / kTile : 0;
  TileCopier<64, true>(at<const bf16>(a.k, a.k_s, b, h), a.k_s[2]).start(sK, key0, a.Lk);
  TileCopier<64, true>(at<const bf16>(a.v, a.v_s, b, h), a.v_s[2]).start(sV, key0, a.Lk);
  copy_qdo(qt0);
  if (qt0 < nqt) put_rows(qt0, fetch_rows(qt0));
  const uint64_t kd = tile_desc(sK), vd = tile_desc(sV);

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

  for (int qt = qt0; qt < nqt; ++qt) {
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tile qt has landed for every thread; tile qt - 1 is consumed
    const bool more = qt + 1 < nqt;
    float2 next_rows = make_float2(0.f, 0.f);
    if (more) {
      copy_qdo(qt + 1);
      next_rows = fetch_rows(qt + 1);
    }
    const int stage = qt & 1;
    const uint64_t qd = tile_desc(ring + stage * 2 * kWgTile), dod = qd + (kWgTile >> 4);
    const float* st = sRow + stage * 3 * kTile;
    const int q0 = qt * kTile;

    float s[NT][4], dp[NT][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(s, kd + 2 * kk, qd + 2 * kk, kk > 0);  // Sᵀ = K·Qᵀ
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(dp, vd + 2 * kk, dod + 2 * kk, kk > 0);  // dPᵀ = V·dOᵀ
    wgmma_commit_wait();
    fence_regs(s);
    fence_regs(dp);

    // only a tile that crosses this warp's diagonal needs the causal mask
    const bool mask = a.causal && k0 - g + 15 > q0;
    uint32_t pa[NT / 2][4], dsa[NT / 2][4];
    fence_regs(dv);
    fence_regs(dk);
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {  // 16 queries a step; their products start at once
#pragma unroll
      for (int nt = 2 * kk; nt < 2 * kk + 2; ++nt) {
        const int col = nt * 8 + 2 * t;  // this thread's query columns col, col + 1
        const float2 m = *reinterpret_cast<const float2*>(st + col);
        const float2 lg = *reinterpret_cast<const float2*>(st + kTile + col);
        const float2 dl = *reinterpret_cast<const float2*>(st + 2 * kTile + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e & 1;
          float x = fmaf(s[nt][e], c, e < 2 ? bz0 : bz1);
          if (mask && (e < 2 ? k0 : k1) > q0 + col + j) x = -INFINITY;
          const float p = ex2((x - (j ? m.y : m.x)) - (j ? lg.y : lg.x));
          s[nt][e] = p;
          dp[nt][e] = p * fmaf(dp[nt][e], a.scale, -(j ? dl.y : dl.x));  // dSᵀ
        }
      }
      pack_p(pa[kk], s, kk);
      pack_p(dsa[kk], dp, kk);
      wgmma_fence();
      wgmma_rs_tb(dv, pa[kk], dod + kk * (2048 >> 4));  // dV += Pᵀ·dO, dO MN-major
      wgmma_rs_tb(dk, dsa[kk], qd + kk * (2048 >> 4));   // dK += dSᵀ·Q, Q MN-major
    }
    wgmma_commit_wait();
    fence_regs(dv);
    fence_regs(dk);
    pin(pa);
    pin(dsa);
    // that stage's rows were last read in iteration qt - 1
    if (more) put_rows(qt + 1, next_rows);
  }

  cp_async_wait<0>();  // with no query tile to walk the copies were never waited for
  __syncthreads();     // no product reads the K and V tiles any more
  store_acc(dk, 1.f, 1.f, aligned, at<bf16>(a.dk, a.dk_s, b, h), a.dk_s[2], key0, a.Lk);
  store_acc(dv, 1.f, 1.f, aligned + kWgTile, at<bf16>(a.dv, a.dv_s, b, h), a.dv_s[2], key0, a.Lk);
}

// ----------------------------------------------------- backward, D = 128, wgmma
// The D = 64 design above, at D = 128, the width of Pink's causal training step
// [8, 16, 305, 128]. What bounds it there on an H100: about 60 MB of q, k, v,
// dO, O and the gradients a kernel (18 us at 3.35 TB/s) against about 4 us of
// causal products, so loads have to run behind the products.
//   * A row of 128 bf16 is two 128-byte swizzle rows: a [64][128] tile is two
//     swizzled [64][64] slabs (columns 0..63, then 64..127) 8 KB apart
//     (TileCopier<128, true>). Products over D step through both slabs
//     (dstep); products whose N is D run as two n64 wgmma, one a slab, so
//     every B descriptor names one swizzle atom across N, as at D = 64.
//   * Registers: dQ's accumulator [64][128] is 64 a thread beside S and dP.
//     dK and dV for 64 keys are 128 a thread, so flash_dkv computes its
//     transposed scores 32 queries at a time (m64n32) and keeps one
//     warpgroup a block; both kernels fit two blocks an SM (about 98 KB of
//     shared memory each: the resident pair of tiles and a ring of two
//     stages of two tiles).
//   * Work that cannot count is skipped, exactly. A key whose bias is
//     finfo.min (clamped to -FLT_MAX in log2 units) or that lies past Lk
//     scores -FLT_MAX or -inf; in a row whose m lies above -FLT_MAX (hence at
//     least one ulp, 2^104, above it) its exponent is below -2^104, so P and
//     dS are +0 and the products gain nothing. A fully masked row (m =
//     -FLT_MAX) instead gives such keys the uniform weight 1/l. So flash_dq
//     walks only the key tiles with a live key unless a row of its block is
//     fully masked, and flash_dkv writes zeros for a block of 64 dead keys
//     unless a row that sees them is fully masked. Pink's ragged text leaves
//     the last one or two of a sample's five key tiles dead.
//   * The grid puts heads in x and row blocks in y, so a wave holds the same
//     row block of many heads, and under causal the longest blocks start
//     first: dQ's last row block walks the most key tiles, dK/dV's first key
//     block the most query tiles.
constexpr int kWgTile2 = 2 * kWgTile;      // bytes of a [64][128] tile
constexpr int kSlab = kWgTile >> 4;        // the second slab, in descriptor units
constexpr int kRows16 = (16 * 128) >> 4;   // 16 rows of a slab, in descriptor units
constexpr int kBwd128MinBlocks = 2;        // blocks an SM, by shared memory

// descriptor offset of step kk (16 of D) in a two-slab tile
__device__ __forceinline__ int dstep(int kk) { return (kk >> 2) * kSlab + 2 * (kk & 3); }

// d = a·b (or d += a·b): m64n32k16, both operands by descriptor, K-major
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
               "%16, %17, p, 1, 1, 0, 0;\n}\n"
               : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
                 "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
                 "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
                 "+f"(d[3][3])
               : "l"(a), "l"(b), "r"(accumulate));
}

// dQ: as flash_dq_wgmma_kernel, with the live key tiles in a mask. Shared
// memory from a 1024-byte aligned base: Q, dO, the two stages of K and V
// tiles, the two stages' biases, each warp's mask of live tiles.
constexpr size_t kDq128SmemBytes =
    1024 + 6 * kWgTile2 + 2 * kTile * sizeof(float) + 4 * sizeof(uint64_t);

__global__ void __launch_bounds__(kThreads, kBwd128MinBlocks)
    flash_dq128_kernel(const FlashArgs a) {
  constexpr int NT = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sQ = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t sDo = sQ + kWgTile2, ring = sQ + 2 * kWgTile2;
  unsigned char* aligned = smem + (sQ - smem_addr(smem));
  float* sB = reinterpret_cast<float*>(aligned + 6 * kWgTile2);
  uint64_t* sLive = reinterpret_cast<uint64_t*>(sB + 2 * kTile);
  const FwdBlock f(a, blockIdx.x, gridDim.y - 1 - blockIdx.y);  // the last row block first
  const TileCopier<128, true> copy_k(at<const bf16>(a.k, a.k_s, f.b, f.h), a.k_s[2]);
  const TileCopier<128, true> copy_v(at<const bf16>(a.v, a.v_s, f.b, f.h), a.v_s[2]);
  auto copy_kv = [&](int kt, int stage) {
    const uint32_t st = ring + stage * 2 * kWgTile2;
    copy_k.start(st, kt * kTile, a.Lk);
    copy_v.start(st + kWgTile2, kt * kTile, a.Lk);
    cp_async_commit();
  };
  const bf16* dout = at<const bf16>(a.dout, a.do_s, f.b, f.h);
  TileCopier<128, true>(at<const bf16>(a.q, a.q_s, f.b, f.h), a.q_s[2]).start(sQ, f.row0, a.Lq);
  TileCopier<128, true>(dout, a.do_s[2]).start(sDo, f.row0, a.Lq);
  copy_kv(0, 0);  // tile 0 goes first, live or not: a dead tile adds exact zeros
  if (threadIdx.x < kTile) sB[threadIdx.x] = f.key_bias(threadIdx.x);

  // delta = rowsum(dO∘O) in fp32 for rows r0 = wrow + g and r1 = r0 + 8: a
  // quad's lanes take 32 columns each
  const int r0 = f.wrow + f.g, r1 = r0 + 8;
  float d[2];
  {
    const bf16* o = at<const bf16>(a.o, a.o_s, f.b, f.h);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = i ? r1 : r0;
      float acc = 0.f;
      if (r < a.Lq) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint4 x = *reinterpret_cast<const uint4*>(dout + r * a.do_s[2] + f.t * 32 + c * 8);
          const uint4 y = *reinterpret_cast<const uint4*>(o + r * a.o_s[2] + f.t * 32 + c * 8);
          const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 u = unpack(xs[e]), w = unpack(ys[e]);
            acc += u.x * w.x + u.y * w.y;
          }
        }
      }
      d[i] = quad_sum(acc);
    }
  }
  const long long row = (long long)f.bh * a.Lq, plane = (long long)a.B * a.H * a.Lq;
  if (f.t == 0) {
    if (r0 < a.Lq) a.delta[row + r0] = d[0];
    if (r1 < a.Lq) a.delta[row + r1] = d[1];
  }
  const float2 st0 = row_terms(a, row, plane, r0), st1 = row_terms(a, row, plane, r1);
  const float ds[2] = {d[0] * a.scale, d[1] * a.scale};  // delta·scale
  const uint64_t qd = tile_desc(sQ), dod = tile_desc(sDo);

  // bit kt: key tile kt holds a live key (bit 63 stands for every tile from
  // 63 on); all bits when a row of the block is fully masked
  uint64_t live = 0;
  if (!f.bias || st0.x == -FLT_MAX || st1.x == -FLT_MAX) {
    live = ~0ull;
  } else {
    for (int j = threadIdx.x; j < a.Lk; j += kThreads)
      if (f.key_bias(j) > -FLT_MAX) live |= 1ull << min(j / kTile, 63);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) live |= __shfl_xor_sync(0xffffffffu, live, o);
  if (f.lane == 0) sLive[f.warp] = live;

  float dq0[8][4], dq1[8][4];  // columns 0..63 and 64..127
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq0[nt][e] = dq1[nt][e] = 0.f;

  int kt = 0;
  for (int it = 0; kt < f.nkt; ++it) {
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tile kt has landed for every thread; the previous one is consumed
    if (it == 0) live = sLive[0] | sLive[1] | sLive[2] | sLive[3];
    int next = kt + 1;
    while (next < f.nkt && !((live >> min(next, 63)) & 1)) ++next;
    const bool more = next < f.nkt;
    const int stage = it & 1;
    float next_bias = 0.f;
    if (more) {
      copy_kv(next, stage ^ 1);
      if (threadIdx.x < kTile) next_bias = f.key_bias(next * kTile + threadIdx.x);
    }
    const uint64_t kd = tile_desc(ring + stage * 2 * kWgTile2), vd = kd + (kWgTile2 >> 4);
    const int key0 = kt * kTile;

    float s[NT][4], dp[NT][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_ss(s, qd + dstep(kk), kd + dstep(kk), kk > 0);  // S = Q·Kᵀ
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_ss(dp, dod + dstep(kk), vd + dstep(kk), kk > 0);  // dO·Vᵀ
    wgmma_commit_wait();
    fence_regs(s);
    fence_regs(dp);

    scale_bias(s, sB + stage * kTile, f.c, f.t);
    if (a.causal && key0 + kTile - 1 > f.wrow) causal_mask(s, key0, f.wrow, f.g, f.t);
    uint32_t dsa[NT / 2][4];
    fence_regs(dq0);
    fence_regs(dq1);
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {  // 16 keys a step; their products start at once
#pragma unroll
      for (int nt = 2 * kk; nt < 2 * kk + 2; ++nt)  // dS = P∘(dP - delta)·scale, over dP
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 st = e < 2 ? st0 : st1;
          dp[nt][e] = ex2((s[nt][e] - st.x) - st.y) * fmaf(dp[nt][e], a.scale, -ds[e >> 1]);
        }
      pack_p(dsa[kk], dp, kk);
      wgmma_fence();
      wgmma_rs_tb(dq0, dsa[kk], kd + kk * kRows16);  // dQ += dS·K, K MN-major, a slab each
      wgmma_rs_tb(dq1, dsa[kk], kd + kSlab + kk * kRows16);
    }
    wgmma_commit_wait();
    fence_regs(dq0);
    fence_regs(dq1);
    pin(dsa);
    // that stage's biases were last read in the iteration before
    if (more && threadIdx.x < kTile) sB[(stage ^ 1) * kTile + threadIdx.x] = next_bias;
    kt = next;
  }

  __syncthreads();  // no product reads the Q tile any more
  bf16* gq = at<bf16>(a.dq, a.dq_s, f.b, f.h);
  store_acc(dq0, 1.f, 1.f, aligned, gq, a.dq_s[2], f.row0, a.Lq);
  store_acc(dq1, 1.f, 1.f, aligned + kWgTile, gq + 64, a.dq_s[2], f.row0, a.Lq);
}

// dK/dV: as flash_dkv_wgmma_kernel, each 64-query tile in two halves of 32
// (Sᵀ and dPᵀ m64n32, then dV and dK over those 32 queries). Shared memory
// from a 1024-byte aligned base: K, V, the two stages of Q and dO tiles, the
// two stages' rows.
constexpr size_t kDkv128SmemBytes = 1024 + 6 * kWgTile2 + 2 * 3 * kTile * sizeof(float);

__global__ void __launch_bounds__(kThreads, kBwd128MinBlocks)
    flash_dkv128_kernel(const FlashArgs a) {
  constexpr int NH = 4;  // 8-query blocks of a half
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sK = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t sV = sK + kWgTile2, ring = sK + 2 * kWgTile2;
  unsigned char* aligned = smem + (sK - smem_addr(smem));
  float* sRow = reinterpret_cast<float*>(aligned + 6 * kWgTile2);  // [stage][m, log l, delta·scale][64]
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int key0 = blockIdx.y * kRows, k0 = key0 + (threadIdx.x >> 5) * 16 + g, k1 = k0 + 8;
  const float* bias = a.bias ? a.bias + (long long)b * a.Lk : nullptr;
  auto key_bias = [&](int j) { return j < a.Lk ? (bias ? bias_log2(bias[j]) : 0.f) : -INFINITY; };
  const float bz0 = key_bias(k0), bz1 = key_bias(k1), c = a.scale * kLog2e;
  const long long row = (long long)bh * a.Lq, plane = (long long)a.B * a.H * a.Lq;
  bf16* gk = at<bf16>(a.dk, a.dk_s, b, h);
  bf16* gv = at<bf16>(a.dv, a.dv_s, b, h);
  const int qt0 = a.causal ? key0 / kTile : 0;  // causal: earlier rows see none of these keys

  // 64 dead keys (see above): their gradients are 0 unless a row that sees
  // them is fully masked
  if (__syncthreads_and(bz0 <= -FLT_MAX && bz1 <= -FLT_MAX)) {
    bool full = false;
    for (int r = qt0 * kTile + threadIdx.x; r < a.Lq; r += kThreads)
      full |= row_terms(a, row, plane, r).x == -FLT_MAX;
    if (!__syncthreads_or(full)) {
      for (int i = threadIdx.x; i < kRows * 16; i += kThreads) {
        const int r = key0 + i / 16, part = i % 16;
        if (r < a.Lk) {
          *reinterpret_cast<uint4*>(gk + r * a.dk_s[2] + part * 8) = make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(gv + r * a.dv_s[2] + part * 8) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      return;
    }
  }

  const TileCopier<128, true> copy_q(at<const bf16>(a.q, a.q_s, b, h), a.q_s[2]);
  const TileCopier<128, true> copy_do(at<const bf16>(a.dout, a.do_s, b, h), a.do_s[2]);
  auto copy_qdo = [&](int qt) {
    const uint32_t stage = ring + (qt & 1) * 2 * kWgTile2;
    copy_q.start(stage, qt * kTile, a.Lq);
    copy_do.start(stage + kWgTile2, qt * kTile, a.Lq);
    cp_async_commit();
  };
  // a stage's rows: threads 0..63 fetch m and log l of one row, 64..127 its
  // delta·scale
  const int rj = threadIdx.x & (kTile - 1);
  auto fetch_rows = [&](int qt) {
    const int r = qt * kTile + rj;
    if (threadIdx.x < kTile) return row_terms(a, row, plane, r);
    return make_float2(r < a.Lq ? a.delta[row + r] * a.scale : 0.f, 0.f);
  };
  auto put_rows = [&](int qt, float2 x) {
    float* st = sRow + (qt & 1) * 3 * kTile;
    if (threadIdx.x < kTile) {
      st[rj] = x.x;
      st[kTile + rj] = x.y;
    } else {
      st[2 * kTile + rj] = x.x;
    }
  };

  const int nqt = (a.Lq + kTile - 1) / kTile;
  TileCopier<128, true>(at<const bf16>(a.k, a.k_s, b, h), a.k_s[2]).start(sK, key0, a.Lk);
  TileCopier<128, true>(at<const bf16>(a.v, a.v_s, b, h), a.v_s[2]).start(sV, key0, a.Lk);
  copy_qdo(qt0);
  if (qt0 < nqt) put_rows(qt0, fetch_rows(qt0));
  const uint64_t kd = tile_desc(sK), vd = tile_desc(sV);

  float dk0[8][4], dk1[8][4], dv0[8][4], dv1[8][4];  // columns 0..63 and 64..127
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk0[nt][e] = dk1[nt][e] = dv0[nt][e] = dv1[nt][e] = 0.f;

  for (int qt = qt0; qt < nqt; ++qt) {
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tile qt has landed for every thread; tile qt - 1 is consumed
    const bool more = qt + 1 < nqt;
    float2 next_rows = make_float2(0.f, 0.f);
    if (more) {
      copy_qdo(qt + 1);
      next_rows = fetch_rows(qt + 1);
    }
    const int stage = qt & 1;
    const uint64_t qd = tile_desc(ring + stage * 2 * kWgTile2), dod = qd + (kWgTile2 >> 4);
    const float* st = sRow + stage * 3 * kTile;

#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int q0 = qt * kTile + half * 32;  // this half's first query
      if (q0 >= a.Lq) break;                  // rows past Lq have P = 0
      const uint64_t qh = qd + half * 2 * kRows16, doh = dod + half * 2 * kRows16;
      float s[NH][4], dp[NH][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_ss_n32(s, kd + dstep(kk), qh + dstep(kk), kk > 0);  // Sᵀ
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_ss_n32(dp, vd + dstep(kk), doh + dstep(kk), kk > 0);  // dPᵀ
      wgmma_commit_wait();
      fence_regs(s);
      fence_regs(dp);

      // only a half that crosses this warp's diagonal needs the causal mask
      const bool mask = a.causal && k0 - g + 15 > q0;
      uint32_t pa[NH / 2][4], dsa[NH / 2][4];
      fence_regs(dv0);
      fence_regs(dv1);
      fence_regs(dk0);
      fence_regs(dk1);
#pragma unroll
      for (int kk = 0; kk < NH / 2; ++kk) {  // 16 queries a step; their products start at once
#pragma unroll
        for (int nt = 2 * kk; nt < 2 * kk + 2; ++nt) {
          const int col = half * 32 + nt * 8 + 2 * t;  // this thread's columns of the tile
          const float2 m = *reinterpret_cast<const float2*>(st + col);
          const float2 lg = *reinterpret_cast<const float2*>(st + kTile + col);
          const float2 dl = *reinterpret_cast<const float2*>(st + 2 * kTile + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = e & 1;
            float x = fmaf(s[nt][e], c, e < 2 ? bz0 : bz1);
            if (mask && (e < 2 ? k0 : k1) > qt * kTile + col + j) x = -INFINITY;
            const float p = ex2((x - (j ? m.y : m.x)) - (j ? lg.y : lg.x));
            s[nt][e] = p;
            dp[nt][e] = p * fmaf(dp[nt][e], a.scale, -(j ? dl.y : dl.x));  // dSᵀ
          }
        }
        pack_p(pa[kk], s, kk);
        pack_p(dsa[kk], dp, kk);
        const int rows = (half * 2 + kk) * kRows16;  // these 16 queries' rows of the tiles
        wgmma_fence();
        wgmma_rs_tb(dv0, pa[kk], dod + rows);  // dV += Pᵀ·dO, dO MN-major, a slab each
        wgmma_rs_tb(dv1, pa[kk], dod + kSlab + rows);
        wgmma_rs_tb(dk0, dsa[kk], qd + rows);  // dK += dSᵀ·Q, Q MN-major
        wgmma_rs_tb(dk1, dsa[kk], qd + kSlab + rows);
      }
      wgmma_commit_wait();
      fence_regs(dv0);
      fence_regs(dv1);
      fence_regs(dk0);
      fence_regs(dk1);
      pin(pa);
      pin(dsa);
    }
    // that stage's rows were last read in iteration qt - 1
    if (more) put_rows(qt + 1, next_rows);
  }

  cp_async_wait<0>();  // with no query tile to walk the copies were never waited for
  __syncthreads();     // no product reads the K and V tiles any more
  store_acc(dk0, 1.f, 1.f, aligned, gk, a.dk_s[2], key0, a.Lk);
  store_acc(dk1, 1.f, 1.f, aligned + kWgTile, gk + 64, a.dk_s[2], key0, a.Lk);
  store_acc(dv0, 1.f, 1.f, aligned + kWgTile2, gv, a.dv_s[2], key0, a.Lk);
  store_acc(dv1, 1.f, 1.f, aligned + kWgTile2 + kWgTile, gv + 64, a.dv_s[2], key0, a.Lk);
}

bool takes(const FlashArgs* a) {
  return a->B >= 1 && a->H >= 1 && a->Lq >= 1 && a->Lk >= 1 && (long long)a->B * a->H <= 65535;
}

// one block for each 64 rows of L (query rows, or keys for dK/dV) and head
template <typename Kernel>
int launch_rows(Kernel kernel, size_t smem, int L, const FlashArgs& a, cudaStream_t s) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + kRows - 1) / kRows, a.B * a.H);
  kernel<<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// the same with heads in x and the row blocks in y
template <typename Kernel>
int launch_heads(Kernel kernel, size_t smem, int L, const FlashArgs& a, cudaStream_t s) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B * a.H, (L + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// D = 64 takes the wgmma kernels; D = 128 the mma.sync forward and the wgmma
// backward; D = 32 the mma.sync ones
template <int D>
int launch(int which, const FlashArgs& a, cudaStream_t s) {
  if constexpr (D == 64) {
    if (which == 0) return launch_rows(flash_fwd_wgmma_kernel, kWgSmemBytes, a.Lq, a, s);
    if (which == 1) return launch_rows(flash_dq_wgmma_kernel, kDqSmemBytes, a.Lq, a, s);
    return launch_rows(flash_dkv_wgmma_kernel, kDkvSmemBytes, a.Lk, a, s);
  } else if constexpr (D == 128) {
    if (which == 0) return launch_rows(flash_fwd_kernel<D>, fwd_smem_bytes<D>(), a.Lq, a, s);
    if (which == 1) return launch_heads(flash_dq128_kernel, kDq128SmemBytes, a.Lq, a, s);
    return launch_heads(flash_dkv128_kernel, kDkv128SmemBytes, a.Lk, a, s);
  } else {
    if (which == 0) return launch_rows(flash_fwd_kernel<D>, fwd_smem_bytes<D>(), a.Lq, a, s);
    if (which == 1) return launch_rows(flash_dq_kernel<D>, 0, a.Lq, a, s);
    return launch_rows(flash_dkv_kernel<D>, 0, a.Lk, a, s);
  }
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
