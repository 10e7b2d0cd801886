// Weight-only group-int4 GEMV for decode-sized inputs (N <= 32 rows), sm_90a.
//
// Replaces the TPU kernel `_gemv_kernel` / `int4_gemv` of
// antmmf_tpu/ops/pallas/int4_matmul.py. For x [N, in_x], packed uint8
// [in/2, out] and scale fp32 [in/group, out] it computes, in fp32,
//
//   y[n, o] = sum_g scale[g, o] * sum_{r in g} x[n, r] * q[r, o]
//
// where byte (r, o) holds q[r, o] + 8 in its low nibble and q[r + in/2, o] as
// a signed two's-complement high nibble (`pack_int4`). The scale multiplies a
// group's partial sum, never a single weight. Columns of x past in_x (records
// padded with zero rows) read as 0.
//
// What bounds it on an H100: bytes, and at decode sizes the latency of
// fetching them. A decode step reads every packed weight once (in*out/2 bytes
// plus the scales) and does 2 flops per weight; at N <= 32 that is far below
// the 295 flop/byte at which the tensor cores would matter, so the kernel
// runs on the CUDA cores. Most of a step's weights come in 0.5-6 MB records,
// which the card reads in well under a microsecond if every byte is asked
// for at once: the design is about the geometry that does so, and about
// keeping the work after the last byte arrives short.
//
// Design:
//  * Full sectors. A lane loads VEC = 16 bytes (16 columns) of a packed row
//    with one vector load; LPR lanes side by side read a stretch of LPR*VEC
//    contiguous bytes of a row (128, narrowed to 64 or 32 where the grid
//    would leave SMs idle: never less than a 32-byte sector), so a warp
//    reads 32/LPR rows of a column tile per load. VEC drops to 8 or 4 bytes
//    only where fout (or the pointer) is not aligned to 16, or where more
//    rows of x a block need the registers. Columns past fout are masked in
//    the kernel.
//  * K split over a cluster. The packed rows are cut into S <= 8 chunks, one
//    block of a thread-block cluster each, until the grid has two blocks an
//    SM; every decode record but lm_head takes S = 8 at N = 1. Inside a block
//    the 4 warps' row lanes ("slots") split the chunk again into contiguous
//    slabs of rows.
//  * Weights in flight first. Every lane issues its first batch of 8 packed
//    rows; then the block stages its chunk's scale rows for the tile (each
//    element once) and its chunk's rows of x (both halves, as fp32) in
//    shared memory, up to 8 loads a thread in flight.
//  * Nibbles are unpacked in registers by the 2^23 bit trick: a byte
//    permute moves each nibble under the exponent of 2^23, and one
//    subtraction takes away 2^23 and the low nibble's +8 (the high nibble is
//    flipped to offset form before).
//  * Group partial sums live in registers and are flushed into the
//    accumulator with the group's scale where a slab crosses a group
//    boundary; the low and high halves track their own boundaries, so any
//    group that divides `in` works, also one that does not divide in/2.
//  * A fixed summation order, no float atomics: the slots of a warp by a
//    shuffle butterfly, the 4 warps of a block through shared memory in
//    order, then each block writes its partial into the shared memory of
//    the cluster block that owns that share of the columns; after one
//    cluster barrier the owner sums the S partials in rank order and writes
//    y once. The result is bit-identical from run to run.
//  * Rows of x are handled NB (1, 2 or 4) at a time: every weight loaded is
//    applied to NB rows; further row batches are blocks of their own that
//    read the same weights again from the L2.
//
// Tried on an H100 and dropped (PERF.md §6): 8 warps a block, 16 rows in
// flight a lane, S <= 4, two blocks an SM by narrow tiles, a cluster
// scheduling preference, the batch processed in runs between group
// boundaries (the compiler hoisted every row's unpack: 254 registers).
//
// Plain C interface for ctypes; launches on the given stream, allocates and
// synchronises nothing, returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;               // warps a block
constexpr int kMaxVec = 16;             // bytes a lane loads from a packed row
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 8;               // packed rows a lane has in flight
constexpr int kStage = 8;               // loads a thread has in flight staging x and scales
constexpr int kMaxChunks = 8;           // blocks of a cluster (the K split)
constexpr int kSplitBlocksPerSm = 2;    // K is split until the grid has this many blocks an SM
constexpr int kFillBlocksPerSm = 1;     // the tile narrows while the grid has fewer blocks an SM
constexpr int kTileBytes = 128;         // widest stretch of a packed row a tile reads
constexpr int kMinTileBytes = 32;       // one full sector
constexpr int kMinChunkRows = 64;       // packed rows a chunk keeps at least
constexpr int kMaxRows = 32;            // GEMV_MAX_ROWS of the Python wrapper
constexpr int kSmemMax = 200 * 1024;    // for x: one row of all of `in`, as before
constexpr int kScaleSmemMax = 16 * 1024;  // staged scale rows; more are read in place

struct Gemv {
  const void* x;
  long long x_stride;
  const uint8_t* packed;
  const float* scale;
  float* y;
  int N, fin_x, half, fout, group;
  int lpr;             // lanes side by side on a packed row
  int chunks;          // S: blocks of a cluster, each a chunk of the rows
  int rows_per_chunk;
  int stage_scales;    // 1: a chunk's scale rows are staged in shared memory; 0: read in place
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// VEC bytes of read-only data, not kept in L1 (every byte is read once).
// Volatile, so that the loads issued before staging x stay before it.
template <int VEC>
__device__ __forceinline__ void load_nc(uint32_t (&w)[VEC / 4], const void* p) {
  if constexpr (VEC == 16) {
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3]) : "l"(p));
  } else if constexpr (VEC == 8) {
    asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
                 : "=r"(w[0]), "=r"(w[1]) : "l"(p));
  } else {
    asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(w[0]) : "l"(p));
  }
}

// 4 packed bytes -> the 4 low-nibble weights (q + 8 stored; q returned) and
// the 4 signed high-nibble weights, as floats. 0x4B000000 is 2^23: a byte
// permute puts each nibble under that exponent, and subtracting 2^23 + 8
// converts exactly. The high nibble s (two's complement) is stored as u;
// u ^ 8 = s + 8, so both halves take the same subtraction.
__device__ __forceinline__ void unpack4(uint32_t w, float lo[4], float hi[4]) {
  constexpr float kBias = 8388608.0f + 8.0f;  // 2^23 + 8, exact in fp32
  const uint32_t l = w & 0x0F0F0F0Fu;
  const uint32_t h = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo[j] = __uint_as_float(__byte_perm(l, 0x4B000000u, 0x7540u + j)) - kBias;
    hi[j] = __uint_as_float(__byte_perm(h, 0x4B000000u, 0x7540u + j)) - kBias;
  }
}

// Element i < n of a block-wide copy into shared memory: load(i) for up to
// kStage elements a thread, all in flight, then store(i, value) for each.
template <typename Load, typename Store>
__device__ __forceinline__ void stage(int n, Load load, Store store) {
  for (int i0 = threadIdx.x; i0 < n; i0 += kStage * kThreads) {
    decltype(load(0)) v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u)
      if (i0 + u * kThreads < n) v[u] = load(i0 + u * kThreads);
#pragma unroll
    for (int u = 0; u < kStage; ++u)
      if (i0 + u * kThreads < n) store(i0 + u * kThreads, v[u]);
  }
}

template <int VEC, int NB, typename XT>
__global__ void __launch_bounds__(kThreads) int4_gemv_kernel(const Gemv a) {
  constexpr int kWords = VEC / 4;
  extern __shared__ float smem[];
  const int tile_cols = a.lpr * VEC;
  const int rows_per_warp = 32 / a.lpr;
  const int slots = kWarps * rows_per_warp;
  const int rpc = a.rows_per_chunk;
  float* xs = smem;                             // x [NB][2][rpc]: the chunk's rows, both halves
  float* red = xs + ((NB * 2 * rpc + 3) & ~3);  // warp partials [kWarps][NB][tile_cols]
  float* part = red + kWarps * NB * tile_cols;  // the ranks' partials of this block's share
  float* ss = part + NB * tile_cols + kMaxChunks;  // scale rows [groups][tile_cols]

  cg::cluster_group cluster = cg::this_cluster();
  const int chunk = (int)cluster.block_rank();  // blockIdx.x % chunks: the K chunk
  const int tile = blockIdx.x / a.chunks;
  const int n0 = blockIdx.y * NB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = (lane % a.lpr) * VEC;           // first column of the lane in the tile
  const long long col = (long long)tile * tile_cols + c;
  const int c0 = chunk * rpc, c1 = min(a.half, c0 + rpc);
  const int rows_per_slot = (rpc + slots - 1) / slots;
  const int r0 = c0 + (warp * rows_per_warp + lane / a.lpr) * rows_per_slot;
  const int r1 = min(c1, r0 + rows_per_slot);
  const bool active = col < a.fout && r0 < r1;
  const uint8_t* wp = a.packed + col;

  // the cluster's blocks mark that they have started (the partials below
  // are written into other blocks' shared memory)
  if (a.chunks > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  // the first weights in flight before anything else
  uint32_t w[kBatch][kWords];
  auto load_batch = [&](int rb) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (rb + u < r1) {
        load_nc<VEC>(w[u], wp + (long long)(rb + u) * a.fout);
      } else {
#pragma unroll
        for (int k = 0; k < kWords; ++k) w[u][k] = 0u;
      }
    }
  };
  if (active) load_batch(r0);

  // then the chunk's scale rows for the tile (low groups, then high ones),
  // each element once a block, and the chunk's rows of x
  const int glo0 = c0 / a.group, ghi0 = (c0 + a.half) / a.group;
  const int n_lo = c0 < c1 ? (c1 - 1) / a.group - glo0 + 1 : 0;
  const int n_hi = c0 < c1 ? (c1 - 1 + a.half) / a.group - ghi0 + 1 : 0;
  if (a.stage_scales) {
    const int qs = __ffs(tile_cols / 4) - 1;  // log2 of the float4s a scale row of the tile holds
    stage((n_lo + n_hi) << qs, [&](int i) {
      const int k = i >> qs, q = i - (k << qs);
      const int g = k < n_lo ? glo0 + k : ghi0 + k - n_lo;
      const long long o = (long long)tile * tile_cols + 4 * q;
      return o < a.fout ? __ldg(reinterpret_cast<const float4*>(a.scale + (long long)g * a.fout + o))
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }, [&](int i, float4 v) { reinterpret_cast<float4*>(ss)[i] = v; });
  }
  // the VEC scales of group g of the low (hi = 0) or high half at the lane's columns
  auto scales = [&](int g, int hi) {
    return a.stage_scales ? ss + (hi ? n_lo + g - ghi0 : g - glo0) * tile_cols + c
                           : a.scale + (long long)g * a.fout + col;
  };
  const XT* x = static_cast<const XT*>(a.x);
  stage(NB * 2 * rpc, [&](int i) {
    const int n = NB == 1 ? 0 : i / (2 * rpc), k = i - n * 2 * rpc;
    const int h = k >= rpc, rr = k - h * rpc;
    const int xc = c0 + rr + h * a.half;
    return n0 + n < a.N && c0 + rr < c1 && xc < a.fin_x
        ? to_float(__ldg(x + (long long)(n0 + n) * a.x_stride + xc)) : 0.0f;
  }, [&](int i, float v) { xs[i] = v; });
  __syncthreads();

  float acc[NB][VEC], plo[NB][VEC], phi[NB][VEC];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[n][j] = plo[n][j] = phi[n][j] = 0.0f;
  auto flush = [&](float (&p)[NB][VEC], const float* sp) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 s4 = *reinterpret_cast<const float4*>(sp + 4 * q);
      const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[n][4 * q + j] = fmaf(s[j], p[n][4 * q + j], acc[n][4 * q + j]);
          p[n][4 * q + j] = 0.0f;
        }
    }
  };

  if (active) {
    int g_lo = r0 / a.group, g_hi = (r0 + a.half) / a.group;
    int next_lo = (g_lo + 1) * a.group;           // packed row where the low group changes
    int next_hi = (g_hi + 1) * a.group - a.half;  // ... and the high one
    for (int rb = r0; rb < r1; rb += kBatch) {
      if (rb != r0) load_batch(rb);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r = rb + u;
        if (r < r1) {
          if (r == next_lo) {
            flush(plo, scales(g_lo++, 0));
            next_lo += a.group;
          }
          if (r == next_hi) {
            flush(phi, scales(g_hi++, 1));
            next_hi += a.group;
          }
          float xl[NB], xh[NB];
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            xl[n] = xs[n * 2 * rpc + r - c0];
            xh[n] = xs[n * 2 * rpc + rpc + r - c0];
          }
#pragma unroll
          for (int k = 0; k < kWords; ++k) {
            float lo[4], hi[4];
            unpack4(w[u][k], lo, hi);
#pragma unroll
            for (int n = 0; n < NB; ++n)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                plo[n][4 * k + j] = fmaf(xl[n], lo[j], plo[n][4 * k + j]);
                phi[n][4 * k + j] = fmaf(xh[n], hi[j], phi[n][4 * k + j]);
              }
          }
        }
      }
    }
    flush(plo, scales(g_lo, 0));
    flush(phi, scales(g_hi, 1));
  }

  // the slots of a warp (lanes LPR apart share columns): a butterfly
  for (int off = a.lpr; off < 32; off <<= 1)
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[n][j] += __shfl_xor_sync(0xffffffffu, acc[n][j], off);
  if (lane < a.lpr)
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int j = 0; j < VEC; ++j) red[(warp * NB + n) * tile_cols + c + j] = acc[n][j];
  __syncthreads();

  auto store = [&](int i, float v) {
    const int n = i / tile_cols;
    const long long o = (long long)tile * tile_cols + (i - n * tile_cols);
    if (n0 + n < a.N && o < a.fout) a.y[(long long)(n0 + n) * a.fout + o] = v;
  };
  // the warps of the block, in order; with a K split, each block's partial
  // goes to the cluster block that owns its share of the columns
  const int per = (NB * tile_cols + a.chunks - 1) / a.chunks;
  if (a.chunks > 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  for (int i = threadIdx.x; i < NB * tile_cols; i += kThreads) {
    float v = red[i];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) v += red[k * NB * tile_cols + i];
    if (a.chunks == 1) {
      store(i, v);
    } else {
      const int owner = i / per;
      cluster.map_shared_rank(part, owner)[chunk * per + i - owner * per] = v;
    }
  }
  if (a.chunks > 1) {
    // a cluster barrier (the writes above are released, the owner acquires
    // them), then each block sums its share over the ranks, in rank order
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    const int end = min(NB * tile_cols - chunk * per, per);
    for (int j = threadIdx.x; j < end; j += kThreads) {
      float v = part[j];
      for (int k = 1; k < a.chunks; ++k) v += part[k * per + j];
      store(chunk * per + j, v);
    }
  }
}

template <int VEC, int NB, typename XT>
int launch(const Gemv& a, unsigned tiles, unsigned row_batches, size_t smem,
           cudaStream_t stream) {
  auto kernel = int4_gemv_kernel<VEC, NB, XT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * a.chunks, row_batches, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.chunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename XT>
int launch_vec(int vec, int nb, const Gemv& a, unsigned tiles, unsigned row_batches,
               size_t smem, cudaStream_t s) {
  switch (vec) {
    case 16:
      return nb == 1 ? launch<16, 1, XT>(a, tiles, row_batches, smem, s)
                     : launch<16, 2, XT>(a, tiles, row_batches, smem, s);
    case 8:
      return nb == 1 ? launch<8, 1, XT>(a, tiles, row_batches, smem, s)
           : nb == 2 ? launch<8, 2, XT>(a, tiles, row_batches, smem, s)
                     : launch<8, 4, XT>(a, tiles, row_batches, smem, s);
    default:
      return nb == 1 ? launch<4, 1, XT>(a, tiles, row_batches, smem, s)
           : nb == 2 ? launch<4, 2, XT>(a, tiles, row_batches, smem, s)
                     : launch<4, 4, XT>(a, tiles, row_batches, smem, s);
  }
}

}  // namespace

// x [N, fin_x] (bf16 if x_is_bf16 else fp32, unit stride over columns,
// x_stride elements between rows), packed [half, fout] uint8, scale
// [2*half/group, fout] fp32, y [N, fout] fp32 (contiguous). Refuses, with
// cudaErrorInvalidValue and without launching: N outside 1..32, fout not a
// multiple of 4, a group that does not divide 2*half, fin_x past 2*half,
// misaligned packed/scale pointers, and an x too wide to stage one row of
// it in shared memory (2*half past 51,200).
extern "C" int antmmf_int4_gemv(const void* x, long long x_stride, const void* packed,
                                const void* scale, void* y, int N, int fin_x, int half,
                                int fout, int group, int x_is_bf16, void* stream) {
  const uintptr_t pa = reinterpret_cast<uintptr_t>(packed);
  if (N < 1 || N > kMaxRows || half < 1 || fout < 4 || fout % 4 || group < 1 ||
      (2 * half) % group || fin_x < 1 || fin_x > 2 * half || pa % 4 ||
      reinterpret_cast<uintptr_t>(scale) % 16 || (size_t)2 * half * sizeof(float) > kSmemMax)
    return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  // rows of x a block, and the widest load fout and the pointer allow; the
  // registers hold VEC * NB <= 32 columns-by-rows a lane
  int nb = N >= 3 ? 4 : N;
  int vec = kMaxVec;
  while (fout % vec || pa % vec || vec * nb > 32) vec /= 2;
  Gemv a{x, x_stride, static_cast<const uint8_t*>(packed), static_cast<const float*>(scale),
         static_cast<float*>(y), N, fin_x, half, fout, group, 0, 0, 0, 0};
  for (;;) {
    // split K, then narrow the tile, until the grid has about two blocks an SM
    const unsigned row_batches = (unsigned)((N + nb - 1) / nb);
    a.lpr = kTileBytes / vec;
    a.chunks = 1;
    auto tiles = [&] { return (unsigned)((fout + a.lpr * vec - 1) / (a.lpr * vec)); };
    auto blocks = [&] { return (long long)tiles() * a.chunks * row_batches; };
    while (blocks() < (long long)kSplitBlocksPerSm * sms && a.chunks < kMaxChunks &&
           half / (2 * a.chunks) >= kMinChunkRows)
      a.chunks *= 2;
    while (blocks() < (long long)kFillBlocksPerSm * sms && a.lpr * vec > kMinTileBytes)
      a.lpr /= 2;
    a.rows_per_chunk = (half + a.chunks - 1) / a.chunks;
    const size_t tile_cols = (size_t)a.lpr * vec;
    // the scale rows a chunk can touch: both halves, a group boundary each
    const size_t groups = 2 * (size_t)((a.rows_per_chunk + group - 2) / group + 1);
    a.stage_scales = groups * tile_cols * sizeof(float) <= kScaleSmemMax;
    const size_t smem = sizeof(float) * (((size_t)nb * 2 * a.rows_per_chunk + 3) / 4 * 4 +
                                         (size_t)(kWarps + 1) * nb * tile_cols + kMaxChunks +
                                         (a.stage_scales ? groups * tile_cols : 0));
    if (smem > kSmemMax + 24 * 1024 && nb > 1) {  // x of fewer rows, then
      nb /= 2;
      continue;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return x_is_bf16 ? launch_vec<__nv_bfloat16>(vec, nb, a, tiles(), row_batches, smem, s)
                     : launch_vec<float>(vec, nb, a, tiles(), row_batches, smem, s);
  }
}
