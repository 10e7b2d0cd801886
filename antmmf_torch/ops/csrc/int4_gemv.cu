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
// What bounds it on an H100: bytes. A decode step reads every packed weight
// once (in*out/2 bytes plus the scales) and does 2 flops per weight; at
// N <= 32 that is far below the 295 flop/byte at which the tensor cores
// would matter, so the design is about streaming the packed bytes once and
// unpacking them in registers between the load and the FMA.
//
// Design (a first, simple version):
//  * A block of 512 threads owns a tile of 4*LPR output columns and all of K.
//    LPR lanes of a warp sit side by side on one packed row, each loading 4
//    bytes (4 columns), so a warp reads 32/LPR rows of 4*LPR contiguous bytes
//    per load. The entry point picks the widest LPR of {32, 16, 8, 4} that
//    still gives at least one block per SM.
//  * The 16 warps split the packed rows into contiguous slabs ("slots"), and
//    each thread keeps 8 independent 4-byte loads in flight.
//  * Nibbles are unpacked with shifts and masks and turned into floats by the
//    2^23 bit trick (no int-to-float conversion); the low nibble's +8 and the
//    high nibble's sign are folded into one subtraction.
//  * x is staged once per block in shared memory as fp32; every lane of a
//    row reads the same word (a broadcast).
//  * Group partial sums live in registers and are flushed into the
//    accumulator with the group's scale whenever a slab crosses a group
//    boundary; the low and high halves track their own boundaries, so any
//    group that divides `in` works, also one that does not divide in/2.
//  * Slots are reduced through shared memory in a fixed order: the result is
//    deterministic, and no atomics or second pass are needed.
//  * Rows of x are handled NB (1, 2 or 4) at a time; the blocks that share a
//    column tile are neighbours in the grid, so the tile's weights are
//    re-read from the L2 and not from device memory.
//
// Plain C interface for ctypes; launches on the given stream, allocates and
// synchronises nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;
constexpr int kMaxRows = 32;            // GEMV_MAX_ROWS of the Python wrapper
constexpr int kSmemMax = 200 * 1024;    // of the 227 KB a block may use

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// 4 packed bytes -> the 4 low-nibble weights (q + 8 stored; q returned) and
// the 4 signed high-nibble weights, as floats. 0x4B000000 is 2^23: OR-ing a
// small integer into its mantissa and subtracting 2^23 converts exactly.
__device__ __forceinline__ void unpack4(uint32_t w, float lo[4], float hi[4]) {
  constexpr float kBias = 8388608.0f + 8.0f;  // 2^23 + 8, exact in fp32
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t b = w >> (8 * j);
    lo[j] = __uint_as_float(0x4B000000u | (b & 0xFu)) - kBias;
    // signed nibble s = ((u ^ 8) - 8) for the stored two's-complement u
    hi[j] = __uint_as_float(0x4B000000u | (((b >> 4) & 0xFu) ^ 8u)) - kBias;
  }
}

template <int LPR, int NB, typename XT>
__global__ void __launch_bounds__(kThreads)
int4_gemv_kernel(const XT* __restrict__ x, long long x_stride,
                 const uint8_t* __restrict__ packed, const float* __restrict__ scale,
                 float* __restrict__ y, int N, int fin_x, int half, int fout, int group,
                 int row_blocks) {
  constexpr int kSlotsPerWarp = 32 / LPR;
  constexpr int kSlots = kWarps * kSlotsPerWarp;
  constexpr int kTileCols = 4 * LPR;
  extern __shared__ float smem[];  // x as fp32 [NB, 2*half]; later the slot partials

  const int fin = 2 * half;
  const int tile = blockIdx.x / row_blocks;
  const int n0 = (blockIdx.x - tile * row_blocks) * NB;
  for (int i = threadIdx.x; i < NB * fin; i += kThreads) {
    const int n = i / fin, r = i - n * fin;
    float v = 0.0f;
    if (n0 + n < N && r < fin_x) v = to_float(x[(long long)(n0 + n) * x_stride + r]);
    smem[i] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = warp * kSlotsPerWarp + lane / LPR;
  const int tile_col = (lane % LPR) * 4;
  const long long col = (long long)tile * kTileCols + tile_col;
  const int rows_per_slot = (half + kSlots - 1) / kSlots;
  const int r0 = slot * rows_per_slot;
  const int r1 = min(half, r0 + rows_per_slot);

  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.0f;

  if (col < fout && r0 < r1) {
    float plo[NB][4], phi[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) plo[n][j] = phi[n][j] = 0.0f;

    // scale rows of the two halves, and the packed row at which each changes
    int g_lo = r0 / group, g_hi = (r0 + half) / group;
    int next_lo = (g_lo + 1) * group, next_hi = (g_hi + 1) * group - half;
    const uint8_t* wp = packed + col;

    auto flush = [&](float (&part)[NB][4], int g) {
      const float4 s = __ldg(reinterpret_cast<const float4*>(scale + (long long)g * fout + col));
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        acc[n][0] += s.x * part[n][0];
        acc[n][1] += s.y * part[n][1];
        acc[n][2] += s.z * part[n][2];
        acc[n][3] += s.w * part[n][3];
        part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.0f;
      }
    };
    auto row = [&](uint32_t w, int r) {
      float lo[4], hi[4];
      unpack4(w, lo, hi);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const float xl = smem[n * fin + r], xh = smem[n * fin + half + r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          plo[n][j] += xl * lo[j];
          phi[n][j] += xh * hi[j];
        }
      }
    };

    int r = r0;
    while (r < r1) {
      if (r == next_lo) { flush(plo, g_lo); ++g_lo; next_lo += group; }
      if (r == next_hi) { flush(phi, g_hi); ++g_hi; next_hi += group; }
      const int end = min(r1, min(next_lo, next_hi));  // rows of one group pair
      for (; r + kUnroll <= end; r += kUnroll) {
        uint32_t w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          w[u] = __ldg(reinterpret_cast<const uint32_t*>(wp + (long long)(r + u) * fout));
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) row(w[u], r + u);
      }
      for (; r < end; ++r)
        row(__ldg(reinterpret_cast<const uint32_t*>(wp + (long long)r * fout)), r);
    }
    flush(plo, g_lo);
    flush(phi, g_hi);
  }

  // slot partials -> shared memory (x is no longer needed), summed in slot order
  __syncthreads();
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      smem[(slot * NB + n) * kTileCols + tile_col + j] = acc[n][j];
  __syncthreads();
  for (int i = threadIdx.x; i < NB * kTileCols; i += kThreads) {
    const int n = i / kTileCols, c = i - n * kTileCols;
    const long long o = (long long)tile * kTileCols + c;
    if (n0 + n >= N || o >= fout) continue;
    float sum = 0.0f;
    for (int s = 0; s < kSlots; ++s) sum += smem[(s * NB + n) * kTileCols + c];
    y[(long long)(n0 + n) * fout + o] = sum;
  }
}

template <int LPR, int NB, typename XT>
int launch(const void* x, long long x_stride, const void* packed, const void* scale, void* y,
           int N, int fin_x, int half, int fout, int group, size_t smem, cudaStream_t stream) {
  auto kernel = int4_gemv_kernel<LPR, NB, XT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int row_blocks = (N + NB - 1) / NB;
  const unsigned grid = (unsigned)((fout + 4 * LPR - 1) / (4 * LPR)) * row_blocks;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const XT*>(x), x_stride, static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale), static_cast<float*>(y), N, fin_x, half, fout, group,
      row_blocks);
  return (int)cudaGetLastError();
}

template <int LPR, typename XT>
int launch_nb(int nb, const void* x, long long x_stride, const void* packed, const void* scale,
              void* y, int N, int fin_x, int half, int fout, int group, size_t smem,
              cudaStream_t stream) {
  switch (nb) {
    case 1: return launch<LPR, 1, XT>(x, x_stride, packed, scale, y, N, fin_x, half, fout, group, smem, stream);
    case 2: return launch<LPR, 2, XT>(x, x_stride, packed, scale, y, N, fin_x, half, fout, group, smem, stream);
    default: return launch<LPR, 4, XT>(x, x_stride, packed, scale, y, N, fin_x, half, fout, group, smem, stream);
  }
}

template <typename XT>
int launch_lpr(int lpr, int nb, const void* x, long long x_stride, const void* packed,
               const void* scale, void* y, int N, int fin_x, int half, int fout, int group,
               size_t smem, cudaStream_t stream) {
  switch (lpr) {
    case 32: return launch_nb<32, XT>(nb, x, x_stride, packed, scale, y, N, fin_x, half, fout, group, smem, stream);
    case 16: return launch_nb<16, XT>(nb, x, x_stride, packed, scale, y, N, fin_x, half, fout, group, smem, stream);
    case 8: return launch_nb<8, XT>(nb, x, x_stride, packed, scale, y, N, fin_x, half, fout, group, smem, stream);
    default: return launch_nb<4, XT>(nb, x, x_stride, packed, scale, y, N, fin_x, half, fout, group, smem, stream);
  }
}

}  // namespace

// x [N, fin_x] (bf16 if x_is_bf16 else fp32, unit stride over columns,
// x_stride elements between rows), packed [half, fout] uint8, scale
// [2*half/group, fout] fp32, y [N, fout] fp32 (contiguous). Refuses, with
// cudaErrorInvalidValue and without launching: N outside 1..32, fout not a
// multiple of 4 (the 4-byte loads), a group that does not divide 2*half,
// fin_x past 2*half, misaligned packed/scale pointers, and an x too wide to
// stage one row in shared memory.
extern "C" int antmmf_int4_gemv(const void* x, long long x_stride, const void* packed,
                                const void* scale, void* y, int N, int fin_x, int half,
                                int fout, int group, int x_is_bf16, void* stream) {
  if (N < 1 || N > kMaxRows || half < 1 || fout < 4 || fout % 4 || group < 1 ||
      (2 * half) % group || fin_x < 1 || fin_x > 2 * half ||
      reinterpret_cast<uintptr_t>(packed) % 4 || reinterpret_cast<uintptr_t>(scale) % 16)
    return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  // rows of x per block: as many as fit in shared memory, at most 4
  int nb = N >= 3 ? 4 : N;
  const size_t row_bytes = (size_t)2 * half * sizeof(float);
  while (nb > 1 && nb * row_bytes > kSmemMax) nb /= 2;
  if (nb * row_bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  // the slot partials reuse the same buffer: kWarps * 128 * nb floats
  size_t smem = nb * row_bytes;
  const size_t red = (size_t)kWarps * 128 * nb * sizeof(float);
  if (red > smem) smem = red;
  // the widest tile that still gives every SM a block
  const int row_blocks = (N + nb - 1) / nb;
  int lpr = 32;
  while (lpr > 4 && (long long)((fout + 4 * lpr - 1) / (4 * lpr)) * row_blocks < sms) lpr /= 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16
      ? launch_lpr<__nv_bfloat16>(lpr, nb, x, x_stride, packed, scale, y, N, fin_x, half, fout, group, smem, s)
      : launch_lpr<float>(lpr, nb, x, x_stride, packed, scale, y, N, fin_x, half, fout, group, smem, s);
}
