// Fused short-sequence self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel antmmf_tpu/ops/pallas/small_attention.py:_kernel
// (reached through its `_fwd` pallas_call): out = softmax(q·kᵀ·scale + key
// bias)·v for L <= 256, with the semantics of the JAX package's
// xla_attention_core. Keys past L never take part in the softmax: the ragged
// edge is masked inside the kernel, not by padding keys into it. A row whose
// keys all carry finfo(float32).min averages them uniformly.
//
// What bounds it on an H100: at the serving shape [256, 12, 50, 64] bf16 the
// kernel must read q, k, v once and write the output once (78.6 MB, 23.5 us
// at 3.35 TB/s) against 2 GFLOP (2 us on the tensor cores), so the bound is
// device-memory bytes. The bf16 kernel is built to wait on nothing else:
//   * one block per (batch, head) and up to 128 query rows, 16 rows a warp
//     (4 warps at the ViT's L = 50, 2 at BERT's L = 30); S = Q·Kᵀ and O = P·V
//     run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 out), so a
//     head costs a few dozen operations a warp instead of some 200
//     shared-memory loads a query row on the CUDA cores;
//   * Q, K and V of the head reach shared memory once, by 16-byte
//     asynchronous copies (cp.async) that pass through no register: Q and K
//     as one group, V as a second, so the scores start while V is in flight.
//     Several blocks fit on an SM (28 KB and 128 threads at the ViT shape),
//     so megabytes of loads are in flight across the card;
//   * q, k, v and the output are addressed through strides, so the
//     [B, L, H, D] projections feed the kernel without transposed copies;
//   * fragments come from ldmatrix (rows padded by 16 bytes: no bank
//     conflicts); the score tile stays in registers and becomes the A operand
//     of P·V; rows and keys past L are zero-filled and masked with -inf;
//   * L <= 64 is one pass over one 64-key tile, of which only the 8-key
//     blocks that hold keys are multiplied (7 of 8 at L = 50, 4 at L = 30).
//     Longer heads sweep the resident K twice in 64-key tiles: first an
//     online softmax for the row max and sum, then the scores again to form
//     P·V. Recomputing Q·Kᵀ costs little on tensor cores and keeps one
//     rounding rule on both branches;
//   * the output leaves through the warp's own (spent) Q rows in shared
//     memory as 16-byte stores.
// Scores, max, sum and normalisation are fp32 (in log2 units, see
// attention_common.cuh); P is normalised and then rounded to bf16 before P·V
// on both branches, as both JAX cores do.
//
// float32 inputs keep full fp32 arithmetic on the CUDA cores (one warp per
// query row, K and V staged in shared memory, bound by shared-memory
// load throughput): TF32 products would keep about three decimal digits.
// No main path runs float32 on the card; that kernel serves checks against
// fp32 references. float32 at D = 128 fits shared memory only to L = 215 and
// is refused beyond.

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kMaxL = 256;
constexpr int kMaxSmem = 232448;  // bytes of shared memory one block may use

// ------------------------------------------------------ bf16, tensor cores
constexpr int kMaxWarpsBf16 = 8;  // 128 query rows a block

// Shared memory, in order: Q (16 rows a warp), K and V (L rounded up to 16
// rows), all [rows][D + 8] bf16; then the keys' biases in log2 units, fp32,
// one per key of every 64-key tile (-inf past L).
template <int D>
size_t smem_bytes_bf16(int L, int warps) {
  const int krows = (L + 15) & ~15, nkt = (L + kTile - 1) / kTile;
  return (size_t)(warps * 16 + 2 * krows) * (D + 8) * sizeof(bf16) + (size_t)nkt * kTile * 4;
}

// row max of a score tile over the four lanes that share rows g and g + 8
__device__ __forceinline__ void tile_max(const float (&s)[kTile / 8][4], float& x0, float& x1) {
  x0 = x1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    x0 = fmaxf(x0, fmaxf(s[nt][0], s[nt][1]));
    x1 = fmaxf(x1, fmaxf(s[nt][2], s[nt][3]));
  }
  x0 = quad_max(x0);
  x1 = quad_max(x1);
}

// s = 2^(s - m)·i per row; returns this lane's part of the row sums
__device__ __forceinline__ void tile_exp(float (&s)[kTile / 8][4], float m0, float m1,
                                         float i0, float i1, float& r0, float& r1) {
  r0 = r1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    s[nt][0] = ex2(s[nt][0] - m0) * i0;
    s[nt][1] = ex2(s[nt][1] - m0) * i0;
    s[nt][2] = ex2(s[nt][2] - m1) * i1;
    s[nt][3] = ex2(s[nt][3] - m1) * i1;
    r0 += s[nt][0] + s[nt][1];
    r1 += s[nt][2] + s[nt][3];
  }
}

// ONE: L <= 64, a single key tile and at most four warps.
template <int D, bool ONE>
__global__ void __launch_bounds__(ONE ? 128 : kMaxWarpsBf16 * 32)
small_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const float* __restrict__ bias,
                            bf16* __restrict__ out, int H, int L,
                            long long sb, long long sh, long long sl,
                            long long ob, long long oh, long long ol, float scale_log2) {
  constexpr int SD = D + 8, KD = D / 16, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];

  const int n = blockIdx.x, b = n / H, h = n % H;
  const int nthr = blockDim.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int qrows = nthr >> 1;  // 16 query rows a warp
  const int q0 = blockIdx.y * qrows;
  const int krows = (L + 15) & ~15, nkt = (L + kTile - 1) / kTile;

  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + qrows * SD;
  bf16* sV = sK + krows * SD;
  float* sB = reinterpret_cast<float*>(sV + krows * SD);

  const long long base = b * sb + h * sh;
  const float* brow = bias ? bias + (long long)b * L : nullptr;

  copy_rows_async<D>(sQ, q + base, sl, q0, qrows, L, nthr);
  copy_rows_async<D>(sK, k + base, sl, 0, krows, L, nthr);
  cp_async_commit();
  copy_rows_async<D>(sV, v + base, sl, 0, krows, L, nthr);
  cp_async_commit();
  for (int j = threadIdx.x; j < nkt * kTile; j += nthr)
    sB[j] = j < L ? (brow ? bias_log2(brow[j]) : 0.f) : -INFINITY;
  cp_async_wait<1>();  // Q and K have landed; V may still be in flight
  __syncthreads();

  bf16* sQw = sQ + warp * 16 * SD;
  uint32_t qf[KD][4];
  load_q_frags<D>(qf, sQw, lane);
  float s[kTile / 8][4], o[ND][4];
#pragma unroll
  for (int nt = 0; nt < ND; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m0, m1, l0, l1;

  if constexpr (ONE) {
    const int nt_live = (L + 7) >> 3;
    score_tile<D>(s, qf, sK, nt_live, lane);
    scale_bias(s, sB, scale_log2, t);
    tile_max(s, m0, m1);
    tile_exp(s, m0, m1, 1.f, 1.f, l0, l1);
    const float i0 = 1.f / quad_sum(l0), i1 = 1.f / quad_sum(l1);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      s[nt][0] *= i0;
      s[nt][1] *= i0;
      s[nt][2] *= i1;
      s[nt][3] *= i1;
    }
    cp_async_wait<0>();
    __syncthreads();  // V has landed
    pv_tile<D>(o, s, sV, (nt_live + 1) >> 1, lane);
  } else {
    // first sweep: the row max and sum, online over the key tiles
    m0 = m1 = -INFINITY;
    l0 = l1 = 0.f;
    for (int kt = 0; kt < nkt; ++kt) {
      const int nt_live = min(kTile / 8, (L - kt * kTile + 7) >> 3);
      score_tile<D>(s, qf, sK + kt * kTile * SD, nt_live, lane);
      scale_bias(s, sB + kt * kTile, scale_log2, t);
      float x0, x1, r0, r1;
      tile_max(s, x0, x1);
      const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
      tile_exp(s, n0, n1, 1.f, 1.f, r0, r1);
      l0 = l0 * ex2(m0 - n0) + r0;  // per-lane partial sums under one shared max
      l1 = l1 * ex2(m1 - n1) + r1;
      m0 = n0;
      m1 = n1;
    }
    const float i0 = 1.f / quad_sum(l0), i1 = 1.f / quad_sum(l1);
    cp_async_wait<0>();
    __syncthreads();  // V has landed
    // second sweep: the scores again, P normalised, rounded and multiplied
    for (int kt = 0; kt < nkt; ++kt) {
      const int nt_live = min(kTile / 8, (L - kt * kTile + 7) >> 3);
      score_tile<D>(s, qf, sK + kt * kTile * SD, nt_live, lane);
      scale_bias(s, sB + kt * kTile, scale_log2, t);
      tile_exp(s, m0, m1, i0, i1, l0, l1);
      pv_tile<D>(o, s, sV + kt * kTile * SD, (nt_live + 1) >> 1, lane);
    }
  }
  store_tile<D>(o, 1.f, 1.f, sQw, out + b * ob + h * oh, ol, q0 + warp * 16, L, lane);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const float* bias, void* out,
                int B, int H, int L, long long sb, long long sh, long long sl,
                long long ob, long long oh, long long ol, float scale, cudaStream_t stream) {
  const int tiles = (L + 15) / 16;
  const int warps = tiles < kMaxWarpsBf16 ? tiles : kMaxWarpsBf16;
  const dim3 grid(B * H, (tiles + warps - 1) / warps);
  const size_t smem = smem_bytes_bf16<D>(L, warps);
  auto kernel = L <= kTile ? small_attention_bf16_kernel<D, true>
                           : small_attention_bf16_kernel<D, false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, warps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), bias,
      static_cast<bf16*>(out), H, L, sb, sh, sl, ob, oh, ol, scale * kLog2e);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- fp32, CUDA cores
constexpr int kMaxWarpsFp32 = 8;

// q·k over D with fp32 accumulation; q is a warp-broadcast fp32 row.
template <int D>
__device__ __forceinline__ float dot_row(const float4* q, const float* k) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D / 4; ++d) {
    const float4 a = q[d];
    s = fmaf(a.x, k[4 * d], s);
    s = fmaf(a.y, k[4 * d + 1], s);
    s = fmaf(a.z, k[4 * d + 2], s);
    s = fmaf(a.w, k[4 * d + 3], s);
  }
  return s;
}

// E neighbouring elements (E = D / 32), read and written back.
template <int E>
__device__ __forceinline__ void load_vec(const float* p, float* f) {
  if constexpr (E == 1) {
    f[0] = p[0];
  } else if constexpr (E == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    f[0] = x.x; f[1] = x.y;
  } else {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  }
}

template <int E>
__device__ __forceinline__ void store_vec(float* p, const float* f) {
  if constexpr (E == 1) {
    p[0] = f[0];
  } else if constexpr (E == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory, in order: per-warp q rows (fp32 [D]), per-warp score rows
// (fp32 [LP], LP = L rounded up to 4), V ([L, D]), K ([L, D + one word], so
// lanes reading different keys at the same d hit different banks).
// A head that does not fit in kMaxSmem is refused with cudaErrorInvalidValue.
int warps_fp32(int L) {
  const int w = (L + 3) / 4;
  return w < 1 ? 1 : (w > kMaxWarpsFp32 ? kMaxWarpsFp32 : w);
}

template <int D>
size_t smem_bytes_fp32(int L, int warps) {
  const int LP = (L + 3) & ~3;
  return ((size_t)warps * (D + LP) + (size_t)L * (2 * D + 1)) * sizeof(float);
}

// One warp per query row: lanes stride over keys for the scores, warp
// shuffles give the row max and sum, each lane owns D/32 neighbouring output
// elements for P·V.
template <int D>
__global__ void __launch_bounds__(kMaxWarpsFp32 * 32)
small_attention_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ bias,
                            float* __restrict__ out, int H, int L,
                            long long sb, long long sh, long long sl,
                            long long ob, long long oh, long long ol, float scale) {
  constexpr int SK = D + 1;
  constexpr int E = D / 32;         // output elements per lane
  constexpr int kChunks = D / 4;    // 16-byte loads per row
  extern __shared__ __align__(16) unsigned char smem[];

  const int n = blockIdx.x;
  const int b = n / H, h = n % H;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int LP = (L + 3) & ~3;

  float* sQ = reinterpret_cast<float*>(smem) + warp * D;
  float* sP = reinterpret_cast<float*>(smem) + warps * D + warp * LP;
  float* sV = reinterpret_cast<float*>(smem) + warps * (D + LP);
  float* sK = sV + L * D;

  const long long base = b * sb + h * sh;
  const float* qn = q + base;
  const float* kn = k + base;
  const float* vn = v + base;
  float* on = out + b * ob + h * oh;
  const float* brow = bias ? bias + (long long)b * L : nullptr;

  // Stage K and V with 16-byte global loads. V rows keep 16-byte alignment;
  // padded K rows are only word-aligned, so K is stored word by word.
  for (int c = threadIdx.x; c < L * kChunks; c += blockDim.x) {
    const int j = c / kChunks, part = c % kChunks;
    const float4 kk = *reinterpret_cast<const float4*>(kn + j * sl + part * 4);
    const float4 vv = *reinterpret_cast<const float4*>(vn + j * sl + part * 4);
    *reinterpret_cast<float4*>(sV + j * D + part * 4) = vv;
    float* dk = sK + j * SK + part * 4;
    dk[0] = kk.x; dk[1] = kk.y; dk[2] = kk.z; dk[3] = kk.w;
  }
  __syncthreads();

  for (int i = warp; i < L; i += warps) {
#pragma unroll
    for (int d = lane; d < D; d += 32) sQ[d] = qn[i * sl + d];
    __syncwarp();

    float mx = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      float s = dot_row<D>(reinterpret_cast<const float4*>(sQ), sK + j * SK) * scale;
      if (brow) s += brow[j];
      sP[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(sP[j] - mx);
      sP[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < L; j += 32) sP[j] = sP[j] / sum;
    __syncwarp();

    float acc[E], vf[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    for (int j = 0; j < L; ++j) {
      const float p = sP[j];
      load_vec<E>(sV + j * D + lane * E, vf);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
    }
    store_vec<E>(on + i * ol + lane * E, acc);
    __syncwarp();  // sQ and sP are rewritten for the next row
  }
}

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, const float* bias, void* out,
                int B, int H, int L, long long sb, long long sh, long long sl,
                long long ob, long long oh, long long ol, float scale, cudaStream_t stream) {
  const int warps = warps_fp32(L);
  const size_t smem = smem_bytes_fp32<D>(L, warps);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(small_attention_fp32_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  small_attention_fp32_kernel<D><<<B * H, warps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, static_cast<float*>(out), H, L, sb, sh, sl, ob, oh, ol, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int is_bf16, const void* q, const void* k, const void* v, const float* bias, void* out,
           int B, int H, int L, long long sb, long long sh, long long sl,
           long long ob, long long oh, long long ol, float scale, cudaStream_t stream) {
  return (is_bf16 ? launch_bf16<D> : launch_fp32<D>)(q, k, v, bias, out, B, H, L, sb, sh, sl,
                                                     ob, oh, ol, scale, stream);
}

}  // namespace

// q, k, v: [B, H, L, D] addressed by element strides (sb, sh, sl) with a unit
// stride over D; out likewise with (ob, oh, ol). Every row start must be
// 16-byte aligned. bias: fp32 [B, L], contiguous, or null. is_bf16 selects
// bfloat16 (1) or float32 (0). Returns a cudaError_t; 0 means launched.
extern "C" int antmmf_small_attention_fwd(
    const void* q, const void* k, const void* v, const float* bias, void* out,
    int B, int H, int L, int D, long long sb, long long sh, long long sl,
    long long ob, long long oh, long long ol, float scale, int is_bf16, void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > kMaxL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(is_bf16, q, k, v, bias, out, B, H, L, sb, sh, sl, ob, oh, ol, scale, s);
    case 64: return launch<64>(is_bf16, q, k, v, bias, out, B, H, L, sb, sh, sl, ob, oh, ol, scale, s);
    case 128: return launch<128>(is_bf16, q, k, v, bias, out, B, H, L, sb, sh, sl, ob, oh, ol, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The message of a cudaError_t returned above.
extern "C" const char* antmmf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
