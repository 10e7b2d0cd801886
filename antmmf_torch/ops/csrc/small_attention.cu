// Fused short-sequence self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel antmmf_tpu/ops/pallas/small_attention.py:_kernel
// (reached through its `_fwd` pallas_call): out = softmax(q·kᵀ·scale + key
// bias)·v for L <= 256, with the semantics of the JAX package's
// xla_attention_core. Keys past L never take part in the softmax: the ragged
// edge is masked by loop bounds, not by padding keys into it.
//
// What bounds it on an H100: at the serving shape [256, 12, 50, 64] bf16 the
// kernel must read q, k, v once and write the output once (78.6 MB, about
// 23 us at 3.35 TB/s) against 2 GFLOP (about 2 us on the tensor cores), so
// the bound is device-memory bytes. The design moves each byte once:
//   * one block per (batch, head); K and V of that head are staged in dynamic
//     shared memory with 16-byte loads and every query row reads them there,
//     so the [L, L] score tensor never reaches device memory;
//   * q, k, v and the output are addressed through strides, so the [B, L, H, D]
//     projections feed the kernel without transposed copies;
//   * one warp per query row: lanes stride over keys for the scores, warp
//     shuffles give the row max and sum, each lane owns D/32 neighbouring
//     output elements for P·V;
//   * K rows in shared memory are padded by one 32-bit word, so lanes reading
//     different keys at the same d hit different banks.
// The scores use CUDA cores, not tensor cores: at this size the kernel is
// limited by shared-memory instructions rather than by device memory, which a
// later tensor-core (mma/wgmma) version addresses.
// Scores, max, sum and normalisation are fp32; P is rounded to the input type
// before P·V, as both JAX cores do. The key bias stays fp32, so a row whose
// keys all carry finfo(float32).min stays finite and averages uniformly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxL = 256;
constexpr int kMaxWarps = 8;
constexpr int kMaxSmem = 232448;  // bytes of shared memory one block may use

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bfloat16)
}

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

template <int D>
__device__ __forceinline__ float dot_row(const float4* q, const __nv_bfloat16* k) {
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(k);
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D / 4; ++d) {
    const float4 a = q[d];
    const float2 k0 = __bfloat1622float2(k2[2 * d]);
    const float2 k1 = __bfloat1622float2(k2[2 * d + 1]);
    s = fmaf(a.x, k0.x, s);
    s = fmaf(a.y, k0.y, s);
    s = fmaf(a.z, k1.x, s);
    s = fmaf(a.w, k1.y, s);
  }
  return s;
}

// E neighbouring elements (E = D / 32) read as fp32, and written back.
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
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* f) {
  if constexpr (E == 1) {
    f[0] = __bfloat162float(p[0]);
  } else {
#pragma unroll
    for (int e = 0; e < E; e += 2) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + e));
      f[e] = x.x; f[e + 1] = x.y;
    }
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

template <int E>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* f) {
  if constexpr (E == 1) {
    p[0] = __float2bfloat16(f[0]);
  } else {
#pragma unroll
    for (int e = 0; e < E; e += 2)
      *reinterpret_cast<__nv_bfloat162*>(p + e) = __floats2bfloat162_rn(f[e], f[e + 1]);
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
// (fp32 [LP], LP = L rounded up to 4), V ([L, D]), K ([L, D + one word]).
// A head that does not fit in kMaxSmem is refused with cudaErrorInvalidValue.
int warps_for(int L) {
  const int w = (L + 3) / 4;
  return w < 1 ? 1 : (w > kMaxWarps ? kMaxWarps : w);
}

template <typename T, int D>
__host__ __device__ constexpr int k_row() { return D + 4 / (int)sizeof(T); }

template <typename T, int D>
size_t smem_bytes(int L, int warps) {
  const int LP = (L + 3) & ~3;
  return (size_t)warps * (D + LP) * sizeof(float) + (size_t)L * (D + k_row<T, D>()) * sizeof(T);
}

template <typename T, int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
small_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ bias,
                       T* __restrict__ out, int H, int L,
                       long long sb, long long sh, long long sl,
                       long long ob, long long oh, long long ol, float scale) {
  constexpr int SK = k_row<T, D>();
  constexpr int E = D / 32;               // output elements per lane
  constexpr int kChunk = 16 / sizeof(T);  // elements in one 16-byte load
  constexpr int kChunks = D / kChunk;     // 16-byte loads per row
  extern __shared__ __align__(16) unsigned char smem[];

  const int n = blockIdx.x;
  const int b = n / H, h = n % H;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int LP = (L + 3) & ~3;

  float* sQ = reinterpret_cast<float*>(smem) + warp * D;
  float* sP = reinterpret_cast<float*>(smem) + warps * D + warp * LP;
  T* sV = reinterpret_cast<T*>(reinterpret_cast<float*>(smem) + warps * (D + LP));
  T* sK = sV + L * D;

  const long long base = b * sb + h * sh;
  const T* qn = q + base;
  const T* kn = k + base;
  const T* vn = v + base;
  T* on = out + b * ob + h * oh;
  const float* brow = bias ? bias + (long long)b * L : nullptr;

  // Stage K and V with 16-byte global loads. V rows keep 16-byte alignment;
  // padded K rows are only word-aligned, so K is stored as 32-bit words.
  for (int c = threadIdx.x; c < L * kChunks; c += blockDim.x) {
    const int j = c / kChunks, part = c % kChunks;
    const uint4 kk = *reinterpret_cast<const uint4*>(kn + j * sl + part * kChunk);
    const uint4 vv = *reinterpret_cast<const uint4*>(vn + j * sl + part * kChunk);
    *reinterpret_cast<uint4*>(sV + j * D + part * kChunk) = vv;
    uint32_t* dk = reinterpret_cast<uint32_t*>(sK + j * SK) + part * 4;
    dk[0] = kk.x; dk[1] = kk.y; dk[2] = kk.z; dk[3] = kk.w;
  }
  __syncthreads();

  for (int i = warp; i < L; i += warps) {
#pragma unroll
    for (int d = lane; d < D; d += 32) sQ[d] = to_float(qn[i * sl + d]);
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
    for (int j = lane; j < L; j += 32) sP[j] = to_float(from_float<T>(sP[j] / sum));
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* bias, void* out,
           int B, int H, int L, long long sb, long long sh, long long sl,
           long long ob, long long oh, long long ol, float scale, cudaStream_t stream) {
  const int warps = warps_for(L);
  const size_t smem = smem_bytes<T, D>(L, warps);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        small_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  small_attention_kernel<T, D><<<B * H, warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), H, L, sb, sh, sl, ob, oh, ol, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const float* bias, void* out,
               int B, int H, int L, int D, long long sb, long long sh, long long sl,
               long long ob, long long oh, long long ol, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, bias, out, B, H, L, sb, sh, sl, ob, oh, ol, scale, stream);
    case 64: return launch<T, 64>(q, k, v, bias, out, B, H, L, sb, sh, sl, ob, oh, ol, scale, stream);
    case 128: return launch<T, 128>(q, k, v, bias, out, B, H, L, sb, sh, sl, ob, oh, ol, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
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
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(q, k, v, bias, out, B, H, L, D, sb, sh, sl, ob, oh, ol, scale, s);
  return dispatch_d<float>(q, k, v, bias, out, B, H, L, D, sb, sh, sl, ob, oh, ol, scale, s);
}

// The message of a cudaError_t returned above.
extern "C" const char* antmmf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
