// GQA flash-attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (called through flash_attention, pl.pallas_call at line 96).  Same
// function: q [B,Hq,Sq,Dk], k [B,Hkv,Sk,Dk], v [B,Hkv,Sk,Dv] -> o
// [B,Hq,Sq,Dv] in v's dtype; KV head h / (Hq/Hkv); scores, running max m,
// running sum l and the accumulator in f32; p rounded to v's dtype before
// the PV product, as the Pallas kernel does (p.astype(v.dtype)); the causal
// mask is top-left aligned (row >= col in absolute indices); rows whose l
// stays 0 divide by 1.
//
// What differs from the TPU kernel, and why:
// - The TPU walks KV blocks as the innermost, in-order grid dimension and
//   carries acc/m/l in VMEM scratch across grid steps.  CUDA blocks run in
//   no order, so one block owns one (batch, q-head, 64-row q tile) and
//   loops over the KV tiles itself.  With causal masking the loop stops at
//   the tile holding the diagonal, as the Pallas kernel skips the blocks
//   above it.
// - The Pallas wrapper halves its block size until it divides S, which
//   falls to one-row blocks for a prime prompt length.  Here the tiles stay
//   64 by 64 and the ragged tail (rows >= Sq, columns >= Sk) is masked
//   inside the kernel.
//
// What bounds it: at the serving shapes (Hq=14, Hkv=2, D=64, S up to
// 1024) the least time is a microsecond or two.  The bytes (Q, K, V read
// once, O written once) set it below S of about 700, the operations
// (2*2*Hq*D per unmasked (row, key) pair, about S^2/2 pairs) above; the
// chip_smoke.py kernel phase computes both.  This
// first version does the products with scalar f32 FMAs from shared memory:
// each of 256 threads owns a 4x4 block of the score tile and a 4x(Dv/16)
// block of the accumulator, so each shared-memory load feeds four FMAs.
// It runs far below the tensor-core rate; wgmma with TMA loads is the way
// to that rate and is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per KV tile
constexpr int NT = 256;       // threads per block: 16 row groups x 16 lanes
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared memory, in floats: Q tile [BQ][dk+1], K tile [BK][dk+1] (padded
// so that 16 lanes reading 16 different keys hit 16 banks), V tile
// [BK][dv], P tile [BQ][BK+1].
__host__ __device__ inline size_t smem_floats(int dk, int dv) {
  return (size_t)BQ * (dk + 1) + (size_t)BK * (dk + 1) + (size_t)BK * dv +
         (size_t)BQ * (BK + 1);
}

// NJ = ceil(dv / 16): accumulator columns per thread.
template <typename T, int NJ>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
                 int sq, int sk, int dk, int dv, float scale, int causal) {
  extern __shared__ float smem[];
  const int ldq = dk + 1, ldk = dk + 1, ldp = BK + 1;
  float* qs = smem;
  float* ks = qs + BQ * ldq;
  float* vs = ks + BK * ldk;
  float* ps = vs + BK * dv;

  const int tid = threadIdx.x;
  const int tx = tid % 16;      // key / output column lane
  const int ty = tid / 16;      // owns rows 4*ty .. 4*ty+3 of the tile
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);

  const T* qb = q + ((size_t)b * hq + h) * sq * dk;
  const T* kb = k + ((size_t)b * hkv + hk) * sk * dk;
  const T* vb = v + ((size_t)b * hkv + hk) * sk * dv;
  T* ob = o + ((size_t)b * hq + h) * sq * dv;

  for (int i = tid; i < BQ * dk; i += NT) {
    const int r = i / dk, d = i % dk;
    qs[r * ldq + d] = (q0 + r < sq) ? to_f32(qb[(size_t)(q0 + r) * dk + d])
                                    : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (sk + BK - 1) / BK;
  if (causal) {
    // the last tile with a key at or left of this block's last row
    const int last = (q0 + BQ - 1) / BK + 1;
    n_tiles = last < n_tiles ? last : n_tiles;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < BK * dk; i += NT) {
      const int r = i / dk, d = i % dk;
      ks[r * ldk + d] = (k0 + r < sk)
                            ? to_f32(kb[(size_t)(k0 + r) * dk + d]) : 0.f;
    }
    for (int i = tid; i < BK * dv; i += NT) {
      const int r = i / dv, d = i % dv;
      vs[r * dv + d] = (k0 + r < sk)
                           ? to_f32(vb[(size_t)(k0 + r) * dv + d]) : 0.f;
    }
    __syncthreads();

    // scores for rows 4*ty+i, keys tx+16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dk; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(4 * ty + i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = ks[(tx + 16 * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = col < sk && (!causal || col <= row);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes holding one row are one half of a warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        // the PV product takes p in v's dtype, the row sum does not
        ps[(4 * ty + i) * ldp + tx + 16 * j] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int kmax = (sk - k0) < BK ? (sk - k0) : BK;
    for (int kk = 0; kk < kmax; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(4 * ty + i) * ldp + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        const float vv = c < dv ? vs[kk * dv + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sq) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < dv) ob[(size_t)row * dv + c] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int sk, int dk, int dv, float scale,
           int causal, cudaStream_t stream) {
  const size_t smem = smem_floats(dk, dv) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, hq, b);
  flash_fwd_kernel<T, NJ><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, sk, dk, dv,
      scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int hq, int hkv, int sq, int sk, int dk, int dv, float scale,
             int causal, cudaStream_t stream) {
  switch ((dv + 15) / 16) {
#define LCX_CASE(NJ)                                                     \
  case NJ:                                                               \
    return launch<T, NJ>(q, k, v, o, b, hq, hkv, sq, sk, dk, dv, scale, \
                         causal, stream);
    LCX_CASE(1) LCX_CASE(2) LCX_CASE(3) LCX_CASE(4)
    LCX_CASE(5) LCX_CASE(6) LCX_CASE(7) LCX_CASE(8)
#undef LCX_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).  Shapes and contiguity are checked by the caller.
extern "C" int lcx_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, int b, int hq,
                                       int hkv, int sq, int sk, int dk,
                                       int dv, float scale, int causal,
                                       int dtype, void* stream) {
  if (dk < 1 || dk > 128 || dv < 1 || dv > 128 || hkv < 1 || hq % hkv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, b, hq, hkv, sq, sk, dk, dv, scale,
                           causal, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, sk, dk, dv,
                                   scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
