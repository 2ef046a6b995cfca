// Mamba-2 SSD chunked scan for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::_ssd_kernel
// (called through ssd_scan_chunked, pl.pallas_call at line 85).  Same
// function, in the model's layout: x [B,S,H,P], dt [B,S,H] f32 (after
// softplus), A [H] f32 (negative), B/C [B,S,H,N] -> y [B,S,H,P] in x's
// dtype and h_final [B,H,N,P] in f32.  Per chunk of CS rows, all in f32:
//   cum = cumsum(dt * A)                               (non-increasing)
//   w[i][j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j  for j <= i only
//   y = w x + (C h) * exp(cum)                         (h entering chunk)
//   h <- h * exp(cum_last) + sum_j B_j (x) x_j * exp(cum_last - cum_j) dt_j
// Entries j > i are never computed: exp(cum_i - cum_j) is the exp of a
// positive number there and may be inf, and inf * 0 is NaN (the Pallas
// kernel computes them and hides them behind a where).
//
// What differs from the TPU kernel, and why:
// - The TPU grid is (B, H, chunk) with the chunk innermost and run in
//   order, so h [N,P] carries across grid steps in VMEM scratch.  CUDA
//   blocks run in no order, so one block owns one (b, h) pair, walks the
//   chunks itself and keeps h in shared memory for the whole sweep.
// - The kernel reads the model's [B,S,H,*] layout with the strides it is
//   given (the last dim contiguous); the JAX wrapper's transpose to
//   [B,H,nc,cs,*] is not needed.
// - The chunk is fixed at CS = 64 rows.  The Pallas wrapper halves its
//   chunk until it divides S, which falls to one-row chunks for a prime
//   prompt length.  Here the rows past S act as dt = 0, x = B = C = 0:
//   cum stays flat over them, so cum_last is the last valid row's, the
//   state is unchanged and nothing is written for them.
//
// What bounds it: at the serving shapes (B=1, H=24, P=64, N=128, one
// group, bf16) the least time is set by bytes (x and dt read once, B and
// C once for the group, y and h_final written once: about 4.2 MB at
// S=512, 1.3 us at 3.35 TB/s) rather than by operations (about
// 2*H*S*CS*(N+P) + 4*H*S*N*P, 0.7 GFLOP at S=512, 0.7 us).
// This first version is far from either: only B*H = 24 blocks run, on
// 24 of the card's 132 SMs, each walking its chunks one after another,
// and the products are scalar f32 FMAs from shared memory (each of 256
// threads owns a 4 x 4 tile of w, a 4 x (P/16) tile of y and an
// (N/16) x (P/16) tile of h, so each shared-memory load feeds several
// FMAs).  A chunk-parallel three-phase design (as ssd_chunked) to fill the
// card, and mma.sync / wgmma with TMA loads, are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CS = 64;        // rows per chunk
constexpr int NT = 256;       // threads: 16 row groups (ty) x 16 lanes (tx)
constexpr int MAX_N = 128;    // state size
constexpr int NI = MAX_N / 16;

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

// Shared memory, in floats: x [CS][P], B and C [CS][N+1] (padded so that
// 16 lanes reading 16 rows hit 16 banks), h [N][P+1], w [CS][CS+1], and
// four vectors of CS: dt, cum, exp(cum), exp(cum_last - cum) * dt.
__host__ __device__ inline size_t smem_floats(int n, int p) {
  return (size_t)CS * p + 2 * (size_t)CS * (n + 1) + (size_t)n * (p + 1) +
         (size_t)CS * (CS + 1) + 4 * CS;
}

struct Strides {
  long long b, s, h;
};

// NJ = ceil(P / 16): columns of P per thread.
template <typename T, int NJ>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ hout, int s, int nh, int p, int n,
                Strides sx, Strides sd, Strides sb, Strides sc) {
  extern __shared__ float smem[];
  const int ldn = n + 1, ldh = p + 1, ldw = CS + 1;
  float* xs = smem;
  float* bs = xs + CS * p;
  float* cs = bs + CS * ldn;
  float* hs = cs + CS * ldn;
  float* ws = hs + n * ldh;
  float* dts = ws + CS * ldw;
  float* cum = dts + CS;
  float* ecum = cum + CS;
  float* coef = ecum + CS;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float a = A[h];

  const T* xb = x + b * sx.b + h * sx.h;
  const float* db = dt + b * sd.b + h * sd.h;
  const T* bb = Bm + b * sb.b + h * sb.h;
  const T* cb = Cm + b * sc.b + h * sc.h;
  T* yb = y + ((size_t)b * s * nh + h) * p;          // y is [B,S,H,P]
  float* hb = hout + ((size_t)b * nh + h) * n * p;   // h_final [B,H,N,P]

  for (int i = tid; i < n * ldh; i += NT) hs[i] = 0.f;

  for (int c0 = 0; c0 < s; c0 += CS) {
    const int rows = (s - c0) < CS ? (s - c0) : CS;
    __syncthreads();  // the previous chunk's tiles are no longer read
    for (int i = tid; i < CS * p; i += NT) {
      const int r = i / p, d = i % p;
      xs[i] = r < rows ? to_f32(xb[(c0 + r) * sx.s + d]) : 0.f;
    }
    for (int i = tid; i < CS * n; i += NT) {
      const int r = i / n, d = i % n;
      const bool ok = r < rows;
      bs[r * ldn + d] = ok ? to_f32(bb[(c0 + r) * sb.s + d]) : 0.f;
      cs[r * ldn + d] = ok ? to_f32(cb[(c0 + r) * sc.s + d]) : 0.f;
    }
    if (tid < CS) dts[tid] = tid < rows ? db[(c0 + tid) * sd.s] : 0.f;
    __syncthreads();

    // cum = inclusive cumsum of dt * A: lane l of warp 0 sums rows 2l and
    // 2l+1, then a warp scan over the 32 pair sums
    if (tid < 32) {
      const float a0 = dts[2 * tid] * a, a1 = dts[2 * tid + 1] * a;
      float incl = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += t;
      }
      float prev = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) prev = 0.f;
      cum[2 * tid] = prev + a0;
      cum[2 * tid + 1] = incl;
    }
    __syncthreads();
    const float cum_last = cum[CS - 1];
    if (tid < CS) {
      ecum[tid] = expf(cum[tid]);
      coef[tid] = expf(cum_last - cum[tid]) * dts[tid];
    }

    // w for rows 4*ty+i, columns tx+16*j; column groups wholly right of
    // this thread's last row are skipped (the same for a whole warp)
    {
      const int jmax = (4 * ty + 3) / 16 + 1;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int d = 0; d < n; ++d) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(4 * ty + i) * ldn + d];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = j < jmax ? bs[(tx + 16 * j) * ldn + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          ws[r * ldw + col] =
              col <= r ? acc[i][j] * expf(cum[r] - cum[col]) * dts[col] : 0.f;
        }
      }
    }
    __syncthreads();  // w, exp(cum) and coef are written

    // y for rows 4*ty+i, columns tx+16*j: the within-chunk term (keys up
    // to the row) plus the carried state's term
    {
      float acc[4][NJ], off[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = off[i][j] = 0.f;
      const int kmax = 4 * ty + 4;
      for (int k = 0; k < kmax; ++k) {
        float wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[i] = ws[(4 * ty + i) * ldw + k];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = tx + 16 * j;
          const float xv = col < p ? xs[k * p + col] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(wv[i], xv, acc[i][j]);
        }
      }
      for (int d = 0; d < n; ++d) {
        float cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(4 * ty + i) * ldn + d];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = tx + 16 * j;
          const float hv = col < p ? hs[d * ldh + col] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) off[i][j] = fmaf(cv[i], hv, off[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * ty + i;
        if (r >= rows) continue;
        const float e = ecum[r];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = tx + 16 * j;
          if (col < p)
            yb[(size_t)(c0 + r) * nh * p + col] =
                from_f32<T>(acc[i][j] + off[i][j] * e);
        }
      }
    }
    __syncthreads();  // every read of the entering h is done

    // h <- h * exp(cum_last) + sum_k coef_k * B_k (x) x_k, for state rows
    // ty+16*i and columns tx+16*j
    {
      const float gamma = expf(cum_last);
      float acc[NI][NJ];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int r = ty + 16 * i, col = tx + 16 * j;
          acc[i][j] = (r < n && col < p) ? hs[r * ldh + col] * gamma : 0.f;
        }
      for (int k = 0; k < rows; ++k) {
        const float ck = coef[k];
        float bv[NI], xv[NJ];
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int r = ty + 16 * i;
          bv[i] = r < n ? bs[k * ldn + r] * ck : 0.f;
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = tx + 16 * j;
          xv[j] = col < p ? xs[k * p + col] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(bv[i], xv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int r = ty + 16 * i, col = tx + 16 * j;
          if (r < n && col < p) hs[r * ldh + col] = acc[i][j];
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < n * p; i += NT) hb[i] = hs[(i / p) * ldh + i % p];
}

template <typename T, int NJ>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* hout, int b, int s, int nh, int p,
           int n, Strides sx, Strides sd, Strides sb, Strides sc,
           cudaStream_t stream) {
  const size_t smem = smem_floats(n, p) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nh, b);
  ssd_scan_kernel<T, NJ><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(hout), s, nh, p, n, sx, sd, sb, sc);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, void* y, void* hout, int b, int s, int nh,
             int p, int n, Strides sx, Strides sd, Strides sb, Strides sc,
             cudaStream_t stream) {
  switch ((p + 15) / 16) {
#define LCX_CASE(NJ)                                                       \
  case NJ:                                                                 \
    return launch<T, NJ>(x, dt, A, Bm, Cm, y, hout, b, s, nh, p, n, sx, sd, \
                         sb, sc, stream);
    LCX_CASE(1) LCX_CASE(2) LCX_CASE(3) LCX_CASE(4)
    LCX_CASE(5) LCX_CASE(6) LCX_CASE(7) LCX_CASE(8)
#undef LCX_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16.  Strides are in
// elements for the [B,S,H] dims of x, dt, B and C (B and C have stride 0
// over H where the heads share one group's rows); their last dims are
// contiguous, A is contiguous, and y [B,S,H,P] and h_final [B,H,N,P] are
// written contiguous.  Returns cudaGetLastError() after the launch (0 on
// success).  Shapes and dtypes are checked by the caller.
extern "C" int lcx_ssd_scan_fwd(const void* x, const void* dt, const void* A,
                                const void* Bm, const void* Cm, void* y,
                                void* hout, int b, int s, int nh, int p,
                                int n, long long sxb, long long sxs,
                                long long sxh, long long sdb, long long sds,
                                long long sdh, long long sbb, long long sbs,
                                long long sbh, long long scb, long long scs,
                                long long sch, int dtype, void* stream) {
  if (b < 1 || s < 1 || nh < 1 || p < 1 || p > 128 || n < 1 || n > MAX_N)
    return (int)cudaErrorInvalidValue;
  const Strides sx{sxb, sxs, sxh}, sd{sdb, sds, sdh}, sb{sbb, sbs, sbh},
      sc{scb, scs, sch};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, dt, A, Bm, Cm, y, hout, b, s, nh, p, n, sx, sd,
                           sb, sc, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, hout, b, s, nh, p, n,
                                   sx, sd, sb, sc, st);
  return (int)cudaErrorInvalidValue;
}
