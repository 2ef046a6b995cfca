// Capacity-format grouped matmul (the MoE expert FFN's products) for Hopper
// (sm_90a), plain CUDA C++: tensor cores for bf16, scalar FMAs for f32.
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py::_gmm_kernel (line
// 19, called through moe_gmm, pl.pallas_call at line 53).  Same function:
// xb [E, C, d] @ w [E, d, f] -> out [E, C, f] in xb's dtype, every product
// summed in f32 and rounded once to the output type
// (src/repro/kernels/ref.py:59).
//
// What differs from the TPU kernel, and why:
// - The TPU's grid is (E, C/bc, f/bf, d/bd) with the contracting sweep
//   innermost and in order, carrying an f32 VMEM accumulator across grid
//   steps.  CUDA blocks run in no order, so one block owns one (expert,
//   C tile, f tile) and walks the whole of d itself.
// - The Pallas wrapper halves each block until it divides its dimension
//   (_pick, :35-40).  Here the tiles keep their size and the ragged edges
//   of C, d and f are masked.  Offsets are 64-bit.
//
// What bounds it: the weight bytes.  The function reads E*d*f weights once
// and does 2*E*C*d*f operations, so its operations per weight byte are
// about C (C/2 in f32): 8 in decode (8 slots give C = 8) and 40 for a
// 498-token prefill of qwen3-moe-30b-a3b (C = 40), against the ~295 that
// bf16 tensor cores need before arithmetic, not memory, is the limit.  At
// decode one projection reads w [128, 2048, 768] bf16, 402,653,184 bytes:
// 0.120 ms at 3.35 TB/s.  The aim is to keep the weight stream at the
// memory rate for every serving C.
//
// bfloat16 design (gmm_mma_kernel), for the weight bytes:
// - It computes out^T = w^T x^T on tensor cores (mma.sync m16n8k16 bf16,
//   f32 accumulators), the weights on the M side: f fills the mma's 16
//   rows and C its 8 columns, so decode's C = 8 is one n-tile and C = 40
//   five, and a thread holds 4 * ceil(C/8) accumulators.  Scalar FMAs and
//   their register-held accumulators, which kept the first version far
//   from the byte bound at C = 8 and made it FMA-bound from C of about 16
//   up, are gone.
// - One block (8 warps) takes one expert, 128 f columns (16 a warp) and
//   all C <= 64 rows, so each weight is read from device memory once a
//   launch; above 64 rows C is tiled by 64, the C tiles of one weight tile
//   neighbours in the grid so that they share it through L2.  Serving
//   shapes give 768 blocks (gate, up) and 2048 (down).
// - Weight tiles [64 d-rows x 128 f-cols] and the block's x rows [C x 64]
//   stream through a 4-stage ring of 16-byte cp.async copies (zeros past
//   the edges of C, d and f), so that three stages, up to 48 KB a block,
//   are in flight while one is multiplied.  Weights reach the A fragments
//   by ldmatrix.trans from their [k][f] rows, x the B fragments by
//   ldmatrix from its [c][k] rows; rows are padded by 16 bytes against
//   bank conflicts.  Shapes whose rows are not 16-byte aligned take
//   element-wise loads into the same ring.
// - The output tile goes through shared memory and leaves in 16-byte
//   rows.
// - Order of the sums (why a row of the output does not depend on the
//   other rows of its launch): an mma's output element depends only on its
//   row of A (weights), its column of B (one row of x) and its accumulator.
//   Every output is one accumulator chain over d in ascending steps of 16
//   (zero-padded past d), whatever C is and however C is tiled, so the
//   expert-parallel path's [E, 8*40, d] launch gives each rank's rows bit
//   for bit what the rank's own [E, 40, d] launch gives.
//
// float32 keeps a scalar kernel (gmm_kernel): TF32 tensor cores round the
// inputs to 10 mantissa bits, far outside the 2 d 2^-24 sum|x||w| bound
// that the f32 path is held to.  Its design:
// - All C rows of an expert sit in one block when C <= 64 (every serving
//   shape), so each weight element is read from device memory once per
//   launch.  Above 64 rows C is tiled by 64.
// - Every thread holds all TM rows of the block for TN neighbouring f
//   columns (TM*TN accumulators in registers; TN = 8 at C <= 8, fewer as
//   C grows), so a weight element is loaded by exactly one thread, straight
//   into registers, as one vector of TN elements with neighbouring lanes
//   on neighbouring addresses.  The block's x rows are staged in shared
//   memory as f32 and read as broadcasts.
// - The 8 warps split d: rows k with (k / 4) % 8 == warp belong to that
//   warp, each warp sums its rows in ascending k (loading the next 4 rows'
//   weights while it multiplies the current ones), and warp 0 then adds the
//   other warps' partial sums in the order 1, 2, ..., 7.  That order is the
//   same for every C, tile shape and launch, so here too a row of the
//   output does not depend on the other rows of the launch.
// - Two blocks an SM (128 registers a thread); the x rows are staged one k
//   at a time, TM values written as float4s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_ptx.cuh"

namespace {

constexpr int NT = 256;            // threads per block: 8 warps
constexpr int NWARPS = NT / 32;
constexpr int KGROUP = 4;          // consecutive k rows a warp takes in turn
constexpr int KSTEP = KGROUP * NWARPS;  // 32: k rows per round of all warps
constexpr int MIN_BLOCKS = 2;      // per SM: caps a thread at 128 registers
constexpr int XS_BYTES = 48 * 1024;     // shared-memory budget of the x tile
constexpr int MAX_TM = 64;         // C rows per block at most

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// N elements of T moved as one aligned vector (two for 32 bytes): loaded
// and stored through plain integer vectors, so that the compiler emits
// one 16-, 8-, 4- or 2-byte access and never an element-wise copy.
template <typename T, int N>
struct alignas(sizeof(T) * N > 16 ? 16 : sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int N>
__host__ __device__ constexpr int pack_align() {
  return sizeof(T) * N > 16 ? 16 : sizeof(T) * N;
}

template <int BYTES> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

template <typename T, int N>
__device__ __forceinline__ void load_pack(const T* p, Pack<T, N>& o) {
  using R = typename Raw<pack_align<T, N>()>::type;
  constexpr int n = sizeof(Pack<T, N>) / sizeof(R);
  const R* src = reinterpret_cast<const R*>(p);
  R* dst = reinterpret_cast<R*>(&o);
#pragma unroll
  for (int i = 0; i < n; ++i) dst[i] = __ldg(src + i);
}

template <typename T, int N>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, N>& o) {
  using R = typename Raw<pack_align<T, N>()>::type;
  constexpr int n = sizeof(Pack<T, N>) / sizeof(R);
  R* dst = reinterpret_cast<R*>(p);
  const R* src = reinterpret_cast<const R*>(&o);
#pragma unroll
  for (int i = 0; i < n; ++i) dst[i] = src[i];
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }

// TN weights of row k from column col, as stored (zeros past the edges of
// d and f).
template <typename T, int TN>
__device__ __forceinline__ void load_w(const T* __restrict__ we, int k, int d,
                                       int f, int col, bool vec,
                                       Pack<T, TN>& o) {
  if (k < d && col < f) {
    const T* p = we + (int64_t)k * f + col;
    if (vec && col + TN <= f) {
      load_pack<T, TN>(p, o);
      return;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) o.v[j] = col + j < f ? p[j] : zero<T>();
  } else {
#pragma unroll
    for (int j = 0; j < TN; ++j) o.v[j] = zero<T>();
  }
}

// One block: expert blockIdx.z, C rows [blockIdx.y*TM, +TM), f columns
// [blockIdx.x*32*TN, +32*TN).  Dynamic shared memory: the x tile as f32
// [kt_max][TM] (k-major, so that a lane reads its TM rows of one k as
// float4 broadcasts), reused at the end for one warp's partial sums.
//
// The k loop runs in steps of KSTEP = 32 rows; in step s warp w takes rows
// 32 s + 4 w .. +3.  The weights of the next step are loaded while the
// current one is multiplied, and a new x tile is staged every kt_max rows
// (kt_max a multiple of KSTEP).
template <typename T, int TM, int TN>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ out, int C, int d, int f, int kt_max, int vec_w,
           int vec_o) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int e = blockIdx.z;
  const int c0 = blockIdx.y * TM;
  const int col = blockIdx.x * (32 * TN) + lane * TN;
  const int rows = min(TM, C - c0);
  const T* xe = x + ((int64_t)e * C + c0) * d;
  const T* we = w + (int64_t)e * d * f;
  const int n_steps = (d + KSTEP - 1) / KSTEP;
  const int tile_steps = kt_max / KSTEP;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  Pack<T, TN> nxt[KGROUP];
#pragma unroll
  for (int rr = 0; rr < KGROUP; ++rr)
    load_w<T, TN>(we, warp * KGROUP + rr, d, f, col, vec_w != 0, nxt[rr]);

  for (int s = 0; s < n_steps; ++s) {
    const int ts = s % tile_steps;
    if (ts == 0) {
      // stage x rows [k0, k0 + kt) of the block's TM rows, zeros past the
      // edges: a thread takes one k at a time and writes its TM rows as
      // float4s, 8 loads in flight
      const int k0 = s * KSTEP;
      const int kt = min(kt_max, d - k0);
      const int ktp = (kt + KSTEP - 1) / KSTEP * KSTEP;
      __syncthreads();  // the previous tile's reads are done
      for (int kk = threadIdx.x; kk < ktp; kk += NT) {
        const bool in = kk < kt;
        const T* xk = xe + k0 + kk;
        float4* dst = reinterpret_cast<float4*>(xs + kk * TM);
#pragma unroll 1
        for (int r0 = 0; r0 < TM; r0 += 8) {
          float v[8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            v[q] = (in && r0 + q < rows) ? to_f32(xk[(int64_t)(r0 + q) * d])
                                         : 0.f;
          dst[r0 / 4] = make_float4(v[0], v[1], v[2], v[3]);
          dst[r0 / 4 + 1] = make_float4(v[4], v[5], v[6], v[7]);
        }
      }
      __syncthreads();
    }
    Pack<T, TN> cur[KGROUP];
#pragma unroll
    for (int rr = 0; rr < KGROUP; ++rr) cur[rr] = nxt[rr];
    if (s + 1 < n_steps) {
#pragma unroll
      for (int rr = 0; rr < KGROUP; ++rr)
        load_w<T, TN>(we, (s + 1) * KSTEP + warp * KGROUP + rr, d, f, col,
                      vec_w != 0, nxt[rr]);
    }
#pragma unroll
    for (int rr = 0; rr < KGROUP; ++rr) {
      float wv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) wv[j] = to_f32(cur[rr].v[j]);
      const float4* xr = reinterpret_cast<const float4*>(
          xs + (ts * KSTEP + warp * KGROUP + rr) * TM);
#pragma unroll
      for (int i4 = 0; i4 < TM / 4; ++i4) {
        const float4 xv = xr[i4];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[4 * i4 + 0][j] = fmaf(xv.x, wv[j], acc[4 * i4 + 0][j]);
          acc[4 * i4 + 1][j] = fmaf(xv.y, wv[j], acc[4 * i4 + 1][j]);
          acc[4 * i4 + 2][j] = fmaf(xv.z, wv[j], acc[4 * i4 + 2][j]);
          acc[4 * i4 + 3][j] = fmaf(xv.w, wv[j], acc[4 * i4 + 3][j]);
        }
      }
    }
  }

  // Warp 0 adds the other warps' partial sums, in warp order.  Layout
  // [TM*TN][32]: lane-minor, so the 32 lanes hit 32 banks.
  float* red = xs;
  for (int src = 1; src < NWARPS; ++src) {
    __syncthreads();
    if (warp == src) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) red[(i * TN + j) * 32 + lane] = acc[i][j];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += red[(i * TN + j) * 32 + lane];
    }
  }
  if (warp != 0 || col >= f) return;
  T* oe = out + ((int64_t)e * C + c0) * f + col;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (i >= rows) break;
    T* o = oe + (int64_t)i * f;
    if (vec_o && col + TN <= f) {
      Pack<T, TN> pk;
#pragma unroll
      for (int j = 0; j < TN; ++j) pk.v[j] = from_f32<T>(acc[i][j]);
      store_pack<T, TN>(o, pk);
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (col + j < f) o[j] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int N>
bool aligned(const void* p, long long f) {
  const size_t a = (size_t)pack_align<T, N>();
  return reinterpret_cast<uintptr_t>(p) % a == 0 && (f * sizeof(T)) % a == 0;
}

template <typename T, int TM, int TN>
int launch(const void* x, const void* w, void* out, long long E, long long C,
           long long d, long long f, cudaStream_t stream) {
  const long long c_tiles = (C + TM - 1) / TM;
  const long long f_tiles = (f + 32 * TN - 1) / (32 * TN);
  if (E > 65535 || c_tiles > 65535 || f_tiles > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  // the x tile: as many k rows as the budget holds, a multiple of KSTEP
  int kt_max = XS_BYTES / (int)(sizeof(float) * TM) / KSTEP * KSTEP;
  const long long d_pad = (d + KSTEP - 1) / KSTEP * KSTEP;
  if (d_pad < kt_max) kt_max = (int)d_pad;
  size_t floats = (size_t)kt_max * TM;
  if ((size_t)32 * TM * TN > floats) floats = (size_t)32 * TM * TN;
  dim3 grid((unsigned)f_tiles, (unsigned)c_tiles, (unsigned)E);
  gmm_kernel<T, TM, TN><<<grid, NT, floats * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      (int)C, (int)d, (int)f, kt_max, aligned<T, TN>(w, f) ? 1 : 0,
      aligned<T, TN>(out, f) ? 1 : 0);
  return (int)cudaGetLastError();
}

// Rows per block and columns per thread by C: all of C in one block up to
// 64 rows, with at most 80 accumulators a thread.
template <typename T>
int dispatch(const void* x, const void* w, void* out, long long E,
             long long C, long long d, long long f, cudaStream_t stream) {
  const long long tm = C >= MAX_TM ? MAX_TM : (C + 7) / 8 * 8;
  switch (tm) {
    case 8:  return launch<T, 8, 8>(x, w, out, E, C, d, f, stream);
    case 16: return launch<T, 16, 4>(x, w, out, E, C, d, f, stream);
    case 24: return launch<T, 24, 2>(x, w, out, E, C, d, f, stream);
    case 32: return launch<T, 32, 2>(x, w, out, E, C, d, f, stream);
    case 40: return launch<T, 40, 2>(x, w, out, E, C, d, f, stream);
    case 48: return launch<T, 48, 1>(x, w, out, E, C, d, f, stream);
    case 56: return launch<T, 56, 1>(x, w, out, E, C, d, f, stream);
    case 64: return launch<T, 64, 1>(x, w, out, E, C, d, f, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int G_NT = 256;             // 8 warps, 16 f columns each
constexpr int G_BF = 128;             // f columns a block
constexpr int G_BK = 64;              // d rows a stage
constexpr int G_STAGES = 4;
constexpr int G_WP = G_BF + 8;        // padded pitch of a weight row
constexpr int G_XP = G_BK + 8;        // padded pitch of an x row
constexpr int G_MAX_BN = 64;          // C rows a block at most

constexpr size_t mma_smem(int bn) {
  return (size_t)G_STAGES * (G_BK * G_WP + bn * G_XP) * sizeof(bf16);
}

// One block: C rows [blockIdx.x * BN, +BN) of expert blockIdx.z, f columns
// [blockIdx.y * G_BF, +G_BF).  NTL = BN / 8 n-tiles.
template <int NTL>
__global__ void __launch_bounds__(G_NT)
gmm_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               bf16* __restrict__ out, int C, int d, int f, int vec_w,
               int vec_x, int vec_o) {
  constexpr int BN = 8 * NTL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][G_BK][G_WP]
  bf16* xs = ws + G_STAGES * G_BK * G_WP;        // [STAGES][BN][G_XP]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * BN;
  const int f0 = blockIdx.y * G_BF;
  const int e = blockIdx.z;
  const int rows = min(BN, C - c0);
  const bf16* xe = x + ((int64_t)e * C + c0) * d;
  const bf16* we = w + (int64_t)e * d * f;
  const int n_k = (d + G_BK - 1) / G_BK;

  auto load_stage = [&](int slot, int kt) {
    const int k0 = kt * G_BK;
    bf16* wsl = ws + slot * G_BK * G_WP;
    for (int i = tid; i < G_BK * (G_BF / 8); i += G_NT) {
      const int r = i / (G_BF / 8), c = (i % (G_BF / 8)) * 8;
      const int k = k0 + r, col = f0 + c;
      bf16* dst = wsl + r * G_WP + c;
      const bf16* src = we + (int64_t)k * f + col;
      if (vec_w) {
        const bool ok = k < d && col < f;
        tc::cp_async16(dst, ok ? src : we, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = (k < d && col + j < f) ? src[j] : __float2bfloat16(0.f);
      }
    }
    bf16* xsl = xs + slot * BN * G_XP;
    for (int i = tid; i < BN * (G_BK / 8); i += G_NT) {
      const int r = i / (G_BK / 8), c = (i % (G_BK / 8)) * 8;
      const int k = k0 + c;
      bf16* dst = xsl + r * G_XP + c;
      const bf16* src = xe + (int64_t)r * d + k;
      if (vec_x) {
        const bool ok = r < rows && k < d;
        tc::cp_async16(dst, ok ? src : xe, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = (r < rows && k + j < d) ? src[j] : __float2bfloat16(0.f);
      }
    }
  };

  float acc[NTL][4];
#pragma unroll
  for (int j = 0; j < NTL; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < G_STAGES - 1; ++s) {
    if (s < n_k) load_stage(s, s);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    tc::cp_async_wait<G_STAGES - 2>();
    __syncthreads();  // stage kt is in; every warp is done with kt - 1
    const int nk = kt + G_STAGES - 1;
    if (nk < n_k) load_stage(nk % G_STAGES, nk);
    tc::cp_async_commit();
    const bf16* wsl = ws + (kt % G_STAGES) * G_BK * G_WP;
    const bf16* xsl = xs + (kt % G_STAGES) * BN * G_XP;
#pragma unroll
    for (int kk = 0; kk < G_BK / 16; ++kk) {
      unsigned a[4];
      tc::ldsm_x4_trans(a, wsl + (16 * kk + (lane & 7) + 8 * (lane >> 4)) *
                                     G_WP +
                               16 * warp + 8 * ((lane >> 3) & 1));
#pragma unroll
      for (int jp = 0; jp < NTL / 2; ++jp) {
        unsigned b[4];
        tc::ldsm_x4(b, xsl + (16 * jp + (lane & 7) + 8 * (lane >> 4)) * G_XP +
                           16 * kk + 8 * ((lane >> 3) & 1));
        tc::mma_bf16(acc[2 * jp], a, b[0], b[1]);
        tc::mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
      }
      if (NTL % 2) {
        unsigned b[2];
        tc::ldsm_x2(b, xsl + (8 * (NTL - 1) + (lane & 7)) * G_XP + 16 * kk +
                           8 * ((lane >> 3) & 1));
        tc::mma_bf16(acc[NTL - 1], a, b[0], b[1]);
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the output tile [BN][G_WP] goes there

  // acc[j]: f column 16 warp + g (+8 for [2], [3]), C row 8 j + 2 t (+1)
  const int g = lane >> 2, t = lane & 3;
  bf16* os = ws;
#pragma unroll
  for (int j = 0; j < NTL; ++j) {
    const int n = 8 * j + 2 * t, m = 16 * warp + g;
    os[n * G_WP + m] = __float2bfloat16(acc[j][0]);
    os[(n + 1) * G_WP + m] = __float2bfloat16(acc[j][1]);
    os[n * G_WP + m + 8] = __float2bfloat16(acc[j][2]);
    os[(n + 1) * G_WP + m + 8] = __float2bfloat16(acc[j][3]);
  }
  __syncthreads();
  bf16* oe = out + ((int64_t)e * C + c0) * f + f0;
  for (int i = tid; i < BN * (G_BF / 8); i += G_NT) {
    const int r = i / (G_BF / 8), c = (i % (G_BF / 8)) * 8;
    if (r >= rows || f0 + c >= f) continue;
    const bf16* src = os + r * G_WP + c;
    bf16* dst = oe + (int64_t)r * f + c;
    if (vec_o) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < 8 && f0 + c + j < f; ++j) dst[j] = src[j];
    }
  }
}

template <int NTL>
int launch_mma(const void* x, const void* w, void* out, long long E,
               long long C, long long d, long long f, cudaStream_t stream) {
  constexpr int BN = 8 * NTL;
  const long long c_tiles = (C + BN - 1) / BN;
  const long long f_tiles = (f + G_BF - 1) / G_BF;
  if (E > 65535 || f_tiles > 65535 || c_tiles > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = mma_smem(BN);
  cudaError_t err = cudaFuncSetAttribute(
      gmm_mma_kernel<NTL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  dim3 grid((unsigned)c_tiles, (unsigned)f_tiles, (unsigned)E);
  gmm_mma_kernel<NTL><<<grid, G_NT, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), (int)C, (int)d, (int)f,
      a16(w) && f % 8 == 0, a16(x) && d % 8 == 0, a16(out) && f % 8 == 0);
  return (int)cudaGetLastError();
}

// all C rows in one block up to 64, else tiles of 64
int dispatch_mma(const void* x, const void* w, void* out, long long E,
                 long long C, long long d, long long f, cudaStream_t stream) {
  const long long ntl = C >= G_MAX_BN ? G_MAX_BN / 8 : (C + 7) / 8;
  switch (ntl) {
#define LCX_CASE(N) \
  case N:           \
    return launch_mma<N>(x, w, out, E, C, d, f, stream);
    LCX_CASE(1) LCX_CASE(2) LCX_CASE(3) LCX_CASE(4)
    LCX_CASE(5) LCX_CASE(6) LCX_CASE(7) LCX_CASE(8)
#undef LCX_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x [E, C, d], w [E, d, f], out
// [E, C, f], all contiguous and of one dtype (checked by the caller), every
// size at least 1, C, d and f below 2^31.  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int lcx_moe_gmm(const void* x, const void* w, void* out,
                           long long E, long long C, long long d, long long f,
                           int dtype, void* stream) {
  if (E < 1 || C < 1 || d < 1 || f < 1 || C > 2147483647LL ||
      d > 2147483647LL || f > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, w, out, E, C, d, f, st);
  if (dtype == 1) return dispatch_mma(x, w, out, E, C, d, f, st);
  return (int)cudaErrorInvalidValue;
}
