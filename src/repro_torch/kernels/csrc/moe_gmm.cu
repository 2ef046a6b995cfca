// Capacity-format grouped matmul (the MoE expert FFN's products) for Hopper
// (sm_90a), plain CUDA C++.
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
// 0.120 ms at 3.35 TB/s.  This first version does the products with
// scalar f32 FMAs (67 TFLOP/s), which become the limit from C of about
// 16 up: at C = 40 they need ~0.24 ms.  mma.sync or wgmma with TMA loads
// are the way to the tensor-core rate and are later work.
//
// Design, for the weight bytes:
// - All C rows of an expert sit in one block when C <= 64 (every serving
//   shape), so each weight element is read from device memory once per
//   launch.  Above 64 rows C is tiled by 64.
// - Every thread holds all TM rows of the block for TN neighbouring f
//   columns (TM*TN accumulators in registers; TN = 8 at C <= 8, fewer as
//   C grows), so a weight element is loaded by exactly one thread, straight
//   into registers, as one vector of TN elements (16 bytes for bf16 at
//   TN = 8) with neighbouring lanes on neighbouring addresses.  The block's
//   x rows are staged in shared memory as f32 and read as broadcasts.
// - The 8 warps split d: rows k with (k / 4) % 8 == warp belong to that
//   warp, each warp sums its rows in ascending k (loading the next 4 rows'
//   weights while it multiplies the current ones), and warp 0 then adds the
//   other warps' partial sums in the order 1, 2, ..., 7.  That order is the
//   same for every C, tile shape and launch, so a row of the output does
//   not depend on how many other rows were in the launch (the expert-
//   parallel path's [E, ep*C, d] launch gives each rank's rows bit for bit
//   what the rank's own [E, C, d] launch gives).
// - Two blocks an SM (128 registers a thread); the x rows are staged one k
//   at a time, TM values written as float4s.
// It still runs at about half the byte bound in decode and a few times the
// FMA bound in prefill (times in PERF.md): 16 warps an SM, each holding
// 64-80 accumulators, keep too few weight loads in flight.  Tensor-core
// fragments would free those registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per block: 8 warps
constexpr int NWARPS = NT / 32;
constexpr int KGROUP = 4;          // consecutive k rows a warp takes in turn
constexpr int KSTEP = KGROUP * NWARPS;  // 32: k rows per round of all warps
constexpr int MIN_BLOCKS = 2;      // per SM: caps a thread at 128 registers
constexpr int XS_BYTES = 48 * 1024;     // shared-memory budget of the x tile
constexpr int MAX_TM = 64;         // C rows per block at most

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
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

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
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, w, out, E, C, d, f, st);
  return (int)cudaErrorInvalidValue;
}
