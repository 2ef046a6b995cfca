// Mamba-2 SSD chunked scan for Hopper (sm_90a), plain CUDA C++: three
// chunk-parallel launches, the bf16 products on tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::_ssd_kernel
// (called through ssd_scan_chunked, pl.pallas_call at line 85).  Same
// function, in the model's layout: x [B,S,H,P], dt [B,S,H] f32 (after
// softplus), A [H] f32 (negative), B/C [B,S,H,N] -> y [B,S,H,P] in x's
// dtype and h_final [B,H,N,P] in f32.  Per chunk c of CS = 64 rows:
//   cum = cumsum(dt * A)                               (non-increasing)
//   w[i][j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j  for j <= i only
//   S_c = sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j
//   gamma_c = exp(cum_last)
//   h_0 = 0,  h_{c+1} = h_c * gamma_c + S_c,  h_final = h_nc
//   y = w x + exp(cum) * (C h_c)
// Entries j > i are never computed: exp(cum_i - cum_j) is the exp of a
// positive number there and may be inf, and inf * 0 is NaN (the Pallas
// kernel computes them and hides them behind a where).
//
// What differs from the TPU kernel, and why:
// - The TPU grid is (B, H, chunk) with the chunk innermost and run in
//   order, so h [N,P] carries across grid steps in VMEM scratch.  CUDA
//   blocks run in no order.  The lesson of this file's first design: one
//   block a (b, h) walking its chunks filled 24 of the 132 SMs and took
//   0.15873 ms a call over mamba2-130m's serve prompts (NVIDIA H100 80GB
//   HBM3, 700 W), slower than its plain version at S = 1024.  So the scan
//   takes the three phases of the reference's ssd_chunked
//   (src/repro/models/ssm.py), one launch each:
//   1. state: one block per (b, h, chunk, 32-column P tile) writes its
//      chunk's own end state S_c for its columns to an f32 workspace
//      [B,H,nc,N,P], and gamma_c beside it (a [B,H,nc] tail of the same
//      workspace, which is written before it is read and needs no fill);
//   2. pass: one thread per (b, h, n, p) walks the chunks in order,
//      h_c -> h_{c+1}, overwriting S_c with the state h_c entering chunk c
//      and writing h_final; its loads run 8 chunks ahead of the sums;
//   3. out: one block per (b, h, chunk, P tile) computes C B^T, w, and
//      y = w x + exp(cum) (C h_c), written once in x's dtype.
//   Each head's state has P columns of its own, so the P tiles split the
//   work of phases 1 and 3 without a reduction: a one-chunk prompt of
//   mamba2-130m (24 heads of 64) runs 48 blocks a launch, S = 1024 768.
//   (Tiles of 16 and 64 columns were no faster on the card.)  A block
//   recomputes C B^T, which the heads of a group and the P tiles of a head
//   share: 64 x 64 x N on tensor cores, against a fourth launch to share it.
// - The kernel reads the model's [B,S,H,*] layout with the strides it is
//   given (the last dim contiguous); the JAX wrapper's transpose to
//   [B,H,nc,cs,*] is not needed.
// - The chunk is fixed at CS = 64 rows.  The Pallas wrapper halves its
//   chunk until it divides S, which falls to one-row chunks for a prime
//   prompt length.  Here the rows past S act as dt = 0, x = B = C = 0:
//   cum stays flat over them, so cum_last is the last valid row's, the
//   state is unchanged and nothing is written for them.
//
// bfloat16: every product runs on mma.sync m16n8k16 (tc_ptx.cuh) from
// ldmatrix fragments of shared-memory tiles filled by 16-byte cp.async
// copies (zero past S, N and P; N padded to a multiple of 32 and the tile
// rows by 16 bytes, so that ldmatrix is free of bank conflicts).  4 warps
// a block.  In phase 3 each warp owns 16 of the chunk's rows and of C B^T
// only the key columns up to its last row; w stays in registers (the
// accumulator fragment of C B^T is the A fragment of w x).  In phase 1
// the state's rows are the M side (B^T through ldmatrix.trans), N/64
// m-tiles a warp.
// Precision: C B^T has bf16 operands, exact products and f32 sums.  The
// other three products each take an f32 operand, which rounded to bf16
// would cost up to 2^-9 of each term: w; exp(cum_last - cum_j) dt_j x_j;
// and h_c.  h_final is held to 1e-4 absolute at entries of order 0.1-1,
// which that does not fit.  So each such operand is split into a bf16
// high part and a bf16 low part, hi = bf16(v), lo = bf16(v - hi), and both
// go through the tensor cores (two MMAs), which keeps about 16 bits of v.
// The carried-state term's per-row exp(cum_i) is applied to the f32
// accumulator after the product.  Measured (chip_smoke.py's ssd check
// lines, bf16, S = 1 .. 2048): h_final within 1.7e-5 of the plain
// version against 1e-4 allowed, y within 1e-2 + 1e-2 |y|
// (tests/test_torch_kernels.py holds the same scheme, in plain PyTorch,
// to those bounds on the CPU against the Pallas kernel).
// float32 keeps scalar FMAs in the same three launches (TF32 would round
// every operand to 10 bits): 256 threads a block, 32 P columns a tile.
//
// What bounds it: at the serving shapes (B=1, H=24, P=64, N=128, one
// group, bf16) the least time is set by bytes (x and dt read once, B and
// C once for the group, y and h_final written once: about 4.2 MB at
// S=512, 1.3 us at 3.35 TB/s) rather than by operations (about
// 2*H*S*CS*(N+P) + 4*H*S*N*P, 0.7 GFLOP at S=512, 0.7 us).  The design
// is far from either.  Over the serve prompts (1-8 chunks) a call is three
// dependent launches of one short wave each, each a few microseconds of
// latency.  At long prompts the output launch dominates: each of its
// blocks reads the group's B and C tiles again (48 times a chunk for
// mamba2-130m, from L2) besides its workspace tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_ptx.cuh"

namespace {

constexpr int CS = 64;      // rows per chunk
constexpr int MAX_N = 128;  // state size
constexpr int MAX_P = 128;  // head dim
constexpr int PASS_NT = 256;
constexpr int PASS_AHEAD = 8;  // chunk states a pass thread loads at once

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, s, h;
};

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  void* y;
  float* hout;    // h_final [B,H,N,P]
  float* states;  // workspace [B,H,nc,N,P]: S_c, then h_c
  float* gam;     // workspace [B,H,nc]: gamma_c
  Strides sx, sd, sb, sc;
  int b, s, nh, p, n, nc;
};

// Warp 0 only: dt of the chunk's rows (0 past ``rows``) into ``dts``, the
// inclusive cumsum of dt * a into ``cum``: lane l sums rows 2l and 2l+1,
// then a warp scan over the 32 pair sums.  Returns cum_last in every lane.
__device__ __forceinline__ float chunk_cum(const float* db, long long sds,
                                           int rows, float a, float* dts,
                                           float* cum) {
  const int lane = threadIdx.x & 31;
  const int r0 = 2 * lane, r1 = r0 + 1;
  const float d0 = r0 < rows ? db[r0 * sds] : 0.f;
  const float d1 = r1 < rows ? db[r1 * sds] : 0.f;
  const float a0 = d0 * a, a1 = d1 * a;
  float incl = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  float prev = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) prev = 0.f;
  dts[r0] = d0;
  dts[r1] = d1;
  cum[r0] = prev + a0;
  cum[r1] = incl;
  return __shfl_sync(0xffffffffu, incl, 31);
}

// ---------------------------------------------------------------------------
// phase 2 (any dtype): the state entering each chunk
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(PASS_NT) ssd_pass_kernel(const Args a) {
  const long long np = (long long)a.n * a.p;
  const int e = blockIdx.x * PASS_NT + threadIdx.x;
  if (e >= np) return;
  const long long bh = (long long)blockIdx.z * a.nh + blockIdx.y;
  float* st = a.states + bh * a.nc * np + e;
  const float* g = a.gam + bh * a.nc;
  float h = 0.f;
  for (int c0 = 0; c0 < a.nc; c0 += PASS_AHEAD) {
    float s[PASS_AHEAD], gm[PASS_AHEAD];
#pragma unroll
    for (int k = 0; k < PASS_AHEAD; ++k) {
      const bool ok = c0 + k < a.nc;
      s[k] = ok ? st[(c0 + k) * np] : 0.f;
      gm[k] = ok ? g[c0 + k] : 1.f;
    }
#pragma unroll
    for (int k = 0; k < PASS_AHEAD; ++k) {
      if (c0 + k >= a.nc) break;
      // phase 3 reads no entering state for chunk 0 (it is 0)
      if (c0 + k > 0) st[(c0 + k) * np] = h;
      h = h * gm[k] + s[k];
    }
  }
  a.hout[bh * np + e] = h;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------
constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;
constexpr int PT = 32;  // P columns a block

// rows [0, CS) x columns [0, DP) of a [row][col] bf16 view into shared
// memory rows of PITCH elements: 16-byte cp.async copies when ``vec``,
// zeros past ``rows`` and ``dim``; else element by element.
template <int DP, int PITCH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long stride, int rows,
                                          int dim, bool vec) {
  constexpr int CH = DP / 8;  // 16-byte chunks a row
  constexpr int TOTAL = CS * CH;
  if (vec) {
#pragma unroll
    for (int n = 0; n < (TOTAL + NT - 1) / NT; ++n) {
      const int i = threadIdx.x + n * NT;
      if (TOTAL % NT != 0 && i >= TOTAL) break;
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = r < rows && c < dim;
      tc::cp_async16(dst + r * PITCH + c, ok ? src + r * stride + c : src,
                     ok ? 16 : 0);
    }
    return;
  }
  for (int i = threadIdx.x; i < TOTAL; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dst[r * PITCH + c + j] = (r < rows && c + j < dim)
                                   ? src[r * stride + c + j]
                                   : __float2bfloat16(0.f);
  }
}

// v = hi + lo, both bf16 (hi = bf16(v), lo = bf16(v - hi)), two values
// packed per register as the mma fragments hold them
__device__ __forceinline__ void split2(float v0, float v1, unsigned& hi,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = tc::pack_bf16(v0 - hf.x, v1 - hf.y);
}

template <int NP>
struct Tile {
  static constexpr int BP = NP + 8;  // bf16 a row of the B and C tiles
  static constexpr int XP = PT + 8;  // bf16 a row of the x and state tiles
  // phase 1: B, x hi, x lo; dt, cum, coef
  static constexpr size_t SMEM1 =
      (size_t)(CS * BP + 2 * CS * XP) * 2 + 3 * CS * 4;
  // phase 3: C, B, x, h hi, h lo; dt, cum
  static constexpr size_t SMEM3 =
      (size_t)(2 * CS * BP + CS * XP + 2 * NP * XP) * 2 + 2 * CS * 4;
};

// this lane's ldmatrix offset (in elements) into a [k][n] tile of rows of
// ``pitch`` read as the "col" B operand, transposed: matrices (k 0-7, n
// 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15), i.e. b0 and b1
// of two n-tiles
__device__ __forceinline__ int trans_b_off(int lane, int pitch) {
  return ((lane & 7) + 8 * ((lane >> 3) & 1)) * pitch + 8 * (lane >> 4);
}

// Phase 1: S_c[n][p] = sum_j B[j][n] * (coef_j x[j][p]) for the block's P
// tile; the state rows are the M side (A = B^T, read with ldmatrix.trans),
// the chunk's rows the K side, x the N side.
template <int NP>
__global__ void __launch_bounds__(NT)
ssd_state_mma(const Args a, int vec) {
  using T = Tile<NP>;
  constexpr int BP = T::BP, XP = T::XP;
  constexpr int MT = NP / 16;                  // m-tiles of the state
  constexpr int MW = (MT + WARPS - 1) / WARPS;  // a warp's m-tiles
  constexpr int PJ = PT / 16;                  // pairs of 8-column n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* bs = reinterpret_cast<bf16*>(smem_raw);  // [CS][BP]
  bf16* xh = bs + CS * BP;                        // [CS][XP]
  bf16* xl = xh + CS * XP;                        // [CS][XP]
  float* dts = reinterpret_cast<float*>(xl + CS * XP);
  float* cum = dts + CS;
  float* coef = cum + CS;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ntp = (a.p + PT - 1) / PT;
  const int c = blockIdx.x / ntp, p0 = (blockIdx.x % ntp) * PT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * CS;
  const int rows = a.s - c0 < CS ? a.s - c0 : CS;

  load_rows<NP, BP>(bs,
                    static_cast<const bf16*>(a.Bm) + b * a.sb.b +
                        h * a.sb.h + (long long)c0 * a.sb.s,
                    a.sb.s, rows, a.n, vec);
  load_rows<PT, XP>(xh,
                    static_cast<const bf16*>(a.x) + b * a.sx.b + h * a.sx.h +
                        (long long)c0 * a.sx.s + p0,
                    a.sx.s, rows, a.p - p0, vec);
  tc::cp_async_commit();
  if (warp == 0) {
    const float last = chunk_cum(a.dt + b * a.sd.b + h * a.sd.h +
                                     (long long)c0 * a.sd.s,
                                 a.sd.s, rows, a.A[h], dts, cum);
    coef[2 * lane] = expf(last - cum[2 * lane]) * dts[2 * lane];
    coef[2 * lane + 1] = expf(last - cum[2 * lane + 1]) * dts[2 * lane + 1];
    if (lane == 0 && p0 == 0)
      a.gam[((long long)b * a.nh + h) * a.nc + c] = expf(last);
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // x rows scaled by coef, split into high and low bf16 parts
  for (int i = threadIdx.x; i < CS * PT / 2; i += NT) {
    const int j = i / (PT / 2), col = 2 * (i % (PT / 2));
    bf16* px = xh + j * XP + col;
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(px));
    unsigned hi, lo;
    split2(v.x * coef[j], v.y * coef[j], hi, lo);
    *reinterpret_cast<unsigned*>(px) = hi;
    *reinterpret_cast<unsigned*>(xl + j * XP + col) = lo;
  }
  __syncthreads();

  float acc[MW][2 * PJ][4];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int j = 0; j < 2 * PJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  const int xoff = trans_b_off(lane, XP);
  // A = B^T from the [j][n] tile: matrices (n 0-7, j 0-7), (n 8-15, j
  // 0-7), (n 0-7, j 8-15), (n 8-15, j 8-15), transposed
  const int aoff = ((lane & 7) + 8 * (lane >> 4)) * BP + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < CS / 16; ++kk) {
    unsigned fh[PJ][4], fl[PJ][4];
#pragma unroll
    for (int jp = 0; jp < PJ; ++jp) {
      tc::ldsm_x4_trans(fh[jp], xh + 16 * kk * XP + 16 * jp + xoff);
      tc::ldsm_x4_trans(fl[jp], xl + 16 * kk * XP + 16 * jp + xoff);
    }
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) {
      const int mt = warp + WARPS * mi;
      if (MT % WARPS != 0 && mt >= MT) break;
      unsigned af[4];
      tc::ldsm_x4_trans(af, bs + 16 * kk * BP + 16 * mt + aoff);
#pragma unroll
      for (int jp = 0; jp < PJ; ++jp) {
        tc::mma_bf16(acc[mi][2 * jp], af, fh[jp][0], fh[jp][1]);
        tc::mma_bf16(acc[mi][2 * jp + 1], af, fh[jp][2], fh[jp][3]);
        tc::mma_bf16(acc[mi][2 * jp], af, fl[jp][0], fl[jp][1]);
        tc::mma_bf16(acc[mi][2 * jp + 1], af, fl[jp][2], fl[jp][3]);
      }
    }
  }

  const long long np = (long long)a.n * a.p;
  float* st = a.states + (((long long)b * a.nh + h) * a.nc + c) * np;
  const bool pair = (a.p & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
    const int mt = warp + WARPS * mi;
    if (MT % WARPS != 0 && mt >= MT) break;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = 16 * mt + g + 8 * hf;
      if (row >= a.n) continue;
      float* srow = st + (long long)row * a.p;
#pragma unroll
      for (int j = 0; j < 2 * PJ; ++j) {
        const int col = p0 + 8 * j + 2 * t;
        if (col >= a.p) continue;
        const float v0 = acc[mi][j][2 * hf], v1 = acc[mi][j][2 * hf + 1];
        if (pair) {
          *reinterpret_cast<float2*>(srow + col) = make_float2(v0, v1);
        } else {
          srow[col] = v0;
          if (col + 1 < a.p) srow[col + 1] = v1;
        }
      }
    }
  }
}

// Phase 3: y = w x + exp(cum) (C h_c) for the block's P tile.  Warp w owns
// rows 16w .. 16w+15 of the chunk, and of C B^T only the key columns up to
// its last row.
template <int NP>
__global__ void __launch_bounds__(NT)
ssd_out_mma(const Args a, int vec) {
  using T = Tile<NP>;
  constexpr int BP = T::BP, XP = T::XP;
  constexpr int KN = NP / 16;  // k-steps over the state
  constexpr int PJ = PT / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);  // [CS][BP]
  bf16* bs = cs + CS * BP;                        // [CS][BP]
  bf16* xs = bs + CS * BP;                        // [CS][XP]
  bf16* hh = xs + CS * XP;                        // [NP][XP]
  bf16* hl = hh + NP * XP;                        // [NP][XP]
  float* dts = reinterpret_cast<float*>(hl + NP * XP);
  float* cum = dts + CS;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ntp = (a.p + PT - 1) / PT;
  const int c = blockIdx.x / ntp, p0 = (blockIdx.x % ntp) * PT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * CS;
  const int rows = a.s - c0 < CS ? a.s - c0 : CS;

  load_rows<NP, BP>(cs,
                    static_cast<const bf16*>(a.Cm) + b * a.sc.b +
                        h * a.sc.h + (long long)c0 * a.sc.s,
                    a.sc.s, rows, a.n, vec);
  load_rows<NP, BP>(bs,
                    static_cast<const bf16*>(a.Bm) + b * a.sb.b +
                        h * a.sb.h + (long long)c0 * a.sb.s,
                    a.sb.s, rows, a.n, vec);
  load_rows<PT, XP>(xs,
                    static_cast<const bf16*>(a.x) + b * a.sx.b + h * a.sx.h +
                        (long long)c0 * a.sx.s + p0,
                    a.sx.s, rows, a.p - p0, vec);
  tc::cp_async_commit();
  // the entering state's [N][PT] tile: every load issued before any is
  // used, then split into high and low parts (chunk 0 enters with 0)
  constexpr int HL = NP * PT / 4 / NT;  // 4-float groups a thread
  float hv[HL][4];
  if (c > 0) {
    const long long np = (long long)a.n * a.p;
    const float* st =
        a.states + (((long long)b * a.nh + h) * a.nc + c) * np + p0;
    const bool v4 = (a.p & 3) == 0;
#pragma unroll
    for (int k = 0; k < HL; ++k) {
      const int i = threadIdx.x + k * NT;
      const int r = i / (PT / 4), col = 4 * (i % (PT / 4));
      if (v4 && r < a.n && p0 + col < a.p) {
        const float4 q = *reinterpret_cast<const float4*>(
            st + (long long)r * a.p + col);
        hv[k][0] = q.x, hv[k][1] = q.y, hv[k][2] = q.z, hv[k][3] = q.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hv[k][e] = (r < a.n && p0 + col + e < a.p)
                         ? st[(long long)r * a.p + col + e]
                         : 0.f;
      }
    }
  }
  if (warp == 0)
    chunk_cum(a.dt + b * a.sd.b + h * a.sd.h + (long long)c0 * a.sd.s,
              a.sd.s, rows, a.A[h], dts, cum);
  if (c > 0) {
#pragma unroll
    for (int k = 0; k < HL; ++k) {
      const int i = threadIdx.x + k * NT;
      const int r = i / (PT / 4), col = 4 * (i % (PT / 4));
      uint2 hi, lo;
      split2(hv[k][0], hv[k][1], hi.x, lo.x);
      split2(hv[k][2], hv[k][3], hi.y, lo.y);
      *reinterpret_cast<uint2*>(hh + r * XP + col) = hi;
      *reinterpret_cast<uint2*>(hl + r * XP + col) = lo;
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  const int r0 = 16 * warp;  // this warp's first row
  if (r0 >= rows) return;    // rows past S: nothing to write
  // C fragments of the warp's rows, kept for C B^T and C h
  unsigned cf[KN][4];
#pragma unroll
  for (int kk = 0; kk < KN; ++kk)
    tc::ldsm_x4(cf[kk], cs + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * BP +
                            16 * kk + 8 * (lane >> 4));

  // C B^T over key columns 0 .. r0 + 15: n-tile pairs jp <= warp
  float sc[CS / 8][4];
#pragma unroll
  for (int j = 0; j < CS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
  const int koff = ((lane & 7) + 8 * (lane >> 4)) * BP + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < KN; ++kk) {
#pragma unroll
    for (int jp = 0; jp < CS / 16; ++jp) {
      if (jp > warp) break;
      unsigned kf[4];
      tc::ldsm_x4(kf, bs + 16 * jp * BP + 16 * kk + koff);
      tc::mma_bf16(sc[2 * jp], cf[kk], kf[0], kf[1]);
      tc::mma_bf16(sc[2 * jp + 1], cf[kk], kf[2], kf[3]);
    }
  }

  // w = (C B^T) exp(cum_i - cum_j) dt_j for j <= i, as high and low A
  // fragments of w x (the accumulator of key columns 16kk .. 16kk+15 is
  // the A fragment of k-step kk)
  const float ci[2] = {cum[r0 + g], cum[r0 + g + 8]};
  unsigned wh[CS / 16][4], wl[CS / 16][4];
#pragma unroll
  for (int jp = 0; jp < CS / 16; ++jp) {
    if (jp > warp) break;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = 2 * jp + q;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + 8 * (e >> 1);
        const int col = 8 * j + 2 * t + (e & 1);
        v[e] = col <= row ? sc[j][e] * expf(ci[e >> 1] - cum[col]) * dts[col]
                          : 0.f;
      }
      split2(v[0], v[1], wh[jp][2 * q], wl[jp][2 * q]);
      split2(v[2], v[3], wh[jp][2 * q + 1], wl[jp][2 * q + 1]);
    }
  }

  float acc[2 * PJ][4];
#pragma unroll
  for (int j = 0; j < 2 * PJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int xoff = trans_b_off(lane, XP);
#pragma unroll
  for (int kk = 0; kk < CS / 16; ++kk) {
    if (kk > warp) break;
#pragma unroll
    for (int jp = 0; jp < PJ; ++jp) {
      unsigned xf[4];
      tc::ldsm_x4_trans(xf, xs + 16 * kk * XP + 16 * jp + xoff);
      tc::mma_bf16(acc[2 * jp], wh[kk], xf[0], xf[1]);
      tc::mma_bf16(acc[2 * jp + 1], wh[kk], xf[2], xf[3]);
      tc::mma_bf16(acc[2 * jp], wl[kk], xf[0], xf[1]);
      tc::mma_bf16(acc[2 * jp + 1], wl[kk], xf[2], xf[3]);
    }
  }

  if (c > 0) {  // + exp(cum_i) * (C h_c)
    float off[2 * PJ][4];
#pragma unroll
    for (int j = 0; j < 2 * PJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) off[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
#pragma unroll
      for (int jp = 0; jp < PJ; ++jp) {
        unsigned fh[4], fl[4];
        tc::ldsm_x4_trans(fh, hh + 16 * kk * XP + 16 * jp + xoff);
        tc::ldsm_x4_trans(fl, hl + 16 * kk * XP + 16 * jp + xoff);
        tc::mma_bf16(off[2 * jp], cf[kk], fh[0], fh[1]);
        tc::mma_bf16(off[2 * jp + 1], cf[kk], fh[2], fh[3]);
        tc::mma_bf16(off[2 * jp], cf[kk], fl[0], fl[1]);
        tc::mma_bf16(off[2 * jp + 1], cf[kk], fl[2], fl[3]);
      }
    }
    const float ec[2] = {expf(ci[0]), expf(ci[1])};
#pragma unroll
    for (int j = 0; j < 2 * PJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += off[j][e] * ec[e >> 1];
  }

  // y is [B,S,H,P], contiguous
  bf16* yb = static_cast<bf16*>(a.y) +
             (((long long)b * a.s + c0) * a.nh + h) * a.p;
  const bool pair = (a.p & 1) == 0;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + g + 8 * hf;
    if (row >= rows) continue;
    bf16* yrow = yb + (long long)row * a.nh * a.p;
#pragma unroll
    for (int j = 0; j < 2 * PJ; ++j) {
      const int col = p0 + 8 * j + 2 * t;
      if (col >= a.p) continue;
      const float v0 = acc[j][2 * hf], v1 = acc[j][2 * hf + 1];
      if (pair) {
        *reinterpret_cast<__nv_bfloat162*>(yrow + col) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        yrow[col] = __float2bfloat16(v0);
        if (col + 1 < a.p) yrow[col + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs
// ---------------------------------------------------------------------------
constexpr int FNT = 256;  // 16 row groups (ty) x 16 lanes (tx)
constexpr int FPT = 32;   // P columns a block
constexpr int FNJ = FPT / 16;
constexpr int FNI = MAX_N / 16;

// rows [0, CS) x columns [0, dim) of a [row][col] f32 view into shared
// memory rows of ``ld`` floats; zeros past ``rows`` and up to ``width``
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long stride, int rows,
                                              int dim, int width, int ld) {
  for (int i = threadIdx.x; i < CS * width; i += FNT) {
    const int r = i / width, d = i % width;
    dst[r * ld + d] = (r < rows && d < dim) ? src[r * stride + d] : 0.f;
  }
}

// Phase 1: S_c for state rows ty + 16 i and columns tx + 16 j of the tile.
__global__ void __launch_bounds__(FNT) ssd_state_f32(const Args a) {
  extern __shared__ float fsm[];
  const int ldb = a.n + 1;
  float* bs = fsm;              // [CS][N+1]
  float* xs = bs + CS * ldb;    // [CS][FPT]
  float* dts = xs + CS * FPT;
  float* cum = dts + CS;
  float* coef = cum + CS;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int ntp = (a.p + FPT - 1) / FPT;
  const int c = blockIdx.x / ntp, p0 = (blockIdx.x % ntp) * FPT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * CS;
  const int rows = a.s - c0 < CS ? a.s - c0 : CS;

  load_rows_f32(bs,
                static_cast<const float*>(a.Bm) + b * a.sb.b + h * a.sb.h +
                    (long long)c0 * a.sb.s,
                a.sb.s, rows, a.n, a.n, ldb);
  load_rows_f32(xs,
                static_cast<const float*>(a.x) + b * a.sx.b + h * a.sx.h +
                    (long long)c0 * a.sx.s + p0,
                a.sx.s, rows, a.p - p0, FPT, FPT);
  if (tid < 32) {
    const float last = chunk_cum(a.dt + b * a.sd.b + h * a.sd.h +
                                     (long long)c0 * a.sd.s,
                                 a.sd.s, rows, a.A[h], dts, cum);
    coef[2 * tid] = expf(last - cum[2 * tid]) * dts[2 * tid];
    coef[2 * tid + 1] = expf(last - cum[2 * tid + 1]) * dts[2 * tid + 1];
    if (tid == 0 && p0 == 0)
      a.gam[((long long)b * a.nh + h) * a.nc + c] = expf(last);
  }
  __syncthreads();

  float acc[FNI][FNJ];
#pragma unroll
  for (int i = 0; i < FNI; ++i)
#pragma unroll
    for (int j = 0; j < FNJ; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < rows; ++k) {
    const float ck = coef[k];
    float bv[FNI], xv[FNJ];
#pragma unroll
    for (int i = 0; i < FNI; ++i) {
      const int r = ty + 16 * i;
      bv[i] = r < a.n ? bs[k * ldb + r] * ck : 0.f;
    }
#pragma unroll
    for (int j = 0; j < FNJ; ++j) xv[j] = xs[k * FPT + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < FNI; ++i)
#pragma unroll
      for (int j = 0; j < FNJ; ++j) acc[i][j] = fmaf(bv[i], xv[j], acc[i][j]);
  }
  const long long np = (long long)a.n * a.p;
  float* st = a.states + (((long long)b * a.nh + h) * a.nc + c) * np;
#pragma unroll
  for (int i = 0; i < FNI; ++i)
#pragma unroll
    for (int j = 0; j < FNJ; ++j) {
      const int r = ty + 16 * i, col = p0 + tx + 16 * j;
      if (r < a.n && col < a.p) st[(long long)r * a.p + col] = acc[i][j];
    }
}

// Phase 3: w for rows 4 ty + i and columns tx + 16 j (4 x 4 a thread),
// then y for rows 4 ty + i and the tile's columns tx + 16 j.
__global__ void __launch_bounds__(FNT) ssd_out_f32(const Args a) {
  extern __shared__ float fsm[];
  const int ldn = a.n + 1, ldw = CS + 1, ldh = FPT + 1;
  float* cs = fsm;               // [CS][N+1]
  float* bs = cs + CS * ldn;     // [CS][N+1]
  float* xs = bs + CS * ldn;     // [CS][FPT]
  float* hs = xs + CS * FPT;     // [N][FPT+1]
  float* ws = hs + MAX_N * ldh;  // [CS][CS+1]
  float* dts = ws + CS * ldw;
  float* cum = dts + CS;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int ntp = (a.p + FPT - 1) / FPT;
  const int c = blockIdx.x / ntp, p0 = (blockIdx.x % ntp) * FPT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * CS;
  const int rows = a.s - c0 < CS ? a.s - c0 : CS;

  load_rows_f32(cs,
                static_cast<const float*>(a.Cm) + b * a.sc.b + h * a.sc.h +
                    (long long)c0 * a.sc.s,
                a.sc.s, rows, a.n, a.n, ldn);
  load_rows_f32(bs,
                static_cast<const float*>(a.Bm) + b * a.sb.b + h * a.sb.h +
                    (long long)c0 * a.sb.s,
                a.sb.s, rows, a.n, a.n, ldn);
  load_rows_f32(xs,
                static_cast<const float*>(a.x) + b * a.sx.b + h * a.sx.h +
                    (long long)c0 * a.sx.s + p0,
                a.sx.s, rows, a.p - p0, FPT, FPT);
  if (c > 0) {
    const long long np = (long long)a.n * a.p;
    const float* st =
        a.states + (((long long)b * a.nh + h) * a.nc + c) * np + p0;
    for (int i = tid; i < a.n * FPT; i += FNT) {
      const int r = i / FPT, d = i % FPT;
      hs[r * ldh + d] = p0 + d < a.p ? st[(long long)r * a.p + d] : 0.f;
    }
  }
  if (tid < 32)
    chunk_cum(a.dt + b * a.sd.b + h * a.sd.h + (long long)c0 * a.sd.s,
              a.sd.s, rows, a.A[h], dts, cum);
  __syncthreads();

  // w: column groups wholly right of this thread's last row are skipped
  {
    const int jmax = (4 * ty + 3) / 16 + 1;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int d = 0; d < a.n; ++d) {
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
  __syncthreads();

  float acc[4][FNJ], off[4][FNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < FNJ; ++j) acc[i][j] = off[i][j] = 0.f;
  const int kmax = 4 * ty + 4;
  for (int k = 0; k < kmax; ++k) {
    float wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = ws[(4 * ty + i) * ldw + k];
#pragma unroll
    for (int j = 0; j < FNJ; ++j) {
      const float xv = xs[k * FPT + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(wv[i], xv, acc[i][j]);
    }
  }
  if (c > 0) {
    for (int d = 0; d < a.n; ++d) {
      float cv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = cs[(4 * ty + i) * ldn + d];
#pragma unroll
      for (int j = 0; j < FNJ; ++j) {
        const float hv = hs[d * ldh + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) off[i][j] = fmaf(cv[i], hv, off[i][j]);
      }
    }
  }
  float* yb = static_cast<float*>(a.y) +
              (((long long)b * a.s + c0) * a.nh + h) * a.p;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows) continue;
    const float e = expf(cum[r]);
#pragma unroll
    for (int j = 0; j < FNJ; ++j) {
      const int col = p0 + tx + 16 * j;
      if (col < a.p)
        yb[(long long)r * a.nh * a.p + col] = acc[i][j] + off[i][j] * e;
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
int launch_pass(const Args& a, cudaStream_t stream) {
  const long long np = (long long)a.n * a.p;
  dim3 grid((unsigned)((np + PASS_NT - 1) / PASS_NT), a.nh, a.b);
  ssd_pass_kernel<<<grid, PASS_NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int NP>
int launch_bf16(const Args& a, int vec, cudaStream_t stream) {
  using T = Tile<NP>;
  int err = set_smem(ssd_state_mma<NP>, T::SMEM1);
  if (err == 0) err = set_smem(ssd_out_mma<NP>, T::SMEM3);
  if (err != 0) return err;
  dim3 grid(a.nc * ((a.p + PT - 1) / PT), a.nh, a.b);
  ssd_state_mma<NP><<<grid, NT, T::SMEM1, stream>>>(a, vec);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  if ((err = launch_pass(a, stream)) != 0) return err;
  ssd_out_mma<NP><<<grid, NT, T::SMEM3, stream>>>(a, vec);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, const Strides& s, int n) {
  return reinterpret_cast<uintptr_t>(p) % (2 * n) == 0 && s.b % n == 0 &&
         s.h % n == 0 && s.s % n == 0;
}

int dispatch_bf16(const Args& a, cudaStream_t stream) {
  const int vec = aligned(a.x, a.sx, 8) && aligned(a.Bm, a.sb, 8) &&
                  aligned(a.Cm, a.sc, 8) && a.p % 8 == 0 && a.n % 8 == 0;
  // N padded to a multiple of 32
  if (a.n <= 32) return launch_bf16<32>(a, vec, stream);
  if (a.n <= 64) return launch_bf16<64>(a, vec, stream);
  if (a.n <= 96) return launch_bf16<96>(a, vec, stream);
  return launch_bf16<128>(a, vec, stream);
}

int dispatch_f32(const Args& a, cudaStream_t stream) {
  const size_t smem1 =
      ((size_t)CS * (a.n + 1) + CS * FPT + 3 * CS) * sizeof(float);
  const size_t smem3 = ((size_t)2 * CS * (a.n + 1) + CS * FPT +
                        (size_t)MAX_N * (FPT + 1) + CS * (CS + 1) + 2 * CS) *
                       sizeof(float);
  int err = set_smem(ssd_state_f32, smem1);
  if (err == 0) err = set_smem(ssd_out_f32, smem3);
  if (err != 0) return err;
  dim3 grid(a.nc * ((a.p + FPT - 1) / FPT), a.nh, a.b);
  ssd_state_f32<<<grid, FNT, smem1, stream>>>(a);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  if ((err = launch_pass(a, stream)) != 0) return err;
  ssd_out_f32<<<grid, FNT, smem3, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16.  Strides are in
// elements for the [B,S,H] dims of x, dt, B and C (B and C have stride 0
// over H where the heads share one group's rows); their last dims are
// contiguous, A is contiguous, and y [B,S,H,P] and h_final [B,H,N,P] are
// written contiguous.  ``ws`` is an f32 workspace of B*H*nc*(N*P + 1)
// floats (nc = ceil(S / 64)), written before it is read: it needs no fill.
// Three launches on ``stream``; returns the first nonzero
// cudaGetLastError() (0 on success).  Shapes and dtypes are checked by
// the caller.
extern "C" int lcx_ssd_scan_fwd(const void* x, const void* dt, const void* A,
                                const void* Bm, const void* Cm, void* y,
                                void* hout, void* ws, int b, int s, int nh,
                                int p, int n, long long sxb, long long sxs,
                                long long sxh, long long sdb, long long sds,
                                long long sdh, long long sbb, long long sbs,
                                long long sbh, long long scb, long long scs,
                                long long sch, int dtype, void* stream) {
  if (b < 1 || s < 1 || nh < 1 || p < 1 || p > MAX_P || n < 1 || n > MAX_N)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bm = Bm;
  a.Cm = Cm;
  a.y = y;
  a.hout = static_cast<float*>(hout);
  a.b = b, a.s = s, a.nh = nh, a.p = p, a.n = n;
  a.nc = (s + CS - 1) / CS;
  a.states = static_cast<float*>(ws);
  a.gam = a.states + (long long)b * nh * a.nc * n * p;
  a.sx = Strides{sxb, sxs, sxh};
  a.sd = Strides{sdb, sds, sdh};
  a.sb = Strides{sbb, sbs, sbh};
  a.sc = Strides{scb, scs, sch};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(a, st);
  if (dtype == 1) return dispatch_bf16(a, st);
  return (int)cudaErrorInvalidValue;
}
