// GQA flash-attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (called through flash_attention, pl.pallas_call at line 96).  Same
// function: q [B,Hq,Sq,Dk], k [B,Hkv,Sk,Dk], v [B,Hkv,Sk,Dv] -> o
// [B,Hq,Sq,Dv] in v's dtype; KV head h / (Hq/Hkv); scores, running max m,
// running sum l and the accumulator in f32; p rounded to v's dtype before
// the PV product while l sums the unrounded p, as the Pallas kernel does
// (p.astype(v.dtype)); the causal mask is top-left aligned (row >= col in
// absolute indices); rows whose l stays 0 divide by 1.  Every tensor is a
// strided view with a contiguous innermost dim (the model's [B,S,H,D]
// activations transposed, without a copy); the strides come from the
// caller.
//
// What differs from the TPU kernel, and why:
// - The TPU walks KV blocks as the innermost, in-order grid dimension and
//   carries acc/m/l in VMEM scratch across grid steps.  CUDA blocks run in
//   no order, so one block owns one (batch, q head, q tile) and loops over
//   the KV tiles itself, stopping at the tile that holds the diagonal, as
//   the Pallas kernel skips the blocks above it.
// - The Pallas wrapper halves its block size until it divides S, which
//   falls to one-row blocks for a prime prompt length.  Here the tiles keep
//   their size and the ragged tail (rows >= Sq, keys >= Sk) is masked
//   inside the kernel.
//
// What bounds it at the serving shapes (qwen2-0.5b: Hq 14, Hkv 2, D 64,
// S 39-498; qwen3-moe-30b-a3b: Hq 32, Hkv 4, D 128): neither bytes nor
// operations.  Q, K, V and O are a few hundred KB to a few MB (about a
// microsecond at 3.35 TB/s) and the products a few GFLOP (a few
// microseconds at the bf16 tensor-core rate).  The time is the latency of
// the longest block's walk over its KV tiles: the last q tile of a causal
// prompt walks all of them, one dependent step (wait for the tile, QK^T,
// softmax, PV) after another, and the card is only partly filled.  So the
// design keeps each step short, in instructions as well as in latency:
// - The products run on tensor cores: mma.sync m16n8k16 bf16 with f32
//   accumulators.  A block is 4 warps, 64 q rows; each warp owns 16 rows,
//   and its Q fragments are loaded once with ldmatrix and stay in
//   registers.  The q tiles nearest the end of the sequence, which walk the
//   most KV tiles, start first.
// - K and V tiles (64 keys, 32 for head dims above 64) stream through a
//   three-stage ring in shared memory filled by 16-byte cp.async copies
//   (zero-filled past Sk and past the head dims, which are padded to 32,
//   64, 96 or 128), two tiles ahead of the products; one __syncthreads a
//   tile.  K is read as the "col" B operand straight from its [key][d]
//   rows, V with ldmatrix.trans.  Rows are padded by 16 bytes, so ldmatrix
//   is free of bank conflicts.
// - S = Q K^T stays in registers.  The online softmax runs on the
//   accumulator fragments: the row max as a tree and then over the 4 lanes
//   of a quad by two shuffles, the scale times log2(e) folded into one FMA
//   before ex2.approx, the row sum kept per lane until the end.  The f32 S
//   fragment, packed to bf16, is the A fragment of the PV product as it
//   is: P never goes through shared memory.
// - Causal masking costs nothing off the diagonal: tiles above it are not
//   loaded, and a warp runs the masked variant of its step only on its
//   diagonal and tail tiles (on the others the mask's compares, which
//   cost as much as the softmax, never run).
// Found on the card, and given up: splitting the long KV walks over more
// blocks with a second merging pass, 128-row blocks, two m-tiles a warp,
// 128-key tiles, deeper rings, and skipping the accumulator's rescale when
// no row max moved were all no faster on the card (PERF.md).
// float32 keeps a scalar kernel: TF32 tensor cores round the inputs to 10
// mantissa bits, which the f32 path's tolerance (2e-5 absolute against
// the plain version, and the f32 greedy checks that rest on it) does not
// allow.  It runs 64 by 64 tiles with f32 FMAs from shared memory: each of
// 256 threads owns a 4x4 block of the score tile and a 4x(Dv/16) block of
// the accumulator.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_ptx.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, s;  // elements; the innermost dim is contiguous
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides qs, ks, vs, os;
  int hq, hkv, sq, sk, dk, dv, causal;
  float scale;
};

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------
constexpr int STAGES = 3;  // KV tiles in the shared-memory ring
constexpr int WARPS = 4;   // 16 q rows each: 64 q rows a block

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DP>
struct Tile {
  static constexpr int BQ = 16 * WARPS;          // q rows a block
  static constexpr int BK = DP <= 64 ? 64 : 32;  // keys a KV tile
  static constexpr int PITCH = DP + 8;           // bf16 a shared-memory row
  static constexpr int NT = 32 * WARPS;
  // Q tile, then STAGES stages of K and of V
  static constexpr size_t SMEM = (size_t)(BQ + 2 * STAGES * BK) * PITCH * 2;
};

using bf16 = __nv_bfloat16;

// rows [0, ROWS) x dims [0, DP) of a [rows][dim] view into shared memory:
// 16-byte cp.async copies when ``vec``, zeros past ``rows`` and ``dim``;
// else element by element.
template <int ROWS, int DP, int NT>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long stride, int rows,
                                          int dim, bool vec) {
  constexpr int CH = DP / 8;  // 16-byte chunks a row
  constexpr int PITCH = DP + 8;
  constexpr int N = (ROWS * CH + NT - 1) / NT;
  if (vec) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int i = threadIdx.x + n * NT;
      if (ROWS * CH % NT != 0 && i >= ROWS * CH) break;
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = r < rows && c < dim;
      tc::cp_async16(dst + r * PITCH + c, ok ? src + r * stride + c : src,
                     ok ? 16 : 0);
    }
    return;
  }
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dst[r * PITCH + c + j] = (r < rows && c + j < dim)
                                   ? src[r * stride + c + j]
                                   : __float2bfloat16(0.f);
  }
}

// One warp's work on one KV tile: S = Q K^T, the online softmax on the
// fragments, O += P V.  MASK: the tile holds keys past Sk or above one of
// the warp's rows (their scores become -inf, so their p is exactly 0);
// the other tiles run without the mask's instructions.
template <int DP, int BK, int PITCH, bool MASK>
__device__ __forceinline__ void tile_step(
    const unsigned (&qf)[DP / 16][4], const bf16* kt, const bf16* vt,
    float (&o)[DP / 8][4], float (&m)[2], float (&l)[2], float sl2, int k0,
    int r0, int sk, int causal) {
  constexpr int KS = DP / 16;  // k-steps of QK^T; dv tile pairs of PV
  constexpr int NK = BK / 8;   // key n-tiles of S
  const int t = threadIdx.x & 3;
  float s[NK][4];
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    unsigned kf[NK / 2][4];
#pragma unroll
    for (int jp = 0; jp < NK / 2; ++jp)
      tc::ldsm_x4(kf[jp], kt + 16 * jp * PITCH + 16 * kk);
#pragma unroll
    for (int jp = 0; jp < NK / 2; ++jp) {
      tc::mma_bf16(s[2 * jp], qf[kk], kf[jp][0], kf[jp][1]);
      tc::mma_bf16(s[2 * jp + 1], qf[kk], kf[jp][2], kf[jp][3]);
    }
  }
  if (MASK) {
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const int row = r0 + (e < 2 ? 0 : 8);
        if (col >= sk || (causal && col > row)) s[j][e] = -INFINITY;
      }
  }
  // row max as a tree over the lane's values, then over the quad; the
  // scale (> 0) is applied to the max and folded into the exponent
  float mx[NK][2];
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    mx[j][0] = fmaxf(s[j][0], s[j][1]);
    mx[j][1] = fmaxf(s[j][2], s[j][3]);
  }
#pragma unroll
  for (int w = NK / 2; w > 0; w >>= 1)
#pragma unroll
    for (int j = 0; j < w; ++j) {
      mx[j][0] = fmaxf(mx[j][0], mx[j + w][0]);
      mx[j][1] = fmaxf(mx[j][1], mx[j + w][1]);
    }
  float al[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float v = mx[0][hf];
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    const float mn = fmaxf(m[hf], v * sl2);
    al[hf] = fast_exp2(m[hf] - mn);
    m[hf] = mn;
  }
  float sm[NK][2];
#pragma unroll
  for (int j = 0; j < NK; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = fast_exp2(fmaf(s[j][e], sl2, -m[e >> 1]));
    sm[j][0] = s[j][0] + s[j][1];
    sm[j][1] = s[j][2] + s[j][3];
  }
#pragma unroll
  for (int w = NK / 2; w > 0; w >>= 1)
#pragma unroll
    for (int j = 0; j < w; ++j) {
      sm[j][0] += sm[j + w][0];
      sm[j][1] += sm[j + w][1];
    }
  // this lane's part of the row sum; the quad's parts add at the end
  l[0] = l[0] * al[0] + sm[0][0];
  l[1] = l[1] * al[1] + sm[0][1];
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j) {
    o[j][0] *= al[0];
    o[j][1] *= al[0];
    o[j][2] *= al[1];
    o[j][3] *= al[1];
  }
  // O += P V: the S fragments of keys 16 kk .. 16 kk + 15, rounded to bf16,
  // are the A fragment as they are
#pragma unroll
  for (int kk = 0; kk < NK / 2; ++kk) {
    unsigned vf[KS][4];
#pragma unroll
    for (int jp = 0; jp < KS; ++jp)
      tc::ldsm_x4_trans(vf[jp], vt + 16 * kk * PITCH + 16 * jp);
    const unsigned pa[4] = {tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int jp = 0; jp < KS; ++jp) {
      tc::mma_bf16(o[2 * jp], pa, vf[jp][0], vf[jp][1]);
      tc::mma_bf16(o[2 * jp + 1], pa, vf[jp][2], vf[jp][3]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(32 * WARPS)
flash_mma_kernel(const Args a, int vec_in, int vec_out) {
  using T = Tile<DP>;
  constexpr int BQ = T::BQ, BK = T::BK, PITCH = T::PITCH, NT = T::NT;
  constexpr int KS = DP / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qsm = reinterpret_cast<bf16*>(smem_raw);
  bf16* ksm = qsm + BQ * PITCH;            // [STAGES][BK][PITCH]
  bf16* vsm = ksm + STAGES * BK * PITCH;   // [STAGES][BK][PITCH]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest q tiles first
  int n_tiles = (a.sk + BK - 1) / BK;
  if (a.causal) {  // up to the tile holding the q tile's last row
    const int last = (qt * BQ + BQ - 1) / BK + 1;
    n_tiles = last < n_tiles ? last : n_tiles;
  }

  const int q0 = qt * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h +
                   (long long)q0 * a.qs.s;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs.b + hk * a.vs.h;
  const bool vec = vec_in != 0;
  const auto load_kv = [&](int tile) {
    const int k0 = tile * BK, slot = tile % STAGES;
    load_rows<BK, DP, NT>(ksm + slot * BK * PITCH, kb + k0 * a.ks.s, a.ks.s,
                          a.sk - k0, a.dk, vec);
    load_rows<BK, DP, NT>(vsm + slot * BK * PITCH, vb + k0 * a.vs.s, a.vs.s,
                          a.sk - k0, a.dv, vec);
  };

  // Q and the first tile are one group, the next STAGES-2 tiles one each
  load_rows<BQ, DP, NT>(qsm, qb, a.qs.s, a.sq - q0, a.dk, vec);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_kv(st);
    tc::cp_async_commit();
  }

  const int wrow = q0 + 16 * warp;  // this warp's first row
  const int r0 = wrow + g;          // and this lane's: r0 and r0 + 8
  const float sl2 = a.scale * LOG2E;
  unsigned qf[KS][4];
  float o[2 * KS][4];
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  // this lane's ldmatrix rows: K as the "col" B operand, V transposed
  const int koff = ((lane & 7) + 8 * (lane >> 4)) * PITCH + 8 * ((lane >> 3) & 1);
  const int voff = ((lane & 7) + 8 * ((lane >> 3) & 1)) * PITCH + 8 * (lane >> 4);

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile it is in; every warp is done with tile it-1
    if (it + STAGES - 1 < n_tiles) load_kv(it + STAGES - 1);
    tc::cp_async_commit();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        tc::ldsm_x4(qf[kk], qsm + (16 * warp + (lane & 7) +
                                   8 * ((lane >> 3) & 1)) * PITCH +
                                16 * kk + 8 * (lane >> 4));
    }
    // rows past Sq, and keys all above this warp's diagonal, need nothing
    if (wrow >= a.sq || (a.causal && k0 > wrow + 15)) continue;
    const bf16* kt = ksm + (it % STAGES) * BK * PITCH + koff;
    const bf16* vt = vsm + (it % STAGES) * BK * PITCH + voff;
    if (k0 + BK > a.sk || (a.causal && k0 + BK - 1 > wrow))
      tile_step<DP, BK, PITCH, true>(qf, kt, vt, o, m, l, sl2, k0, r0, a.sk,
                                     a.causal);
    else
      tile_step<DP, BK, PITCH, false>(qf, kt, vt, o, m, l, sl2, k0, r0, a.sk,
                                      a.causal);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
  }
  bf16* ob = static_cast<bf16*>(a.o) + b * a.os.b + h * a.os.h;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + 8 * hf;
    if (row >= a.sq) continue;
    const float inv = 1.f / (l[hf] == 0.f ? 1.f : l[hf]);
    bf16* orow = ob + (long long)row * a.os.s;
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= a.dv) continue;
      const float x0 = o[j][2 * hf] * inv, x1 = o[j][2 * hf + 1] * inv;
      if (vec_out) {  // dv even and 4-byte aligned rows: col + 1 < dv
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        orow[col] = __float2bfloat16(x0);
        if (col + 1 < a.dv) orow[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int DP>
int launch_mma(const Args& a, int b, int vec_in, int vec_out,
               cudaStream_t stream) {
  using T = Tile<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.sq + T::BQ - 1) / T::BQ, a.hq, b);
  flash_mma_kernel<DP><<<grid, T::NT, T::SMEM, stream>>>(a, vec_in, vec_out);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, const Strides& s, int n) {
  return reinterpret_cast<uintptr_t>(p) % (2 * n) == 0 && s.b % n == 0 &&
         s.h % n == 0 && s.s % n == 0;
}

// head dims padded to 32, 64, 96 or 128
int dispatch_bf16(const Args& a, int b, cudaStream_t stream) {
  const int vec_in = aligned(a.q, a.qs, 8) && aligned(a.k, a.ks, 8) &&
                     aligned(a.v, a.vs, 8) && a.dk % 8 == 0 && a.dv % 8 == 0;
  const int vec_out = aligned(a.o, a.os, 2) && a.dv % 2 == 0;
  const int dmax = a.dk > a.dv ? a.dk : a.dv;
  if (dmax <= 32) return launch_mma<32>(a, b, vec_in, vec_out, stream);
  if (dmax <= 64) return launch_mma<64>(a, b, vec_in, vec_out, stream);
  if (dmax <= 96) return launch_mma<96>(a, b, vec_in, vec_out, stream);
  return launch_mma<128>(a, b, vec_in, vec_out, stream);
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs
// ---------------------------------------------------------------------------
constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per KV tile
constexpr int NT = 256;       // threads per block: 16 row groups x 16 lanes

// Shared memory, in floats: Q tile [BQ][dk+1], K tile [BK][dk+1] (padded
// so that 16 lanes reading 16 different keys hit 16 banks), V tile
// [BK][dv], P tile [BQ][BK+1].
__host__ __device__ inline size_t smem_floats(int dk, int dv) {
  return (size_t)BQ * (dk + 1) + (size_t)BK * (dk + 1) + (size_t)BK * dv +
         (size_t)BQ * (BK + 1);
}

// NJ = ceil(dv / 16): accumulator columns per thread.
template <int NJ>
__global__ void __launch_bounds__(NT) flash_f32_kernel(const Args a) {
  extern __shared__ float smem[];
  const int dk = a.dk, dv = a.dv, sq = a.sq, sk = a.sk;
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
  const int hk = h / (a.hq / a.hkv);

  const float* qb = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.ks.b +
                    hk * a.ks.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.vs.b +
                    hk * a.vs.h;
  float* ob = static_cast<float*>(a.o) + b * a.os.b + h * a.os.h;

  for (int i = tid; i < BQ * dk; i += NT) {
    const int r = i / dk, d = i % dk;
    qs[r * ldq + d] = (q0 + r < sq) ? qb[(long long)(q0 + r) * a.qs.s + d]
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
  if (a.causal) {
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
                            ? kb[(long long)(k0 + r) * a.ks.s + d] : 0.f;
    }
    for (int i = tid; i < BK * dv; i += NT) {
      const int r = i / dv, d = i % dv;
      vs[r * dv + d] = (k0 + r < sk)
                           ? vb[(long long)(k0 + r) * a.vs.s + d] : 0.f;
    }
    __syncthreads();

    // scores for rows 4*ty+i, keys tx+16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dk; ++d) {
      float x[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = qs[(4 * ty + i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = ks[(tx + 16 * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = col < sk && (!a.causal || col <= row);
        s[i][j] = ok[j] ? s[i][j] * a.scale : NEG_INF;
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
        ps[(4 * ty + i) * ldp + tx + 16 * j] = p;
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
      if (c < dv) ob[(long long)row * a.os.s + c] = acc[i][j] * inv;
    }
  }
}

template <int NJ>
int launch_f32(const Args& a, int b, cudaStream_t stream) {
  const size_t smem = smem_floats(a.dk, a.dv) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.sq + BQ - 1) / BQ, a.hq, b);
  flash_f32_kernel<NJ><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch_f32(const Args& a, int b, cudaStream_t stream) {
  switch ((a.dv + 15) / 16) {
#define LCX_CASE(NJ) \
  case NJ:           \
    return launch_f32<NJ>(a, b, stream);
    LCX_CASE(1) LCX_CASE(2) LCX_CASE(3) LCX_CASE(4)
    LCX_CASE(5) LCX_CASE(6) LCX_CASE(7) LCX_CASE(8)
#undef LCX_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  ``strides``: 12 element strides, the
// (batch, head, sequence) strides of q, k, v and o in turn; each tensor's
// innermost dim is contiguous and ``scale`` is positive (checked by the
// caller, as are the shapes).  Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int lcx_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o,
                                       const long long* strides, int b,
                                       int hq, int hkv, int sq, int sk,
                                       int dk, int dv, float scale,
                                       int causal, int dtype, void* stream) {
  if (dk < 1 || dk > 128 || dv < 1 || dv > 128 || hkv < 1 || hq % hkv ||
      b < 1 || b > 65535 || hq > 65535 || sq < 1 || sk < 1 || !(scale > 0))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  Strides* st[4] = {&a.qs, &a.ks, &a.vs, &a.os};
  for (int i = 0; i < 4; ++i)
    *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.hq = hq;
  a.hkv = hkv;
  a.sq = sq;
  a.sk = sk;
  a.dk = dk;
  a.dv = dv;
  a.causal = causal;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(a, b, s);
  if (dtype == 1) return dispatch_bf16(a, b, s);
  return (int)cudaErrorInvalidValue;
}
