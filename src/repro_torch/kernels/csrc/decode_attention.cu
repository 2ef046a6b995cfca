// GQA decode attention for Hopper (sm_90a), plain CUDA C++: everything
// between the QKV projections and the output projection of one decode
// step, in one launch.
//
// Replaces no TPU kernel: the reference decodes in plain JAX
// (src/repro/models/attention.py:558, attn_decode), outside any Pallas
// kernel.  It was added because the port's plain decode
// (models/attention.py, attn_decode without the hook) casts each layer's
// whole [B, Smax, Hkv, hd] cache to f32, masks and softmaxes every row,
// valid or not, and takes ~60 launches a layer for RoPE, the row write and
// the mask.
//
// Same function as kernels/decode_attention.py::decode_attention_plain.
// Inputs: the un-roped q [B, Hq, hd] and k_new, v_new [B, Hkv, hd] in bf16
// (after qk_norm where the config has it), cos and sin [B, hd/2] in f32
// (computed once a decode step from the lengths), the layer's cache k and
// v [B, Smax, Hkv, hd] in bf16 and lengths [B] int32.  For each slot b and
// KV head h it
// - ropes q's G = Hq/Hkv heads and k_new in f32 (products and sums rounded
//   one by one, as PyTorch's elementwise ops round them) and rounds them to
//   bf16, as apply_rope does;
// - writes the roped k_new and v_new into row clamp(lengths[b], 0, Smax-1)
//   of the cache, free slots at length 0 included;
// - attends the G query heads over rows max(0, len - window + 1) .. len
//   only (every row up to len without a window): scores, running max and
//   sum and the accumulator in f32, p rounded to bf16 before the PV
//   product, the output rounded once to bf16.
// What differs from the plain version: p is rounded before it is divided
// by the row sum (the plain version rounds the normalised p), exp2 is the
// approximate ex2 with the scale folded in, and the sums run in another
// order.
//
// What bounds it: bytes.  A valid row of one KV head is 512 bytes of K and
// V, against 4 G hd operations: ~6 operations a byte at G = 6, far below
// the ~295 a byte where the tensor cores would be the limit.  So the
// design reads each valid row once and nothing else:
// - A split-KV (flash-decoding) grid of (splits, Hkv, B).  The split count
//   comes from the static Smax (``chunk`` rows a split, the wrapper's
//   CHUNK), never from the lengths, so the host needs no sync; a split
//   that holds no valid row of its slot exits at once.
// - Each split's rows stream through a three-stage ring in shared memory,
//   64 rows a tile, by 16-byte cp.async copies two tiles ahead of the
//   products (one KV head's row is hd * 2 contiguous bytes).
// - The products run on tensor cores, mma.sync m16n8k16 with G padded to
//   16 rows as flash_attention.cu does: each of the 4 warps takes 16 rows
//   of a tile with its own online softmax, and the warps' partials merge
//   through shared memory at the end.
// - The splits merge in the same launch: a split writes its partial
//   (unnormalised acc, max, sum) to scratch and takes a ticket; the last
//   split of a (b, h) to arrive merges them and writes the output, and
//   sets the ticket back to 0 for the next launch.  A slot with one split
//   writes its output directly.  One launch a layer.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;
constexpr int BK = 16 * WARPS;  // rows a tile: 16 for each warp
constexpr int STAGES = 3;       // tiles in the shared-memory ring
constexpr int GP = 16;          // query heads padded to one m16 tile

struct Args {
  const bf16* q;      // [B, Hkv * G, hd]
  const bf16* k_new;  // [B, Hkv, hd]
  const bf16* v_new;
  const float* cos;   // [B, hd / 2]
  const float* sin;
  bf16* kc;           // [B, Smax, Hkv, hd]
  bf16* vc;
  const int* lengths;  // [B]
  bf16* out;           // [B, Hkv * G, hd]
  float* part_acc;     // [B, Hkv, splits, G, hd]
  float* part_ml;      // [B, Hkv, splits, G, 2]: max (log2 units), sum
  int* tickets;        // [B * Hkv], 0 between launches
  int hkv, g, smax, window, chunk, splits;
  float sl2;           // scale * log2(e)
};

template <int HD>
struct Cfg {
  static constexpr int PITCH = HD + 8;  // bf16 a shared-memory row
  static constexpr int CH = HD / 8;     // 16-byte chunks a row
  static constexpr size_t Q = (size_t)GP * PITCH * 2;
  static constexpr size_t RING = (size_t)2 * STAGES * BK * PITCH * 2;
  // the warps' maxima, sums and accumulators, over the ring once it is free
  static constexpr size_t MERGE = (size_t)WARPS * GP * (HD + 2) * 4;
  static constexpr size_t SMEM = Q + (RING > MERGE ? RING : MERGE);
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// apply_rope on one pair: each product and sum rounded to f32 on its own
// (no fused multiply-add), then to bf16
__device__ __forceinline__ void rope(bf16 x1b, bf16 x2b, float c, float s,
                                     bf16& y1, bf16& y2) {
  const float x1 = __bfloat162float(x1b), x2 = __bfloat162float(x2b);
  y1 = __float2bfloat16(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
  y2 = __float2bfloat16(__fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c)));
}

// One warp's 16 rows of a tile: S = Q K^T, the online softmax on the
// fragments, O += P V.  MASK: rows from ``valid`` on hold no key of the
// slot (their scores become -inf, so their p is exactly 0).
template <int HD, bool MASK>
__device__ __forceinline__ void warp_step(const unsigned (&qf)[HD / 16][4],
                                          const bf16* kt, const bf16* vt,
                                          float (&o)[HD / 8][4], float (&m)[2],
                                          float (&l)[2], float sl2,
                                          int valid) {
  constexpr int KS = HD / 16;
  const int t = threadIdx.x & 3;
  float s[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    unsigned kf[4];
    tc::ldsm_x4(kf, kt + 16 * kk);
    tc::mma_bf16(s[0], qf[kk], kf[0], kf[1]);
    tc::mma_bf16(s[1], qf[kk], kf[2], kf[3]);
  }
  if (MASK) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + 2 * t + (e & 1) >= valid) s[j][e] = -INFINITY;
  }
  float al[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float v = fmaxf(fmaxf(s[0][2 * hf], s[0][2 * hf + 1]),
                    fmaxf(s[1][2 * hf], s[1][2 * hf + 1]));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    const float mn = fmaxf(m[hf], v * sl2);
    al[hf] = fast_exp2(m[hf] - mn);
    m[hf] = mn;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = fast_exp2(fmaf(s[j][e], sl2, -m[e >> 1]));
      rs[e >> 1] += s[j][e];
    }
  // this lane's part of the row sum; the quad's parts add at the end
  l[0] = l[0] * al[0] + rs[0];
  l[1] = l[1] * al[1] + rs[1];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[j][0] *= al[0];
    o[j][1] *= al[0];
    o[j][2] *= al[1];
    o[j][3] *= al[1];
  }
  // the S fragments of the 16 rows, rounded to bf16, are the A fragment
  const unsigned pa[4] = {tc::pack_bf16(s[0][0], s[0][1]),
                          tc::pack_bf16(s[0][2], s[0][3]),
                          tc::pack_bf16(s[1][0], s[1][1]),
                          tc::pack_bf16(s[1][2], s[1][3])};
#pragma unroll
  for (int jp = 0; jp < KS; ++jp) {
    unsigned vf[4];
    tc::ldsm_x4_trans(vf, vt + 16 * jp);
    tc::mma_bf16(o[2 * jp], pa, vf[0], vf[1]);
    tc::mma_bf16(o[2 * jp + 1], pa, vf[2], vf[3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT) decode_attn_kernel(const Args a) {
  using C = Cfg<HD>;
  constexpr int PITCH = C::PITCH, CH = C::CH, KS = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qsm = reinterpret_cast<bf16*>(smem_raw);  // [GP][PITCH]
  bf16* ksm = qsm + GP * PITCH;                   // [STAGES][BK][PITCH]
  bf16* vsm = ksm + STAGES * BK * PITCH;          // [STAGES][BK][PITCH]
  __shared__ int is_last;

  const int z = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = a.lengths[b];
  const int hi = min(max(len, 0), a.smax - 1);  // the row written, the last read
  const int lo = a.window > 0 ? max(0, len - a.window + 1) : 0;
  const int z0 = lo / a.chunk, z1 = hi / a.chunk;
  if (z < z0 || z > z1) return;  // no row of this slot in the split
  const int r0 = max(lo, z * a.chunk), r1 = min(hi + 1, (z + 1) * a.chunk);
  const int g = a.g, tid = threadIdx.x;
  const long long bh = (long long)b * a.hkv + h;

  // q's G heads roped into shared memory (rows G..15 zero); the split that
  // holds row hi writes the roped k_new and v_new there first
  const bf16* qb = a.q + bh * g * HD;
  const float* cb = a.cos + (long long)b * (HD / 2);
  const float* sb = a.sin + (long long)b * (HD / 2);
  for (int i = tid; i < GP * (HD / 2); i += NT) {
    const int r = i / (HD / 2), j = i % (HD / 2);
    bf16 y1 = __float2bfloat16(0.f), y2 = y1;
    if (r < g) rope(qb[r * HD + j], qb[r * HD + j + HD / 2], cb[j], sb[j], y1,
                    y2);
    qsm[r * PITCH + j] = y1;
    qsm[r * PITCH + j + HD / 2] = y2;
  }
  const long long row_stride = (long long)a.hkv * HD;  // between cache rows
  const long long base = (long long)b * a.smax * row_stride + h * HD;
  const bf16* kb = a.kc + base;  // row 0 of (b, h)
  const bf16* vb = a.vc + base;
  if (z == z1) {
    const long long at = base + hi * row_stride;
    const bf16* kn = a.k_new + bh * HD;
    const bf16* vn = a.v_new + bh * HD;
    bf16* kw = a.kc + at;
    bf16* vw = a.vc + at;
    for (int j = tid; j < HD / 2; j += NT)
      rope(kn[j], kn[j + HD / 2], cb[j], sb[j], kw[j], kw[j + HD / 2]);
    for (int j = tid; j < HD; j += NT) vw[j] = vn[j];
  }
  __syncthreads();  // the row written is read below, through L2

  const int n_tiles = (r1 - r0 + BK - 1) / BK;
  const auto load_kv = [&](int tile) {
    const int k0 = r0 + tile * BK, rows = r1 - k0;
    bf16* kd = ksm + (tile % STAGES) * BK * PITCH;
    bf16* vd = vsm + (tile % STAGES) * BK * PITCH;
#pragma unroll
    for (int n = 0; n < BK * CH / NT; ++n) {
      const int i = tid + n * NT, r = i / CH, c = (i % CH) * 8;
      const bool ok = r < rows;  // zeros past the split's last row
      const long long off = (long long)(k0 + (ok ? r : 0)) * row_stride + c;
      tc::cp_async16(kd + r * PITCH + c, kb + off, ok ? 16 : 0);
      tc::cp_async16(vd + r * PITCH + c, vb + off, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_kv(st);
    tc::cp_async_commit();
  }

  const int lane = tid & 31, warp = tid >> 5, t = lane & 3, gq = lane >> 2;
  unsigned qf[KS][4];
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  // this lane's ldmatrix rows: K as the "col" B operand, V transposed
  const int koff =
      (16 * warp + (lane & 7) + 8 * (lane >> 4)) * PITCH + 8 * ((lane >> 3) & 1);
  const int voff =
      (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * PITCH + 8 * (lane >> 4);

  for (int it = 0; it < n_tiles; ++it) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile it is in; every warp is done with tile it-1
    if (it + STAGES - 1 < n_tiles) load_kv(it + STAGES - 1);
    tc::cp_async_commit();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        tc::ldsm_x4(qf[kk], qsm + ((lane & 7) + 8 * ((lane >> 3) & 1)) * PITCH +
                                16 * kk + 8 * (lane >> 4));
    }
    const int valid = r1 - (r0 + it * BK + 16 * warp);  // this warp's rows
    if (valid <= 0) continue;
    const bf16* kt = ksm + (it % STAGES) * BK * PITCH + koff;
    const bf16* vt = vsm + (it % STAGES) * BK * PITCH + voff;
    if (valid < 16)
      warp_step<HD, true>(qf, kt, vt, o, m, l, a.sl2, valid);
    else
      warp_step<HD, false>(qf, kt, vt, o, m, l, a.sl2, valid);
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
  }
  __syncthreads();  // every warp is done with the ring
  float* wm = reinterpret_cast<float*>(ksm);  // [WARPS][GP] maxima
  float* wl = wm + WARPS * GP;                // [WARPS][GP] sums
  float* wo = wl + WARPS * GP;                // [WARPS][GP][HD]
  if (t == 0) {
    wm[warp * GP + gq] = m[0];
    wm[warp * GP + gq + 8] = m[1];
    wl[warp * GP + gq] = l[0];
    wl[warp * GP + gq + 8] = l[1];
  }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<float2*>(wo + (warp * GP + gq) * HD + col) =
        make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(wo + (warp * GP + gq + 8) * HD + col) =
        make_float2(o[j][2], o[j][3]);
  }
  __syncthreads();

  // the block's (acc, max, sum) over its warps; a warp with no row of the
  // slot has max -1e30 and weighs exp2(-1e30 - max) = 0
  const int n_act = z1 - z0 + 1;
  bf16* ob = a.out + bh * g * HD;
  for (int i = tid; i < g * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    float mb = wm[r];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mb = fmaxf(mb, wm[w * GP + r]);
    float acc = 0.f, lb = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = fast_exp2(wm[w * GP + r] - mb);
      acc += wo[(w * GP + r) * HD + d] * c;
      lb += wl[w * GP + r] * c;
    }
    if (n_act == 1) {
      ob[i] = __float2bfloat16(acc / lb);
    } else {
      const long long p = (bh * a.splits + z) * g + r;
      a.part_acc[p * HD + d] = acc;
      if (d == 0) {
        a.part_ml[2 * p] = mb;
        a.part_ml[2 * p + 1] = lb;
      }
    }
  }
  if (n_act == 1) return;

  // the last of the slot's splits to arrive merges them
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    is_last = atomicAdd(a.tickets + bh, 1) == n_act - 1;
    if (is_last) a.tickets[bh] = 0;  // every split has taken its ticket
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = tid; i < g * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    const long long p0 = (bh * a.splits + z0) * g + r;
    float mg = NEG_INF;
    for (int zz = 0; zz < n_act; ++zz)
      mg = fmaxf(mg, __ldcg(a.part_ml + 2 * (p0 + (long long)zz * g)));
    float acc = 0.f, lg = 0.f;
    for (int zz = 0; zz < n_act; ++zz) {
      const long long p = p0 + (long long)zz * g;
      const float c = fast_exp2(__ldcg(a.part_ml + 2 * p) - mg);
      acc += __ldcg(a.part_acc + p * HD + d) * c;
      lg += __ldcg(a.part_ml + 2 * p + 1) * c;
    }
    ob[i] = __float2bfloat16(acc / lg);
  }
}

template <int HD>
int launch(const Args& a, int b, cudaStream_t stream) {
  using C = Cfg<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.splits, a.hkv, b);
  decode_attn_kernel<HD><<<grid, NT, C::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Every tensor contiguous, the cache rows 16-byte aligned, lengths in [0,
// Smax) and ``scale`` positive (checked by the caller, as are the shapes).
// ``window`` 0 means none; ``chunk`` (a multiple of 64) is the rows a
// split; ``part_acc`` / ``part_ml`` hold B * Hkv * ceil(Smax / chunk) * G
// partials (unused, and may be null, when that count is one split a slot);
// ``tickets`` holds B * Hkv zeros.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int lcx_decode_attention(
    const void* q, const void* k_new, const void* v_new, const float* cos,
    const float* sin, void* k_cache, void* v_cache, const int* lengths,
    void* out, float* part_acc, float* part_ml, int* tickets, int b, int hq,
    int hkv, int smax, int hd, int window, int chunk, float scale,
    void* stream) {
  if (hkv < 1 || hq % hkv || hq / hkv > GP || b < 1 || b > 65535 ||
      hkv > 65535 || smax < 1 || chunk < BK || chunk % BK || window < 0 ||
      !(scale > 0))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k_new = static_cast<const bf16*>(k_new);
  a.v_new = static_cast<const bf16*>(v_new);
  a.cos = cos;
  a.sin = sin;
  a.kc = static_cast<bf16*>(k_cache);
  a.vc = static_cast<bf16*>(v_cache);
  a.lengths = lengths;
  a.out = static_cast<bf16*>(out);
  a.part_acc = part_acc;
  a.part_ml = part_ml;
  a.tickets = tickets;
  a.hkv = hkv;
  a.g = hq / hkv;
  a.smax = smax;
  a.window = window;
  a.chunk = chunk;
  a.splits = (smax + chunk - 1) / chunk;
  a.sl2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch<64>(a, b, s);
  if (hd == 128) return launch<128>(a, b, s);
  return (int)cudaErrorInvalidValue;
}
