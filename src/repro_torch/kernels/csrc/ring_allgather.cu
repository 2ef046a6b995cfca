// All-gather over rank-stacked tensors for Hopper (sm_90a), plain CUDA
// C++: one read of each shard, broadcast to every rank's row.
//
// Replaces the TPU kernel src/repro/kernels/ring_allgather.py::_ring_kernel
// (line 35; called through ring_all_gather, pl.pallas_call at line 70).
// Same function, on one card where every rank is one row of a
// rank-stacked tensor: x [n, 1, *r] (rank i's shard is x[i]) ->
// out [n, n, *r] with out[r, i] = x[i, 0].  It is a byte copy, so every
// dtype is handled alike and the result is bit-exact.
//
// Why it no longer follows the ring.  The TPU kernel copies its shard
// into its own slot, then for n - 1 steps forwards the slot it received
// last to its right neighbour: the put and signal of remote DMA between
// chips.  Every forwarding step reads back a slot that was just written
// and writes it once more, 2 n^2 S bytes for the n^2 S the result needs,
// which caps a ring at (n + 1) / (2 n) of the bound below (56% at n = 8).
// On one card every rank's row lies in the same memory, so nothing has to
// be forwarded: each shard is read once and stored to all n rows.  The
// ring's put and signal stay where they mean something: in LCX's
// all_gather(backend="ring") (repro_torch/core/collectives.py) and in the
// plain version, ring_all_gather_plain.
//
// What bounds it: bytes.  n S read and n^2 S written, (n + n^2) S bytes
// at 3.35 TB/s on an H100 SXM; it does no arithmetic.
//
// Design (the host-side plan is ring_allgather.plan in Python, where the
// CPU tests check that it covers every byte once):
// - Work unit: a tile of one shard's body (a multiple of 4 KiB, the
//   plan giving every block of the grid one tile or none), read once
//   from x[i] and stored to out[r, i] for r = 0 .. n-1.
// - A body of 16-byte vectors (x and out agree mod 16, S a multiple of
//   16) goes by TMA: one thread per block streams the tile in 16 KiB
//   bulk loads (cp.async.bulk on an mbarrier) through a ring of 4 chunks
//   in shared memory and stores each chunk n times with bulk stores
//   (cp.async.bulk.global.shared::cta) carrying an L2 evict-first hint:
//   the output, up to 4 GiB, is far larger than the 50 MB L2 and is not
//   read back.  The load and store engines stay busy while the threads
//   do almost nothing.  3 blocks of 64 KiB share an SM.
// - Any other body (8, 4, 2 or 1-byte vectors, the widest at which every
//   source and destination is aligned) goes through registers: UNROLL
//   streamed loads in flight per thread (__ldcs), then n streaming
//   stores (__stcs).  The same path at 16 bytes, which the TMA path
//   beat at the FSDP gather's shape, is timed beside it by chip_smoke.py.
// - Each shard's head (before its first aligned byte) and tail (after
//   its last whole vector) go to a byte path in the same launch.
// - A persistent grid of 3 blocks per SM walks the tiles grid-stride.
//   No block waits for another: no flags, no cooperative launch, no
//   memset, and one device operation per call.
// - Offsets are 64-bit: n^2 S reaches 4 GiB at n = 8 and S = 64 MiB.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;     // threads per block
constexpr int UNROLL = 4;   // vectors in flight per thread

struct Args {
  const char* x;
  char* out;
  long long shard;            // S, bytes of one shard
  long long head, body;       // byte path [0, head), vectors [head, head + body)
  long long edge;             // head + tail: byte-path bytes of a shard
  long long tile;             // bytes of a shard's body per work unit
  long long tiles_per_shard;
  long long n_tiles;          // n * tiles_per_shard
  int n;
};

template <int VEC> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<4> { using T = unsigned; };
template <> struct Vec<2> { using T = unsigned short; };
template <> struct Vec<1> { using T = unsigned char; };

// Tile t: a span of shard i's body, loaded once and stored n times.
template <int VEC>
__device__ __forceinline__ void copy_tile(const Args& a, long long t) {
  using V = typename Vec<VEC>::T;
  const long long i = t / a.tiles_per_shard;
  const long long off = a.head + (t - i * a.tiles_per_shard) * a.tile;
  const long long units = min(a.tile, a.head + a.body - off) / VEC;
  const long long row = (long long)a.n * a.shard;  // out[r + 1] - out[r]
  const V* src = reinterpret_cast<const V*>(a.x + i * a.shard + off);
  char* dst0 = a.out + i * a.shard + off;          // out[0, i] + off
  for (long long u0 = threadIdx.x; u0 < units; u0 += (long long)UNROLL * NT) {
    V v[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long u = u0 + (long long)k * NT;
      if (u < units) v[k] = __ldcs(src + u);
    }
    for (int r = 0; r < a.n; ++r) {
      V* dst = reinterpret_cast<V*>(dst0 + r * row);
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const long long u = u0 + (long long)k * NT;
        if (u < units) __stcs(dst + u, v[k]);
      }
    }
  }
}

// The byte path: each shard's head and tail bytes, e = i * edge + b over
// all shards, thread `first` of `stride`.
__device__ __forceinline__ void copy_edges(const Args& a, long long first,
                                           long long stride) {
  const long long row = (long long)a.n * a.shard;
  for (long long e = first; e < a.n * a.edge; e += stride) {
    const long long i = e / a.edge, b = e - i * a.edge;
    const long long j = b < a.head ? b : a.body + b;  // tail after the body
    const char c = a.x[i * a.shard + j];
    for (int r = 0; r < a.n; ++r) a.out[r * row + i * a.shard + j] = c;
  }
}

template <int VEC>
__global__ void __launch_bounds__(NT) broadcast_kernel(Args a) {
  for (long long t = blockIdx.x; t < a.n_tiles; t += gridDim.x)
    copy_tile<VEC>(a, t);
  if (a.edge)
    copy_edges(a, (long long)blockIdx.x * NT + threadIdx.x,
               (long long)gridDim.x * NT);
}

// ---- 16-byte bodies: TMA bulk copies through a ring of shared memory ----
constexpr int TMA_NT = 32;      // one warp; its first thread copies
constexpr int CHUNK = 16384;    // bytes of a bulk load
constexpr int STAGES = 4;       // chunks in shared memory
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

struct Cursor {  // chunk at byte `off` of this block's tile `t`
  long long t, off;
};

__device__ __forceinline__ long long tile_len(const Args& a, long long t) {
  const long long i = t / a.tiles_per_shard;
  return min(a.tile, a.body - (t - i * a.tiles_per_shard) * a.tile);
}

__device__ __forceinline__ void advance(const Args& a, Cursor& c) {
  c.off += CHUNK;
  if (c.off >= tile_len(a, c.t)) {
    c.t += gridDim.x;
    c.off = 0;
  }
}

// c's shard i, its offset in x[i] (and in every out[r, i]) and its bytes
__device__ __forceinline__ long long chunk_at(const Args& a, const Cursor& c,
                                              long long& i, unsigned& len) {
  i = c.t / a.tiles_per_shard;
  len = (unsigned)min((long long)CHUNK, tile_len(a, c.t) - c.off);
  return a.head + (c.t - i * a.tiles_per_shard) * a.tile + c.off;
}

// One thread keeps STAGES - 1 bulk loads in flight ahead of the chunk it
// stores; each chunk is stored n times by bulk copies with an L2
// evict-first hint, and its slot is loaded again once those stores have
// read it (wait_group.read).  The thread waits only on its own block's
// copies.
__global__ void __launch_bounds__(TMA_NT) broadcast_tma_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) unsigned long long bar[STAGES];
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_u32(&bar[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    unsigned long long policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                 : "=l"(policy));
    const long long row = (long long)a.n * a.shard;  // out[r + 1] - out[r]
    auto load = [&](const Cursor& c, int slot) {
      long long i;
      unsigned len;
      const long long off = chunk_at(a, c, i, len);
      const unsigned b = smem_u32(&bar[slot]);
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
          "r"(len)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(smem_u32(stage + slot * CHUNK)),
          "l"(a.x + i * a.shard + off), "r"(len), "r"(b)
          : "memory");
    };
    Cursor ld{blockIdx.x, 0}, st{blockIdx.x, 0};
    for (int s = 0; s < STAGES && ld.t < a.n_tiles; ++s) {
      load(ld, s);
      advance(a, ld);
    }
    for (long long j = 0; st.t < a.n_tiles; ++j) {
      const int slot = (int)(j % STAGES);
      const unsigned b = smem_u32(&bar[slot]);
      const unsigned parity = (unsigned)((j / STAGES) & 1);
      unsigned landed = 0;
      while (!landed)
        asm volatile(
            "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, "
            "[%1], %2; selp.u32 %0, 1, 0, p; }"
            : "=r"(landed)
            : "r"(b), "r"(parity)
            : "memory");
      long long i;
      unsigned len;
      const long long off = chunk_at(a, st, i, len);
      const unsigned src = smem_u32(stage + slot * CHUNK);
      for (int r = 0; r < a.n; ++r)
        asm volatile(
            "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
            " [%0], [%1], %2, %3;" ::"l"(a.out + r * row + i * a.shard + off),
            "r"(src), "r"(len), "l"(policy)
            : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      advance(a, st);
      // load the next chunk into the slot of chunk j - 1 once its stores
      // have read it (chunk j's group may still be reading)
      if (j >= 1 && ld.t < a.n_tiles) {
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        load(ld, (int)((j - 1) % STAGES));
        advance(a, ld);
      }
    }
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
  if (a.edge)
    copy_edges(a, (long long)blockIdx.x * TMA_NT + threadIdx.x,
               (long long)gridDim.x * TMA_NT);
}

template <int VEC>
cudaError_t launch_regs(const Args& a, int grid, cudaStream_t st) {
  broadcast_kernel<VEC><<<grid, NT, 0, st>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_tma(const Args& a, int grid, cudaStream_t st) {
  // above 48 KB of dynamic shared memory needs the attribute, set once
  // per device
  static bool ready[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(broadcast_tma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               STAGES * CHUNK);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  broadcast_tma_kernel<<<grid, TMA_NT, STAGES * CHUNK, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x: n contiguous shards of shard_bytes each; out: n * n * shard_bytes.
// The plan (ring_allgather.plan): vectors of `vec` bytes over
// [head, head + body) of every shard, in tiles of `tile` bytes, on `grid`
// blocks, by TMA bulk copies if `tma` (16-byte vectors only) or else
// through registers; the other bytes of each shard by the byte path.
// Launches one kernel on `stream` and returns its cudaError (0 on
// success); cudaErrorInvalidValue, with nothing launched, for a plan that
// does not fit the shapes or the pointers' alignment.
extern "C" int lcx_ring_allgather(const void* x, void* out, int n,
                                  long long shard_bytes, int vec,
                                  long long head, long long body,
                                  long long tile, int grid, int tma,
                                  void* stream) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  const bool vec_ok = vec == 1 || vec == 2 || vec == 4 || vec == 8 ||
                      vec == 16;
  if (n < 1 || shard_bytes < 1 || grid < 1 || !vec_ok || head < 0 ||
      body < 0 || head + body > shard_bytes || body % vec || tile < vec ||
      tile % vec || (xa + head) % vec || (oa + head) % vec ||
      (n > 1 && shard_bytes % vec) || (tma && vec != 16))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const char*>(x);
  a.out = static_cast<char*>(out);
  a.shard = shard_bytes;
  a.head = head;
  a.body = body;
  a.edge = shard_bytes - body;
  a.tile = tile;
  a.tiles_per_shard = (body + tile - 1) / tile;
  a.n_tiles = (long long)n * a.tiles_per_shard;
  a.n = n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tma) return (int)launch_tma(a, grid, st);
  switch (vec) {
    case 16: return (int)launch_regs<16>(a, grid, st);
    case 8: return (int)launch_regs<8>(a, grid, st);
    case 4: return (int)launch_regs<4>(a, grid, st);
    case 2: return (int)launch_regs<2>(a, grid, st);
    default: return (int)launch_regs<1>(a, grid, st);
  }
}
