// Ring all-gather over rank-stacked tensors for Hopper (sm_90a), plain
// CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/ring_allgather.py::_ring_kernel
// (called through ring_all_gather, pl.pallas_call at line 70).  Same
// function and the same algorithm, on one card where every rank is one
// row of a rank-stacked tensor: x [n, 1, *r] (rank i's shard is x[i]) ->
// out [n, n, *r] with out[r, i] = x[i, 0].  It is a byte copy, so every
// dtype is handled alike.  Rank r:
//   1. copies its shard into out[r, r] (the LCX loopback put);
//   2. for step s = 0 .. n-2 puts slot (r - s) mod n of its own row into
//      the same slot of row (r + 1) mod n, then signals;
//   3. before step s + 1 waits until its incoming slot (r - 1 - s) mod n
//      has arrived.  The TPU kernel's DMA semaphores (rdc.wait()) play
//      this part there; here a flag per (rank, step, block) does.
// The last received slot is not forwarded; n = 1 is the loopback copy.
//
// Design:
// - Blocks.  The grid holds n * B blocks, B per rank.  A rank's block j
//   copies the same contiguous span (j-th of B, a multiple of 16 bytes) of
//   the slot at every step, with its 256 threads striding over the span in
//   16-byte vectors (a byte loop where the pointers or the count are not
//   16-byte aligned, and for the tail).  B is the most blocks that can be
//   resident at once divided by n, and no more than one per 4 KiB of the
//   shard, so a small shard takes one block per rank.
// - Signals.  Block j of rank r, after its span of step s is written:
//   __syncthreads(), then thread 0 does __threadfence() and a device-scope
//   release store of 1 to flag[r][s][j].  Block j of rank r + 1 waits only
//   on that flag (per-span flags, not per-step ones): thread 0 spins on a
//   device-scope acquire load, then __syncthreads().  The forwarded bytes
//   are read with ld.global.cg (L2, never a stale L1 line).  A wait that
//   lasts SPIN_LIMIT_NS traps (a CUDA error at the next synchronise)
//   instead of hanging the card.
// - Flags are zeroed on the launch's stream (cudaMemsetAsync) before every
//   launch, so a launch never sees an earlier one's flags.
// - Co-residency.  A block that spins on its left neighbour's flag needs
//   that neighbour to run, so every block must be resident at once: the
//   grid is sized from cudaOccupancyMaxActiveBlocksPerMultiprocessor times
//   the SM count and launched with cudaLaunchCooperativeKernel, which
//   refuses (an error code, raised by the wrapper) a grid that cannot be.
// - Offsets are 64-bit: n * n * S reaches 4 GiB at n = 8 and S = 64 MiB.
//
// What bounds it: bytes.  The function must read n * S bytes and write
// n * n * S (3.35 TB/s on an H100 SXM).  The ring also reads every
// forwarded slot back and writes its own slot once more, 2 * n * n * S
// bytes in all, so it can reach at most (n + 1) / (2 n) of that bound
// (75% at n = 2, 56% at n = 8); a single broadcast copy could reach all
// of it.  The ring is the TPU kernel's algorithm, kept.
#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                  // threads per block
constexpr long long MIN_SPAN = 4096;     // bytes of shard per block, at least
constexpr int MAX_BLOCKS_PER_RANK = 256; // the wrapper's flag capacity
constexpr unsigned long long SPIN_LIMIT_NS = 5000000000ull;

using flag_ref = cuda::atomic_ref<unsigned, cuda::thread_scope_device>;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Copy this block's span: 16-byte vectors, four in flight per thread,
// where both pointers are 16-byte aligned; bytes for the rest.
__device__ __forceinline__ void copy_span(char* __restrict__ dst,
                                          const char* __restrict__ src,
                                          long long nbytes) {
  long long i = threadIdx.x;
  if (((reinterpret_cast<uintptr_t>(dst) |
        reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const long long nvec = nbytes >> 4;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    long long v = threadIdx.x;
    for (; v + 3 * NT < nvec; v += 4 * NT) {
      const int4 a = __ldcg(s4 + v);
      const int4 b = __ldcg(s4 + v + NT);
      const int4 c = __ldcg(s4 + v + 2 * NT);
      const int4 d = __ldcg(s4 + v + 3 * NT);
      d4[v] = a;
      d4[v + NT] = b;
      d4[v + 2 * NT] = c;
      d4[v + 3 * NT] = d;
    }
    for (; v < nvec; v += NT) d4[v] = __ldcg(s4 + v);
    i = (nvec << 4) + threadIdx.x;
  }
  for (; i < nbytes; i += NT) dst[i] = __ldcg(src + i);
}

__global__ void __launch_bounds__(NT)
ring_allgather_kernel(const char* __restrict__ x, char* __restrict__ out,
                      unsigned* flags, int n, int per_rank, long long shard,
                      long long span) {
  const int r = blockIdx.x / per_rank;
  const int j = blockIdx.x % per_rank;
  const long long lo = (long long)j * span;
  const long long len = lo < shard ? min(span, shard - lo) : 0;
  char* row = out + (long long)r * n * shard;
  char* right_row = out + (long long)((r + 1) % n) * n * shard;
  const int left = (r + n - 1) % n;

  // 1. the loopback put: my shard into my own slot
  copy_span(row + (long long)r * shard + lo, x + (long long)r * shard + lo,
            len);
  __syncthreads();
  for (int s = 0; s < n - 1; ++s) {
    const int slot = (r - s + n) % n;
    if (s > 0) {
      // 3. slot (r - s) arrived from the left neighbour's step s - 1
      if (threadIdx.x == 0) {
        flag_ref f(flags[((long long)left * (n - 1) + (s - 1)) * per_rank + j]);
        const unsigned long long t0 = global_ns();
        while (f.load(cuda::memory_order_acquire) == 0) {
          __nanosleep(32);
          if (global_ns() - t0 > SPIN_LIMIT_NS) __trap();
        }
      }
      __syncthreads();
    }
    // 2. put the slot into the right neighbour's row, then signal
    copy_span(right_row + (long long)slot * shard + lo,
              row + (long long)slot * shard + lo, len);
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      flag_ref f(flags[((long long)r * (n - 1) + s) * per_rank + j]);
      f.store(1u, cuda::memory_order_release);
    }
  }
}

}  // namespace

// x: n contiguous shards of shard_bytes each; out: n * n * shard_bytes;
// flags: flag_capacity 32-bit words of scratch, at least
// n * (n - 1) * MAX_BLOCKS_PER_RANK.  Launches on `stream` and returns the
// launch's cudaError (0 on success); nothing is launched for empty shards.
extern "C" int lcx_ring_allgather(const void* x, void* out, void* flags,
                                  long long flag_capacity, int n,
                                  long long shard_bytes, void* stream) {
  if (n < 1 || shard_bytes < 0 ||
      flag_capacity < (long long)n * (n - 1) * MAX_BLOCKS_PER_RANK)
    return (int)cudaErrorInvalidValue;
  if (shard_bytes == 0) return 0;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ring_allgather_kernel, NT, 0);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  const long long resident = (long long)per_sm * sms;
  if (resident < n) return (int)cudaErrorCooperativeLaunchTooLarge;
  long long blocks = resident / n;
  if (blocks > MAX_BLOCKS_PER_RANK) blocks = MAX_BLOCKS_PER_RANK;
  const long long by_size = (shard_bytes + MIN_SPAN - 1) / MIN_SPAN;
  if (blocks > by_size) blocks = by_size;
  long long span = (shard_bytes + blocks - 1) / blocks;
  span = (span + 15) / 16 * 16;
  blocks = (shard_bytes + span - 1) / span;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_flags = (long long)n * (n - 1) * blocks;
  if (n_flags > 0) {
    err = cudaMemsetAsync(flags, 0, (size_t)n_flags * sizeof(unsigned), st);
    if (err != cudaSuccess) return (int)err;
  }
  const char* xp = static_cast<const char*>(x);
  char* op = static_cast<char*>(out);
  unsigned* fp = static_cast<unsigned*>(flags);
  int per_rank = (int)blocks;
  long long shard = shard_bytes;
  void* args[] = {&xp, &op, &fp, &n, &per_rank, &shard, &span};
  err = cudaLaunchCooperativeKernel((const void*)ring_allgather_kernel,
                                    dim3((unsigned)(n * blocks)), dim3(NT),
                                    args, 0, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
