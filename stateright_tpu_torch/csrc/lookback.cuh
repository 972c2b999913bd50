// Single-pass scan pieces shared by the port's two kernels: a block-wide
// exclusive scan and the decoupled look-back of Merrill & Garland (2016,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back").
//
// Both TPU kernels (pallas_compact.py, pallas_merge.py) ran their grid in
// order on one core and carried a running output offset in SMEM from one
// grid step to the next. On Hopper blocks run in parallel and in no order,
// so each tile finds its offset from its predecessors instead:
//
//   * every tile owns one 64-bit status word: the top two bits say what the
//     low 62 hold -- nothing yet (0), the tile's own count (aggregate), or
//     the count of every tile up to and including it (inclusive prefix);
//     flag and count travel in one word, so one relaxed load sees both;
//   * a tile publishes its aggregate at once, then one warp walks back over
//     its predecessors 32 words at a time, summing aggregates until it meets
//     an inclusive prefix, and publishes its own inclusive prefix;
//   * tiles take their index from an atomic ticket, not from blockIdx, so a
//     tile only ever waits on tiles that have already started and that
//     publish without waiting: no order of block scheduling can deadlock.
//
// The status words and the ticket live in one int64 scratch of
// status_words(n_tiles) words, zeroed by a cudaMemsetAsync on the launch's
// stream just before the kernel: two device launches per call.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace stpu {

constexpr unsigned long long kStatusAggregate = 1ull << 62;
constexpr unsigned long long kStatusPrefix = 2ull << 62;
constexpr unsigned long long kCountMask = (1ull << 62) - 1;

// Status words plus the ticket counter.
inline long long status_words(long long n_tiles) { return n_tiles + 1; }

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The tile index of this block, from the ticket after the n_tiles status
// words. Every thread of the block calls it; `slot` is shared memory.
__device__ __forceinline__ long long take_ticket(unsigned long long* status,
                                                 long long n_tiles,
                                                 unsigned long long* slot) {
  if (threadIdx.x == 0) *slot = atomicAdd(status + n_tiles, 1ull);
  __syncthreads();
  return (long long)*slot;
}

// Exclusive scan of one int per thread over the block (blockDim.x a
// multiple of 32, at most 1024). `warp_sums` is shared memory of
// blockDim.x / 32 ints; the block total goes to *total. Synchronises.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < warps; ++w) {
    const int s = warp_sums[w];
    before += w < warp ? s : 0;
    all += s;
  }
  *total = all;
  return before + incl - v;
}

// Decoupled look-back for tile `tile` whose own count is `count`. Called by
// every lane of ONE warp; returns the exclusive prefix (the sum of the
// counts of tiles 0 .. tile-1) on every lane, and leaves the tile's
// inclusive prefix published.
__device__ __forceinline__ long long look_back(unsigned long long* status, long long tile,
                                               long long count) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) store_relaxed(status, kStatusPrefix | (unsigned long long)count);
    return 0;
  }
  if (lane == 0) store_relaxed(status + tile, kStatusAggregate | (unsigned long long)count);
  long long exclusive = 0;
  long long end = tile;  // the window is tiles [end - 32, end), nearest first
  while (true) {
    const long long idx = end - 1 - lane;
    unsigned long long w = kStatusPrefix;  // before tile 0: a zero prefix
    if (idx >= 0) {
      do {
        w = load_relaxed(status + idx);
      } while ((w >> 62) == 0);
    }
    const unsigned prefix = __ballot_sync(0xffffffffu, (w >> 62) == 2);
    // Sum the nearest predecessors up to and including the first one that
    // holds an inclusive prefix (all 32 if none does).
    const int stop = prefix ? __ffs(prefix) - 1 : 31;
    long long v = lane <= stop ? (long long)(w & kCountMask) : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    exclusive += v;
    if (prefix) break;
    end -= 32;
  }
  if (lane == 0) {
    store_relaxed(status + tile, kStatusPrefix | (unsigned long long)(exclusive + count));
  }
  return exclusive;
}

}  // namespace stpu
