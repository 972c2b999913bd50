// Merge-insert of a presorted batch into the key-sorted visited table.
//
// Replaces the TPU kernel stateright_tpu/ops/pallas_merge.py (merge_insert,
// pallas_call at :347, with the merge-path partition _merge_partition :89).
// Contract, equal to that kernel's: table [4, C] and batch [4, m] are int64
// planes (key_hi, key_lo, val_hi, val_lo) holding 32-bit words; the table
// is sorted by (key_hi, key_lo) and the batch by (key, ticket); pads carry
// the all-ones key. Outputs: merged [4, C] (rows from min(n_keep, C) on are
// unspecified), keep_batch [m] in batch-sorted order, and n_keep, the total
// survivor count (above C means overflow).
//
// The TPU kernel walked merge-path chunks in order on one core, carrying
// the previous merged key and the output offset across chunks in SMEM. Here
// it is one pass, one kernel after the memset of its look-back status
// words (lookback.cuh). Block k takes tile k (merged positions
// [kD, (k+1)D), D = kTile) by ticket and
//
//   1. splits its two diagonals by merge-path search over the global keys,
//      one warp each (merge_path below), with the table-first tie rule of
//      _merge_partition: the tile consumes table[ii_k, ii_k+1) and
//      batch[jj_k, jj_k+1), D rows in all;
//   2. loads those rows' keys once, coalesced, folded to one uint64 each,
//      into shared memory;
//   3. gives each thread D / kThreads merged positions: a binary search of
//      its sub-diagonal in shared memory, then a serial merge in registers
//      with the keep rule -- a real table row is kept; a real batch row iff
//      its key differs from the previous merged key; a pad (the all-ones
//      key) never. The previous key of a thread's first position is the
//      larger of the last table and batch keys consumed before it: a
//      shared-memory read inside the tile, and key(t[ii-1]) / key(b[jj-1])
//      at the tile's start -- the TPU kernel's SMEM carry becomes a read;
//   4. ranks its kept rows by a block scan, writes keep_batch for its batch
//      rows, and one warp looks back over the predecessors for the tile's
//      output offset; the last tile writes n_keep;
//   5. writes each kept row once at its rank (nothing at or past C): the
//      key words from shared memory, the two value words read from global
//      memory only now, for kept rows only.
//
// What bounds it on the H100: bytes. A merged position costs a few
// compares; the least time is both inputs' keys read once, the kept rows'
// values read once, merged and keep_batch written once, over 3.35 TB/s.
// The design reads each input once, writes each output once and keeps no
// scratch in device memory but the status words: no per-row search over
// the other array in global memory and no merged copy written and read
// again. What it adds to the bound: the two diagonal searches per tile
// (log32 of the bracket in rounds of 32 parallel loads), the look-back, and
// the block-wide barriers between a tile's stages, which leave an SM's
// memory traffic to its other resident blocks.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;                    // merged positions per thread
constexpr int kTile = kThreads * kPerThread;     // D, merged positions per tile
constexpr unsigned long long kPad = 0xFFFFFFFFFFFFFFFFull;

__device__ __forceinline__ long long lmin(long long a, long long b) { return a < b ? a : b; }

__device__ __forceinline__ unsigned long long key_at(const long long* planes, long long n,
                                                     long long i) {
  return ((unsigned long long)planes[i] << 32) | (unsigned long long)planes[n + i];
}

inline long long num_tiles(long long c, long long m) { return (c + m + kTile - 1) / kTile; }

// The number of table rows among the first d merged rows: the largest i in
// [max(0, d - m), min(c, d)] with key(t[i-1]) <= key(b[d-i]) (ties go to
// the table). Called by all lanes of one warp; each round tests 32 points
// of the bracket and keeps the stretch between the last that holds and the
// first that fails, so n rows close in log32(n) rounds of one load pair.
__device__ long long merge_path(const long long* t, long long c, const long long* b,
                                long long m, long long d) {
  const int lane = threadIdx.x & 31;
  long long lo = d - m > 0 ? d - m : 0;
  long long hi = lmin(c, d);
  while (lo < hi) {
    const long long step = (hi - lo + 31) >> 5;
    const long long at = lmin(lo + (lane + 1) * step, hi);  // in (lo, hi]
    const bool ok = key_at(t, c, at - 1) <= key_at(b, m, d - at);
    const int n = __popc(__ballot_sync(0xffffffffu, ok));  // a prefix of lanes
    if (n == 0) {
      hi = lo + step - 1;
    } else {
      const long long first_fail = n < 32 ? lmin(lo + (n + 1) * step, hi) : hi + 1;
      lo = lmin(lo + n * step, hi);
      hi = first_fail - 1;
    }
  }
  return lo;
}

// At most 40 registers a thread, so six blocks fit on an SM.
__global__ void __launch_bounds__(kThreads, 6)
merge_kernel(const long long* __restrict__ table, long long c,
             const long long* __restrict__ batch, long long m,
             bool* __restrict__ keep_batch, long long* __restrict__ merged,
             unsigned long long* __restrict__ status, long long n_tiles,
             long long* __restrict__ n_keep) {
  __shared__ unsigned long long keys[kTile];  // the tile's table keys, then its batch keys
  __shared__ unsigned short kept[kTile];      // kept rows' slots in keys[], rank order
  __shared__ bool keep_b[kTile];              // keep flags of the tile's batch rows
  __shared__ long long split[2];
  __shared__ unsigned long long before[2];    // key(t[ii-1]), key(b[jj-1])
  __shared__ int warp_sums[kThreads / 32];
  __shared__ unsigned long long slot;
  __shared__ long long offset;
  const long long tile = stpu::take_ticket(status, n_tiles, &slot);
  const long long d0 = tile * kTile;
  const long long d1 = lmin(d0 + kTile, c + m);
  const int warp = threadIdx.x >> 5;

  // 1. The tile's diagonals.
  if (warp < 2) {
    const long long i = merge_path(table, c, batch, m, warp ? d1 : d0);
    if ((threadIdx.x & 31) == 0) split[warp] = i;
  }
  __syncthreads();
  const long long ii = split[0], jj = d0 - ii;
  const int na = (int)(split[1] - ii);
  const int nt = (int)(d1 - d0);
  const int nb = nt - na;

  // 2. Its keys, folded, into shared memory: every load of the thread is
  // issued before the first store, so they are in flight together.
  long long hi_w[kPerThread], lo_w[kPerThread];
#pragma unroll
  for (int v = 0; v < kPerThread; ++v) {
    const int x = threadIdx.x + v * kThreads;
    if (x < nt) {
      const bool from_table = x < na;
      const long long* p = from_table ? table + ii + x : batch + jj + (x - na);
      const long long rows = from_table ? c : m;
      hi_w[v] = p[0];
      lo_w[v] = p[rows];
    }
  }
#pragma unroll
  for (int v = 0; v < kPerThread; ++v) {
    const int x = threadIdx.x + v * kThreads;
    if (x < nt) keys[x] = ((unsigned long long)hi_w[v] << 32) | (unsigned long long)lo_w[v];
  }
  if (threadIdx.x == 0) {
    before[0] = ii > 0 ? key_at(table, c, ii - 1) : 0;
    before[1] = jj > 0 ? key_at(batch, m, jj - 1) : 0;
  }
  __syncthreads();

  // 3. This thread's positions [diag, diag + kPerThread): split, merge, keep.
  const unsigned long long* a = keys;
  const unsigned long long* b = keys + na;
  const int diag = min((int)threadIdx.x * kPerThread, nt);
  int lo = max(0, diag - nb), hi = min(na, diag);
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a[mid - 1] <= b[diag - mid]) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  int i = lo, j = diag - lo;
  const bool has_a = ii + i > 0, has_b = jj + j > 0;
  const unsigned long long pa = i > 0 ? a[i - 1] : before[0];
  const unsigned long long pb = j > 0 ? b[j - 1] : before[1];
  unsigned long long prev = has_a ? (has_b && pb > pa ? pb : pa) : (has_b ? pb : kPad);
  int slots[kPerThread];
  unsigned keep = 0;
#pragma unroll
  for (int v = 0; v < kPerThread; ++v) {
    slots[v] = 0;
    if (diag + v < nt) {
      const bool from_table = j >= nb || (i < na && a[i] <= b[j]);
      const int u = from_table ? i++ : na + j++;
      const unsigned long long k = keys[u];
      const bool kp = k != kPad && (from_table || k != prev);
      if (kp) keep |= 1u << v;
      if (!from_table) keep_b[u - na] = kp;
      prev = k;
      slots[v] = u;
    }
  }

  // 4. Ranks, keep flags, the tile's offset.
  int total;
  int rank = stpu::block_exclusive_scan(__popc(keep), warp_sums, &total);
#pragma unroll
  for (int v = 0; v < kPerThread; ++v) {
    if (keep >> v & 1) kept[rank++] = (unsigned short)slots[v];
  }
  for (int x = threadIdx.x; x < nb; x += kThreads) keep_batch[jj + x] = keep_b[x];
  if (warp == 0) {
    const long long before_tile = stpu::look_back(status, tile, total);
    if (threadIdx.x == 0) {
      offset = before_tile;
      if (tile == n_tiles - 1) *n_keep = before_tile + total;
    }
  }
  __syncthreads();

  // 5. The kept rows, once each, in rank order.
  const long long off = offset;
  for (int x = threadIdx.x; x < total; x += kThreads) {
    const long long r = off + x;
    if (r >= c) break;
    const int u = kept[x];
    const unsigned long long k = keys[u];
    const bool from_table = u < na;
    const long long* src = from_table ? table : batch;
    const long long rows = from_table ? c : m;
    const long long row = from_table ? ii + u : jj + (u - na);
    merged[r] = (long long)(k >> 32);
    merged[c + r] = (long long)(k & 0xFFFFFFFFull);
    merged[2 * c + r] = src[2 * rows + row];
    merged[3 * c + r] = src[3 * rows + row];
  }
}

}  // namespace

extern "C" {

// keep_batch: [m] bool; merged: [4, C] int64; status:
// stpu_merge_status_words(C, m) int64 of scratch; n_keep: one int64.
// Two launches on `stream` (the status memset and the kernel). Returns the
// cudaError_t.
int stpu_merge_insert(const void* table, long long c, const void* batch,
                      long long m, void* keep_batch, void* merged, void* status,
                      void* n_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_tiles = num_tiles(c, m);
  if (n_tiles == 0) return (int)cudaMemsetAsync(n_keep, 0, sizeof(long long), s);
  const cudaError_t err =
      cudaMemsetAsync(status, 0, stpu::status_words(n_tiles) * sizeof(long long), s);
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(
      static_cast<const long long*>(table), c, static_cast<const long long*>(batch), m,
      static_cast<bool*>(keep_batch), static_cast<long long*>(merged),
      static_cast<unsigned long long*>(status), n_tiles, static_cast<long long*>(n_keep));
  return (int)cudaGetLastError();
}

long long stpu_merge_status_words(long long c, long long m) {
  return stpu::status_words(num_tiles(c, m));
}

const char* stpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
