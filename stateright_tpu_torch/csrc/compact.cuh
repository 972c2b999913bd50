// Order-preserving stream compaction of P int64 lanes by a bool mask.
//
// Replaces the TPU kernel stateright_tpu/ops/pallas_compact.py
// (compact_pallas_staged, pallas_call at :229). There the grid ran in order
// on one core and carried a running output offset in SMEM across grid
// steps, placing survivors with one-hot MXU contractions because Mosaic had
// no in-kernel cumsum. On Hopper blocks run in parallel and in no order, so
// the running offset becomes an explicit three-launch scan:
//
//   1. count:   each block counts the survivors of its tile
//               (__syncthreads_count per round);
//   2. scan:    one block turns the per-block counts into exclusive
//               offsets, in place, and writes the total (n_valid);
//   3. scatter: each block recomputes its in-tile ranks (warp ballot +
//               __popc prefix, per-warp totals in shared memory) and writes
//               lane p of survivor r to out[p * cap + r] only when r < cap.
//
// What bounds it on the H100: bytes. It does a handful of integer
// operations per element and reads the mask twice and each survivor's P
// lanes once; the least time is the mask plus the lanes' live elements
// read and P * min(n, cap) int64 written, over 3.35 TB/s. The design keeps
// those bytes near that floor: lanes are passed as (pointer, stride)
// descriptors in the kernel's parameter block, so a strided plane of the
// [F, A, W] action grid or a per-state lane broadcast over the A action
// slots is read in place -- no stacked [P, M] copy of the grid is made and
// nothing is copied to the device before the launch. The mask is read once
// per pass (two passes). Survivors past cap are dropped with no write.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace stpu {

constexpr int kThreads = 256;                // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;                  // rounds of kThreads per tile
constexpr long long kTile = (long long)kThreads * kRounds;
constexpr int kScanThreads = 1024;
constexpr int kMaxLanes = 32;

// Element k of a lane is base[(k / cols) * s0 + (k % cols) * s1]: the
// row-major flattening of a [M / cols, cols] view with element strides
// (s0, s1). s1 == 0 broadcasts a per-row value over the columns.
struct Lane {
  const long long* base;
  long long s0;
  long long s1;
};

struct Lanes {
  Lane lane[kMaxLanes];
  int count;
};

inline long long num_tiles(long long m) { return (m + kTile - 1) / kTile; }

__global__ void compact_count(const bool* __restrict__ mask, long long m,
                              long long* __restrict__ tile_counts) {
  const long long base = (long long)blockIdx.x * kTile;
  int total = 0;
  for (int r = 0; r < kRounds; ++r) {
    const long long k = base + (long long)r * kThreads + threadIdx.x;
    total += __syncthreads_count(k < m && mask[k]);
  }
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// One block: exclusive scan of tile_counts[0, n_tiles) in place; the total
// goes to *n_valid.
__global__ void compact_scan(long long* __restrict__ tile_counts,
                             long long n_tiles, long long* __restrict__ n_valid) {
  __shared__ long long warp_sums[kScanThreads / 32];
  const long long per = (n_tiles + blockDim.x - 1) / blockDim.x;
  const long long lo = (long long)threadIdx.x * per;
  const long long hi = lo + per < n_tiles ? lo + per : n_tiles;
  long long own = 0;
  for (long long i = lo; i < hi; ++i) own += tile_counts[i];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = own;
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  long long run = incl - own + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (long long i = lo; i < hi; ++i) {
    const long long c = tile_counts[i];
    tile_counts[i] = run;
    run += c;
  }
  if (threadIdx.x == blockDim.x - 1) *n_valid = run;
}

__global__ void compact_scatter(const bool* __restrict__ mask, long long m,
                                long long cols, const __grid_constant__ Lanes lanes,
                                const long long* __restrict__ tile_offsets,
                                long long* __restrict__ out, long long cap) {
  __shared__ int warp_counts[kWarps];
  const long long base = (long long)blockIdx.x * kTile;
  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane_id) - 1u;
  long long running = tile_offsets[blockIdx.x];
  for (int r = 0; r < kRounds; ++r) {
    const long long k = base + (long long)r * kThreads + threadIdx.x;
    const bool keep = k < m && mask[k];
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane_id == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, round_total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_counts[w];
      before += w < warp ? c : 0;
      round_total += c;
    }
    const long long rank = running + before + __popc(ballot & below);
    if (keep && rank < cap) {
      const long long row = k / cols, col = k - row * cols;
      for (int p = 0; p < lanes.count; ++p) {
        const Lane& l = lanes.lane[p];
        out[(long long)p * cap + rank] = l.base[row * l.s0 + col * l.s1];
      }
    }
    running += round_total;
    __syncthreads();  // warp_counts is rewritten next round
  }
}

// The three launches on `stream`. tile_scratch holds num_tiles(m) int64.
inline cudaError_t launch_compact(const bool* mask, long long m, long long cols,
                                  const Lanes& lanes, long long* out, long long cap,
                                  long long* tile_scratch, long long* n_valid,
                                  cudaStream_t stream) {
  const long long n_tiles = num_tiles(m);
  if (n_tiles == 0) return cudaMemsetAsync(n_valid, 0, sizeof(long long), stream);
  compact_count<<<(unsigned)n_tiles, kThreads, 0, stream>>>(mask, m, tile_scratch);
  compact_scan<<<1, kScanThreads, 0, stream>>>(tile_scratch, n_tiles, n_valid);
  compact_scatter<<<(unsigned)n_tiles, kThreads, 0, stream>>>(
      mask, m, cols, lanes, tile_scratch, out, cap);
  return cudaGetLastError();
}

}  // namespace stpu
