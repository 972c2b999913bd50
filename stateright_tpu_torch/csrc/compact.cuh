// Order-preserving stream compaction of P int64 lanes by a bool mask.
//
// Replaces the TPU kernel stateright_tpu/ops/pallas_compact.py
// (compact_pallas_staged, pallas_call at :229). There the grid ran in order
// on one core and carried a running output offset in SMEM across grid
// steps, placing survivors with one-hot MXU contractions because Mosaic had
// no in-kernel cumsum. Here it is one pass, one kernel after the memset of
// its look-back status words (lookback.cuh):
//
//   1. each block takes a tile of kTile = 8192 flags by ticket and reads
//      them once: 16 flags a thread, as one 16-byte load where the mask is
//      aligned (a scalar loop on the ragged edge), folded to a 16-bit mask;
//   2. popcounts and a block scan give every survivor its rank in the tile;
//      the survivors' tile positions go to shared memory in rank order;
//   3. one warp looks back over the predecessors' status words for the
//      tile's offset; the last tile writes n_valid, the total;
//   4. the block walks its survivors in rank order, so consecutive threads
//      write consecutive columns: lane p of survivor r goes to
//      out[p * cap + r] when r < cap, and nothing is written past cap.
//
// What bounds it on the H100: bytes. It does a handful of integer
// operations per flag; the least time is the mask plus the survivors' lane
// elements read once and P * min(n, cap) int64 written once, over
// 3.35 TB/s. The mask is read once, and a tile's survivors are written in
// rank order, so the writes are coalesced. Lanes are (pointer, stride,
// stride) descriptors in the kernel's parameter block, so a strided plane
// of the [F, A, W] action grid or a per-state lane broadcast over the A
// action slots is read in place: no stacked [P, M] copy of the grid is
// made. The grid's survivors are scattered over its 32-byte sectors (W = 2
// words a slot), so the sectors any kernel must touch hold about twice the
// bytes the bound counts.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace stpu {

constexpr int kThreads = 512;                // threads per block
constexpr int kFlags = 16;                   // flags per thread (one 16-byte load)
constexpr long long kTile = (long long)kThreads * kFlags;
constexpr int kMaxLanes = 64;  // a 64 x 24-byte Lanes block is 1.5 KB of kernel parameters

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

// Four bool bytes (any nonzero byte is true) -> four bits, byte b to bit b.
__device__ __forceinline__ unsigned bits_of(unsigned w) {
  w = __vcmpne4(w, 0u) & 0x01010101u;
  return (w | (w >> 7) | (w >> 14) | (w >> 21)) & 0xFu;
}

__global__ void __launch_bounds__(kThreads)
compact_kernel(const unsigned char* __restrict__ mask, long long m, long long cols,
               const __grid_constant__ Lanes lanes, long long* __restrict__ out,
               long long cap, unsigned long long* __restrict__ status, long long n_tiles,
               long long* __restrict__ n_valid) {
  __shared__ unsigned short pos[kTile];  // survivors' tile positions, rank order
  __shared__ int warp_sums[kThreads / 32];
  __shared__ unsigned long long slot;
  __shared__ long long offset;
  const long long tile = take_ticket(status, n_tiles, &slot);
  const long long base = tile * kTile;
  const long long k0 = base + (long long)threadIdx.x * kFlags;

  unsigned bits = 0;
  if (k0 + kFlags <= m && ((reinterpret_cast<uintptr_t>(mask) & 15) == 0)) {
    const uint4 v = *reinterpret_cast<const uint4*>(mask + k0);
    bits = bits_of(v.x) | bits_of(v.y) << 4 | bits_of(v.z) << 8 | bits_of(v.w) << 12;
  } else {
    for (int b = 0; b < kFlags; ++b) {
      if (k0 + b < m && mask[k0 + b]) bits |= 1u << b;
    }
  }
  int total;
  int rank = block_exclusive_scan(__popc(bits), warp_sums, &total);
  for (unsigned rest = bits; rest; rest &= rest - 1) {
    pos[rank++] = (unsigned short)(threadIdx.x * kFlags + __ffs(rest) - 1);
  }
  if (threadIdx.x < 32) {
    const long long before = look_back(status, tile, total);
    if (threadIdx.x == 0) {
      offset = before;
      if (tile == n_tiles - 1) *n_valid = before + total;
    }
  }
  __syncthreads();

  const long long off = offset;
  const bool narrow = m <= 0xFFFFFFFFll;  // 32-bit division where it fits
  for (int x = threadIdx.x; x < total; x += kThreads) {
    const long long r = off + x;
    if (r >= cap) break;
    const long long k = base + pos[x];
    long long row, col;
    if (narrow) {
      const unsigned q = (unsigned)k / (unsigned)cols;
      row = q;
      col = k - (long long)q * cols;
    } else {
      row = k / cols;
      col = k - row * cols;
    }
    for (int p = 0; p < lanes.count; ++p) {
      const Lane& l = lanes.lane[p];
      out[(long long)p * cap + r] = l.base[row * l.s0 + col * l.s1];
    }
  }
}

// The two launches on `stream`: the status memset and the kernel. status
// holds status_words(num_tiles(m)) int64.
inline cudaError_t launch_compact(const bool* mask, long long m, long long cols,
                                  const Lanes& lanes, long long* out, long long cap,
                                  long long* status, long long* n_valid,
                                  cudaStream_t stream) {
  const long long n_tiles = num_tiles(m);
  if (n_tiles == 0) return cudaMemsetAsync(n_valid, 0, sizeof(long long), stream);
  cudaError_t err = cudaMemsetAsync(status, 0, status_words(n_tiles) * sizeof(long long), stream);
  if (err != cudaSuccess) return err;
  compact_kernel<<<(unsigned)n_tiles, kThreads, 0, stream>>>(
      reinterpret_cast<const unsigned char*>(mask), m, cols, lanes, out, cap,
      reinterpret_cast<unsigned long long*>(status), n_tiles, n_valid);
  return cudaGetLastError();
}

}  // namespace stpu
