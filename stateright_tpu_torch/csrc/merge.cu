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
// the previous merged key across chunks in SMEM and placing rows with
// one-hot MXU contractions. On Hopper every row finds its merged position
// on its own, so no carry is needed:
//
//   1. place: table row i goes to i + #{batch < a_i} (lower bound) and
//      batch row j to j + #{table <= b_j} (upper bound: the table wins
//      ties) -- one binary search over the other array per row. The
//      positions are distinct by construction, pads included. The four
//      planes and an is_batch flag land in a [C + m] scratch, and pos_b[j]
//      is recorded.
//   2. keep: keep[x] = real[x] & (!is_batch[x] | key[x] != key[x - 1]);
//      keep_batch[j] = keep[pos_b[j]]. In-batch duplicate runs keep their
//      first (lowest ticket) row; a batch row equal to a table key follows
//      it and dies.
//   3. compact: the stream compaction of compact.cuh moves the four planes
//      by keep into [4, C]; its total is n_keep.
//
// What bounds it on the H100: bytes. Each row does one binary search
// (log2 of the other array's length in dependent 16-byte loads) and a few
// compares; the least time is the table and batch read once, merged and
// keep_batch written once, over 3.35 TB/s. This first design pays about
// three more passes over [C + m] than that floor (the scratch planes are
// written by the placement, read by the keep pass and by the compaction),
// and the searches' loads, which neighbouring threads share through L1/L2.
// A merge-path partition with shared-memory tiles (one read of each input,
// one write) is the faster design a later change can bring.

#include "compact.cuh"

namespace {

constexpr unsigned long long kPad = 0xFFFFFFFFFFFFFFFFull;

__device__ __forceinline__ unsigned long long key_at(const long long* hi,
                                                     const long long* lo,
                                                     long long i) {
  return ((unsigned long long)hi[i] << 32) | (unsigned long long)lo[i];
}

// #{i in [0, n) : key(i) < k} (strict) or #{i : key(i) <= k} (!strict)
// over a sorted key array.
__device__ long long rank_of(const long long* hi, const long long* lo,
                             long long n, unsigned long long k, bool strict) {
  long long l = 0, h = n;
  while (l < h) {
    const long long mid = (l + h) >> 1;
    const unsigned long long x = key_at(hi, lo, mid);
    if (strict ? x < k : x <= k) {
      l = mid + 1;
    } else {
      h = mid;
    }
  }
  return l;
}

__global__ void merge_place(const long long* __restrict__ table, long long c,
                            const long long* __restrict__ batch, long long m,
                            long long* __restrict__ scratch,
                            unsigned char* __restrict__ is_batch,
                            long long* __restrict__ pos_b) {
  const long long n = c + m;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  long long pos;
  const long long* src;
  long long stride, row;
  if (t < c) {
    row = t;
    src = table;
    stride = c;
    pos = row + rank_of(batch, batch + m, m, key_at(table, table + c, row), true);
    is_batch[pos] = 0;
  } else {
    row = t - c;
    src = batch;
    stride = m;
    pos = row + rank_of(table, table + c, c, key_at(batch, batch + m, row), false);
    is_batch[pos] = 1;
    pos_b[row] = pos;
  }
  for (int p = 0; p < 4; ++p) scratch[p * n + pos] = src[p * stride + row];
}

__device__ __forceinline__ bool keep_at(const long long* __restrict__ scratch,
                                        long long n,
                                        const unsigned char* __restrict__ is_batch,
                                        long long x) {
  const unsigned long long k = key_at(scratch, scratch + n, x);
  if (k == kPad) return false;
  if (!is_batch[x] || x == 0) return true;
  return k != key_at(scratch, scratch + n, x - 1);
}

__global__ void merge_keep(const long long* __restrict__ scratch, long long n,
                           const unsigned char* __restrict__ is_batch,
                           const long long* __restrict__ pos_b, long long m,
                           bool* __restrict__ keep, bool* __restrict__ keep_batch) {
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x < n) keep[x] = keep_at(scratch, n, is_batch, x);
  if (x < m) keep_batch[x] = keep_at(scratch, n, is_batch, pos_b[x]);
}

}  // namespace

extern "C" {

// scratch: [4, C + m] int64; is_batch, keep: [C + m] bytes; pos_b: [m] int64;
// tile_scratch: stpu_merge_tiles(C, m) int64. Returns the cudaError_t.
int stpu_merge_insert(const void* table, long long c, const void* batch,
                      long long m, void* scratch, void* is_batch, void* pos_b,
                      void* keep, void* keep_batch, void* merged,
                      void* tile_scratch, void* n_keep, void* stream) {
  const long long n = c + m;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  long long* sc = static_cast<long long*>(scratch);
  if (n > 0) {
    merge_place<<<blocks, threads, 0, s>>>(
        static_cast<const long long*>(table), c,
        static_cast<const long long*>(batch), m, sc,
        static_cast<unsigned char*>(is_batch), static_cast<long long*>(pos_b));
    merge_keep<<<blocks, threads, 0, s>>>(
        sc, n, static_cast<const unsigned char*>(is_batch),
        static_cast<const long long*>(pos_b), m, static_cast<bool*>(keep),
        static_cast<bool*>(keep_batch));
  }
  const cudaError_t placed = cudaGetLastError();
  if (placed != cudaSuccess) return (int)placed;
  stpu::Lanes lanes{};
  lanes.count = 4;
  for (int p = 0; p < 4; ++p) lanes.lane[p] = stpu::Lane{sc + p * n, 1, 0};
  return (int)stpu::launch_compact(
      static_cast<const bool*>(keep), n, 1, lanes, static_cast<long long*>(merged),
      c, static_cast<long long*>(tile_scratch), static_cast<long long*>(n_keep), s);
}

long long stpu_merge_tiles(long long c, long long m) {
  return stpu::num_tiles(c + m);
}

const char* stpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
