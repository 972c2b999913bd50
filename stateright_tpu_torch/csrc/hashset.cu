// Open-addressing insert into the hash visited set, with the lowest-index
// election.
//
// Replaces no TPU kernel: the JAX package's insert
// (stateright_tpu/ops/hashset.py insert) is jitted JAX, a while_loop of
// probe rounds in which a scatter-min over a claim buffer elects one winner
// per slot. Its round count depends on the data, which a CUDA graph cannot
// replay without conditional nodes, and an atomic compare-and-swap is the
// card's own form of the insert. Contract, the reference's: EMPTY is the key
// 0; the home slot is (hi ^ (lo * 0x9E3779B1)) & (C - 1) in 32-bit
// arithmetic, probing linear; among in-batch duplicates of a key absent
// before the batch the lowest batch index wins (is_new) and its value is
// stored; overflow[i] says element i is unresolved after max_probes
// advances past other keys.
//
// Planes: key [C] and val [C] int64, (hi << 32) | lo; ticket [C] int32,
// INT_MAX at rest. Batch: four int64 word lanes [m] and active [m] bool.
// Launches, all on `stream`:
//   0. a memset of the exact-path flag;
//   1. claim: each active element walks its window (its home slot and the
//      max_probes - 1 after it), stops at its key, or CAS-claims the first
//      empty slot, and records that slot; a claimer marks the slot's ticket
//      with its index. An element that finds neither raises the flag;
//   2. elect: each element whose slot was claimed in this batch (ticket
//      below INT_MAX: a key new to the table) marks itself, takes
//      atomicMin of its index on that ticket, and raises the flag if its
//      window is occupied from end to end (it reads on from its slot: the
//      slots before it are filled);
//   3. commit: the marked element whose index equals its slot's ticket is
//      the winner: is_new, its value written, the ticket reset. Another
//      element of the slot reads the winner's index or INT_MAX, never its
//      own;
//   4. exact: one block, which returns at once unless the flag is raised.
//      Then it clears the slots the batch filled (one winner each) and runs
//      the reference's rounds exactly, claim buffer and all, so is_new,
//      overflow and the slot layout are the reference's.
//
// A fifth entry point, stpu_hashset_undo, clears the slots an insert's
// winners filled unless a device flag says keep: the gated level's undo of
// a level it does not commit (one byte read an element; two words written
// a winner, only when the level is dropped).
//
// Why the flag is enough: linear probing fills the same set of slots
// whatever the order of the insertions, the reference's rounds are one such
// order (each round's winners in any order), and so are the CAS's
// successes. The reference leaves an element unresolved only after
// passing max_probes slots that stay filled, and what it fills is a subset
// of what this kernel fills: so an element the reference would leave
// unresolved finds its whole window filled here. (An element whose key was
// in the table stops at it, inside its window, in both; duplicates of a
// new key travel together in the reference.) With no full window and
// no failed claim, the reference resolves every element, and is_new, the
// empty overflow and the stored (key, value) pairs are its. Only the slot
// that each of several distinct keys contending for one slot lands in may
// differ (the CAS's arrival order).
//
// What bounds it on the H100: bytes and latency. The least an insert moves
// is its batch lanes read once, one 32-byte sector of the table read for
// each active element and a key and a value written for each new key;
// every such table access is random. Launches 1-3 each read an element's
// slot again and its ticket twice; the window check, for new keys only,
// reads on to the first empty slot (about one slot at the engine's load of
// at most 1/4). The exact path is one block and slow; it
// runs only where a window is full, which the engine's load rule makes
// rare, and an overflowing level is retried at a larger table anyway.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr int kExactThreads = 1024;
constexpr unsigned kGolden = 0x9E3779B1u;
// Per-element state bits of the exact path.
constexpr unsigned char kDone = 1, kMatch = 2, kCand = 4, kBump = 8;

__device__ __forceinline__ unsigned long long pack(long long hi, long long lo) {
  return (static_cast<unsigned long long>(hi) << 32) |
         (static_cast<unsigned long long>(lo) & 0xFFFFFFFFull);
}

__device__ __forceinline__ unsigned long long home(long long hi, long long lo,
                                                   unsigned long long mask) {
  const unsigned h = static_cast<unsigned>(hi);
  const unsigned l = static_cast<unsigned>(lo);
  return static_cast<unsigned long long>(h ^ (l * kGolden)) & mask;
}

__global__ void claim_kernel(unsigned long long* key, int* ticket, unsigned long long mask,
                             const long long* hi, const long long* lo, const bool* active,
                             long long m, int max_probes, bool* is_new, bool* overflow,
                             long long* slot, int* flag) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < m;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    is_new[i] = false;
    overflow[i] = false;
    slot[i] = -1;
    if (!active[i]) continue;
    const unsigned long long k = pack(hi[i], lo[i]);
    unsigned long long s = home(hi[i], lo[i], mask);
    long long at = -1;
    for (int p = 0; p < max_probes; ++p) {
      // A stale read of 0 is settled by the CAS; a filled slot never changes.
      unsigned long long cur = key[s];
      if (cur == 0ull) {
        cur = atomicCAS(&key[s], 0ull, k);
        if (cur == 0ull) {
          atomicMin(&ticket[s], static_cast<int>(i));
          at = static_cast<long long>(s);
          break;
        }
      }
      if (cur == k) {
        at = static_cast<long long>(s);
        break;
      }
      s = (s + 1) & mask;
    }
    slot[i] = at;
    if (at < 0) *flag = 1;
  }
}

__global__ void elect_kernel(const unsigned long long* key, int* ticket, unsigned long long mask,
                             const long long* hi, const long long* lo, long long m,
                             int max_probes, const long long* slot, unsigned char* fresh,
                             int* flag) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < m;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long s = slot[i];
    fresh[i] = s >= 0 && ticket[s] != INT_MAX;
    if (!fresh[i]) continue;
    atomicMin(&ticket[s], static_cast<int>(i));
    const unsigned long long h = home(hi[i], lo[i], mask);
    const unsigned long long before = (static_cast<unsigned long long>(s) - h) & mask;
    unsigned long long w = (static_cast<unsigned long long>(s) + 1) & mask;
    bool full = true;
    for (long long p = before + 1; p < max_probes; ++p) {
      if (key[w] == 0ull) {
        full = false;
        break;
      }
      w = (w + 1) & mask;
    }
    if (full) *flag = 1;
  }
}

__global__ void commit_kernel(unsigned long long* val, int* ticket, const long long* vh,
                              const long long* vl, long long m, const long long* slot,
                              const unsigned char* fresh, bool* is_new) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < m;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (!fresh[i]) continue;
    const long long s = slot[i];
    if (ticket[s] != static_cast<int>(i)) continue;
    is_new[i] = true;
    val[s] = pack(vh[i], vl[i]);
    ticket[s] = INT_MAX;
  }
}

__global__ void exact_kernel(unsigned long long* key, unsigned long long* val,
                             unsigned long long mask, const long long* hi, const long long* lo,
                             const long long* vh, const long long* vl, const bool* active,
                             long long m, int max_probes, bool* is_new, bool* overflow,
                             long long* slot, int* probes, unsigned char* state, int* claim,
                             long long claim_cap, const int* flag) {
  if (*flag == 0) return;
  const int t = threadIdx.x;
  const int n = blockDim.x;
  // Clear what launches 1-3 filled: each filled slot has one winner.
  for (long long i = t; i < m; i += n) {
    if (is_new[i]) {
      key[slot[i]] = 0ull;
      val[slot[i]] = 0ull;
    }
  }
  __syncthreads();
  for (long long i = t; i < m; i += n) {
    slot[i] = static_cast<long long>(home(hi[i], lo[i], mask));
    probes[i] = 0;
    state[i] = active[i] ? 0 : kDone;
    is_new[i] = false;
  }
  const unsigned long long cmask = static_cast<unsigned long long>(claim_cap) - 1;
  __shared__ int any_live;
  for (long long rnd = 0; rnd < max_probes + m; ++rnd) {
    if (t == 0) any_live = 0;
    for (long long j = t; j < claim_cap; j += n) claim[j] = INT_MAX;
    __syncthreads();
    // Reads of the table as the round starts: match, candidate or advance.
    int mine = 0;
    for (long long i = t; i < m; i += n) {
      unsigned char st = state[i] & kDone;
      if (!st && probes[i] < max_probes) {
        mine = 1;
        const unsigned long long k = key[slot[i]];
        if (k == 0ull) {
          st = kCand;
          atomicMin(&claim[static_cast<unsigned long long>(slot[i]) & cmask], static_cast<int>(i));
        } else {
          st = k == pack(hi[i], lo[i]) ? kMatch : kBump;
        }
      }
      state[i] = st;
    }
    if (mine) any_live = 1;
    __syncthreads();
    if (!any_live) break;
    // Winners write; matches are done; blocked elements advance.
    for (long long i = t; i < m; i += n) {
      const unsigned char st = state[i];
      const long long s = slot[i];
      if (st & kMatch) {
        state[i] = kDone;
      } else if (st & kCand) {
        if (claim[static_cast<unsigned long long>(s) & cmask] == static_cast<int>(i)) {
          key[s] = pack(hi[i], lo[i]);
          val[s] = pack(vh[i], vl[i]);
          is_new[i] = true;
          state[i] = kDone;
        } else {
          state[i] = 0;
        }
      } else if (st & kBump) {
        probes[i] += 1;
        slot[i] = static_cast<long long>((static_cast<unsigned long long>(s) + 1) & mask);
        state[i] = 0;
      }
    }
    __syncthreads();
  }
  for (long long i = t; i < m; i += n) overflow[i] = !(state[i] & kDone);
}

__global__ void undo_kernel(unsigned long long* key, unsigned long long* val, const long long* slot,
                            const bool* is_new, const bool* keep, long long m) {
  if (*keep) return;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < m;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (is_new[i]) {
      key[slot[i]] = 0ull;
      val[slot[i]] = 0ull;
    }
  }
}

unsigned grid_for(long long m) {
  const long long want = (m + kThreads - 1) / kThreads;
  return static_cast<unsigned>(want < kMaxBlocks ? want : kMaxBlocks);
}

}  // namespace

extern "C" {

// key, val: [C] int64; ticket: [C] int32 (INT_MAX at rest); hi, lo, vh, vl:
// [m] int64; active, is_new, overflow: [m] bool; slot: [m] int64; scratch:
// probes [m] int32, state [m] uint8, claim [claim_cap] int32, flag one
// int32. Five launches on `stream`. Returns the cudaError_t.
int stpu_hashset_insert(void* key, void* val, void* ticket, long long c, const void* hi,
                        const void* lo, const void* vh, const void* vl, const void* active,
                        long long m, int max_probes, void* is_new, void* overflow, void* slot,
                        void* probes, void* state, void* claim, long long claim_cap, void* flag,
                        void* stream) {
  if (m == 0) return 0;
  if (c < 1 || (c & (c - 1)) || max_probes < 1 || claim_cap < 1 ||
      (claim_cap & (claim_cap - 1)) || m > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned long long mask = static_cast<unsigned long long>(c) - 1;
  const unsigned blocks = grid_for(m);
  auto* k64 = static_cast<unsigned long long*>(key);
  auto* v64 = static_cast<unsigned long long*>(val);
  auto* tk = static_cast<int*>(ticket);
  auto* h = static_cast<const long long*>(hi);
  auto* l = static_cast<const long long*>(lo);
  auto* a = static_cast<const bool*>(active);
  auto* nw = static_cast<bool*>(is_new);
  auto* sl = static_cast<long long*>(slot);
  auto* fl = static_cast<int*>(flag);
  cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  claim_kernel<<<blocks, kThreads, 0, s>>>(k64, tk, mask, h, l, a, m, max_probes, nw,
                                           static_cast<bool*>(overflow), sl, fl);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // The exact path's state bytes serve launches 2-3 as the fresh-key marks.
  auto* fresh = static_cast<unsigned char*>(state);
  elect_kernel<<<blocks, kThreads, 0, s>>>(k64, tk, mask, h, l, m, max_probes, sl, fresh, fl);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  commit_kernel<<<blocks, kThreads, 0, s>>>(v64, tk, static_cast<const long long*>(vh),
                                            static_cast<const long long*>(vl), m, sl, fresh, nw);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  exact_kernel<<<1, kExactThreads, 0, s>>>(
      k64, v64, mask, h, l, static_cast<const long long*>(vh), static_cast<const long long*>(vl),
      a, m, max_probes, nw, static_cast<bool*>(overflow), sl, static_cast<int*>(probes),
      static_cast<unsigned char*>(state), static_cast<int*>(claim), claim_cap, fl);
  return static_cast<int>(cudaGetLastError());
}

// key, val: [C] int64; slot: [m] int64 and is_new: [m] bool of an insert;
// keep: one bool on the device. One launch on `stream`.
int stpu_hashset_undo(void* key, void* val, const void* slot, const void* is_new,
                      const void* keep, long long m, void* stream) {
  if (m == 0) return 0;
  undo_kernel<<<grid_for(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(key), static_cast<unsigned long long*>(val),
      static_cast<const long long*>(slot), static_cast<const bool*>(is_new),
      static_cast<const bool*>(keep), m);
  return static_cast<int>(cudaGetLastError());
}

const char* stpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
