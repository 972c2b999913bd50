// Open-addressing insert into the hash visited set, with the lowest-index
// election, and the gated level's undo of an insert.
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
// Layout: one 32-byte slot word a slot, [C, 4] int64, one sector:
//   key = (hi << 32) | lo (0 = EMPTY), ticket (INT_MAX at rest),
//   val = (val_hi << 32) | val_lo, and a pad word (0).
// Key and ticket share a 16-byte half, which one atomic compare-and-swap
// claims: (0, INT_MAX) -> (key, index). So a reader sees an empty slot, a
// key that was there before the batch (ticket at rest: a hit) or a key
// claimed in this batch with the least index so far (a duplicate), all in
// one 16-byte read. Batch: four int64 word lanes [m] and active [m] bool.
//
// The record of an insert, `filled` int32 [m + 2]: filled[0] the number of
// slots the batch filled, filled[1] the exact-path flag (1 where it ran),
// filled[2 .. 2 + filled[0]) those slots, in no order.
//
// Launches, all on `stream`:
//   0. a memset of filled[0..1];
//   1. claim, one pass over the batch, one lane a thread. Each active
//      element reads its key words once, walks its window (its home slot
//      and the max_probes - 1 after it) and stops at its key or CAS-claims
//      the first empty slot with its index as the ticket. A duplicate of a key
//      claimed in this batch lowers the ticket (atomicMin); a hit stops on
//      its read. A block's claims gather in shared memory and go to the
//      record with one atomicAdd a block. An element that finds neither its
//      key nor an empty slot raises the flag;
//   2. commit, over the record: the ticket names the winner, which is_new
//      marks and whose value the slot takes; the ticket goes back to rest.
//      The flag is raised where the winner's window is occupied from end to
//      end (it reads on from the slot: the slots before it are filled);
//   3. exact: one block, which returns at once unless the flag is raised.
//      Then it clears the slots the record holds and runs the reference's
//      rounds exactly, claim buffer and all, so is_new, overflow and the
//      slot layout are the reference's; the record is made anew.
//
// stpu_hashset_undo clears the slots of a record unless a device flag says
// keep: the gated level's undo of a level it does not commit (one 32-byte
// sector written a winner, only when the level is dropped).
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
// What bounds it on the H100: random accesses. The least an insert moves
// is its batch lanes read once, one 32-byte sector of the table read for
// each active element and, for each new key, its value words read and its
// slot's sector written; every such table access is random, and the card
// serves random sectors far below its streaming rate (chip_smoke.py's
// `hashset_kernel` phase measures both rates at a 2^26-slot table: a
// gather of one word an active lane, and the undo's whole-sector writes).
// The claim pass reads each active element's sector once (a hit or a
// duplicate settles there); the commit pass reads a new key's sector
// again, its value words, and, for its window check, on to the first empty
// slot (about one slot at the engine's load of at most 1/4).
// tools/hashset_variants.py times variants of this file. The exact path
// is one block and slow; it runs only where a window is full, which the
// engine's load rule makes rare, and an overflowing level is retried at a
// larger table anyway.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr int kExactThreads = 1024;
constexpr unsigned kGolden = 0x9E3779B1u;
// A slot word's 64-bit words, and the ticket at rest.
constexpr int kWords = 4, kTicket = 1, kVal = 2;
constexpr unsigned long long kRest = INT_MAX;
// Per-element state bits of the exact path.
constexpr unsigned char kDone = 1, kMatch = 2, kCand = 4, kBump = 8;

__device__ __forceinline__ unsigned long long pack(long long hi, long long lo) {
  return (static_cast<unsigned long long>(hi) << 32) |
         (static_cast<unsigned long long>(lo) & 0xFFFFFFFFull);
}

__device__ __forceinline__ unsigned long long home(unsigned long long key,
                                                   unsigned long long mask) {
  const unsigned h = static_cast<unsigned>(key >> 32);
  const unsigned l = static_cast<unsigned>(key);
  return static_cast<unsigned long long>(h ^ (l * kGolden)) & mask;
}

// Key and ticket of slot s in one 16-byte read from L2 (an L1 line could be
// stale: other blocks claim slots meanwhile).
__device__ __forceinline__ ulonglong2 read_half(const unsigned long long* slots,
                                                unsigned long long s) {
  return __ldcg(reinterpret_cast<const ulonglong2*>(slots + s * kWords));
}

// One 16-byte compare-and-swap of slot s's key and ticket (sm_90); returns
// what the slot held.
__device__ __forceinline__ ulonglong2 cas_half(unsigned long long* slots, unsigned long long s,
                                               ulonglong2 want, ulonglong2 put) {
  ulonglong2 old;
  asm volatile(
      "{\n\t.reg .b128 want128, put128, old128;\n\t"
      "mov.b128 want128, {%2, %3};\n\t"
      "mov.b128 put128, {%4, %5};\n\t"
      "atom.relaxed.gpu.global.cas.b128 old128, [%6], want128, put128;\n\t"
      "mov.b128 {%0, %1}, old128;\n\t}"
      : "=l"(old.x), "=l"(old.y)
      : "l"(want.x), "l"(want.y), "l"(put.x), "l"(put.y), "l"(slots + s * kWords)
      : "memory");
  return old;
}

__global__ void __launch_bounds__(kThreads)
    claim_kernel(unsigned long long* slots, unsigned long long mask, const long long* hi,
                 const long long* lo, const bool* active, long long m, int max_probes,
                 bool* is_new, bool* overflow, int* filled) {
  __shared__ int claimed[kThreads];
  __shared__ int n_claimed, base;
  if (threadIdx.x == 0) n_claimed = 0;
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < m) {
    is_new[i] = false;
    overflow[i] = false;
  }
  if (i < m && active[i]) {
    const unsigned long long k = pack(hi[i], lo[i]);
    const unsigned long long ticket = static_cast<unsigned long long>(i);
    unsigned long long s = home(k, mask);
    bool done = false;
    for (int p = 0; p < max_probes; ++p) {
      ulonglong2 c = read_half(slots, s);
      if (c.x == 0ull) {
        // A stale read of EMPTY is settled by the CAS; a filled key never
        // changes within the batch.
        c = cas_half(slots, s, make_ulonglong2(0ull, kRest), make_ulonglong2(k, ticket));
        if (c.x == 0ull) {
          claimed[atomicAdd(&n_claimed, 1)] = static_cast<int>(s);
          done = true;
          break;
        }
      }
      if (c.x == k) {
        // A ticket below rest: the key was claimed in this batch.
        if (c.y != kRest && c.y > ticket) {
          atomicMin(reinterpret_cast<long long*>(slots + s * kWords + kTicket),
                    static_cast<long long>(ticket));
        }
        done = true;
        break;
      }
      s = (s + 1) & mask;
    }
    if (!done) filled[1] = 1;
  }
  __syncthreads();
  if (threadIdx.x == 0) base = n_claimed ? atomicAdd(&filled[0], n_claimed) : 0;
  __syncthreads();
  if (threadIdx.x < n_claimed) filled[2 + base + threadIdx.x] = claimed[threadIdx.x];
}

__global__ void commit_kernel(unsigned long long* slots, unsigned long long mask,
                              const long long* vh, const long long* vl, int max_probes,
                              bool* is_new, int* filled) {
  const long long n = filled[0];
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const unsigned long long s = static_cast<unsigned>(filled[2 + e]);
    unsigned long long* w = slots + s * kWords;
    const ulonglong2 kt = *reinterpret_cast<const ulonglong2*>(w);
    const long long i = static_cast<long long>(kt.y);
    is_new[i] = true;
    w[kVal] = pack(vh[i], vl[i]);
    w[kTicket] = kRest;
    const unsigned long long before = (s - home(kt.x, mask)) & mask;
    unsigned long long at = (s + 1) & mask;
    bool full = true;
    for (long long p = before + 1; p < max_probes; ++p) {
      if (slots[at * kWords] == 0ull) {
        full = false;
        break;
      }
      at = (at + 1) & mask;
    }
    if (full) filled[1] = 1;
  }
}

__global__ void exact_kernel(unsigned long long* slots, unsigned long long mask,
                             const long long* hi, const long long* lo, const long long* vh,
                             const long long* vl, const bool* active, long long m, int max_probes,
                             bool* is_new, bool* overflow, int* slot, int* probes,
                             unsigned char* state, int* claim, long long claim_cap, int* filled) {
  if (filled[1] == 0) return;
  const int t = threadIdx.x;
  const int n = blockDim.x;
  // Clear what launches 1-2 filled (each slot of the record once); the
  // rounds make the record anew.
  const int n_filled = filled[0];
  for (int e = t; e < n_filled; e += n) {
    unsigned long long* w = slots + static_cast<unsigned long long>(filled[2 + e]) * kWords;
    w[0] = 0ull;
    w[kTicket] = kRest;
    w[kVal] = 0ull;
  }
  __syncthreads();
  if (t == 0) filled[0] = 0;
  for (long long i = t; i < m; i += n) {
    slot[i] = static_cast<int>(home(pack(hi[i], lo[i]), mask));
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
        const unsigned long long k = slots[static_cast<unsigned long long>(slot[i]) * kWords];
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
      const unsigned long long s = static_cast<unsigned>(slot[i]);
      if (st & kMatch) {
        state[i] = kDone;
      } else if (st & kCand) {
        if (claim[s & cmask] == static_cast<int>(i)) {
          slots[s * kWords] = pack(hi[i], lo[i]);
          slots[s * kWords + kVal] = pack(vh[i], vl[i]);
          is_new[i] = true;
          state[i] = kDone;
          filled[2 + atomicAdd(&filled[0], 1)] = static_cast<int>(s);
        } else {
          state[i] = 0;
        }
      } else if (st & kBump) {
        probes[i] += 1;
        slot[i] = static_cast<int>((s + 1) & mask);
        state[i] = 0;
      }
    }
    __syncthreads();
  }
  for (long long i = t; i < m; i += n) overflow[i] = !(state[i] & kDone);
}

__global__ void undo_kernel(unsigned long long* slots, const int* filled, const bool* keep) {
  if (*keep) return;
  // Two threads a slot, one 16-byte half each: a warp's store covers whole
  // sectors, which the card writes without reading them first.
  const long long n = 2LL * filled[0];
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const unsigned long long s = static_cast<unsigned>(filled[2 + (e >> 1)]);
    reinterpret_cast<ulonglong2*>(slots + s * kWords)[e & 1] =
        make_ulonglong2(0ull, (e & 1) ? 0ull : kRest);
  }
}

unsigned grid_for(long long m) {
  const long long want = (m + kThreads - 1) / kThreads;
  return static_cast<unsigned>(want < 1 ? 1 : want < kMaxBlocks ? want : kMaxBlocks);
}

}  // namespace

extern "C" {

// slots: [C, 4] int64 slot words; hi, lo, vh, vl: [m] int64; active,
// is_new, overflow: [m] bool; filled: [m + 2] int32, the record; scratch of
// the exact path: slot and probes [m] int32, state [m] uint8, claim
// [claim_cap] int32. Four operations on `stream` (a memset and three
// kernels). Returns the cudaError_t.
int stpu_hashset_insert(void* slots, long long c, const void* hi, const void* lo, const void* vh,
                        const void* vl, const void* active, long long m, int max_probes,
                        void* is_new, void* overflow, void* filled, void* slot, void* probes,
                        void* state, void* claim, long long claim_cap, void* stream) {
  if (c < 1 || (c & (c - 1)) || c > (1LL << 31) || max_probes < 1 || claim_cap < 1 ||
      (claim_cap & (claim_cap - 1)) || m >= INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(filled, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess || m == 0) return static_cast<int>(err);
  const unsigned long long mask = static_cast<unsigned long long>(c) - 1;
  auto* sw = static_cast<unsigned long long*>(slots);
  auto* h = static_cast<const long long*>(hi);
  auto* l = static_cast<const long long*>(lo);
  auto* v_hi = static_cast<const long long*>(vh);
  auto* v_lo = static_cast<const long long*>(vl);
  auto* a = static_cast<const bool*>(active);
  auto* nw = static_cast<bool*>(is_new);
  auto* ov = static_cast<bool*>(overflow);
  auto* rec = static_cast<int*>(filled);
  const unsigned tiles = static_cast<unsigned>((m + kThreads - 1) / kThreads);
  claim_kernel<<<tiles, kThreads, 0, s>>>(sw, mask, h, l, a, m, max_probes, nw, ov, rec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  commit_kernel<<<grid_for(m), kThreads, 0, s>>>(sw, mask, v_hi, v_lo, max_probes, nw, rec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  exact_kernel<<<1, kExactThreads, 0, s>>>(
      sw, mask, h, l, v_hi, v_lo, a, m, max_probes, nw, ov, static_cast<int*>(slot),
      static_cast<int*>(probes), static_cast<unsigned char*>(state), static_cast<int*>(claim),
      claim_cap, rec);
  return static_cast<int>(cudaGetLastError());
}

// slots: [C, 4] int64; filled: an insert's record (int32, at least m + 2
// long); keep: one bool on the device. One launch on `stream`.
int stpu_hashset_undo(void* slots, const void* filled, const void* keep, long long m,
                      void* stream) {
  undo_kernel<<<grid_for(2 * m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(slots), static_cast<const int*>(filled),
      static_cast<const bool*>(keep));
  return static_cast<int>(cudaGetLastError());
}

const char* stpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
