// The port's native host kit: batch fingerprinting and the parent map.
//
// Counterpart of stateright_tpu/native/hostkit.cpp, with the same C ABI
// (fingerprint_words, parentmap_build/free/count/get/chain), the same
// fmix32 fold and reserved keys, the same splitmix64 slot and the same
// chain return codes, so that both libraries give the same answers bit for
// bit. It is host code, built by g++ (stateright_tpu_torch/native/
// __init__.py) and loaded through ctypes.
//
// The engines keep the visited set on the device; witness reconstruction
// reads its occupied rows (key_hi/key_lo -> parent_hi/parent_lo, uint32
// each) to the host once and walks each discovery's parent chain back to
// an init state. This library indexes those rows in an open-addressing
// table and walks a whole chain in one call.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// Two-lane fingerprint, the mirror of stateright_tpu_torch/ops/fphash.py:
// each word's position-keyed fmix32 digests XOR-folded across the width,
// then one seeded avalanche of the fold.
// ---------------------------------------------------------------------------

static inline uint32_t fmix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

// words: [n, w] row-major uint32; out_hi/out_lo: [n]
void fingerprint_words(const uint32_t* words, int64_t n, int64_t w,
                       uint32_t* out_hi, uint32_t* out_lo) {
    for (int64_t r = 0; r < n; ++r) {
        uint32_t fold_hi = 0;
        uint32_t fold_lo = 0;
        const uint32_t* row = words + r * w;
        for (int64_t i = 0; i < w; ++i) {
            uint32_t word = row[i];
            uint32_t pos = (uint32_t)(i + 1);
            fold_hi ^= fmix32(word * 0x2545F491u + 0x9E3779B9u * pos);
            fold_lo ^= fmix32(word * 0x85157AF5u + 0x61C88647u * pos);
        }
        uint32_t hi = fmix32(fold_hi ^ 0x9E3779B9u);
        uint32_t lo = fmix32(fold_lo ^ 0x517CC1B7u);
        if (hi == 0 && lo == 0) lo = 1;  // the visited set's empty row
        if (hi == 0xFFFFFFFFu && lo == 0xFFFFFFFFu) lo = 0xFFFFFFFEu;  // the sorted set's pad key
        out_hi[r] = hi;
        out_lo[r] = lo;
    }
}

// ---------------------------------------------------------------------------
// Parent map: an open-addressing index over the visited set's rows.
// ---------------------------------------------------------------------------

struct ParentMap {
    int64_t capacity;   // a power of two
    uint64_t* keys;     // fp64, 0 == empty
    uint64_t* parents;  // the parent's fp64
    int64_t count;
};

static inline int64_t pm_slot(uint64_t key, int64_t mask) {
    // splitmix64's finalizer: uncorrelated with the device's slot hash.
    uint64_t z = key + 0x9E3779B97F4A7C15ull;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    z ^= z >> 31;
    return (int64_t)(z & (uint64_t)mask);
}

// Builds the index over n_slots rows, skipping (0, 0) keys; returns NULL
// only when an allocation fails. The capacity is the least power of two of
// at least 64 and at least twice the rows kept.
ParentMap* parentmap_build(const uint32_t* key_hi, const uint32_t* key_lo,
                           const uint32_t* val_hi, const uint32_t* val_lo,
                           int64_t n_slots) {
    int64_t occupied = 0;
    for (int64_t i = 0; i < n_slots; ++i)
        if (key_hi[i] || key_lo[i]) ++occupied;
    int64_t cap = 64;
    while (cap < occupied * 2) cap <<= 1;

    ParentMap* pm = (ParentMap*)std::malloc(sizeof(ParentMap));
    if (!pm) return nullptr;
    pm->capacity = cap;
    pm->count = occupied;
    pm->keys = (uint64_t*)std::calloc((size_t)cap, sizeof(uint64_t));
    pm->parents = (uint64_t*)std::calloc((size_t)cap, sizeof(uint64_t));
    if (!pm->keys || !pm->parents) {
        std::free(pm->keys);
        std::free(pm->parents);
        std::free(pm);
        return nullptr;
    }
    int64_t mask = cap - 1;
    for (int64_t i = 0; i < n_slots; ++i) {
        if (!(key_hi[i] || key_lo[i])) continue;
        uint64_t key = ((uint64_t)key_hi[i] << 32) | key_lo[i];
        uint64_t par = ((uint64_t)val_hi[i] << 32) | val_lo[i];
        int64_t s = pm_slot(key, mask);
        while (pm->keys[s] != 0 && pm->keys[s] != key) s = (s + 1) & mask;
        pm->keys[s] = key;
        pm->parents[s] = par;
    }
    return pm;
}

void parentmap_free(ParentMap* pm) {
    if (!pm) return;
    std::free(pm->keys);
    std::free(pm->parents);
    std::free(pm);
}

int64_t parentmap_count(const ParentMap* pm) { return pm->count; }

// Looks up one fingerprint: returns 1 and writes *parent on a hit, 0 on a
// miss.
int parentmap_get(const ParentMap* pm, uint64_t key, uint64_t* parent) {
    int64_t mask = pm->capacity - 1;
    int64_t s = pm_slot(key, mask);
    while (pm->keys[s] != 0) {
        if (pm->keys[s] == key) {
            *parent = pm->parents[s];
            return 1;
        }
        s = (s + 1) & mask;
    }
    return 0;
}

// Walks the parent chain from fp64 back to a zero parent (an init state),
// writing at most max_len fingerprints into out, the discovery first and
// the init state last. Returns the chain's length, -1 if a fingerprint is
// missing from the map (the host and device codecs disagree), or -2 if the
// chain is longer than max_len (a cycle, which an insert-once table cannot
// hold).
int64_t parentmap_chain(const ParentMap* pm, uint64_t fp64, uint64_t* out,
                        int64_t max_len) {
    int64_t len = 0;
    uint64_t cur = fp64;
    while (cur != 0) {
        if (len >= max_len) return -2;
        uint64_t parent;
        if (!parentmap_get(pm, cur, &parent)) return -1;
        out[len++] = cur;
        cur = parent;
    }
    return len;
}

}  // extern "C"
