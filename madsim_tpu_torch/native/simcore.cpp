// simcore — the native runtime core of the host tier.
//
// The reference's native surface is Rust + libc interposition; ours is the
// executor's hot data structures in C++ (SURVEY.md §2 "native" mapping):
//
//  * TimerHeap  — the virtual-time timer queue (the naive-timer binary heap
//    of madsim/src/sim/time/mod.rs:21-230), ordered by (deadline, seq) with
//    the same FIFO tie-break as the Python heapq path, so swapping the
//    backend never changes a schedule.
//  * ReadyQueue — the random-pop ready queue (swap_remove semantics of
//    madsim/src/sim/utils/mpsc.rs:71-84); the *index* still comes from the
//    Python GlobalRng so the RNG draw sequence is byte-identical.
//  * threefry2x32 — JAX-compatible Threefry-2x32 (20 rounds, rotation
//    schedule and key constant per the Salmon et al. reference
//    implementation used by jax.random), for native bit-exact replay of
//    device-engine randomness without importing JAX.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).
//
// Build: g++ -O2 -shared -fPIC -std=c++17 simcore.cpp -o _simcore.so
// (native/__init__.py builds it into _build/native/ at first use)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- TimerHeap

struct TimerEntry {
  int64_t deadline;
  uint64_t seq;
  uint64_t id;
};

struct TimerHeap {
  std::vector<TimerEntry> heap;
  uint64_t next_seq = 0;
};

static bool timer_later(const TimerEntry& a, const TimerEntry& b) {
  // max-heap comparator inverted -> min-heap on (deadline, seq)
  if (a.deadline != b.deadline) return a.deadline > b.deadline;
  return a.seq > b.seq;
}

TimerHeap* timer_heap_new() { return new TimerHeap(); }

void timer_heap_free(TimerHeap* h) { delete h; }

void timer_heap_push(TimerHeap* h, int64_t deadline, uint64_t id) {
  h->heap.push_back(TimerEntry{deadline, h->next_seq++, id});
  std::push_heap(h->heap.begin(), h->heap.end(), timer_later);
}

// Returns 1 and fills (deadline,id) of the minimum without removing it.
int timer_heap_peek(TimerHeap* h, int64_t* deadline, uint64_t* id) {
  if (h->heap.empty()) return 0;
  *deadline = h->heap.front().deadline;
  *id = h->heap.front().id;
  return 1;
}

int timer_heap_pop(TimerHeap* h, int64_t* deadline, uint64_t* id) {
  if (h->heap.empty()) return 0;
  *deadline = h->heap.front().deadline;
  *id = h->heap.front().id;
  std::pop_heap(h->heap.begin(), h->heap.end(), timer_later);
  h->heap.pop_back();
  return 1;
}

uint64_t timer_heap_len(TimerHeap* h) { return h->heap.size(); }

// --------------------------------------------------------------- ReadyQueue

struct ReadyQueue {
  std::vector<uint64_t> items;
};

ReadyQueue* ready_queue_new() { return new ReadyQueue(); }

void ready_queue_free(ReadyQueue* q) { delete q; }

void ready_queue_push(ReadyQueue* q, uint64_t id) { q->items.push_back(id); }

uint64_t ready_queue_len(ReadyQueue* q) { return q->items.size(); }

// Swap-remove the element at `idx` (the caller draws idx from GlobalRng —
// ref try_recv_random, mpsc.rs:73-83). Returns the removed id.
uint64_t ready_queue_swap_remove(ReadyQueue* q, uint64_t idx) {
  uint64_t id = q->items[idx];
  q->items[idx] = q->items.back();
  q->items.pop_back();
  return id;
}

// -------------------------------------------------------------- threefry2x32

// JAX-compatible Threefry-2x32, 20 rounds (5 blocks of 4), rotations per
// the Random123 reference. key/ctr are two 32-bit words each.
static const unsigned ROT[8] = {13, 15, 26, 6, 17, 29, 16, 24};

static inline uint32_t rotl32(uint32_t x, unsigned d) {
  return (x << d) | (x >> (32 - d));
}

void threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                  uint32_t* out0, uint32_t* out1) {
  uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
  for (unsigned block = 0; block < 5; ++block) {
    const unsigned* r = ROT + (block % 2 ? 4 : 0);
    for (unsigned i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl32(x1, r[i]);
      x1 ^= x0;
    }
    unsigned s = block + 1;
    x0 += ks[s % 3];
    x1 += ks[(s + 1) % 3] + s;
  }
  *out0 = x0;
  *out1 = x1;
}

// Batch helper: n counters (pairs), writes n output pairs.
void threefry2x32_batch(uint32_t k0, uint32_t k1, const uint32_t* ctr,
                        uint32_t* out, uint64_t n) {
  for (uint64_t i = 0; i < n; ++i) {
    threefry2x32(k0, k1, ctr[2 * i], ctr[2 * i + 1], &out[2 * i],
                 &out[2 * i + 1]);
  }
}

}  // extern "C"
