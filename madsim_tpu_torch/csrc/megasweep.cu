// The resident multi-step sweep of the probe workload, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel madsim_tpu/engine/megakernel.py::_mega_kernel
// (wrapper run_megasweep). For every seed it runs `steps` complete engine
// events with the seed's whole state in registers, exactly as
// engine/core.step_batch runs them on the probe workload
// (engine/megakernel.py in this package):
//   1. the event's threefry words (fold_in, then one block per word):
//      of the 15 the engine draws, the event reads w0 (the clock jitter),
//      w1 (the pop tie) and w2..w7 (the handler's draws), so only those
//      8 are computed;
//   2. the pop: the lexicographic minimum of (time, prio, slot) with
//      prio = murmur(slot, w1); found = that time is not INVALID;
//   3. the clock: now' = max(now, t) + 50 + mulhi(w0, 51); the event is
//      taken iff the seed is live, found and now' <= time_limit;
//   4. the popped slot is freed when live and found (a pop cut by the
//      time limit is still consumed);
//   5. the probe handler: acc' = acc + (w2 ^ w3), ring[node][acc' & 31] =
//      w4 (node = the popped payload word 0), nsent + 1, and one re-arm
//      at now' + 1 ms + mulhi(w5, 19,000,001) on node mulhi(w6, 5) with
//      payload word 1 = w7 — all gated by take;
//   6. the push at the first free slot (searched after the removal, so
//      the popped slot can be reused); no free slot latches overflow;
//   7. the queue's occupancy after the push raises qmax; a taken event
//      advances now and ctr; a live seed that found nothing or ran past
//      the limit is done, and a done seed is frozen.
//
// Design: one warp per seed, 8 seeds per 256-thread block. Lane l holds
// queue slots l and l + 32 (capacity <= 64: deadline, kind, 8 payload
// words) and ring words ring[j][l] for j < 5, in registers, for all
// `steps` events. Lanes 0-7 each draw one threefry word after every
// lane computes the fold_in block; the words reach all lanes by shuffle.
// The pop is a butterfly shuffle reduction on (time, prio, slot), whose
// min-index tie rule is the reference's argmin; the first free slot and
// the occupancy come from ballots. State is read from and written back to
// device memory once per call.
//
// Bound (S = 16,384 seeds, 512 steps): the carry is read and written once
// per call (about 106 MB, 32 us at 3.35 TB/s), while the integer work is
// about 1,460 32-bit instructions per event (9 threefry blocks, 58 murmur
// priorities and compares, the push, the count and the handler): about
// 1.2e10 per call, about 0.37 ms at the card's issue ceiling of 128
// thread-instructions per SM per clock (chip_smoke.py counts it). So the
// kernel is bound by integer instructions. This first version does not
// attack that: 24 of 32 lanes idle through the draws, and the fold_in
// block is computed by every lane.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sim_math.cuh"

namespace {

using madsim::clock_step;
using madsim::draw_word;
using madsim::fold_in;
using madsim::kInvalidTime;
using madsim::mulhi32;
using madsim::murmur_prio;
using madsim::pop_less;

constexpr int kSeedsPerBlock = 8;
constexpr int kPay = 8;       // payload words per slot
constexpr int kNodes = 5;     // ring rows
constexpr int kRing = 32;     // ring columns (one per lane)
constexpr int kWords = 8;     // the draws the event reads: w0..w7
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kJitterLo = 50, kJitterSpan = 51;
constexpr uint32_t kDelayLo = 1000000, kDelaySpan = 19000001;

struct Planes {
  long long* qtime;      // [S, Q]
  int* qkind;            // [S, Q]
  int* qpay;             // [S, Q, 8]
  const long long* key;  // [S, 2], 32-bit words
  long long* now;        // [S]
  int* ctr;              // [S]
  uint8_t* done;         // [S]
  uint8_t* ov;           // [S]
  long long* qmax;       // [S]
  int* ring;             // [S, 5, 32]
  int* acc;              // [S]
  int* nsent;            // [S]
};

__global__ void __launch_bounds__(32 * kSeedsPerBlock)
megasweep_kernel(Planes p, int num_seeds, int capacity, int steps,
                 long long time_limit) {
  const int seed = blockIdx.x * kSeedsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (seed >= num_seeds) return;  // uniform across the warp
  const size_t row = (size_t)seed * capacity;
  const int s0 = lane, s1 = lane + 32;
  const bool has0 = s0 < capacity, has1 = s1 < capacity;

  long long t0 = kInvalidTime, t1 = kInvalidTime;
  int kd0 = 0, kd1 = 0;
  int pay0[kPay], pay1[kPay];
#pragma unroll
  for (int j = 0; j < kPay; ++j) pay0[j] = pay1[j] = 0;
  if (has0) {
    t0 = p.qtime[row + s0];
    kd0 = p.qkind[row + s0];
#pragma unroll
    for (int j = 0; j < kPay; ++j) pay0[j] = p.qpay[(row + s0) * kPay + j];
  }
  if (has1) {
    t1 = p.qtime[row + s1];
    kd1 = p.qkind[row + s1];
#pragma unroll
    for (int j = 0; j < kPay; ++j) pay1[j] = p.qpay[(row + s1) * kPay + j];
  }
  int ring[kNodes];
#pragma unroll
  for (int j = 0; j < kNodes; ++j)
    ring[j] = p.ring[(size_t)seed * kNodes * kRing + j * kRing + lane];

  const uint32_t k0 = (uint32_t)p.key[2 * seed];
  const uint32_t k1 = (uint32_t)p.key[2 * seed + 1];
  long long now = p.now[seed];
  int ctr = p.ctr[seed];
  bool done = p.done[seed] != 0;
  bool ov = p.ov[seed] != 0;
  long long qmax = p.qmax[seed];
  int acc = p.acc[seed];
  int nsent = p.nsent[seed];

  for (int step = 0; step < steps; ++step) {
    if (done) {
      // a done seed is frozen: nothing pops or pushes, so its occupancy
      // is what it is now for every remaining step
      const int occ =
          __popc(__ballot_sync(kFull, has0 && t0 != kInvalidTime)) +
          __popc(__ballot_sync(kFull, has1 && t1 != kInvalidTime));
      qmax = qmax > occ ? qmax : occ;
      break;
    }

    // 1. draws
    uint32_t f0, f1;
    fold_in(k0, k1, (uint32_t)ctr, &f0, &f1);
    const uint32_t mine = lane < kWords ? draw_word(f0, f1, (uint32_t)lane) : 0u;
    uint32_t w[kWords];
#pragma unroll
    for (int j = 0; j < kWords; ++j) w[j] = __shfl_sync(kFull, mine, j);

    // 2. pop: (time, prio, slot) minimum over the warp
    long long bt = kInvalidTime;
    uint32_t bp = 0xFFFFFFFFu;
    int bs = 0x7FFFFFFF;  // loses to every real slot
    if (has0) {
      bt = t0;
      bp = murmur_prio((uint32_t)s0, w[1]);
      bs = s0;
    }
    if (has1) {
      const uint32_t pr = murmur_prio((uint32_t)s1, w[1]);
      if (pop_less(t1, pr, s1, bt, bp, bs)) {
        bt = t1;
        bp = pr;
        bs = s1;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const long long ot = __shfl_xor_sync(kFull, bt, off);
      const uint32_t op = __shfl_xor_sync(kFull, bp, off);
      const int os = __shfl_xor_sync(kFull, bs, off);
      if (pop_less(ot, op, os, bt, bp, bs)) {
        bt = ot;
        bp = op;
        bs = os;
      }
    }
    const bool found = bt != kInvalidTime;
    // the popped slot's payload word 0 (garbage when !found; every use
    // below is gated by take)
    const int node =
        __shfl_sync(kFull, bs >= 32 ? pay1[0] : pay0[0], bs & 31);

    // 3. clock and masks
    const uint32_t jitter = kJitterLo + mulhi32(w[0], kJitterSpan);
    const long long now2 = clock_step(now, bt, found, jitter);
    const bool time_up = now2 > time_limit;
    const bool take = found && !time_up;  // the seed is live here

    // 4. remove the popped slot (live and found, even when time_up)
    if (found) {
      if (bs == s0) t0 = kInvalidTime;
      if (bs == s1) t1 = kInvalidTime;
    }

    // 5. the probe handler
    const uint32_t acc2 = (uint32_t)acc + (w[2] ^ w[3]);
    if (take && lane == (int)(acc2 & (kRing - 1))) {
#pragma unroll
      for (int j = 0; j < kNodes; ++j)
        if (node == j) ring[j] = (int)w[4];
    }
    const long long et = now2 + (long long)(kDelayLo + mulhi32(w[5], kDelaySpan));
    const int next_node = (int)mulhi32(w[6], kNodes);

    // 6. push at the first free slot
    const unsigned free0 = __ballot_sync(kFull, has0 && t0 == kInvalidTime);
    const unsigned free1 = __ballot_sync(kFull, has1 && t1 == kInvalidTime);
    const int ff = free0 ? __ffs(free0) - 1 : (free1 ? 32 + __ffs(free1) - 1 : -1);
    if (take && ff >= 0) {
      if (ff == s0) {
        t0 = et;
        kd0 = 0;
#pragma unroll
        for (int j = 0; j < kPay; ++j) pay0[j] = 0;
        pay0[0] = next_node;
        pay0[1] = (int)w[7];
      } else if (ff == s1) {
        t1 = et;
        kd1 = 0;
#pragma unroll
        for (int j = 0; j < kPay; ++j) pay1[j] = 0;
        pay1[0] = next_node;
        pay1[1] = (int)w[7];
      }
    }
    ov = ov || (take && ff < 0);

    // 7. occupancy, clock, counters, done
    const int occ = __popc(__ballot_sync(kFull, has0 && t0 != kInvalidTime)) +
                    __popc(__ballot_sync(kFull, has1 && t1 != kInvalidTime));
    qmax = qmax > occ ? qmax : occ;
    if (take) {
      now = now2;
      ctr += 1;
      acc = (int)acc2;
      nsent += 1;
    }
    done = !found || time_up;
  }

  if (has0) {
    p.qtime[row + s0] = t0;
    p.qkind[row + s0] = kd0;
#pragma unroll
    for (int j = 0; j < kPay; ++j) p.qpay[(row + s0) * kPay + j] = pay0[j];
  }
  if (has1) {
    p.qtime[row + s1] = t1;
    p.qkind[row + s1] = kd1;
#pragma unroll
    for (int j = 0; j < kPay; ++j) p.qpay[(row + s1) * kPay + j] = pay1[j];
  }
#pragma unroll
  for (int j = 0; j < kNodes; ++j)
    p.ring[(size_t)seed * kNodes * kRing + j * kRing + lane] = ring[j];
  if (lane == 0) {
    p.now[seed] = now;
    p.ctr[seed] = ctr;
    p.done[seed] = done ? 1 : 0;
    p.ov[seed] = ov ? 1 : 0;
    p.qmax[seed] = qmax;
    p.acc[seed] = acc;
    p.nsent[seed] = nsent;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): `steps` events for seeds
// [0, num_seeds) of the planes, updated in place. Launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch
// (0 = ok); 1000 for a capacity the kernel does not take.
extern "C" int madsim_megasweep(void* qtime, void* qkind, void* qpay,
                                const void* key, void* now, void* ctr,
                                void* done, void* ov, void* qmax, void* ring,
                                void* acc, void* nsent, int num_seeds,
                                int capacity, int steps, long long time_limit,
                                void* stream) {
  if (capacity < 1 || capacity > 64) return 1000;
  if (num_seeds <= 0 || steps <= 0) return 0;
  Planes p{(long long*)qtime, (int*)qkind, (int*)qpay, (const long long*)key,
           (long long*)now, (int*)ctr, (uint8_t*)done, (uint8_t*)ov,
           (long long*)qmax, (int*)ring, (int*)acc, (int*)nsent};
  const dim3 block(32 * kSeedsPerBlock);
  const dim3 grid((num_seeds + kSeedsPerBlock - 1) / kSeedsPerBlock);
  megasweep_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      p, num_seeds, capacity, steps, time_limit);
  return (int)cudaGetLastError();
}
