// One seed's events of the probe workload, shared by the megasweep kernel
// (megasweep.cu, the seed's slots in shared memory) and its host build
// (sim_math_host.cpp, the slots in the state's own arrays), so the CPU
// tests run the kernel's own arithmetic against the reference.
//
// probe_run(seed, slots, ring, capacity, steps, time_limit) runs `steps`
// engine events of one seed exactly as engine/core.step_batch runs them on
// the probe workload (and as madsim_tpu/engine/megakernel.py::_mega_kernel
// does). Per event, in the reference's order:
//   1. the draws: fold_in(key, ctr), then the words the event reads,
//      w0 (the clock jitter) and w2..w7 (the handler's draws); w1 (the pop
//      tie) only when two or more live slots share the minimum deadline;
//   2. the pop: the lexicographic minimum of (time, prio, slot) with
//      prio = murmur(slot, w1). Only the live slots (a set bit of the
//      seed's live mask: deadline != INVALID) are walked: a unique
//      minimum needs no priority, and on an empty queue every slot ties
//      but the popped slot is used only when something was found;
//   3. the clock: now' = max(now, t) + 50 + mulhi(w0, 51); the event is
//      taken iff the seed is live, found and now' <= time_limit;
//   4. the popped slot is freed when found (a pop cut by the time limit
//      is still consumed);
//   5. the handler, under take: acc' = acc + (w2 ^ w3); the ring cell
//      f = node * 32 + (acc' & 31) in int32 wrap-around (node = the popped
//      payload word 0, any int32) gets w4 when 0 <= f < 160, as the
//      reference's `flat == node * 32 + idx` over the [5, 32] ring; one
//      re-arm at now' + 1 ms + mulhi(w5, 19,000,001) on node mulhi(w6, 5)
//      with payload word 1 = w7;
//   6. the push at the lowest free slot, searched after the removal; no
//      free slot latches overflow (only on a taken event);
//   7. the occupancy after the push raises qmax; a taken event advances
//      now, ctr, acc and nsent; a live seed that found nothing or ran
//      past the limit is done, and a done seed is frozen (its occupancy
//      still raises qmax once more).
// A live seed that is not taken is done, so the events of a run use the
// counters ctr, ctr + 1, ... in turn. The run is software-pipelined on
// that: while an event's handler and push run (without a branch), the
// next event's draws and the key of the one after are computed beside
// them as 8 interleaved threefry blocks, so one thread always has
// independent instruction chains to issue (on the card, one warp per
// scheduler has only its own to hide each instruction's latency).
//
// The slots are addressed through strides: the deadline, payload word 0
// and payload word 1 of slot i are time[i * ts], node[i * ns] and
// word1[i * ws]. A removed slot only leaves the live mask; a pushed slot
// gets its deadline, word 0 and word 1 here and joins `pushed`. The
// caller writes the rest once after the run: INVALID for a slot that is
// not live, and kind 0 and payload words 2-7 = 0 for a pushed slot.

#pragma once

#include <stdint.h>

#include "sim_math.cuh"

namespace madsim {

constexpr int kProbePay = 8;    // payload words per slot
constexpr int kProbeNodes = 5;  // ring rows
constexpr int kProbeRing = 32;  // ring columns
constexpr uint32_t kProbeJitterLo = 50, kProbeJitterSpan = 51;
constexpr uint32_t kProbeDelayLo = 1000000, kProbeDelaySpan = 19000001;

struct ProbeSlots {
  long long* time;
  int ts;
  int* node;  // payload word 0
  int ns;
  int* word1;  // payload word 1
  int ws;
};

struct ProbeSeed {
  uint32_t k0, k1;
  long long now;
  int ctr;
  bool done, ov;
  long long qmax;
  int acc, nsent;
  uint64_t live;    // bit i: slot i's deadline is not INVALID
  uint64_t pushed;  // bit i: slot i was pushed during the run
};

// The state planes of a batch (the layout cuda_megasweep.planes makes):
// qtime int64[S, Q], qkind int32[S, Q], qpay int32[S, Q, 8], key as int64
// words [S, 2], now, ctr, done (uint8), ov (uint8), qmax, ring int32[S, 5,
// 32], acc, nsent.
struct ProbePlanes {
  long long* qtime;
  int* qkind;
  int* qpay;
  const long long* key;
  long long* now;
  int* ctr;
  uint8_t* done;
  uint8_t* ov;
  long long* qmax;
  int* ring;
  int* acc;
  int* nsent;
};

MADSIM_HD ProbeSeed probe_load(const ProbePlanes& p, int seed) {
  ProbeSeed s;
  s.k0 = (uint32_t)p.key[2 * seed];
  s.k1 = (uint32_t)p.key[2 * seed + 1];
  s.now = p.now[seed];
  s.ctr = p.ctr[seed];
  s.done = p.done[seed] != 0;
  s.ov = p.ov[seed] != 0;
  s.qmax = p.qmax[seed];
  s.acc = p.acc[seed];
  s.nsent = p.nsent[seed];
  s.live = 0;
  s.pushed = 0;
  return s;
}

MADSIM_HD void probe_store(const ProbePlanes& p, int seed, const ProbeSeed& s) {
  p.now[seed] = s.now;
  p.ctr[seed] = s.ctr;
  p.done[seed] = s.done ? 1 : 0;
  p.ov[seed] = s.ov ? 1 : 0;
  p.qmax[seed] = s.qmax;
  p.acc[seed] = s.acc;
  p.nsent[seed] = s.nsent;
}

// Payload word j of a pushed slot: word 0 the node, word 1 the draw w7,
// the rest 0.
MADSIM_HD int probe_pushed_word(int j, int node, int word1) {
  return j == 0 ? node : (j == 1 ? word1 : 0);
}

MADSIM_HD int lowest_bit(uint64_t m) {  // m != 0
#ifdef __CUDA_ARCH__
  return __ffsll((long long)m) - 1;
#else
  return __builtin_ctzll(m);
#endif
}

MADSIM_HD int popcount64(uint64_t m) {
#ifdef __CUDA_ARCH__
  return __popcll(m);
#else
  return __builtin_popcountll(m);
#endif
}

MADSIM_HD uint64_t capacity_mask(int capacity) {  // 1 <= capacity <= 64
  return capacity == 64 ? ~0ull : (1ull << capacity) - 1;
}

MADSIM_HD uint64_t probe_live_mask(const ProbeSlots& q, int capacity) {
  uint64_t live = 0;
  for (int i = 0; i < capacity; ++i)
    if (q.time[i * q.ts] != kInvalidTime) live |= 1ull << i;
  return live;
}

// The ring cell of the handler's write: node * 32 + idx with int32
// wrap-around, or -1 when that lies outside the [5, 32] ring.
MADSIM_HD int probe_ring_cell(int node, uint32_t idx) {
  const uint32_t f = (uint32_t)node * (uint32_t)kProbeRing + idx;
  return f < (uint32_t)(kProbeNodes * kProbeRing) ? (int)f : -1;
}

// Fold a live slot's (deadline, node) into the pop's running minimum, in
// any order of the slots: a unique minimum is found whatever the order,
// and a tied one is settled by the walk of the tie path. A slot that is
// not there (`has` false) changes nothing. No branch: bitwise logic and
// selects.
MADSIM_HD void pop_fold(bool has, long long t, int i, int node, long long& bt,
                        int& bs, int& bnode, bool& tied) {
  const bool less = has & (t < bt);
  tied = (!less) & (tied | (has & (t == bt)));
  bt = less ? t : bt;
  bs = less ? i : bs;
  bnode = less ? node : bnode;
}

// The lowest set bit of m, or -1 when m is 0.
MADSIM_HD int lowest_bit_or_none(uint64_t m) {
#ifdef __CUDA_ARCH__
  return __ffsll((long long)m) - 1;
#else
  return m ? __builtin_ctzll(m) : -1;
#endif
}

constexpr int kPopAhead = 6;  // live slots loaded without a branch

// The pop's minimum deadline bt over the live slots, the slot bs holding
// it and that slot's node (payload word 0); bt is INVALID on an empty
// queue. Only a minimum that two or more live slots hold takes the tie
// path: the draw w1 from the event's key (f0, f1) and the minimal (prio,
// slot) among them.
MADSIM_HD void probe_pop(const ProbeSeed& s, const ProbeSlots& q, uint32_t f0,
                         uint32_t f1, long long& bt, int& bs, int& node) {
  uint64_t m = s.live;
  int slot[kPopAhead], nd[kPopAhead];
  long long t[kPopAhead];
  MADSIM_UNROLL
  for (int k = 0; k < kPopAhead; ++k) {  // loads issued together
    slot[k] = lowest_bit_or_none(m);
    const int at = slot[k] < 0 ? 0 : slot[k];  // slot 0 stands in for none
    t[k] = q.time[at * q.ts];
    nd[k] = q.node[at * q.ns];
    m &= m - 1;
  }
  bt = kInvalidTime;
  bs = 0;
  node = 0;
  bool tied = false;
  MADSIM_UNROLL
  for (int k = 0; k < kPopAhead; ++k)
    pop_fold(slot[k] >= 0, t[k], slot[k], nd[k], bt, bs, node, tied);
  for (; m; m &= m - 1) {
    const int i = lowest_bit(m);
    pop_fold(true, q.time[i * q.ts], i, q.node[i * q.ns], bt, bs, node, tied);
  }
  if (tied) {
    const uint32_t w1 = draw_word(f0, f1, 1u);
    uint32_t bp = 0;
    bs = -1;
    for (uint64_t r = s.live; r; r &= r - 1) {  // increasing slots
      const int i = lowest_bit(r);
      if (q.time[i * q.ts] != bt) continue;
      const uint32_t p = murmur_prio((uint32_t)i, w1);
      if (bs < 0 || p < bp) {
        bp = p;
        bs = i;
      }
    }
    node = q.node[bs * q.ns];
  }
}

// 8 interleaved threefry blocks: the draws w0 and w2..w7 (into w[0] and
// w[2..7]; w[1] is drawn by the tie path alone) of the event whose key is
// (f0, f1), and the key (g0, g1) = fold_in((k0, k1), ctr) of a later event.
MADSIM_HD void probe_draws(uint32_t k0, uint32_t k1, uint32_t ctr, uint32_t f0,
                           uint32_t f1, uint32_t* w, uint32_t* g0,
                           uint32_t* g1) {
  const uint32_t key0[8] = {k0, f0, f0, f0, f0, f0, f0, f0};
  const uint32_t key1[8] = {k1, f1, f1, f1, f1, f1, f1, f1};
  const uint32_t x0[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  const uint32_t x1[8] = {ctr, 0u, 2u, 3u, 4u, 5u, 6u, 7u};
  uint32_t o0[8], o1[8];
  threefry2x32_n<8>(key0, key1, x0, x1, o0, o1);
  *g0 = o0[0];
  *g1 = o1[0];
  w[0] = o0[1] ^ o1[1];
  w[1] = 0u;
  MADSIM_UNROLL
  for (int j = 2; j < 8; ++j) w[j] = o0[j] ^ o1[j];
}

// The rest of a live seed's event, after its pop (bt, bs, node) and with
// its draws w: the clock, the removal, the handler, the push and the
// counters, without a branch (the stores are predicated).
MADSIM_HD void probe_finish(ProbeSeed& s, const ProbeSlots& q, int* ring,
                            int capacity, long long time_limit,
                            const uint32_t* w, long long bt, int bs,
                            int node) {
  const bool found = s.live != 0;
  const uint32_t jitter = kProbeJitterLo + mulhi32(w[0], kProbeJitterSpan);
  const long long now2 = clock_step(s.now, bt, found, jitter);
  const bool take = found & !(now2 > time_limit);

  s.live &= found ? ~(1ull << bs) : ~0ull;
  const uint32_t acc2 = (uint32_t)s.acc + (w[2] ^ w[3]);
  const int cell = probe_ring_cell(node, acc2 & (kProbeRing - 1));
  if (take & (cell >= 0)) ring[cell] = (int)w[4];

  const int ff = lowest_bit_or_none(~s.live & capacity_mask(capacity));
  const bool push = take & (ff >= 0);
  const long long et =
      add_wrap64(now2, kProbeDelayLo + mulhi32(w[5], kProbeDelaySpan));
  if (push) {
    q.time[ff * q.ts] = et;
    q.node[ff * q.ns] = (int)mulhi32(w[6], kProbeNodes);
    q.word1[ff * q.ws] = (int)w[7];
  }
  const uint64_t fbit = push ? 1ull << ff : 0ull;
  s.pushed |= fbit;
  s.live |= et != kInvalidTime ? fbit : 0ull;
  s.ov = s.ov | (take & (ff < 0));
  s.now = take ? now2 : s.now;
  s.ctr += take ? 1 : 0;
  s.acc = take ? (int)acc2 : s.acc;
  s.nsent += take ? 1 : 0;
  const long long occ = popcount64(s.live);
  s.qmax = occ > s.qmax ? occ : s.qmax;
  s.done = !take;
}

MADSIM_HD void probe_run(ProbeSeed& s, const ProbeSlots& q, int* ring,
                         int capacity, int steps, long long time_limit) {
  // this event's key f and draws w, and the next event's key g
  uint32_t f0, f1, g0, g1, w[8];
  fold_in(s.k0, s.k1, (uint32_t)s.ctr, &f0, &f1);
  probe_draws(s.k0, s.k1, (uint32_t)s.ctr + 1u, f0, f1, w, &g0, &g1);
  for (int step = 0; step < steps; ++step) {
    if (s.done) {  // frozen: its occupancy raises qmax, nothing else moves
      const long long occ = popcount64(s.live);
      if (occ > s.qmax) s.qmax = occ;
      return;
    }
    long long bt;
    int bs, node;
    probe_pop(s, q, f0, f1, bt, bs, node);
    // the next event's draws and the key after it, beside this event's end
    uint32_t h0, h1, wn[8];
    probe_draws(s.k0, s.k1, (uint32_t)s.ctr + 2u, g0, g1, wn, &h0, &h1);
    MADSIM_KEEP(h0);
    MADSIM_KEEP(h1);
    MADSIM_UNROLL
    for (int j = 0; j < 8; ++j) MADSIM_KEEP(wn[j]);
    probe_finish(s, q, ring, capacity, time_limit, w, bt, bs, node);
    f0 = g0;
    f1 = g1;
    g0 = h0;
    g1 = h1;
    MADSIM_UNROLL
    for (int j = 0; j < 8; ++j) w[j] = wn[j];
  }
}

}  // namespace madsim
