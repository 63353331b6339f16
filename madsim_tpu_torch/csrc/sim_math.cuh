// Per-lane integer arithmetic of the engine's event step, shared by the
// hand-written kernels (pop_min.cu, megasweep.cu) and buildable by a host
// C++ compiler for the CPU parity test (sim_math_host.cpp).
//
// Every function is bit-identical to the reference package's definition:
//   threefry2x32  - jax.random's threefry-2x32 (20 rounds), the block of
//                   madsim_tpu/engine/megakernel.py::_threefry2x32
//                   (threefry2x32_n: N blocks interleaved round by round);
//   fold_in,      - engine/rng.event_bits(key, ctr, n): fold_in (a block
//   draw_word       at counter (0, ctr)), then word i of the partitionable
//                   bits (o0 ^ o1 of a block at counter (0, i));
//   murmur_prio   - the pop tie-break fmix32(slot * 2654435761 ^ tie) of
//                   engine/queue.py::pop_min;
//   mulhi32       - floor(x * c / 2**32), engine/rng.bounded for a span
//                   c < 2**32 (megakernel._mulhi32);
//   clock_step    - now' = max(now, t) + jitter for a popped deadline t,
//                   and now + jitter when nothing was popped (t is then
//                   INT64_MAX, whose jump would overflow; that lane is
//                   never taken, so the value reaches no state); the
//                   add wraps as the reference's int64 add does.
// The 32-bit mixes are done in uint32_t, where wrap-around is defined.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define MADSIM_HD __host__ __device__ __forceinline__
#define MADSIM_UNROLL _Pragma("unroll")
#else
#define MADSIM_HD static inline
#define MADSIM_UNROLL
#endif

// MADSIM_KEEP(x): x (a 32-bit register value) is computed at this point
// of the program, not sunk by the compiler into the branches that use it,
// so that independent work stays together for the card's scheduler; no
// instruction is emitted. A no-op on the host.
#ifdef __CUDA_ARCH__
#define MADSIM_KEEP(x) asm volatile("" : "+r"(x))
#else
#define MADSIM_KEEP(x) ((void)0)
#endif

namespace madsim {

constexpr long long kInvalidTime = 0x7FFFFFFFFFFFFFFFLL;
constexpr uint32_t kHashMult = 2654435761u;  // Knuth multiplicative hash

MADSIM_HD uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// One threefry-2x32 block: key (k0, k1), counter (x0, x1) -> (*o0, *o1).
MADSIM_HD void threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0,
                            uint32_t x1, uint32_t* o0, uint32_t* o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  x0 += ks[0];
  x1 += ks[1];
  MADSIM_UNROLL
  for (int block = 0; block < 5; ++block) {
    MADSIM_UNROLL
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl32(x1, rot[(block & 1) * 4 + i]);
      x1 ^= x0;
    }
    x0 += ks[(block + 1) % 3];
    x1 += ks[(block + 2) % 3] + (uint32_t)(block + 1);
  }
  *o0 = x0;
  *o1 = x1;
}

// N threefry-2x32 blocks at once, block n with key (k0[n], k1[n]) and
// counter (x0[n], x1[n]), computed round by round across the N blocks, so
// that their N dependency chains interleave: on the card one warp's
// independent instructions are what hides each instruction's latency.
// Equal to N calls of threefry2x32.
template <int N>
MADSIM_HD void threefry2x32_n(const uint32_t* k0, const uint32_t* k1,
                              const uint32_t* x0_in, const uint32_t* x1_in,
                              uint32_t* o0, uint32_t* o1) {
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  uint32_t ks[N][3], x0[N], x1[N];
  MADSIM_UNROLL
  for (int n = 0; n < N; ++n) {
    ks[n][0] = k0[n];
    ks[n][1] = k1[n];
    ks[n][2] = k0[n] ^ k1[n] ^ 0x1BD11BDAu;
    x0[n] = x0_in[n] + ks[n][0];
    x1[n] = x1_in[n] + ks[n][1];
  }
  MADSIM_UNROLL
  for (int block = 0; block < 5; ++block) {
    MADSIM_UNROLL
    for (int i = 0; i < 4; ++i) {
      MADSIM_UNROLL
      for (int n = 0; n < N; ++n) {
        x0[n] += x1[n];
        x1[n] = rotl32(x1[n], rot[(block & 1) * 4 + i]);
        x1[n] ^= x0[n];
      }
    }
    MADSIM_UNROLL
    for (int n = 0; n < N; ++n) {
      x0[n] += ks[n][(block + 1) % 3];
      x1[n] += ks[n][(block + 2) % 3] + (uint32_t)(block + 1);
    }
  }
  MADSIM_UNROLL
  for (int n = 0; n < N; ++n) {
    o0[n] = x0[n];
    o1[n] = x1[n];
  }
}

// The event key: fold_in(key, ctr).
MADSIM_HD void fold_in(uint32_t k0, uint32_t k1, uint32_t ctr, uint32_t* f0,
                       uint32_t* f1) {
  threefry2x32(k0, k1, 0u, ctr, f0, f1);
}

// Word i of the event's draws, from the folded key (f0, f1).
MADSIM_HD uint32_t draw_word(uint32_t f0, uint32_t f1, uint32_t i) {
  uint32_t o0, o1;
  threefry2x32(f0, f1, 0u, i, &o0, &o1);
  return o0 ^ o1;
}

MADSIM_HD uint32_t murmur_prio(uint32_t slot, uint32_t tie) {
  uint32_t x = slot * kHashMult ^ tie;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

MADSIM_HD uint32_t mulhi32(uint32_t x, uint32_t c) {
  return (uint32_t)(((uint64_t)x * (uint64_t)c) >> 32);
}

// a + b in int64 with two's-complement wrap-around, as the reference's
// int64 add (a signed overflow would be undefined in C++)
MADSIM_HD long long add_wrap64(long long a, uint32_t b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

MADSIM_HD long long clock_step(long long now, long long t, bool found,
                               uint32_t jitter) {
  const long long base = found ? (t > now ? t : now) : now;
  return add_wrap64(base, jitter);
}

// The lexicographic order of the pop: (time, prio, slot).
MADSIM_HD bool pop_less(long long t, uint32_t p, int s, long long bt,
                        uint32_t bp, int bs) {
  return t < bt || (t == bt && (p < bp || (p == bp && s < bs)));
}

}  // namespace madsim
