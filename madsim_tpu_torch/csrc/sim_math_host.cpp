// Host build of sim_math.cuh and probe_event.cuh for the CPU parity test
// (tests/test_torch_megakernel.py): the per-lane arithmetic the kernels
// share and the megasweep kernel's per-seed event function, behind a
// plain C interface for ctypes. Build with
//   g++ -O2 -std=c++17 -shared -fPIC -o libsim_math_host.so sim_math_host.cpp

#include <stddef.h>

#include "probe_event.cuh"
#include "sim_math.cuh"

extern "C" {

// out[i] = word i of event_bits(key, ctr, n), for i < n.
void madsim_event_words(uint32_t k0, uint32_t k1, uint32_t ctr, int n,
                        uint32_t* out) {
  uint32_t f0, f1;
  madsim::fold_in(k0, k1, ctr, &f0, &f1);
  for (int i = 0; i < n; ++i) out[i] = madsim::draw_word(f0, f1, (uint32_t)i);
}

uint32_t madsim_murmur_prio(uint32_t slot, uint32_t tie) {
  return madsim::murmur_prio(slot, tie);
}

uint32_t madsim_mulhi32(uint32_t x, uint32_t c) { return madsim::mulhi32(x, c); }

long long madsim_clock_step(long long now, long long t, int found,
                            uint32_t jitter) {
  return madsim::clock_step(now, t, found != 0, jitter);
}

// The megasweep kernel's work on the host: `steps` probe events for seeds
// [0, num_seeds) of the planes (megasweep.cu's madsim_megasweep layout),
// updated in place, through the kernel's own probe_run with each seed's
// slots addressed in the planes themselves. Returns 1000 for a capacity
// the kernel does not take, else 0.
int madsim_megasweep_host(void* qtime, void* qkind, void* qpay,
                          const void* key, void* now, void* ctr, void* done,
                          void* ov, void* qmax, void* ring, void* acc,
                          void* nsent, int num_seeds, int capacity, int steps,
                          long long time_limit) {
  using namespace madsim;
  if (capacity < 1 || capacity > 64) return 1000;
  const ProbePlanes p{(long long*)qtime, (int*)qkind, (int*)qpay,
                      (const long long*)key, (long long*)now, (int*)ctr,
                      (uint8_t*)done, (uint8_t*)ov, (long long*)qmax,
                      (int*)ring, (int*)acc, (int*)nsent};
  for (int seed = 0; seed < num_seeds; ++seed) {
    const size_t row = (size_t)seed * capacity;
    int* pay = p.qpay + row * kProbePay;
    const ProbeSlots q{p.qtime + row, 1, pay, kProbePay, pay + 1, kProbePay};
    ProbeSeed s = probe_load(p, seed);
    s.live = probe_live_mask(q, capacity);
    probe_run(s, q, p.ring + (size_t)seed * kProbeNodes * kProbeRing,
              capacity, steps, time_limit);
    probe_store(p, seed, s);
    for (int i = 0; i < capacity; ++i) {
      if (!(s.live >> i & 1)) p.qtime[row + i] = kInvalidTime;
      if (!(s.pushed >> i & 1)) continue;
      p.qkind[row + i] = 0;
      const int node = pay[i * kProbePay], word1 = pay[i * kProbePay + 1];
      for (int j = 0; j < kProbePay; ++j)
        pay[i * kProbePay + j] = probe_pushed_word(j, node, word1);
    }
  }
  return 0;
}

}  // extern "C"
