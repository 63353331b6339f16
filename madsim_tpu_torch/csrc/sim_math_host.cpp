// Host build of sim_math.cuh for the CPU parity test
// (tests/test_torch_megakernel.py): the per-lane arithmetic the kernels
// share, behind a plain C interface for ctypes. Build with
//   g++ -O2 -shared -fPIC -o libsim_math_host.so sim_math_host.cpp

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

}  // extern "C"
