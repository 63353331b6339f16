// The resident multi-step sweep of the probe workload, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel madsim_tpu/engine/megakernel.py::_mega_kernel
// (wrapper run_megasweep). For every seed it runs `steps` complete engine
// events, exactly as engine/core.step_batch runs them on the probe
// workload (engine/megakernel.py in this package). The events are
// probe_event.cuh's probe_run, which the CPU tests also build with g++
// and hold to the reference; its comment lists the event's order.
//
// Design: one thread per seed, 64 seeds per block. What an event touches
// at a data-dependent slot lives in shared memory, laid out [slot][seed
// in block] so that the lanes of a warp hit distinct banks whatever slots
// they address: the deadlines (int64) and payload words 0 (the node, read
// by the handler) and 1 (written by the push), 16 B per slot and seed,
// 59 KB per block at Q = 58 (dynamic shared memory, above the 48 KB
// default). The rest of the seed's state is registers: the scalars, the
// 64-bit live mask (the pop walks only its set bits; the first free slot
// is its lowest clear bit, the occupancy its popcount) and the mask of
// pushed slots. A pushed slot's kind and payload words 2-7 are always 0,
// so they are written once after the run, for the pushed slots only,
// together with the deadlines (INVALID where not live) and words 0-1; the
// block's rows are contiguous in the planes, so those loads and stores
// are coalesced. The ring is written in place in the planes (one store per
// taken event at a data-dependent cell; cuda_megasweep.planes hands the
// kernel private copies). A payload word stored at its push would cost a
// warp 32 scattered stores per event; word 1 in shared memory costs none.
//
// Bound (S = 16,384 seeds, 512 steps, chip_smoke.py counts it from the
// run's data): the state is read and written once per call (about 106 MB,
// 32 us at 3.35 TB/s), while the integer work the probe's events need is
// about 611 32-bit instructions per event (fold_in, w0 and w2..w7 at 68-69
// each, about 4 per live slot at the pop, 40 fixed): about 0.15 ms at the
// card's issue ceiling of 128 thread-instructions per SM per clock. Every
// lane that issues does an event's own work: a unique minimum costs no
// priority hash, and w1 is drawn only for a tied minimum. 16,384 seeds are
// 512 warps, about one per scheduler, so each warp's instruction latency
// is hidden only by its own independent chains: probe_run computes the
// next event's 7 draws and the key after it (8 threefry blocks,
// interleaved round by round) beside the branch-free end of the current
// event, and loads the first live slots' deadlines together. What then
// limits it is not settled (no profiler of the SM's pipes runs where it
// was measured): most of the loop's instructions (rotates, xors, 3-input
// adds, compares, selects) go to the integer ALU pipe, which takes 64
// lanes per SM per clock on compute capability 9.0, one warp instruction
// every 2 clocks per scheduler, and a warp still waits on its own
// dependency chains. PERF.md lists what was tried.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "probe_event.cuh"
#include "sim_math.cuh"

namespace {

using madsim::kInvalidTime;
using madsim::kProbeNodes;
using madsim::kProbePay;
using madsim::kProbeRing;
using madsim::ProbePlanes;
using madsim::ProbeSeed;
using madsim::ProbeSlots;

constexpr int kSeedsPerBlock = 64;
constexpr int kMaxCapacity = 64;  // the live mask's bits
constexpr int kMaxDevices = 64;

// deadlines [Q][B] int64, words 0 and 1 [Q][B] int32 each, then the live
// and pushed masks [B] uint64 each
size_t shared_bytes(int capacity) {
  return (size_t)capacity * kSeedsPerBlock * (8 + 4 + 4) +
         2 * kSeedsPerBlock * sizeof(uint64_t);
}

__global__ void __launch_bounds__(kSeedsPerBlock)
megasweep_kernel(ProbePlanes p, int num_seeds, int capacity, int steps,
                 long long time_limit) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int B = kSeedsPerBlock;
  long long* sh_time = (long long*)smem;
  int* sh_node = (int*)(sh_time + (size_t)capacity * B);
  int* sh_word1 = sh_node + capacity * B;
  uint64_t* sh_live = (uint64_t*)(sh_word1 + capacity * B);
  uint64_t* sh_pushed = sh_live + B;

  const int first = blockIdx.x * B;
  const int nb = min(B, num_seeds - first);
  const int tid = threadIdx.x;
  const size_t base = (size_t)first * capacity;  // the block's first slot
  const int cells = nb * capacity;

  for (int c = tid; c < cells; c += B) {  // coalesced: the rows are contiguous
    const int ls = c / capacity, slot = c - ls * capacity;
    sh_time[slot * B + ls] = p.qtime[base + c];
    sh_node[slot * B + ls] = p.qpay[(base + c) * kProbePay];
  }
  __syncthreads();

  if (tid < nb) {
    const int seed = first + tid;
    const ProbeSlots q{sh_time + tid, B, sh_node + tid, B, sh_word1 + tid, B};
    ProbeSeed s = madsim::probe_load(p, seed);
    s.live = madsim::probe_live_mask(q, capacity);
    madsim::probe_run(s, q, p.ring + (size_t)seed * kProbeNodes * kProbeRing,
                      capacity, steps, time_limit);
    madsim::probe_store(p, seed, s);
    sh_live[tid] = s.live;
    sh_pushed[tid] = s.pushed;
  }
  __syncthreads();

  for (int c = tid; c < cells; c += B) {
    const int ls = c / capacity, slot = c - ls * capacity;
    p.qtime[base + c] =
        (sh_live[ls] >> slot & 1) ? sh_time[slot * B + ls] : kInvalidTime;
    if (sh_pushed[ls] >> slot & 1) p.qkind[base + c] = 0;
  }
  for (int c = tid; c < cells * kProbePay; c += B) {
    const int cell = c / kProbePay, j = c - cell * kProbePay;
    const int ls = cell / capacity, slot = cell - ls * capacity;
    if (sh_pushed[ls] >> slot & 1)
      p.qpay[base * kProbePay + c] = madsim::probe_pushed_word(
          j, sh_node[slot * B + ls], sh_word1[slot * B + ls]);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): `steps` events for seeds
// [0, num_seeds) of the planes, updated in place. Launches on `stream`,
// does not synchronise, and returns the CUDA error of setting the shared
// memory size or of the launch (0 = ok); 1000 for a capacity the kernel
// does not take, 1001 for a device ordinal beyond its table.
extern "C" int madsim_megasweep(void* qtime, void* qkind, void* qpay,
                                const void* key, void* now, void* ctr,
                                void* done, void* ov, void* qmax, void* ring,
                                void* acc, void* nsent, int num_seeds,
                                int capacity, int steps, long long time_limit,
                                void* stream) {
  if (capacity < 1 || capacity > kMaxCapacity) return 1000;
  if (num_seeds <= 0 || steps <= 0) return 0;
  // the most any capacity needs, set once per device (the first launch
  // comes before any graph capture)
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return 1001;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(megasweep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shared_bytes(kMaxCapacity));
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  const ProbePlanes p{(long long*)qtime, (int*)qkind, (int*)qpay,
                      (const long long*)key, (long long*)now, (int*)ctr,
                      (uint8_t*)done, (uint8_t*)ov, (long long*)qmax,
                      (int*)ring, (int*)acc, (int*)nsent};
  const dim3 grid((num_seeds + kSeedsPerBlock - 1) / kSeedsPerBlock);
  megasweep_kernel<<<grid, kSeedsPerBlock, shared_bytes(capacity),
                     (cudaStream_t)stream>>>(p, num_seeds, capacity, steps,
                                             time_limit);
  return (int)cudaGetLastError();
}
