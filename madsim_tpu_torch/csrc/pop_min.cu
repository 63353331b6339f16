// Batched pop-min decision for the event queue, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel madsim_tpu/engine/pallas_queue.py::_kernel
// (wrapper pop_min_pallas). Per seed s it returns
//   slot[s]  = the lexicographic minimum of (time, prio, slot) over the
//              row's Q slots, prio = fmix32(slot * 2654435761 ^ tie[s])
//              (the murmur3 finalizer of engine/queue.py pop_min);
//   found[s] = the minimum time is not INVALID_TIME (INT64_MAX).
// That order is exactly the reference's rule: min(time), then
// argmin(where(time == min, prio, 2**33)), then the first index. It is
// also right for an empty queue: every slot is a candidate, so slot is the
// minimal-priority slot overall and found is false. The TPU kernel split
// the int64 deadlines into hi/lo int32 planes because its vector units
// have no 64-bit lanes; Hopper compares int64 natively, so there is no
// split here.
//
// Design: one warp per seed, 8 seeds per 256-thread block. Lane l scans
// slots l, l+32, ... (coalesced 8-byte loads), keeps its running minimum
// of the (time, prio, slot) tuple, then a 5-step shuffle reduction
// combines the lanes and lane 0 writes the result.
//
// Bound: the kernel reads S*Q*8 + S*4 bytes and writes S*5 — about 8.4 MB
// at S = 16,384 and Q = 64, i.e. about 2.5 us at the H100's 3.35 TB/s.
// At that size the launch latency (a few microseconds), not the bytes,
// dominates each call; fusing it with the neighbouring queue ops is later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sim_math.cuh"

namespace {

using madsim::kInvalidTime;
using madsim::murmur_prio;
using madsim::pop_less;

constexpr int kSeedsPerBlock = 8;

__global__ void __launch_bounds__(32 * kSeedsPerBlock)
pop_min_kernel(const long long* __restrict__ time,
               const uint32_t* __restrict__ tie,
               int* __restrict__ slot_out, bool* __restrict__ found_out,
               int num_seeds, int capacity) {
  const int seed = blockIdx.x * kSeedsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (seed >= num_seeds) return;  // uniform across the warp
  const long long* row = time + (size_t)seed * capacity;
  const uint32_t draw = tie[seed];

  // sentinel loses to every real slot (slot index < INT32_MAX)
  long long bt = kInvalidTime;
  uint32_t bp = 0xFFFFFFFFu;
  int bs = 0x7FFFFFFF;
  for (int s = lane; s < capacity; s += 32) {
    const long long t = row[s];
    const uint32_t p = murmur_prio((uint32_t)s, draw);
    if (pop_less(t, p, s, bt, bp, bs)) {
      bt = t;
      bp = p;
      bs = s;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long ot = __shfl_down_sync(0xFFFFFFFFu, bt, off);
    const uint32_t op = __shfl_down_sync(0xFFFFFFFFu, bp, off);
    const int os = __shfl_down_sync(0xFFFFFFFFu, bs, off);
    if (pop_less(ot, op, os, bt, bp, bs)) {
      bt = ot;
      bp = op;
      bs = os;
    }
  }
  if (lane == 0) {
    slot_out[seed] = bs;
    found_out[seed] = bt != kInvalidTime;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch (0 = ok).
extern "C" int madsim_pop_min(const void* time, const void* tie, void* slot,
                              void* found, int num_seeds, int capacity,
                              void* stream) {
  if (num_seeds <= 0) return 0;
  const dim3 block(32 * kSeedsPerBlock);
  const dim3 grid((num_seeds + kSeedsPerBlock - 1) / kSeedsPerBlock);
  pop_min_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const long long*)time, (const uint32_t*)tie, (int*)slot, (bool*)found,
      num_seeds, capacity);
  return (int)cudaGetLastError();
}
