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
// Design: a group of 16 lanes per seed, two seeds per warp, one wave of
// blocks over the card with a grid-stride loop over seed pairs. A lane
// reads its slots with 16-byte loads (two deadlines each) when the row
// allows it (Q even and the plane 16-byte aligned: a Q = 64 row is two
// loads per lane), else with 8-byte loads. First the minimum deadline
// alone: per lane the minimum, how many of its slots hold it and the
// first of them, then an int64 min over the group. A unique minimum is
// the answer and needs no hash; only when two or more slots hold the
// minimum (a tie, or an empty queue, where all Q tie) do the lanes hash
// the slots at the minimum and reduce (prio, slot) over the group.
//
// Bound: the kernel reads S*Q*8 + S*4 bytes and writes S*5 — about 8.4 MB
// at S = 16,384 and Q = 64, i.e. about 2.5 us at the H100's 3.35 TB/s.
// Every 16-lane group's loads are issued together, and one wave holds
// 16,384 seeds at once, so the reads are in flight together.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sim_math.cuh"

namespace {

using madsim::kInvalidTime;
using madsim::murmur_prio;

constexpr int kGroup = 16;  // lanes per seed
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Fold one slot's deadline into the lane's (minimum, count at it, first
// slot at it); slots come in increasing order.
__device__ __forceinline__ void fold_min(long long t, int s, long long& lt,
                                         int& lc, int& ls) {
  if (t < lt || lc == 0) {
    lt = t;
    lc = 1;
    ls = s;
  } else if (t == lt) {
    ++lc;
  }
}

// Fold one slot into the lane's (prio, slot) minimum when it holds the
// minimum deadline mt.
__device__ __forceinline__ void fold_prio(long long t, int s, long long mt,
                                          uint32_t tie, uint32_t& bp,
                                          int& bs) {
  if (t != mt) return;
  const uint32_t p = murmur_prio((uint32_t)s, tie);
  if (bs < 0 || p < bp) {
    bp = p;
    bs = s;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
pop_min_kernel(const long long* __restrict__ time,
               const uint32_t* __restrict__ tie,
               int* __restrict__ slot_out, bool* __restrict__ found_out,
               int num_seeds, int capacity) {
  const int lane = threadIdx.x & 31;
  const int g = lane & (kGroup - 1);
  const int half = lane >> 4;
  const int warps = gridDim.x * (kThreads / 32);
  const int warp = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  // warp-uniform trip count: both groups of a warp take part in every
  // shuffle; a group past the batch works on nothing and stores nothing
  for (int pair = warp; 2 * pair < num_seeds; pair += warps) {
    const int seed = 2 * pair + half;
    const bool valid = seed < num_seeds;
    const long long* row = time + (size_t)(valid ? seed : 0) * capacity;
    long long lt = kInvalidTime;
    int lc = 0, ls = 0;
    if (valid) {
      if (kVec) {
        const longlong2* row2 = reinterpret_cast<const longlong2*>(row);
        for (int p = g; 2 * p < capacity; p += kGroup) {
          const longlong2 v = row2[p];
          fold_min(v.x, 2 * p, lt, lc, ls);
          fold_min(v.y, 2 * p + 1, lt, lc, ls);
        }
      } else {
        for (int s = g; s < capacity; s += kGroup)
          fold_min(row[s], s, lt, lc, ls);
      }
    }
    long long mt = lt;
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      const long long o = __shfl_xor_sync(kFull, mt, off, kGroup);
      mt = o < mt ? o : mt;
    }
    const bool at_min = lc > 0 && lt == mt;
    const unsigned group_bits = 0xFFFFu << (16 * half);
    const unsigned holders = __ballot_sync(kFull, at_min) & group_bits;
    const unsigned multi = __ballot_sync(kFull, at_min && lc > 1) & group_bits;
    const bool unique = __popc(holders) == 1 && multi == 0;
    int bs = __shfl_sync(kFull, ls, holders ? __ffs(holders) - 1 : lane);
    if (__any_sync(kFull, !unique)) {  // a tie in either group of the warp
      const uint32_t draw = valid ? tie[seed] : 0u;
      uint32_t bp = 0;
      int cs = -1;
      if (valid && at_min) {
        if (kVec) {
          const longlong2* row2 = reinterpret_cast<const longlong2*>(row);
          for (int p = g; 2 * p < capacity; p += kGroup) {
            const longlong2 v = row2[p];
            fold_prio(v.x, 2 * p, mt, draw, bp, cs);
            fold_prio(v.y, 2 * p + 1, mt, draw, bp, cs);
          }
        } else {
          for (int s = g; s < capacity; s += kGroup)
            fold_prio(row[s], s, mt, draw, bp, cs);
        }
      }
      if (cs < 0) bp = 0xFFFFFFFFu;  // loses to every candidate
      unsigned key_slot = cs < 0 ? 0x7FFFFFFFu : (unsigned)cs;
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1) {
        const uint32_t op = __shfl_xor_sync(kFull, bp, off, kGroup);
        const unsigned os = __shfl_xor_sync(kFull, key_slot, off, kGroup);
        if (op < bp || (op == bp && os < key_slot)) {
          bp = op;
          key_slot = os;
        }
      }
      if (!unique) bs = (int)key_slot;
    }
    if (valid && g == 0) {
      slot_out[seed] = bs;
      found_out[seed] = mt != kInvalidTime;
    }
  }
}

// One wave of the kernel over the card: the blocks that fit at once.
template <bool kVec>
cudaError_t wave_blocks(int* blocks) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pop_min_kernel<kVec>, kThreads, 0);
    if (err != cudaSuccess) return err;
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *blocks = cached[dev];
  return cudaSuccess;
}

template <bool kVec>
int launch(const void* time, const void* tie, void* slot, void* found,
           int num_seeds, int capacity, cudaStream_t stream) {
  int wave = 0;
  const cudaError_t err = wave_blocks<kVec>(&wave);
  if (err != cudaSuccess) return (int)err;
  const int seeds_per_block = 2 * (kThreads / 32);
  const int needed = (num_seeds + seeds_per_block - 1) / seeds_per_block;
  pop_min_kernel<kVec><<<needed < wave ? needed : wave, kThreads, 0, stream>>>(
      (const long long*)time, (const uint32_t*)tie, (int*)slot, (bool*)found,
      num_seeds, capacity);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, and returns the CUDA error of the occupancy query or of the
// launch (0 = ok).
extern "C" int madsim_pop_min(const void* time, const void* tie, void* slot,
                              void* found, int num_seeds, int capacity,
                              void* stream) {
  if (num_seeds <= 0) return 0;
  const bool vec = capacity % 2 == 0 && (uintptr_t)time % 16 == 0;
  return vec ? launch<true>(time, tie, slot, found, num_seeds, capacity,
                            (cudaStream_t)stream)
             : launch<false>(time, tie, slot, found, num_seeds, capacity,
                             (cudaStream_t)stream);
}
