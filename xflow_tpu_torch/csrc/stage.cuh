// The device-memory stage of the field forms (K1 and K2 MVM and FFM,
// mvm.cuh and ffm.cuh; K7 and K8, pool.cu) past their shared-memory
// caps.  Below its cap each form stages a row in shared memory, as it
// always did, and that instantiation is unchanged; a row whose stage
// does not fit (an MVM row past 1,482 slots, FFM's F x F field sums
// past about F = 240, a pooled row past 4,090 slots) takes the same
// kernel instantiated with kGlobalStage, whose stage is a slice of a
// device-memory scratch the wrapper allocates (torch.empty), one stage
// a resident warp or block.  Its grid is capped at what the card holds
// at once (kResidentThreads an SM) and at kBudget bytes of stage, and
// the blocks loop over the rows, so the scratch stays small: every
// stage is reused row after row.  Shared-memory atomics become global
// atomics on the same addresses.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace stage {

constexpr size_t kBudget = static_cast<size_t>(256) << 20;  // bytes a launch
constexpr int kResidentThreads = 512;  // an SM's share of the grid
constexpr size_t kAlign = 256;         // a stage's stride

inline size_t aligned(size_t bytes) {
  return (bytes + kAlign - 1) / kAlign * kAlign;
}

// The card's opt-in shared memory a block (232,448 B on an H100).
inline size_t optin_bytes() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<size_t>(optin);
}

// Blocks of `threads` threads, each staging `per_block` bytes in device
// memory, for `want` blocks of work: at most kResidentThreads of them
// an SM and kBudget bytes in all, at least one.
inline int blocks(long long want, int threads, size_t per_block) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int per_sm = threads >= kResidentThreads ? 1 : kResidentThreads / threads;
  long long cap = static_cast<long long>(sms) * per_sm;
  const long long fit = static_cast<long long>(kBudget / (per_block > 0 ? per_block : 1));
  if (cap > fit) cap = fit;
  if (want > cap) want = cap;
  return static_cast<int>(want > 0 ? want : 1);
}

}  // namespace stage
