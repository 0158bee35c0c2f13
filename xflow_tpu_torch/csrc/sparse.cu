// K4 — consolidation of a batch's (or a slice's) keys into unique slots,
// and K5 — the touched-rows optimizer update, for the sparse update
// modes (update_mode="sparse", sequential mode's sparse inner).
//
// Replaces these XLA-lowered regions of the JAX reference (it has no
// Pallas kernels, so these jnp regions are what a port turns into
// kernels — ROADMAP Queue B):
//   B5  xflow_tpu/ops/sparse.py:62-119 consolidate_plan / consolidate_apply
//       (argsort of the M sentinel-coded keys, segment starts, cumsum
//       segment ids, the ukeys scatter; segment-sum of the [M, D]
//       per-occurrence gradients), called from parallel/step.py:1191
//       (_sparse_update).
//   B6  xflow_tpu/ops/sparse.py:121-129 gather_rows / scatter_rows and
//       parallel/step.py:1143-1156 _apply_touched_rows: gather the state
//       rows at the unique keys (clipped), the optimizer's update_rows,
//       scatter back (sentinel dropped); with B3's recurrence
//       (optim/ftrl.py:50-69, optim/sgd.py:24-27), through ftrl.cuh,
//       the one copy K3 (optim.cu) uses too.
//
// K4 (xf_consolidate).  Input: keys i32 [M], sentinel-coded: a key < 0
// (the compact wire's -1) or >= T (the reference's sentinel T) is
// padding.  Outputs: ukeys [M] whose first U entries are the distinct
// live keys, count [1] = U on the device (it never reaches the host),
// and slots [M]: for each occurrence the slot u of its key, -1 for
// padding.  The update does not depend on the order of the unique keys,
// so no sort runs: a direct-mapped slot map, int32 [T] held at -1
// between calls (64 MiB at T = 2^24), assigns slots.
//   1. memset count = 0;
//   2. claim: a warp takes 32 consecutive occurrences; a lane whose map
//      entry reads -1 tries atomicCAS(-1 -> -2); the lanes that won are
//      counted with one ballot, the warp's first winner takes their
//      slots from the counter with ONE atomicAdd, and each winner writes
//      ukeys[u] = key and map[key] = u.  A key's later occurrences see
//      a claimed entry (-2 or u) and skip: the hottest key is claimed
//      once, and nobody waits for it;
//   3. index (a second launch, so every claim has landed and no reader
//      spins): slots[i] = map[keys[i]], or -1 for padding.
// K5 resets the map entries of the keys it touched (the last table's
// launch), so no O(T) clear runs per step.  Slots follow the order in
// which warps won their claims, which changes from run to run; the
// plain version (ops/sparse.py) gives the reference's sorted order.
//
// K5 (xf_touched_*).  For i < U (read from count on the device), row
// r = ukeys[i], element d: FTRL (or SGD) in place on (w, n, z)[r, d]
// with g = gsum[i, d].  Every row is unique, so there are no races and no atomics.  It clears
// gsum[i, d] after reading it (K2's index mode accumulates into a
// zeroed buffer, as K3 clears g), and, when given the map, sets
// map[r] = -1.
//
// The fold (head not null, the hot table's hybrid update —
// parallel/step.py:1194-1238 _sparse_update): a unique key r < H adds
// its gsum row into row r of the [H, d] head buffer, where K2 summed
// the hot plane's gradients, and takes no step here; K3 then runs once
// over rows [0, H) with that buffer as g, so every head row sees one
// summed gradient, as in the reference.  Rows are unique, so the adds
// need no atomics either.
//
// Bound.  K4 reads the keys once and writes the slots and the ukeys:
// 8M + 4U bytes (about 21.0 MB, 0.0063 ms at 3.35 TB/s, at M = 65,536 x
// 40 and U = 323,000); the map's entries are scratch, whose sectors
// (32 B per distinct key, read, CAS and written) stay in L2.  K5 FTRL
// reads w, n, z and gsum rows and writes w, n, z: 28 U D + 4U bytes
// (about 92 MB, 0.027 ms, at D = 10), SGD 12 U D + 4U.  A row of D floats at a random r moves whole 32-byte sectors: a
// 40-byte row (D = 10) spans exactly 2 sectors at every offset 40 r, so
// the sector bound is 64 B per row and array.  Both kernels do a few
// operations per byte, far below the card's arithmetic rate.
//
// Design (first, simple and right).  K4: grid-stride loops, a few
// blocks per SM; the claim loop is warp-uniform so the ballot and the
// shuffle see all 32 lanes.  K5: one thread per (row, lane) element,
// a grid-stride loop over U*D sized by the buffer's capacity, so a
// row's D floats are read by neighbouring threads (coalesced within
// the row) and D = 10's 40-byte rows need no 16-byte alignment.

#include <cuda_runtime.h>

#include <cstdint>

#include "ftrl.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kFree = -1;     // a map entry no key holds
constexpr int kClaimed = -2;  // claimed, its slot not written yet

int grid_for(long long items) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long want = (items + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

__global__ void __launch_bounds__(kThreads)
claim_kernel(const int* __restrict__ keys, long long m, int t, int* map,
             int* __restrict__ ukeys, int* __restrict__ count) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  // base is warp-uniform, so every lane runs every iteration
  for (long long base = warp * 32; base < m; base += warps * 32) {
    const long long i = base + lane;
    int key = kFree;
    bool won = false;
    if (i < m) {
      key = keys[i];
      if (key >= 0 && key < t && __ldcg(map + key) == kFree) {
        won = atomicCAS(map + key, kFree, kClaimed) == kFree;
      }
    }
    const unsigned winners = __ballot_sync(0xffffffffu, won);
    if (winners == 0u) continue;
    const int leader = __ffs(winners) - 1;
    int first = 0;
    if (lane == leader) first = atomicAdd(count, __popc(winners));
    first = __shfl_sync(0xffffffffu, first, leader);
    if (won) {
      const int u = first + __popc(winners & ((1u << lane) - 1u));
      ukeys[u] = key;
      map[key] = u;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
index_kernel(const int* __restrict__ keys, long long m, int t,
             const int* __restrict__ map, int* __restrict__ slots) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < m; i += stride) {
    const int key = keys[i];
    slots[i] = (key >= 0 && key < t) ? map[key] : kFree;
  }
}

enum class Form { kFtrl, kSgd };

template <Form F>
__global__ void __launch_bounds__(kThreads)
touched_kernel(float* __restrict__ w, float* __restrict__ n,
               float* __restrict__ z, float* __restrict__ gsum,
               const int* __restrict__ ukeys, const int* __restrict__ count,
               int d, FtrlParams p, float lr, int* __restrict__ map,
               float* __restrict__ head, int hot_size) {
  const long long total = static_cast<long long>(*count) * d;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < total; e += stride) {
    const long long i = e / d;
    const int lane = static_cast<int>(e - i * d);
    const int r = ukeys[i];
    const long long at = static_cast<long long>(r) * d + lane;
    const float g = gsum[e];
    gsum[e] = 0.0f;
    if (map != nullptr && lane == 0) map[r] = kFree;
    if (r < hot_size) {  // the fold: head rows step in K3
      head[static_cast<long long>(r) * d + lane] += g;
      continue;
    }
    if constexpr (F == Form::kFtrl) {
      float wv = w[at], nv = n[at], zv = z[at];
      ftrl_one(wv, nv, zv, g, p);
      w[at] = wv;
      n[at] = nv;
      z[at] = zv;
    } else {
      w[at] = w[at] - lr * g;
    }
  }
}

template <Form F>
int launch_touched(float* w, float* n, float* z, float* gsum,
                   const int* ukeys, const int* count, long long cap, int d,
                   FtrlParams p, float lr, int* map, float* head,
                   int hot_size, void* stream) {
  if (cap <= 0 || d <= 0) return 0;
  if (head == nullptr) hot_size = 0;
  touched_kernel<F><<<grid_for(cap * d), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      w, n, z, gsum, ukeys, count, d, p, lr, map, head, hot_size);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4 over m keys of a table of t rows, on `stream`: count = 0, the
// claim launch, the index launch.  The map must hold -1 at every entry
// on entry (K5 restores it).  Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int xf_consolidate(const int* keys, long long m, int t, int* map,
                              int* ukeys, int* count, int* slots,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (rc != cudaSuccess || m <= 0) return static_cast<int>(rc);
  const int grid = grid_for(m);
  claim_kernel<<<grid, kThreads, 0, s>>>(keys, m, t, map, ukeys, count);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  index_kernel<<<grid, kThreads, 0, s>>>(keys, m, t, map, slots);
  return static_cast<int>(cudaGetLastError());
}

// K5, FTRL form: rows ukeys[0, *count) of the [T, d] tables w, n, z
// with the gradients gsum [cap, d]; `map` (nullable) is reset at those
// keys; with `head` (nullable) [hot_size, d], keys < hot_size fold into
// it instead (the fold, header).  `cap` (the ukeys/gsum capacity) only
// sizes the grid.
extern "C" int xf_touched_ftrl(float* w, float* n, float* z, float* gsum,
                               const int* ukeys, const int* count,
                               long long cap, int d, float alpha, float beta,
                               float l1, float l2, int* map, float* head,
                               int hot_size, void* stream) {
  return launch_touched<Form::kFtrl>(w, n, z, gsum, ukeys, count, cap, d,
                                     FtrlParams{alpha, beta, l1, l2}, 0.0f,
                                     map, head, hot_size, stream);
}

// K5, SGD form: w[r] -= lr * gsum[i]; otherwise as xf_touched_ftrl.
extern "C" int xf_touched_sgd(float* w, float* gsum, const int* ukeys,
                              const int* count, long long cap, int d,
                              float lr, int* map, float* head, int hot_size,
                              void* stream) {
  return launch_touched<Form::kSgd>(w, nullptr, nullptr, gsum, ukeys, count,
                                    cap, d, FtrlParams{1.0f, 0.0f, 0.0f, 0.0f},
                                    lr, map, head, hot_size, stream);
}
