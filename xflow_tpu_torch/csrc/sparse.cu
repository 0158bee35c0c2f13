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
//       scatter back (sentinel dropped), once per table; with B3's
//       recurrence (optim/ftrl.py:50-69, optim/sgd.py:24-27), through
//       ftrl.cuh, the one copy K3 (optim.cu) uses too.
//
// K4 (xf_consolidate).  Input: keys i32 [M], sentinel-coded: a key < 0
// (the compact wire's -1) or >= T (the reference's sentinel T) is
// padding.  Outputs: ukeys [M] whose first U entries are the distinct
// live keys, count [1] = U on the device (it never reaches the host),
// and slots [M]: for each occurrence the slot u of its key, -1 for
// padding.  The update does not depend on the order of the unique keys,
// so no sort runs: a direct-mapped slot map, int32 [T] held at -1
// between calls (64 MiB at T = 2^24), assigns slots.  Both forms claim
// the same way: a lane whose map entry reads -1 tries atomicCAS(-1 ->
// -2), so a key's first claim wins and its later occurrences see a
// claimed entry (-2 or u) and skip — the hottest key is claimed once,
// and nobody waits for it; then the winner writes ukeys[u] = key and
// map[key] = u, and once every claim has landed each occurrence reads
// slots[i] = map[key].  K5 resets the map entries of the keys it
// touched, so no O(T) clear runs per step.  Slots follow the order in
// which claims were won, which changes from run to run; the plain
// version (ops/sparse.py) gives the reference's sorted order.
//
//   The slice form (M <= kSliceMax = 32,768: a sequential slice of 512
//   rows is 20,480 keys at the flagship) is ONE launch, a cooperative
//   grid of 256-thread blocks, a key a thread: the lanes read, look up
//   and claim their keys; a warp's winners take their block offsets
//   with one shared-memory atomicAdd (the ballot); a first grid.sync()
//   (behind which block 0 zeroed count) lets each block take its base
//   from count with one atomicAdd; a second stands where the index
//   launch's boundary stood; then the slots.  No memset and no second
//   kernel: a slice's K4 was three device operations (memset, claim,
//   index), 0.0120-0.0125 ms at 0.004864 ms an empty launch.  Thread
//   block clusters in its place (the counter in the leader block's
//   shared memory, reached through distributed shared memory) took
//   0.0141 ms with 8 blocks of 1,024 threads on 8 SMs and 0.0122 with
//   16, against the grid's 0.0103 on 80 (PERF.md).
//   The batch form (M > kSliceMax) keeps the three operations: count
//   zeroed by cudaMemsetAsync, the claim kernel (grid-stride, a few
//   blocks per SM; the warp's first winner takes the warp's slots with
//   one global atomicAdd), then the index kernel, whose launch boundary
//   is the grid-wide barrier between the claims and the reads.  At
//   65,536 rows (M = 2,621,440) the launch overheads are a few percent
//   of the 0.129 ms call.
//
// K5 (xf_touched).  One launch steps every table of an update (w and v
// for FM, MVM's v, FFM's w and v [T, F*D], w and emb for wide_deep and
// dcn, two_tower's emb): the tables come by value in a small struct
// (pointers, widths, gsum rows, head buffers).  For i < U (count read
// once a block), row r = ukeys[i] (read once a row for all tables), and
// each element (table t, column c): FTRL (or SGD) in place on (w, n,
// z)_t[r, c] with g = gsum_t[i, c], which it then clears (K2's index
// mode accumulates into a zeroed buffer, as K3 clears g).  Every row is
// unique, so there are no races and no atomics.  Given the map, the
// row's first lane sets map[r] = -1, once a row, in the same launch.
// Layout, a kernel each (so each keeps its own registers).  One table:
// the per-table form's kernel, a thread an element of the flattened
// [U, d] block.  Two tables or more whose plan one full pass of the
// grid covers (a slice's): row-major, a block holds 256 / W rows side
// by side (W = the sum of the widths: 23 rows of FM's 1 + 10, 99 % of
// the threads busy), thread t keeps column t % W of row t / W (one
// division a thread, none an element), so every table's elements of a
// row are in flight together.  Otherwise (a batch's plan): table-major,
// each table's [U, d] block in turn, a thread an element (a 32-bit
// division), within 32 registers so that eight blocks an SM stay in
// flight for a batch's 13 elements a thread (at 40 and 58 registers
// the batch took 6 % and 20 % longer than the per-table launches).
// The fold and the map's reset ride in all three.
//
// The fold (heads given, the hot table's hybrid update —
// parallel/step.py:1194-1238 _sparse_update): a unique key r < H adds
// its gsum row into row r of each table's [H, d] head buffer, where K2
// summed the hot plane's gradients, and takes no step here; K3 then
// runs once over rows [0, H) with that buffer as g, so every head row
// sees one summed gradient, as in the reference.  Rows are unique, so
// the adds need no atomics either.
//
// Bound.  K4 reads the keys once and writes the slots and the ukeys:
// 8M + 4U bytes (about 21.0 MB, 0.0063 ms at 3.35 TB/s, at M = 65,536 x
// 40 and U = 323,000; about 0.00006 ms at a slice's M = 20,480 and U ≈
// 8,100, where the launch itself is the cost); the map's entries are
// scratch, whose sectors (32 B per distinct key, read, CAS and written)
// stay in L2.  K5 FTRL reads w, n, z and gsum rows and writes w, n, z:
// 28 U D + 4U bytes a table (about 92 MB, 0.027 ms, at D = 10), SGD
// 12 U D + 4U.  A row of D floats at a random r moves whole 32-byte
// sectors: a 40-byte row (D = 10) spans exactly 2 sectors at every
// offset 40 r, so the sector bound is 64 B per row and array.  Both
// kernels do a few operations per byte, far below the card's
// arithmetic rate.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ftrl.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kFree = -1;     // a map entry no key holds
constexpr int kClaimed = -2;  // claimed, its slot not written yet
// the slice form's most keys: 128 blocks of kThreads, a key a thread,
// all resident at once (a cooperative launch needs them so)
constexpr long long kSliceMax = 128LL * kThreads;
constexpr int kMaxTables = 4;

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

int grid_for(long long items) {
  const long long want = (items + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSm;
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

// The slice form (header): one cooperative launch of ceil(m / 256)
// blocks, a key a thread.  The claim runs before the first grid
// barrier, which makes block 0's zeroed count visible to every block's
// atomicAdd.
__global__ void __launch_bounds__(kThreads)
slice_kernel(const int* __restrict__ keys, int m, int t, int* map,
             int* __restrict__ ukeys, int* __restrict__ count,
             int* __restrict__ slots) {
  __shared__ int block_total;  // claims of this block
  __shared__ int block_base;
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int i = static_cast<int>(blockIdx.x) * kThreads + threadIdx.x;
  if (threadIdx.x == 0) block_total = 0;
  if (i == 0) *count = 0;
  int key = i < m ? keys[i] : kFree;
  if (key >= t) key = kFree;
  bool won = key >= 0 && __ldcg(map + key) == kFree;
  if (won) won = atomicCAS(map + key, kFree, kClaimed) == kFree;
  __syncthreads();  // block_total reads 0
  const unsigned winners = __ballot_sync(0xffffffffu, won);
  int local = kFree;
  if (winners != 0u) {
    const int leader = __ffs(winners) - 1;
    int first = 0;
    if (lane == leader) first = atomicAdd(&block_total, __popc(winners));
    first = __shfl_sync(0xffffffffu, first, leader);
    if (won) local = first + __popc(winners & ((1u << lane) - 1u));
  }
  grid.sync();  // count is 0 for every block, and block_total is final
  if (threadIdx.x == 0) block_base = atomicAdd(count, block_total);
  __syncthreads();
  if (won) {
    ukeys[block_base + local] = key;
    map[key] = block_base + local;
  }
  grid.sync();  // where the index launch's boundary stood: every claim is in the map
  if (i < m) {
    slots[i] = key < 0 ? kFree : (won ? block_base + local : __ldcg(map + key));
  }
}

int launch_slice(const int* keys, int m, int t, int* map, int* ukeys,
                 int* count, int* slots, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(m > 0 ? (m + kThreads - 1) / kThreads : 1);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc =
      cudaLaunchKernelEx(&cfg, slice_kernel, keys, m, t, map, ukeys, count, slots);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

int launch_batch(const int* keys, long long m, int t, int* map, int* ukeys,
                 int* count, int* slots, cudaStream_t s) {
  cudaError_t rc = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (rc != cudaSuccess || m <= 0) return static_cast<int>(rc);
  const int grid = grid_for(m);
  claim_kernel<<<grid, kThreads, 0, s>>>(keys, m, t, map, ukeys, count);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  index_kernel<<<grid, kThreads, 0, s>>>(keys, m, t, map, slots);
  return static_cast<int>(cudaGetLastError());
}

enum class Form { kFtrl, kSgd };

// The tables of one update (header); n and z unread in the SGD form,
// head null where keys do not fold.
struct Tables {
  float* w[kMaxTables];
  float* n[kMaxTables];
  float* z[kMaxTables];
  float* gsum[kMaxTables];
  float* head[kMaxTables];
  int d[kMaxTables];
  int count;  // tables
  int width;  // the sum of d
};

// Column `col` of one table (width d) over the rows i0, i0 + stride,
// ... below u: FTRL or SGD on (w, n, z)[r, col] with the row's summed
// gradient gsum[i, col], which it clears, or (r < hot_size) the fold
// into head[r, col].  `map`, given to one thread a row, is reset at r.
template <Form F>
__device__ __forceinline__ void touched_column(
    float* w, float* n, float* z, float* gsum, float* head, int d, int col,
    int i0, int stride, int u, const int* __restrict__ ukeys, int* map,
    int hot_size, FtrlParams p, float lr) {
  for (int i = i0; i < u; i += stride) {
    const int r = ukeys[i];
    if (map != nullptr) map[r] = kFree;
    float* gp = gsum + static_cast<long long>(i) * d + col;
    const float g = *gp;
    *gp = 0.0f;
    const long long at = static_cast<long long>(r) * d + col;
    if (r < hot_size) {  // the fold: head rows step in K3
      head[at] += g;
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

// One table's rows below u, an element a thread at a time over the
// flattened [u, d] block (a 32-bit division an element).
template <Form F>
__device__ __forceinline__ void touched_flat(float* w, float* n, float* z,
                                             float* gsum, float* head, int d, int u,
                                             const int* __restrict__ ukeys, int* map,
                                             int hot_size, FtrlParams p, float lr) {
  const unsigned total = static_cast<unsigned>(u) * static_cast<unsigned>(d);
  for (unsigned e = blockIdx.x * kThreads + threadIdx.x; e < total;
       e += gridDim.x * kThreads) {
    const unsigned i = e / static_cast<unsigned>(d);
    const int col = static_cast<int>(e - i * static_cast<unsigned>(d));
    const int r = ukeys[i];
    if (map != nullptr && col == 0) map[r] = kFree;
    const float g = gsum[e];
    gsum[e] = 0.0f;
    const long long at = static_cast<long long>(r) * d + col;
    if (r < hot_size) {  // the fold: head rows step in K3
      head[at] += g;
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

// Columns [begin, end) of the concatenated tables, `rows` rows a block
// side by side: this thread's column of them (and every kThreads-th
// after it), over its rows.  `reset`: the column whose thread resets
// the map (-1: none).
template <Form F>
__device__ __forceinline__ void touched_columns(const Tables& tb, int begin,
                                                int end, int rows, int u,
                                                const int* __restrict__ ukeys,
                                                int* __restrict__ map, int reset,
                                                int hot_size, FtrlParams p,
                                                float lr) {
  const int span = end - begin;
  const int slot = rows > 1 ? threadIdx.x / span : 0;
  if (slot >= rows) return;  // the block's spare threads
  int t = 0, base = 0;
  for (int c = begin + threadIdx.x - slot * span; c < end; c += kThreads) {
    while (c - base >= tb.d[t]) base += tb.d[t++];
    touched_column<F>(tb.w[t], tb.n[t], tb.z[t], tb.gsum[t], tb.head[t],
                      tb.d[t], c - base, static_cast<int>(blockIdx.x) * rows + slot,
                      static_cast<int>(gridDim.x) * rows, u, ukeys,
                      c == reset ? map : nullptr, hot_size, p, lr);
  }
}

// The three forms (header, "Layout"), picked by the shape in
// launch_touched: row-major, table-major, one table.
template <Form F>
__global__ void __launch_bounds__(kThreads)
touched_rows_kernel(const Tables tb, const int* __restrict__ ukeys,
                    const int* __restrict__ count, FtrlParams p, float lr,
                    int* __restrict__ map, int hot_size) {
  __shared__ int live;
  if (threadIdx.x == 0) live = *count;
  __syncthreads();
  touched_columns<F>(tb, 0, tb.width, tb.width <= kThreads ? kThreads / tb.width : 1,
                     live, ukeys, map, 0, hot_size, p, lr);
}

template <Form F>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
touched_tables_kernel(const Tables tb, const int* __restrict__ ukeys,
                      const int* __restrict__ count, FtrlParams p, float lr,
                      int* __restrict__ map, int hot_size) {
  __shared__ int live;
  if (threadIdx.x == 0) live = *count;
  __syncthreads();
  const int u = live;
  for (int t = 0; t < tb.count; ++t) {
    touched_flat<F>(tb.w[t], tb.n[t], tb.z[t], tb.gsum[t], tb.head[t], tb.d[t], u,
                    ukeys, t == tb.count - 1 ? map : nullptr, hot_size, p, lr);
  }
}

template <Form F>
__global__ void __launch_bounds__(kThreads)
touched_one_kernel(float* __restrict__ w, float* __restrict__ n,
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

// The blocks of `kernel` an SM holds at once, read once a kernel.
template <typename Kernel>
int resident_blocks(Kernel kernel, int* cached) {
  if (*cached == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(cached, kernel, kThreads, 0);
    if (*cached < 1) *cached = 1;
  }
  return *cached;
}

template <Form F>
int launch_touched(const Tables& tb, const int* ukeys, const int* count,
                   long long cap, FtrlParams p, float lr, int* map,
                   int hot_size, cudaStream_t s) {
  static int resident = 0;  // the table-major kernel's blocks an SM
  const long long sms = sm_count();
  const int rows = tb.width <= kThreads ? kThreads / tb.width : 1;
  if (tb.count > 1 && cap <= sms * kBlocksPerSm * rows) {
    const int grid = static_cast<int>((cap + rows - 1) / rows);
    touched_rows_kernel<F><<<grid, kThreads, 0, s>>>(tb, ukeys, count, p, lr, map,
                                                     hot_size);
  } else if (tb.count == 1) {
    touched_one_kernel<F><<<grid_for(cap * tb.d[0]), kThreads, 0, s>>>(
        tb.w[0], tb.n[0], tb.z[0], tb.gsum[0], ukeys, count, tb.d[0], p, lr, map,
        tb.head[0], hot_size);
  } else {
    // a thread an element of the widest table, at most every block the
    // card holds at once
    int widest = 1;
    for (int t = 0; t < tb.count; ++t) widest = tb.d[t] > widest ? tb.d[t] : widest;
    const long long want = (cap * widest + kThreads - 1) / kThreads;
    const long long fit = sms * resident_blocks(touched_tables_kernel<F>, &resident);
    const int grid = static_cast<int>(want < fit ? want : fit);
    touched_tables_kernel<F><<<grid, kThreads, 0, s>>>(tb, ukeys, count, p, lr,
                                                       map, hot_size);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The slice form's largest M (header).
extern "C" long long xf_consolidate_slice_max() { return kSliceMax; }

// K4 over m keys of a table of t rows, on `stream`: the slice form for
// m <= kSliceMax, else the batch form (header).  The map must hold -1
// at every entry on entry (K5 restores it).  Returns cudaGetLastError()
// after the launches (0 = launched).
extern "C" int xf_consolidate(const int* keys, long long m, int t, int* map,
                              int* ukeys, int* count, int* slots,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 0) m = 0;
  if (m <= kSliceMax) {
    return launch_slice(keys, static_cast<int>(m), t, map, ukeys, count, slots, s);
  }
  return launch_batch(keys, m, t, map, ukeys, count, slots, s);
}

// K5 over `tables` tables in one launch: sgd = 0 the FTRL form (w, n,
// z), else SGD (w[r] -= lr * gsum[i]); table k is [T, d[k]] with its
// gradients gsum[k] [cap, d[k]] and, with head[k] (nullable) [hot_size,
// d[k]], keys < hot_size fold into it instead (header).  `map`
// (nullable) is reset at the rows ukeys[0, *count).  `cap` (the
// ukeys/gsum capacity) picks the order and sizes the grid; cap < 2^31 -
// 2^24 and cap * d[k] < 2^32 (else cudaErrorInvalidValue).
extern "C" int xf_touched(int sgd, int tables, float* const* w,
                          float* const* n, float* const* z,
                          float* const* gsum, float* const* head,
                          const int* d, const int* ukeys, const int* count,
                          long long cap, float alpha, float beta, float l1,
                          float l2, float lr, int* map, int hot_size,
                          void* stream) {
  if (tables < 1 || tables > kMaxTables) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Tables tb = {};
  tb.count = tables;
  for (int k = 0; k < tables; ++k) {
    if (d[k] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    tb.w[k] = w[k];
    tb.n[k] = sgd ? nullptr : n[k];
    tb.z[k] = sgd ? nullptr : z[k];
    tb.gsum[k] = gsum[k];
    tb.head[k] = head != nullptr ? head[k] : nullptr;
    tb.d[k] = d[k];
    tb.width += d[k];
  }
  if (cap <= 0) return 0;
  // rows are counted in int, a table's [cap, d] elements in unsigned
  if (cap > (1LL << 31) - (1LL << 24)) return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < tables; ++k) {
    if (cap * d[k] >= (1LL << 32)) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (head == nullptr) hot_size = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sgd) {
    return launch_touched<Form::kSgd>(tb, ukeys, count, cap,
                                      FtrlParams{1.0f, 0.0f, 0.0f, 0.0f}, lr, map,
                                      hot_size, s);
  }
  return launch_touched<Form::kFtrl>(tb, ukeys, count, cap,
                                     FtrlParams{alpha, beta, l1, l2}, 0.0f, map,
                                     hot_size, s);
}
