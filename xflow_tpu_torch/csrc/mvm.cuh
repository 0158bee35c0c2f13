// The MVM form of K1 (score.cu) and K2 (train.cu): B9's per-example
// field sums, their product and the guarded gradient, on one warp per
// example with the example's slots and v rows staged in shared memory.
//
// Replaces these XLA-lowered regions of the JAX reference (it has no
// Pallas kernels, so its jnp regions are what a port turns into
// kernels — ROADMAP Queue B):
//   B9  xflow_tpu/models/blocks.py:186-202 mvm_slot_terms — one_plus =
//       1 + slotsum [B, S, D] through a one-hot [B, K, S] einsum, prod
//       over S; xflow_tpu/models/mvm.py:82-112 MVMModel.logit (the
//       centred sum_d (prod_d - 1)) and grad_logit (prod / own * x,
//       zero where |own| < 1e-12 and for fields outside [0, S)).
//   B4s the field planes it reads (step.py:691-701,782-786,806-810).
//
// What the design does.  An empty field's factor is exactly 1 + 0 = 1,
// so the product over the S fields equals the product over the fields
// present in the example (at most KH + K of them), up to the order of
// the multiplications: no [S, D] buffer, and no cap on S.  A slot whose
// key is padding, or whose field lies outside [0, S) (a negative id on
// the full wire, the u8 clamp's 255 on the others), is dropped from
// both passes, as the reference's zero one-hot row and `valid` mask
// drop it.  One warp takes an example.  Its stage holds, for each of
// the n = KH + K slots, its key, x, field, representative (the row's
// first slot of the same field), gradient destination, the next slot
// of its field, the representatives in slot order, and the tile's
// values: kBytesPerSlot bytes a slot, and kWarpBytes more a warp for
// the first-slot table and the tile's product.  In order:
//   1. The lanes stride over the slots: coalesced key, x and field
//      reads, the first device round trip.
//   2. link_fields: the first-slot table, indexed by field (kFieldTable
//      entries, kNone between rows), is filled by a walk over the
//      32-slot chunks from the last to the first.  __match_any_sync
//      groups a chunk's lanes by field; a slot's next slot of its field
//      is the next lane of its group or, for the group's last lane, the
//      table's entry (the field's first slot in later chunks); then the
//      group's first lane takes the entry.  After the walk each entry
//      is its field's first slot, the representative, and the slots
//      reset their entries.  O(n) a row, and each field's slots come
//      out linked in slot order, which an atomicMin fill of the same
//      table would not give.  With S > kFieldTable (int32 fields on the
//      full wire) a lane scans the row's earlier and later slots
//      instead: O(n) a slot.  A ballot lists the representatives in
//      slot order.
//   3. stage_values: the lanes stride over the flat (slot, factor)
//      pairs of the tile, n * dt of them, each lane with kBatchShared
//      (kBatchGlobal) independent v loads in flight before any lands in
//      the stage, so an example's rows arrive in n * dt / (32 * 8)
//      device round trips (two at the flagship's 44 slots x 10 factors,
//      where a walk over the slots would wait on 44 dependent loads):
//      val[j * dt + d] = v[key][d0 + d] * x, the value rounded to bf16
//      first for a hot slot under the flag.
//   4. merge_fields, only where a field repeats: a lane takes a
//      representative, walks its field's slots in slot order with
//      kMergeCols factors in registers, and leaves the field's sum at
//      the representative, added in slot order; the fields run in
//      parallel across the lanes.
//   5. tile_prod: the representatives are split among 32 / dt lane
//      groups (3 at D = 10); each group multiplies 1 + its fields' sums
//      in slot order, and lane d merges the groups' partial products in
//      group order: a fixed order and a third of the chain.  Several
//      examples a warp would keep the lanes as busy, but a 512-row
//      slice has only 512 examples, and one a warp keeps each example's
//      latency chain short on as many SMs as there are.
//   6. In K2 (train.cu) the lanes stride over the (slot, factor) pairs
//      again, consecutive lanes on consecutive factors of a row, so one
//      warp instruction's float reductions into a row coalesce into its
//      two 32-byte sectors.  The remap puts every field's hottest id in
//      the head's first rows, so thousands of a batch's gradients land
//      on a few adjacent sectors, and there each L2 operation counts: a
//      lane a slot with 8- and 16-byte vector reductions makes three
//      operations a slot and was slower on that skew (PERF.md §6).
//      The device-memory stage keeps that form (a lane a slot, kSeg
//      factors), whose slot reads do not wait behind the reductions.
// Everything past step 1 reads the stage only.  prod - 1 stays in
// float32 and the guard divides, as the reference does (no expm1, no
// exclusive product: they differ where it fires).  D > kTile runs in
// tiles of kTile factors; K2 recomputes a tile's values for its
// backward, all but the last one's.  A row past the shared memory a
// block holds (n * kBytesPerSlot + kWarpBytes > 232,448 B: past 1,482
// slots) takes the device-memory stage (stage.cuh), one a warp, with
// the same code over global addresses (global_plan).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "stage.cuh"

namespace mvm {

constexpr int kTile = 32;  // factors per pass
constexpr float kGuardEps = 1e-12f;  // models/mvm.py _GUARD_EPS
constexpr int kNone = -1;
constexpr int kFieldTable = 256;  // first-slot table: fields [0, 256)
// v loads a lane keeps in flight: 8 where the stage is in shared
// memory (the kernels run three blocks an SM within 85 registers), 16
// in the device-memory stage (a long row, one block an SM)
constexpr int kBatchShared = 8;
constexpr int kBatchGlobal = 16;
constexpr int kMergeCols = 16;  // factors a lane sums along a field's slots
// key, x, field, representative, destination, next slot of the field
// and the representatives' order (7 x 4 B), and one tile's values
// (kTile x 4 B)
constexpr int kBytesPerSlot = 7 * 4 + kTile * 4;
// the first-slot table and the tile's product
constexpr int kWarpBytes = kFieldTable * 4 + kTile * 4;
constexpr int kSmallSmem = 48 * 1024;  // the default dynamic limit
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kAll, v, off);
  }
  return v;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One warp's stage over n slots (layout above).
struct Stage {
  int* head;    // [kFieldTable] each field's first slot; kNone between rows
  float* prod;  // [kTile] the tile's product, factor d
  int* key;     // -1: dropped from both passes
  float* x;
  int* fld;     // -1 with key
  int* rep;     // the row's first slot of its field; kNone when dropped
  int* dst;     // gradient row (K2); -1: no gradient lands
  int* next;    // the next slot of its field; kNone at the last
  int* reps;    // the representatives in slot order
  float* val;   // [n * dt]: v * x at j * dt + d, the field sums at reps
};

__host__ __device__ __forceinline__ size_t warp_bytes(int n) {
  return static_cast<size_t>(n) * kBytesPerSlot + kWarpBytes;
}

__device__ __forceinline__ Stage stage_at(char* smem, int warp, int n) {
  char* base = smem + static_cast<long long>(warp) *
                          (static_cast<long long>(n) * kBytesPerSlot + kWarpBytes);
  Stage s;
  s.head = reinterpret_cast<int*>(base);
  s.prod = reinterpret_cast<float*>(s.head + kFieldTable);
  s.key = reinterpret_cast<int*>(s.prod + kTile);
  s.x = reinterpret_cast<float*>(s.key + n);
  s.fld = reinterpret_cast<int*>(s.x + n);
  s.rep = s.fld + n;
  s.dst = s.rep + n;
  s.next = s.dst + n;
  s.reps = s.next + n;
  s.val = reinterpret_cast<float*>(s.reps + n);
  return s;
}

// Field id of slot j (hot slots j < KH first), u8 or int32 planes.
__device__ __forceinline__ int field_of(const void* fields,
                                        const void* hot_fields, int f_i32,
                                        long long b, int K, int KH, int j) {
  if (j < KH) {
    const long long at = b * KH + j;
    return f_i32 ? static_cast<const int*>(hot_fields)[at]
                 : static_cast<const uint8_t*>(hot_fields)[at];
  }
  const long long at = b * K + (j - KH);
  return f_i32 ? static_cast<const int*>(fields)[at]
               : static_cast<const uint8_t*>(fields)[at];
}

// Once a warp, before its first row: the first-slot table empty.
__device__ __forceinline__ void clear_heads(const Stage& s, int S, int lane) {
  const int m = S < kFieldTable ? S : kFieldTable;
  for (int f = lane; f < m; f += 32) s.head[f] = kNone;
  __syncwarp();
}

// Step 2, after the lanes have staged key and fld: each slot's
// representative and the next slot of its field, and the
// representatives in slot order (their count in nr).  Returns whether
// a field holds two slots or more (step 4 is needed).
__device__ __forceinline__ bool link_fields(const Stage& s, int n, int S,
                                            int lane, int& nr) {
  __syncwarp();
  if (S <= kFieldTable) {
    for (int c = (n - 1) & ~31; c >= 0; c -= 32) {
      const int j = c + lane;
      const int f = j < n ? s.fld[j] : kNone;
      const unsigned same = __match_any_sync(kAll, f);
      if (f >= 0) {
        const unsigned later = same & ~((2u << lane) - 1u);
        s.next[j] = later != 0u ? c + __ffs(later) - 1 : s.head[f];
      }
      __syncwarp();
      if (f >= 0 && (same & ((1u << lane) - 1u)) == 0u) s.head[f] = j;
      __syncwarp();
    }
    for (int j = lane; j < n; j += 32) {
      const int f = s.fld[j];
      s.rep[j] = f >= 0 ? s.head[f] : kNone;
    }
    __syncwarp();
    for (int j = lane; j < n; j += 32) {
      const int f = s.fld[j];
      if (f >= 0) s.head[f] = kNone;
    }
  } else {
    for (int j = lane; j < n; j += 32) {
      const int f = s.fld[j];
      int r = kNone;
      int nx = kNone;
      if (f >= 0) {
        r = j;
        for (int k = 0; k < j; ++k) {
          if (s.fld[k] == f) {
            r = k;
            break;
          }
        }
        for (int k = j + 1; k < n; ++k) {
          if (s.fld[k] == f) {
            nx = k;
            break;
          }
        }
      }
      s.rep[j] = r;
      s.next[j] = nx;
    }
  }
  __syncwarp();
  int count = 0;
  bool repeats = false;
  for (int c = 0; c < n; c += 32) {
    const int j = c + lane;
    const int r = j < n ? s.rep[j] : kNone;
    const unsigned first = __ballot_sync(kAll, r == j);
    repeats |= __any_sync(kAll, r >= 0 && r != j) != 0;
    if (r == j) s.reps[count + __popc(first & ((1u << lane) - 1u))] = j;
    count += __popc(first);
  }
  __syncwarp();
  nr = count;
  return repeats;
}

// Step 3: val[j * dt + d] = v[key_j][d0 + d] * x_j for the live slots,
// kBatch loads a lane in flight.  Row(j) gives slot j's v row and
// whether it rounds to bfloat16.
template <int kBatch, typename Rows>
__device__ __forceinline__ void stage_values(const Stage& s, int n, int d0,
                                             int dt, int lane,
                                             const Rows& rows) {
  const int total = n * dt;
  const int step_j = 32 / dt;
  const int step_d = 32 - step_j * dt;
  int j = lane / dt;
  int d = lane - j * dt;
  for (int p0 = 0; p0 < total; p0 += 32 * kBatch) {
    float vv[kBatch];
    float xv[kBatch];
    int at[kBatch];
    unsigned round = 0u;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      at[u] = -1;
      vv[u] = 0.0f;
      xv[u] = 0.0f;
      if (p0 + u * 32 + lane < total && s.fld[j] >= 0) {
        bool to_bf16;
        const float* row = rows(j, to_bf16);
        vv[u] = __ldg(row + d0 + d);
        xv[u] = s.x[j];
        at[u] = j * dt + d;
        if (to_bf16) round |= 1u << u;
      }
      j += step_j;
      d += step_d;
      if (d >= dt) {
        d -= dt;
        ++j;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (at[u] >= 0) {
        const float vd = ((round >> u) & 1u) != 0u ? bf16_round(vv[u]) : vv[u];
        s.val[at[u]] = vd * xv[u];
      }
    }
  }
}

// Step 4: each repeated field's sum at its representative, its slots
// added in slot order.  A lane takes a representative and kMergeCols
// factors at a time, so a field's list is walked once a column chunk
// and the factors' loads of a slot are issued together.
__device__ __forceinline__ void merge_fields(const Stage& s, int nr, int dt,
                                             int lane) {
  for (int i = lane; i < nr; i += 32) {
    const int r = s.reps[i];
    if (s.next[r] < 0) continue;
    for (int c = 0; c < dt; c += kMergeCols) {
      const int w = min(kMergeCols, dt - c);
      float sum[kMergeCols];
#pragma unroll
      for (int d = 0; d < kMergeCols; ++d) sum[d] = d < w ? s.val[r * dt + c + d] : 0.0f;
      for (int k = s.next[r]; k >= 0; k = s.next[k]) {
#pragma unroll
        for (int d = 0; d < kMergeCols; ++d) {
          if (d < w) sum[d] += s.val[k * dt + c + d];
        }
      }
#pragma unroll
      for (int d = 0; d < kMergeCols; ++d) {
        if (d < w) s.val[r * dt + c + d] = sum[d];
      }
    }
  }
}

// Step 5: lane d < dt gets prod over the present fields of (1 + their
// sum), which also goes to s.prod[d]; the other lanes hold partials.
__device__ __forceinline__ float tile_prod(const Stage& s, int nr, int dt,
                                           int lane) {
  const int groups = 32 / dt;
  const int g = lane / dt;
  const int d = lane - g * dt;
  const int per = (nr + groups - 1) / groups;
  float p = 1.0f;
  if (g < groups) {
    const int hi = min(nr, (g + 1) * per);
    for (int i = g * per; i < hi; ++i) p *= 1.0f + s.val[s.reps[i] * dt + d];
  }
  for (int k = 1; k < groups; ++k) {
    const float o = __shfl_sync(kAll, p, k * dt + d);
    if (g == 0) p *= o;
  }
  if (lane < dt) s.prod[lane] = p;
  __syncwarp();
  return p;
}

// Steps 3-5 for the tile [d0, d0 + dt): lane d < dt gets its product.
// kGlobalStage: the stage is in device memory.
template <bool kGlobalStage, typename Rows>
__device__ __forceinline__ float tile_forward(const Stage& s, int n, int nr,
                                              bool repeats, int d0, int dt,
                                              int lane, const Rows& rows) {
  __syncwarp();  // the previous tile's values and product are read out
  stage_values<kGlobalStage ? kBatchGlobal : kBatchShared>(s, n, d0, dt, lane, rows);
  __syncwarp();
  if (repeats) {
    merge_fields(s, nr, dt, lane);
    __syncwarp();
  }
  return tile_prod(s, nr, dt, lane);
}

// Whether one warp's stage of n slots fits a block's shared memory.
inline bool fits_shared(int n) {
  return warp_bytes(n) <= stage::optin_bytes();
}

// The device-memory form for B rows of n slots at `warps` warps a
// block: the grid, and the scratch bytes (a stage a warp).
inline int global_plan(int B, int n, int warps, size_t* bytes) {
  const size_t per_warp = stage::aligned(warp_bytes(n));
  const int grid = stage::blocks((B + warps - 1) / warps, 32 * warps, warps * per_warp);
  *bytes = static_cast<size_t>(grid) * warps * per_warp;
  return grid;
}

// The stage of warp `warp` (of the grid) in the device-memory scratch.
__device__ __forceinline__ Stage global_stage_at(char* scratch, long long warp,
                                                 int n) {
  const size_t per_warp = (warp_bytes(n) + stage::kAlign - 1) / stage::kAlign *
                          stage::kAlign;
  return stage_at(scratch + warp * per_warp, 0, n);
}

// Warps per block and dynamic shared bytes for n slots a warp (at most
// max_warps), raising the kernel's dynamic limit when it needs more
// than 48 KB.  Returns a CUDA error code, cudaErrorInvalidValue when
// one warp's stage exceeds the card's per-block shared memory (the
// caller takes the device-memory form there).
template <typename Kernel>
int launch_shape(Kernel kernel, int n, int max_warps, int* warps,
                 size_t* smem) {
  const size_t per_warp = warp_bytes(n);
  if (!fits_shared(n)) return static_cast<int>(cudaErrorInvalidValue);
  int w = max_warps;
  while (w > 1 && w * per_warp > static_cast<size_t>(kSmallSmem)) --w;
  *warps = w;
  *smem = w * per_warp;
  if (*smem > static_cast<size_t>(kSmallSmem)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(*smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace mvm
