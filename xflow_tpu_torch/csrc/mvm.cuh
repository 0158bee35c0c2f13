// The MVM form of K1 (score.cu) and K2 (train.cu): B9's per-example
// field sums, their product and the guarded gradient, on one warp per
// example with the example's slots staged in shared memory.
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
// drop it.  Per warp the shared stage holds, for each of the n = KH + K
// slots, its key, x, field, representative (the row's first slot of
// the same field), gradient destination row, and its field's sum over
// one tile of kTile factors: kBytesPerSlot bytes a slot.  Lanes first
// stride over the slots (coalesced key, x and field reads; the
// representatives by a scan of the earlier fields), then a lane takes
// one factor d of the tile and walks the slots in order: the v row
// read is coalesced across lanes, each lane adds into its own column
// of the sums (no races, and one fixed order of addition), multiplies
// 1 + sum over the representatives in slot order, and in K2 adds each
// slot's prod / own * x * r into its row with one atomic per factor.
// prod - 1 stays in float32 and the guard divides, as the reference
// does (no expm1, no exclusive product: they differ where it fires).
// D > kTile runs in tiles of kTile factors; K2 recomputes a tile's sums
// for its backward, all but the last one's.  A row past the shared
// memory a block holds (n * kBytesPerSlot > 232,448 B: past 1,570
// slots) takes the device-memory stage (stage.cuh), one a warp, with
// the same code over global addresses (global_plan).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "stage.cuh"

namespace mvm {

constexpr int kTile = 32;  // factors per pass: one per lane
constexpr float kGuardEps = 1e-12f;  // models/mvm.py _GUARD_EPS
// key, x, field, representative and destination (5 x 4 B), and the
// field sums over one tile (kTile x 4 B)
constexpr int kBytesPerSlot = 5 * 4 + kTile * 4;
constexpr int kSmallSmem = 48 * 1024;  // the default dynamic limit

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One warp's stage over n slots (layout above).
struct Stage {
  int* key;  // -1: dropped from both passes
  float* x;
  int* fld;  // -1 with key
  int* rep;
  int* dst;  // gradient row (K2); -1: no gradient lands
  float* ss;  // [n][kTile] field sums of the current tile
};

__device__ __forceinline__ Stage stage_at(char* smem, int warp, int n) {
  char* base = smem + static_cast<long long>(warp) * n * kBytesPerSlot;
  Stage s;
  s.key = reinterpret_cast<int*>(base);
  s.x = reinterpret_cast<float*>(s.key + n);
  s.fld = reinterpret_cast<int*>(s.x + n);
  s.rep = s.fld + n;
  s.dst = s.rep + n;
  s.ss = reinterpret_cast<float*>(s.dst + n);
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

// After the lanes have staged key and fld: each slot's representative,
// the first slot of the row with its field (itself when dropped).
__device__ __forceinline__ void find_reps(const Stage& s, int n, int lane) {
  __syncwarp();
  for (int j = lane; j < n; j += 32) {
    const int f = s.fld[j];
    int r = j;
    if (f >= 0) {
      for (int k = 0; k < j; ++k) {
        if (s.fld[k] == f) {
          r = k;
          break;
        }
      }
    }
    s.rep[j] = r;
  }
  __syncwarp();
}

// Tile [d0, d0 + dt): lane d < dt sums v[key][d0 + d] * x over each
// field's slots, in slot order, into its representative's column d.
// Row(j) gives slot j's v row and whether it rounds to bfloat16.
template <typename Rows>
__device__ __forceinline__ void tile_sums(const Stage& s, int n, int d0,
                                          int dt, int lane, const Rows& rows) {
  if (lane >= dt) return;
  for (int j = 0; j < n; ++j) {
    if (s.fld[j] < 0) continue;
    bool to_bf16;
    const float* row = rows(j, to_bf16);
    const float vd = to_bf16 ? bf16_round(row[d0 + lane]) : row[d0 + lane];
    const float vx = vd * s.x[j];
    const int r = s.rep[j];
    if (r == j) {
      s.ss[j * kTile + lane] = vx;
    } else {
      s.ss[r * kTile + lane] += vx;
    }
  }
}

// Lane d < dt: prod over the present fields of (1 + their sum), slot
// order; 1 for lanes past the tile.
__device__ __forceinline__ float tile_prod(const Stage& s, int n, int dt,
                                           int lane) {
  float p = 1.0f;
  if (lane >= dt) return p;
  for (int j = 0; j < n; ++j) {
    if (s.fld[j] >= 0 && s.rep[j] == j) p *= 1.0f + s.ss[j * kTile + lane];
  }
  return p;
}

// Slot j's factor-d gradient of the logit, unscaled: prod / own * x,
// zero where |own| < kGuardEps (mvm.py:104-112).
__device__ __forceinline__ float slot_grad(const Stage& s, int j, float prod,
                                           int lane) {
  const float own = 1.0f + s.ss[s.rep[j] * kTile + lane];
  const float g = fabsf(own) < kGuardEps ? 0.0f : prod / own;
  return g * s.x[j];
}

// Whether one warp's stage of n slots fits a block's shared memory.
inline bool fits_shared(int n) {
  return static_cast<size_t>(n) * kBytesPerSlot <= stage::optin_bytes();
}

// The device-memory form for B rows of n slots at `warps` warps a
// block: the grid, and the scratch bytes (a stage a warp).
inline int global_plan(int B, int n, int warps, size_t* bytes) {
  const size_t per_warp = stage::aligned(static_cast<size_t>(n) * kBytesPerSlot);
  const int grid = stage::blocks((B + warps - 1) / warps, 32 * warps, warps * per_warp);
  *bytes = static_cast<size_t>(grid) * warps * per_warp;
  return grid;
}

// The stage of warp `warp` (of the grid) in the device-memory scratch.
__device__ __forceinline__ Stage global_stage_at(char* scratch, long long warp,
                                                 int n) {
  const size_t per_warp = (static_cast<size_t>(n) * kBytesPerSlot +
                           stage::kAlign - 1) / stage::kAlign * stage::kAlign;
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
  const size_t per_warp = static_cast<size_t>(n) * kBytesPerSlot;
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
