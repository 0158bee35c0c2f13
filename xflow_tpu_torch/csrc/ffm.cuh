// The FFM form of K1 (score.cu) and K2 (train.cu): B10's field-aware
// interaction, its explicit gradient and their launch shape, on one
// block per example with the example's slots and field sums staged in
// shared memory.
//
// Replaces these XLA-lowered regions of the JAX reference (it has no
// Pallas kernels, so its jnp regions are what a port turns into
// kernels — ROADMAP Queue B):
//   B10 xflow_tpu/models/blocks.py:205-246 ffm_field_interaction — the
//       one-hot [B, K, F] of each slot's own field, S = onehot^T (v * x)
//       [B, F, F*D] by a batch matmul over K, cross = sum S4 * S4^T and
//       diag = sum_i x_i^2 ||v[k_i, f_i]||^2, the pair term
//       1/2 (cross - diag); xflow_tpu/models/ffm.py:74-92 FFMModel.logit
//       (the linear term over masked_x, the pair term over x_eff, the
//       fields outside [0, F) dropped through valid_fields,
//       blocks.py:56-64); and its gradient, which the reference takes
//       by automatic differentiation (value_and_grad, step.py:59-74),
//       written out:
//         dlogit/dw[k_i]        = x_i
//         dlogit/dv[k_i, g, d]  = x_eff_i * S[g, f_i, d]
//                                 - [g == f_i] x_eff_i^2 v[k_i, f_i, d]
//   B4s the field planes it reads (step.py:691-701,782-786,806-810).
//
// What the design does.  The reference's einsum runs over the one-hot
// [B, K, F]; here each example's n = KH + K slots are staged once in
// shared memory (key, x, field or -1 when the slot is padding or its
// field lies outside [0, F), gradient row) and the sums S[f1, f2, d]
// of a tile of Dt factors are built in shared memory, F * F * Dt
// floats, with one thread per column (f2, d) of the tile: the thread
// walks the slots in order (reading kAhead slots' v ahead, or, in K1
// where one tile holds D, the rows K1 first copied into shared memory:
// score.cu) and adds x_i * v[k_i, f2, d0 + d] into row f_i of its own
// column, so there are no shared-memory atomics and the order of
// addition is fixed.  The v row's F * Dt reads of a slot
// are coalesced across the threads (contiguous when Dt = D).  The
// diagonal is added in the same walk (the column whose f2 is the
// slot's own field), the cross term is each column's sum over f1 of
// S[f1, f2, d] S[f2, f1, d] after a block barrier, and a block
// reduction in a fixed order gives every thread the same logit.  K2
// then forms the residual on every thread and adds, for each staged
// slot, (S[f2, f_i, d] - [f2 == f_i] x_i v[k_i, f_i, d]) * x_i * r into
// the slot's gradient row, coalesced along the row: where one tile
// holds all of D and D % 4 == 0, one 16-byte vector reduction
// (red.global.add.v4.f32) per 4 factors of a field block, the (slot,
// group) items spread over the block (1,560 an example at the flagship,
// a quarter of the scalar form's 6,240 atomics); elsewhere one atomicAdd
// per column.  w's gradient x_i * r takes one atomic per slot.
// Both the cross term and the gradient separate over d, so D is tiled
// exactly: Dt is the most factors whose stage fits kTileSmem (48 KB,
// the default dynamic limit; all of D at the flagship F = 39, D = 4,
// 24,336 B), and K2 recomputes each tile's sums for its backward but
// the last one's.  One factor's stage past the card's opt-in shared
// memory per block (F above about 240) takes the device-memory stage
// (stage.cuh), one a block, with the same code over global addresses
// (global_plan; Dt is then 1, as tile_factors gives it).
//
// Bound.  Per live slot: its key, x and field, w[k] (4 B) and the v row
// (4 F D B), and in K2 the gradient rows read and written; per example
// the arithmetic is about 2 F D flops a slot for S and 2 F^2 D for the
// cross term (3 F D a slot more in K2's backward): at the flagship
// (n = 40, F = 39, D = 4) about 37 kflop an example against about 25 KB
// of v rows, 1.5 flop a byte, far below the card's 20 flop/B float32
// ridge, so bytes bound it.
//
// Why K2 keeps no shared-memory table of hot destinations, as its
// LR/FM form does (timed with chip_smoke.py --kernel-times on a
// path-like flagship batch of 65,536 rows, H100 80GB HBM3 at 700 W):
// with the vector reductions K2 took 1.552 ms, and 1.444 ms with the
// reductions computed but not issued, so they are 7 % of its time; a
// 32-row table (20 KB a block beside the stage, each table column owned
// by one thread, since shared-memory float atomics are compare-and-swap
// loops on sm_90a) took 3.570 ms.  The rest is the forward: reading the
// v rows kAhead slots ahead took 1.552 to 1.386 ms (2 ahead 1.454, 6
// and 8 slower for their registers).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "mvm.cuh"
#include "stage.cuh"

namespace ffm {

constexpr int kBytesPerSlot = 16;  // key, x, field, gradient row
constexpr int kScratchBytes = 32 * 4;  // one float per warp
constexpr int kTileSmem = 48 * 1024;
constexpr int kMaxThreads = 256;
constexpr int kAhead = 4;  // slots whose v reads tile_sums issues together

__host__ __device__ inline size_t stage_bytes(int F, int n, int dt) {
  return static_cast<size_t>(4) * F * F * dt +
         static_cast<size_t>(kBytesPerSlot) * n + kScratchBytes;
}

// Factors per tile: the most (at most D) whose stage fits kTileSmem,
// and at least one.
inline int tile_factors(int F, int D, int n) {
  int dt = D;
  while (dt > 1 && stage_bytes(F, n, dt) > static_cast<size_t>(kTileSmem)) --dt;
  return dt;
}

// One block's stage: S [F][F * dt] of the current tile, the slots, and
// the reduction scratch.
struct Stage {
  float* S;
  int* key;  // -1: padding
  float* x;  // masked x (the linear term's and w's)
  int* fld;  // the field, or -1: dropped from the pair term
  int* dst;  // gradient row (K2); -1: no gradient lands
  float* red;
};

__device__ __forceinline__ Stage stage_at(void* smem, int F, int dt, int n) {
  Stage s;
  s.S = static_cast<float*>(smem);
  s.key = reinterpret_cast<int*>(s.S + static_cast<size_t>(F) * F * dt);
  s.x = reinterpret_cast<float*>(s.key + n);
  s.fld = reinterpret_cast<int*>(s.x + n);
  s.dst = s.fld + n;
  s.red = reinterpret_cast<float*>(s.dst + n);
  return s;
}

// Slot j's v row: the live table's row (FFM's v opts out of the hot
// path, so a hot slot's row is the table's row < H as it stands, and
// there is no window-start snapshot).
struct Rows {
  const float* v;
  const int* key;
  int E;
  __device__ __forceinline__ const float* operator()(int j) const {
    return v + static_cast<long long>(key[j]) * E;
  }
};

// The sum of every thread's v over the block, in a fixed order, on
// every thread.  Holds block barriers: every thread must call it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
  v = mvm::warp_sum(v);
  __syncthreads();  // red is free (an earlier sum has been read)
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.0f;
  for (int i = 0; i < warps; ++i) total += red[i];
  return total;
}

// Tile [d0, d0 + dt): each thread's columns c = (f2, dd) of S set to
// the sums over the staged slots, in slot order, of x_i v[k_i][f2 * D +
// d0 + dd] into row f_i; returns this thread's share of the diagonal
// (the columns with f2 = f_i).  v is [T, F * D]; Row(j) gives slot j's
// v row.  The caller syncs before other threads read S.
template <typename Row>
__device__ __forceinline__ float tile_sums(const Stage& s, int n, int F, int D,
                                           int d0, int dt, const Row& row) {
  const int cols = F * dt;
  float diag = 0.0f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const int f2 = c / dt;
    const int at = f2 * D + d0 + (c - f2 * dt);
    for (int f1 = 0; f1 < F; ++f1) s.S[f1 * cols + c] = 0.0f;
    // kAhead slots' v reads in flight together, then their sums in
    // slot order
    for (int j0 = 0; j0 < n; j0 += kAhead) {
      float vx[kAhead];
      int fl[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int j = j0 + u;
        fl[u] = j < n ? s.fld[j] : -1;
        vx[u] = fl[u] >= 0 ? __fmul_rn(row(j)[at], s.x[j]) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (fl[u] < 0) continue;
        s.S[fl[u] * cols + c] += vx[u];
        if (fl[u] == f2) diag += vx[u] * vx[u];
      }
    }
  }
  return diag;
}

// This thread's share of the cross term over the tile's columns:
// sum over f1 of S[f1, f2, dd] * S[f2, f1, dd].
__device__ __forceinline__ float tile_cross(const Stage& s, int F, int dt) {
  const int cols = F * dt;
  float cross = 0.0f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const int f2 = c / dt;
    const int dd = c - f2 * dt;
    for (int f1 = 0; f1 < F; ++f1) {
      cross += s.S[f1 * cols + c] * s.S[f2 * cols + f1 * dt + dd];
    }
  }
  return cross;
}

// Threads of an FFM block whose tile has F * dt columns.
inline int threads_for(int F, int dt) {
  const int t = (F * dt + 31) / 32 * 32;
  return t < 64 ? 64 : (t > kMaxThreads ? kMaxThreads : t);
}

// Whether the block's stage (tile dt) fits a block's shared memory.
inline bool fits_shared(int F, int n, int dt) {
  return stage_bytes(F, n, dt) <= stage::optin_bytes();
}

// The device-memory form for B rows: the grid of `threads`-thread
// blocks, and the scratch bytes (a stage a block).
inline int global_plan(int B, int F, int n, int dt, int threads,
                       size_t* bytes) {
  const size_t per_block = stage::aligned(stage_bytes(F, n, dt));
  const int grid = stage::blocks(B, threads, per_block);
  *bytes = static_cast<size_t>(grid) * per_block;
  return grid;
}

// Block `block`'s stage in the device-memory scratch.
__device__ __forceinline__ Stage global_stage_at(char* scratch, long long block,
                                                 int F, int dt, int n) {
  const size_t per_block = (stage_bytes(F, n, dt) + stage::kAlign - 1) /
                           stage::kAlign * stage::kAlign;
  return stage_at(scratch + block * per_block, F, dt, n);
}

// Threads and dynamic shared bytes for an FFM block of n slots (tile
// dt factors), raising the kernel's dynamic limit when it needs more
// than 48 KB.  Returns a CUDA error code, cudaErrorInvalidValue when
// the stage exceeds the card's per-block shared memory (the caller
// takes the device-memory form there).
template <typename Kernel>
int launch_shape(Kernel kernel, int F, int dt, int n, int* threads,
                 size_t* smem) {
  *smem = stage_bytes(F, n, dt);
  if (!fits_shared(F, n, dt)) return static_cast<int>(cudaErrorInvalidValue);
  *threads = threads_for(F, dt);
  if (*smem > static_cast<size_t>(mvm::kSmallSmem)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(*smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace ffm

// A field form's device-memory stage for B rows of n slots (form 1 MVM
// at `mvm_warps` warps a block, 2 FFM at S fields of D / S factors):
// the grid, and the scratch bytes, 0 where the row's stage fits shared
// memory (K1's and K2's launches and their stage_bytes queries agree).
inline int field_stage_plan(int form, int S, int B, int n, int D, int mvm_warps,
                            size_t* bytes) {
  *bytes = 0;
  if (form == 1) {
    return mvm::fits_shared(n) ? 0 : mvm::global_plan(B, n, mvm_warps, bytes);
  }
  if (form == 2) {
    const int dt = ffm::tile_factors(S, D / S, n);
    return ffm::fits_shared(S, n, dt)
               ? 0
               : ffm::global_plan(B, S, n, dt, ffm::threads_for(S, dt), bytes);
  }
  return 0;
}
