// K1 — fused sparse scoring for LR and FM: the serving forward in one
// kernel.
//
// Replaces these XLA-lowered regions of the JAX reference's predict
// path (xflow_tpu/parallel/step.py::TrainStep._predict_impl, line 1516;
// the reference has no Pallas kernels, so these jnp regions are what a
// port turns into kernels — ROADMAP Queue B):
//   B4 compact  step.py:769-813 _expand_wire — sentinel key -1 means
//               padding; key = max(ck, 0); val = mask = (ck >= 0)
//   B1          step.py:815-822 _gather_model_rows (w[key]) +
//               models/blocks.py:41-53 masked_x / linear_term +
//               utils/metrics.py:34-38 sigmoid_ref (asymmetric clamp)
//   B8 forward  models/blocks.py:171-183 fm_pair_pieces +
//               models/fm.py:60-65 — logit = linear + sum_d(s_d^2 - s2_d),
//               s = sum_k v*x, s2 = sum_k (v*x)^2, no 1/2 (reference quirk)
//   B7 gather   ops/hot.py:71 hot_gather over the head rows [0, H), with
//               step.py:793-812 (the hot plane's decode: u16 with 0xFFFF,
//               or int32 with -1) and :849-867 _model_view (hot first)
//
// Inputs: keys i32 [B, K] sentinel-coded (-1 = padding); x f32 [B, K]
// or null (null: x = 1 wherever key >= 0, the compact wire's binary
// features); w f32 [T, 1]; v f32 [T, D] or null (LR).  Outputs: pctr
// f32 [B]; logit f32 [B] when the pointer is not null.
//
// The hot plane (B7; KH = 0 without a hot table): hot [B, KH], u16
// (hot_u16, 0xFFFF padding) or i32 (-1 padding), and hot_x f32 [B, KH]
// or null, as x.  On this card the head is rows [0, H) of the same
// table, so a hot entry is an ordinary row read: the reference's
// one-hot matmuls (a TPU device for its per-slice gather cost) have no
// counterpart here, only their contract: a hot key outside [0, H) reads
// a zero row, which contributes nothing (taken here as padding), and
// with hot_bf16 the hot rows' w and v are rounded to bfloat16 (nearest
// even, XLA's astype) before use — hot_impl "mxu" with hot_dtype
// "bfloat16".  Lanes stride over the KH + K entries of the row, hot
// first, so the hot plane adds its keys' bytes and its rows' sectors
// to the bound below and nothing else.
//
// Bound.  The work is a gather.  It uses
//   B*K*(4 key + 4 x, if given) + rows * (4 B of w + 4D B of v) + 4B
// bytes, where rows counts the distinct live keys; since a random row
// read moves whole 32-byte DRAM sectors, the card moves at least
//   B*K*(4 + 4, if x) + rows * (32 B for w + ceil(4D/32) * 32 B for v)
//   + 4B
// bytes (the sector-level bound), over 3.35 TB/s on an H100 SXM.  At
// the serving shapes (B <= 512, K = 40, D = 10) that is 1-2 MB — under
// a microsecond — so at serving sizes the kernel is bound by its
// launch latency, not by the card.  The arithmetic (4D + 2 flops per
// live slot) is negligible.
//
// Design: one warp per example, four examples a block, and every table
// read of an example in flight at once: the chain is two device-memory
// round trips (the keys, then the rows), whatever K, KH and D are.
//   1. Lanes stride over the KH + K slots and read the keys, x and the
//      hot plane's decode in one coalesced pass (entry_key: a hot key
//      >= H is padding) into the warp's stage in shared memory.
//   2. Lane (p, g) copies factor group g of slots p, p + P, ... (P =
//      32 / groups; lanes stride over the (slot, group) items past 32
//      groups) into the stage with cp.async, in groups of VW = 4, 2 or
//      1 floats as D and v's alignment allow (a D = 10 row is five
//      8-byte copies); no register waits on them.  A padding slot's
//      row is zeros in the stage and its x 0, so step 4 has no branch.
//   3. Lanes stride over the slots again for w, whose reads fly beside
//      the copies, and sum the linear term.
//   4. After cp.async.wait_all, lane (q, d) sums factor d's s and s2
//      over every Q-th slot from the stage (Q = 32 / D lane groups for
//      D <= 16, else one lane a factor, lanes looping over d past 32),
//      the Q partial sums meet by shuffles in group order, and each
//      factor's s^2 - s2 joins the linear term in one warp butterfly.
// LR (no v) stages nothing and is its own instantiation (VW = 0): a
// lane reads each of its slots' key and then its w, the first form's
// loop, two slots a lane in flight at K = 40.  Run through the FM
// form's stage, or inside the FM form's instantiation, LR took 13-15 %
// longer at the 16,384-row eval batch (0.0177-0.0179 ms against 0.0156,
// H100 80GB HBM3 at 700 W).
// A row of more slots than the stage holds (kFmWarpBudget a warp: 254
// slots at D = 10, 44 at D = 64) runs in chunks of slots, each one
// such pair of round trips, the sums carried in the stage; so no row
// width is refused, and D is limited only by one slot's stage fitting
// a block (12 D + 8 bytes: about 19,000 factors).  Lane 0 forms the
// logit and the clamped sigmoid.  Nothing goes back to device memory
// between the gather and the score.  A padding slot is skipped before
// any table read: the JAX path reads row 0 and masks it out, this
// kernel never reads it.  With hot_bf16 a hot slot's w and v values are
// rounded as they leave the stage.  Sums run in another order than the
// plain version (and contract to FMA), so results agree to float
// rounding, not bitwise.
//
// The MVM form (B9, fields not null; mvm.cuh has its regions, bound
// and design): no w; the field planes fields [B, K] and hot_fields
// [B, KH], u8 (compact and dictionary wires, the clamp's 255 past any
// S <= 255) or int32 (f_i32, the full wire), and S = max_fields; the
// logit is sum_d (prod_d - 1).  Bound: the keys (and x), the fields
// (1 or 4 B a slot), each distinct row's 4D B of v and 4B out; the
// arithmetic (about 2D flops a slot and D per present field) is far
// below the card's rate, so bytes bound it, and at serving sizes the
// launch does.
//
// The FFM form (B10, form 2; ffm.cuh has its regions, bound and
// design): w and v [T, S * D] (D = the row width over S), the field
// planes as the MVM form's; one block per example, the linear term over
// every live slot (an out-of-range field included) and the pair term
// 1/2 (cross - diag) over the slots whose field lies in [0, S).  With
// the hot plane, hot_bf16 rounds w's hot rows alone: FFM's v opts out
// of the hot path (TableSpec.hot=False), so its hot rows are read as
// they are.  Where one tile holds D and the example's rows fit beside
// the sums (the flagship: 40 rows of 39 x 4 floats, 24,960 B, beside
// 25,104 B of sums and slots, with the opt-in past 48 KB), the block
// first copies every live slot's v row into shared memory with
// cp.async, all in flight together, and w's reads fly beside them; the
// sums then walk shared memory (where the batch fits one wave of
// blocks: rows_staged).  K2's walk (ffm.cuh) reads v kAhead = 4
// slots ahead from device memory, ten dependent round trips at n = 40:
// K2 runs many blocks an SM and its registers bound the read-ahead,
// while K1 runs one block an example.  Other shapes (D in tiles, rows
// past the opt-in) keep that walk.  Bound: the keys (and x), the
// fields, each distinct row's 4 + 4 S D B and 4B out; bytes bound it,
// and at serving sizes the launch does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ffm.cuh"
#include "mvm.cuh"
#include "stage.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;  // the LR/FM form's, at most
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kMvmWarps = 8;  // at most, as the stage fits (mvm.cuh)
// The LR/FM form's stage a warp: the rows of a chunk of slots, each
// factor's s and s2, and the chunk's keys and x (fm_warp_bytes).
constexpr size_t kFmWarpBudget = 12 * 1024;

using mvm::bf16_round;
using mvm::warp_sum;

// Entry j of row b: hot entries j < KH, then the cold ones.  Sets the
// key (-1: padding, or a hot key outside [0, H)), x and whether the
// row's values round to bf16.
__device__ __forceinline__ int entry_key(const int* krow, const float* xrow,
                                         const void* hot, const float* hot_x,
                                         int hot_u16, int H, int hot_bf16,
                                         long long b, int KH, int j, float& xv,
                                         bool& to_bf16) {
  if (j < KH) {
    const long long at = b * KH + j;
    int key = hot_u16 ? static_cast<int>(static_cast<const uint16_t*>(hot)[at])
                      : static_cast<const int*>(hot)[at];
    if (key >= H) key = -1;
    xv = hot_x != nullptr ? hot_x[at] : 1.0f;
    to_bf16 = hot_bf16 != 0;
    return key;
  }
  xv = xrow != nullptr ? xrow[j - KH] : 1.0f;
  to_bf16 = false;
  return krow[j - KH];
}

__device__ __forceinline__ void write_score(float logit, float* pctr,
                                            float* logit_out, int b) {
  float p = 1.0f / (1.0f + expf(-logit));
  if (logit < -30.0f) p = 1e-6f;
  if (logit > 30.0f) p = 1.0f;
  pctr[b] = p;
  if (logit_out != nullptr) logit_out[b] = logit;
}

__host__ __device__ inline size_t align16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// A warp's LR/FM stage for chunks of `chunk` slots at v width D: the
// rows [chunk][D] (first: cp.async wants them 16-byte aligned), s [D],
// s2 [D], key [chunk], x [chunk].
__host__ __device__ inline size_t fm_warp_bytes(int chunk, int D) {
  return align16(4 * static_cast<size_t>(chunk) * D + 8 * static_cast<size_t>(D) +
                 8 * static_cast<size_t>(chunk));
}

// Slots a warp stages at once: as many of the row's n as kFmWarpBudget
// holds, at least one.
inline int fm_chunk(int n, int D) {
  const size_t per_slot = 8 + 4 * static_cast<size_t>(D);
  const size_t fixed = 8 * static_cast<size_t>(D);
  const long long fit =
      kFmWarpBudget > fixed ? static_cast<long long>((kFmWarpBudget - fixed) / per_slot) : 0;
  const long long c = fit < n ? fit : n;
  return static_cast<int>(c > 1 ? c : 1);
}

// An asynchronous copy of kBytes (4, 8 or 16, both addresses aligned to
// it) from device memory into shared memory; cp_async_wait_all waits
// for this thread's copies.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(to), "l"(src),
               "n"(kBytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The LR/FM form (header): VW floats a v copy (D % VW == 0, v aligned to
// 4 VW bytes); VW = 0 for LR (D = 0).
template <int VW>
__global__ void __launch_bounds__(kThreads)
score_kernel(const int* __restrict__ keys, const float* __restrict__ x,
             const void* __restrict__ hot, const float* __restrict__ hot_x,
             int hot_u16, int H, int hot_bf16,
             const float* __restrict__ w, const float* __restrict__ v,
             float* __restrict__ pctr, float* __restrict__ logit_out,
             int B, int K, int KH, int D, int chunk) {
  extern __shared__ __align__(16) char fm_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // warp-uniform; the kernel has no block barrier
  const long long row = static_cast<long long>(b) * K;
  const int* krow = keys + row;
  const float* xrow = x != nullptr ? x + row : nullptr;
  const int n = KH + K;
  float lin = 0.0f;
  if constexpr (VW == 0) {  // LR: a key's w read follows it, two slots a lane in flight
    for (int j = lane; j < n; j += 32) {
      float xv;
      bool to_bf16;
      const int key = entry_key(krow, xrow, hot, hot_x, hot_u16, H, hot_bf16, b, KH, j,
                                xv, to_bf16);
      if (key < 0) continue;  // padding: never read, never counted
      const float wv = w[key];
      lin += (to_bf16 ? bf16_round(wv) : wv) * xv;
    }
    lin = warp_sum(lin);
    if (lane == 0) write_score(lin, pctr, logit_out, b);
    return;
  } else {
    float* rows = reinterpret_cast<float*>(fm_smem + warp * fm_warp_bytes(chunk, D));
    float* s = rows + static_cast<size_t>(chunk) * D;
    float* s2 = s + D;
    int* skey = reinterpret_cast<int*>(s2 + D);
    float* sx = reinterpret_cast<float*>(skey + chunk);
    const int groups = D / VW;  // v copies a slot
    // lane (q, dd) sums factor dd over the slots q, q + Q, ... of a chunk
    const bool split = D <= 16;
    const int Q = split ? 32 / D : 1;
    const int q = split ? lane / D : 0;
    const int dd = split ? lane - q * D : lane;
    for (int d = lane; d < D; d += 32) {
      s[d] = 0.0f;
      s2[d] = 0.0f;
    }
    for (int c0 = 0; c0 < n; c0 += chunk) {
      const int cn = min(chunk, n - c0);
      __syncwarp();  // the previous chunk's stage is read out
      for (int i = lane; i < cn; i += 32) {
        float xv;
        bool to_bf16;
        const int key = entry_key(krow, xrow, hot, hot_x, hot_u16, H, hot_bf16, b, KH,
                                  c0 + i, xv, to_bf16);
        skey[i] = key;
        sx[i] = key >= 0 ? xv : 0.0f;  // padding adds exact zeros below
      }
      __syncwarp();
      // every v row of the chunk in flight; a padding slot's row is zeros
      // (never read)
      auto copy = [&](int i, int g) {
        const int key = skey[i];
        float* dst = rows + i * D + g * VW;
        if (key >= 0) {
          cp_async<4 * VW>(dst, v + static_cast<long long>(key) * D + g * VW);
        } else {
#pragma unroll
          for (int k = 0; k < VW; ++k) dst[k] = 0.0f;
        }
      };
      if (groups <= 32) {  // lane (p, g) copies group g of slots p, p + P, ...
        const int P = 32 / groups;
        const int p = lane / groups;
        if (p < P) {
          for (int i = p; i < cn; i += P) copy(i, lane - p * groups);
        }
      } else {
        for (int it = lane; it < cn * groups; it += 32) copy(it / groups, it % groups);
      }
      // w's reads beside them
      for (int i = lane; i < cn; i += 32) {
        const int key = skey[i];
        if (key < 0) continue;
        const float wv = w[key];
        lin += (c0 + i < KH && hot_bf16 ? bf16_round(wv) : wv) * sx[i];
      }
      cp_async_wait_all();
      __syncwarp();  // every lane's copies have landed
      auto add = [&](int i, int d, float& cs, float& cs2) {
        const float r = rows[i * D + d];
        const float vx = (c0 + i < KH && hot_bf16 ? bf16_round(r) : r) * sx[i];
        cs += vx;
        cs2 += vx * vx;
      };
      if (split) {
        float cs = 0.0f, cs2 = 0.0f;
        if (q < Q) {
#pragma unroll 4
          for (int i = q; i < cn; i += Q) add(i, dd, cs, cs2);
        }
        float ts = 0.0f, ts2 = 0.0f;  // the groups' sums, in group order
        for (int g = 0; g < Q; ++g) {
          ts += __shfl_sync(0xffffffffu, cs, g * D + dd);
          ts2 += __shfl_sync(0xffffffffu, cs2, g * D + dd);
        }
        if (q == 0) {
          s[dd] += ts;
          s2[dd] += ts2;
        }
      } else {
        for (int d = lane; d < D; d += 32) {
          float cs = 0.0f, cs2 = 0.0f;
#pragma unroll 4
          for (int i = 0; i < cn; ++i) add(i, d, cs, cs2);
          s[d] += cs;
          s2[d] += cs2;
        }
      }
    }
    float inter = 0.0f;  // each lane's factors: those it summed into s, s2
    for (int d = lane; d < D; d += 32) inter += s[d] * s[d] - s2[d];
    const float logit = warp_sum(lin + inter);
    if (lane == 0) write_score(logit, pctr, logit_out, b);
  }
}

// The MVM form: slot j's v row (the head rows for hot slots, rounded
// to bf16 under the flag).
struct ScoreRows {
  const float* v;
  const int* key;
  int D, KH, bf16;
  __device__ __forceinline__ const float* operator()(int j,
                                                     bool& to_bf16) const {
    to_bf16 = j < KH && bf16 != 0;
    return v + static_cast<long long>(key[j]) * D;
  }
};

// Row b of the MVM form on one warp's stage (kGlobalStage: in device
// memory).
template <bool kGlobalStage>
__device__ __forceinline__ void score_mvm_row(
    const mvm::Stage& s, int b, int lane, const int* keys, const float* x,
    const void* hot, const float* hot_x, int hot_u16, int H, int hot_bf16,
    const void* fields, const void* hot_fields, int f_i32, int S,
    const float* v, float* pctr, float* logit_out, int K, int KH, int D) {
  const int n = KH + K;
  const long long row = static_cast<long long>(b) * K;
  for (int j = lane; j < n; j += 32) {
    float xv;
    bool to_bf16;
    int key = entry_key(keys + row, x != nullptr ? x + row : nullptr, hot,
                        hot_x, hot_u16, H, hot_bf16, b, KH, j, xv, to_bf16);
    int f = mvm::field_of(fields, hot_fields, f_i32, b, K, KH, j);
    if (key < 0 || f < 0 || f >= S) {
      key = -1;
      f = -1;
    }
    s.key[j] = key;
    s.x[j] = xv;
    s.fld[j] = f;
  }
  int nr = 0;
  const bool repeats = mvm::link_fields(s, n, S, lane, nr);
  const ScoreRows rows{v, s.key, D, KH, hot_bf16};
  float logit = 0.0f;
  for (int d0 = 0; d0 < D; d0 += mvm::kTile) {
    const int dt = min(mvm::kTile, D - d0);
    const float p = mvm::tile_forward<kGlobalStage>(s, n, nr, repeats, d0, dt, lane, rows);
    logit += warp_sum(lane < dt ? p - 1.0f : 0.0f);
  }
  if (lane == 0) write_score(logit, pctr, logit_out, b);
}

// kGlobalStage: the warps' stages in the device-memory scratch `gstage`
// (stage.cuh), the grid looping over the rows; else in shared memory,
// a warp a row.
template <bool kGlobalStage>
__global__ void __launch_bounds__(32 * kMvmWarps)
score_mvm_kernel(const int* __restrict__ keys, const float* __restrict__ x,
                 const void* __restrict__ hot, const float* __restrict__ hot_x,
                 int hot_u16, int H, int hot_bf16,
                 const void* __restrict__ fields,
                 const void* __restrict__ hot_fields, int f_i32, int S,
                 const float* __restrict__ v, float* __restrict__ pctr,
                 float* __restrict__ logit_out, int B, int K, int KH, int D,
                 char* __restrict__ gstage) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int first = blockIdx.x * warps + warp;
  if constexpr (kGlobalStage) {
    const mvm::Stage s = mvm::global_stage_at(gstage, first, KH + K);
    mvm::clear_heads(s, S, lane);
    for (int b = first; b < B; b += gridDim.x * warps) {
      __syncwarp();  // the previous row's stage is read out
      score_mvm_row<true>(s, b, lane, keys, x, hot, hot_x, hot_u16, H, hot_bf16,
                    fields, hot_fields, f_i32, S, v, pctr, logit_out, K, KH, D);
    }
  } else {
    extern __shared__ char smem[];
    if (first >= B) return;  // warp-uniform; the kernel has no block barrier
    const mvm::Stage s = mvm::stage_at(smem, warp, KH + K);
    mvm::clear_heads(s, S, lane);
    score_mvm_row<false>(s, first, lane, keys, x, hot,
                  hot_x, hot_u16, H, hot_bf16, fields, hot_fields, f_i32, S, v,
                  pctr, logit_out, K, KH, D);
  }
}

// Slot j's v row in K1's own stage of the rows (the FFM form where one
// tile holds D and the rows fit beside the sums: rows_staged).
struct StagedRows {
  const float* rows;
  int E;
  __device__ __forceinline__ const float* operator()(int j) const {
    return rows + static_cast<long long>(j) * E;
  }
};

// The pair term 1/2 (cross - diag) of the staged slots, tile by tile
// (ffm.cuh), each slot's v row from `rows`.
template <typename Row>
__device__ __forceinline__ float ffm_pair(const ffm::Stage& s, int n, int F,
                                          int D, int dt, const Row& rows) {
  float pair = 0.0f;
  for (int d0 = 0; d0 < D; d0 += dt) {
    const int t = min(dt, D - d0);
    const float diag = ffm::tile_sums(s, n, F, D, d0, t, rows);
    __syncthreads();
    pair += ffm::tile_cross(s, F, t) - diag;
    __syncthreads();  // before the next tile's sums overwrite S
  }
  return pair;
}

// Row b of the FFM form on the block's stage (ffm.cuh).  srows not
// null: every live slot's v row is first copied into it with cp.async
// (16-byte copies where F D % 4 == 0 and v is aligned), so the row's
// reads are in flight together and the sums read shared memory, where
// ffm::tile_sums' walk reads v kAhead slots ahead from device memory.
// Either way the sums add the same values in the same order.
__device__ __forceinline__ void score_ffm_row(
    const ffm::Stage& s, float* srows, long long b, const int* keys,
    const float* x, const void* hot, const float* hot_x, int hot_u16, int H,
    int hot_bf16, const void* fields, const void* hot_fields, int f_i32, int F,
    const float* w, const float* v, float* pctr, float* logit_out, int K,
    int KH, int D, int dt) {
  const int n = KH + K;
  const long long row = b * K;
  const int E = F * D;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float xv;
    bool to_bf16;
    const int key = entry_key(keys + row, x != nullptr ? x + row : nullptr, hot,
                              hot_x, hot_u16, H, hot_bf16, b, KH, j, xv, to_bf16);
    const int f = mvm::field_of(fields, hot_fields, f_i32, b, K, KH, j);
    s.key[j] = key;
    s.x[j] = xv;
    s.fld[j] = key >= 0 && f >= 0 && f < F ? f : -1;
  }
  __syncthreads();
  if (srows != nullptr) {
    if ((E & 3) == 0 && (reinterpret_cast<std::uintptr_t>(v) & 15u) == 0) {
      const int groups = E >> 2;
      for (int it = threadIdx.x; it < n * groups; it += blockDim.x) {
        const int j = it / groups;
        const int g = it - j * groups;
        if (s.fld[j] >= 0) {
          cp_async<16>(srows + j * E + 4 * g,
                       v + static_cast<long long>(s.key[j]) * E + 4 * g);
        }
      }
    } else {
      for (int it = threadIdx.x; it < n * E; it += blockDim.x) {
        const int j = it / E;
        const int c = it - j * E;
        if (s.fld[j] >= 0) {
          cp_async<4>(srows + it, v + static_cast<long long>(s.key[j]) * E + c);
        }
      }
    }
  }
  // the linear term, w's reads beside the copies
  float lin = 0.0f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int key = s.key[j];
    if (key < 0) continue;
    const float wv = w[key];
    lin += (j < KH && hot_bf16 ? bf16_round(wv) : wv) * s.x[j];
  }
  float pair;
  if (srows != nullptr) {
    cp_async_wait_all();
    __syncthreads();  // every thread's copies have landed
    pair = ffm_pair(s, n, F, D, D, StagedRows{srows, E});
  } else {
    pair = ffm_pair(s, n, F, D, dt, ffm::Rows{v, s.key, E});
  }
  const float logit = ffm::block_sum(lin + 0.5f * pair, s.red);
  if (threadIdx.x == 0) write_score(logit, pctr, logit_out, static_cast<int>(b));
}

// The FFM form: one block per row.  kGlobalStage: the blocks' stages
// in the device-memory scratch `gstage` (stage.cuh), the grid looping
// over the rows; else in shared memory, with the rows' v staged there
// too when kStagedRows (rows_staged).
template <bool kGlobalStage, bool kStagedRows>
__global__ void __launch_bounds__(ffm::kMaxThreads)
score_ffm_kernel(const int* __restrict__ keys, const float* __restrict__ x,
                 const void* __restrict__ hot, const float* __restrict__ hot_x,
                 int hot_u16, int H, int hot_bf16,
                 const void* __restrict__ fields,
                 const void* __restrict__ hot_fields, int f_i32, int F,
                 const float* __restrict__ w, const float* __restrict__ v,
                 float* __restrict__ pctr, float* __restrict__ logit_out,
                 int B, int K, int KH, int D, int dt, char* __restrict__ gstage) {
  const int n = KH + K;
  if constexpr (kGlobalStage) {
    const ffm::Stage s = ffm::global_stage_at(gstage, blockIdx.x, F, dt, n);
    for (long long b = blockIdx.x; b < B; b += gridDim.x) {
      __syncthreads();  // the previous row's stage and sums are read out
      score_ffm_row(s, nullptr, b, keys, x, hot, hot_x, hot_u16, H, hot_bf16,
                    fields, hot_fields, f_i32, F, w, v, pctr, logit_out, K, KH,
                    D, dt);
    }
  } else {
    extern __shared__ __align__(16) float ffm_smem[];
    float* srows = kStagedRows
                       ? ffm_smem + align16(ffm::stage_bytes(F, n, dt)) / 4
                       : nullptr;
    score_ffm_row(ffm::stage_at(ffm_smem, F, dt, n), srows, blockIdx.x, keys, x,
                  hot, hot_x, hot_u16, H, hot_bf16, fields, hot_fields, f_i32, F,
                  w, v, pctr, logit_out, K, KH, D, dt);
  }
}

// K1's FFM stage with the rows beside it: the sums and slots as
// ffm::stage_bytes, then n rows of F * D floats (one tile holds D).
inline size_t rows_staged_bytes(int F, int n, int D) {
  return align16(ffm::stage_bytes(F, n, D)) + 4 * static_cast<size_t>(n) * F * D;
}

// Whether K1's FFM form stages the rows for B examples: one tile holds
// D, the rows fit beside the sums in a block's shared memory, and the
// card holds every block at once.  Past one wave the stage's shared
// memory (about 4 blocks an SM at the flagship, 9 without it) costs more
// than the read latency it hides: at the 16,384-row eval batch the
// staged form took 0.231 ms against the walk's 0.217 (H100 80GB HBM3,
// 700 W), at 512 rows 0.0152 against 0.0204.  Opts the kernel in to the
// stage's shared memory; the residency is kept for the last shape.
inline bool rows_staged(int B, int F, int n, int D, int dt) {
  if (dt != D) return false;
  const size_t smem = rows_staged_bytes(F, n, D);
  if (smem > stage::optin_bytes()) return false;
  static size_t key_smem = 0;
  static int key_threads = 0, key_dev = -1, wave = 0;
  const int threads = ffm::threads_for(F, dt);
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  if (dev != key_dev || smem != key_smem || threads != key_threads) {
    if (smem > static_cast<size_t>(mvm::kSmallSmem) &&
        cudaFuncSetAttribute(score_ffm_kernel<false, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess) {
      return false;
    }
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, score_ffm_kernel<false, true>,
                                                  threads, smem);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    wave = per_sm * sms;
    key_dev = dev;
    key_smem = smem;
    key_threads = threads;
  }
  return B <= wave;
}

struct HotPlane {
  const void* keys;
  const float* x;
  int u16, H, bf16, KH;
};

// The LR/FM form's launch: as many warps a block (at most four) as keep
// the stages within 48 KB, or one warp past it with the opt-in.
// Returns 0 or a CUDA error (cudaErrorInvalidValue when one slot's
// stage exceeds a block's shared memory).
template <int VW>
int launch_fm(const int* keys, const float* x, const HotPlane& h,
              const float* w, const float* v, float* pctr, float* logit, int B,
              int K, int D, cudaStream_t stream) {
  const int chunk = fm_chunk(K + h.KH, D);
  const size_t per_warp = D > 0 ? fm_warp_bytes(chunk, D) : 0;  // LR stages nothing
  int warps = kWarpsPerBlock;
  while (warps > 1 && warps * per_warp > static_cast<size_t>(mvm::kSmallSmem)) --warps;
  const size_t smem = warps * per_warp;
  if (smem > static_cast<size_t>(mvm::kSmallSmem)) {
    if (smem > stage::optin_bytes()) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = cudaFuncSetAttribute(
        score_kernel<VW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (B + warps - 1) / warps;
  score_kernel<VW><<<grid, 32 * warps, smem, stream>>>(
      keys, x, h.keys, h.x, h.u16, h.H, h.bf16, w, v, pctr, logit, B, K, h.KH,
      D, chunk);
  return 0;
}

}  // namespace

extern "C" int xf_mvm_bytes_per_slot() { return mvm::kBytesPerSlot; }
extern "C" int xf_mvm_warp_bytes() { return mvm::kWarpBytes; }
extern "C" int xf_ffm_stage_bytes(int F, int n, int dt) {
  return static_cast<int>(ffm::stage_bytes(F, n, dt));
}
extern "C" int xf_ffm_tile(int F, int D, int n) {
  return ffm::tile_factors(F, D, n);
}

// The device-memory scratch xf_score needs for these shapes (bytes; 0:
// none, the field form stages in shared memory, or another form).
extern "C" long long xf_score_stage_bytes(int form, int S, int B, int K,
                                          int KH, int D) {
  size_t bytes = 0;
  if (B > 0) {
    field_stage_plan(form, S, B, K + (KH > 0 ? KH : 0), D, kMvmWarps, &bytes);
  }
  return static_cast<long long>(bytes);
}

// Launches K1 on `stream`; KH = 0 means no hot plane (hot, hot_x,
// hot_fields unread).  form 0 is LR (v null) or FM, 1 the MVM form (w
// unread), 2 the FFM form (D is v's row width, S * the factors); the
// field forms read the field planes (f_i32: int32, else u8; S =
// max_fields).  A field form whose row does not fit shared memory
// stages it in `gstage`, xf_score_stage_bytes of device memory
// (stage.cuh).  Returns cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue when such a row comes without
// its scratch.
extern "C" int xf_score(const int* keys, const float* x, const void* hot,
                        const float* hot_x, int hot_u16, int H, int hot_bf16,
                        int form, const void* fields, const void* hot_fields,
                        int f_i32, int S, const float* w, const float* v,
                        float* pctr, float* logit, int B, int K, int KH, int D,
                        void* gstage, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HotPlane h{hot, hot_x, hot_u16, H, hot_bf16, KH > 0 ? KH : 0};
  size_t global_bytes = 0;
  const int global_grid =
      field_stage_plan(form, S, B, K + h.KH, D, kMvmWarps, &global_bytes);
  if (global_bytes > 0 && gstage == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  char* scratch = static_cast<char*>(gstage);
  if (form == 2) {
    const int dv = D / S;
    const int dt = ffm::tile_factors(S, dv, K + h.KH);
    if (global_bytes > 0) {
      score_ffm_kernel<true, false><<<global_grid, ffm::threads_for(S, dt), 0, s>>>(
          keys, x, hot, hot_x, hot_u16, H, hot_bf16, fields, hot_fields, f_i32,
          S, w, v, pctr, logit, B, K, h.KH, dv, dt, scratch);
    } else if (rows_staged(B, S, K + h.KH, dv, dt)) {
      const size_t smem = rows_staged_bytes(S, K + h.KH, dv);
      score_ffm_kernel<false, true><<<B, ffm::threads_for(S, dt), smem, s>>>(
          keys, x, hot, hot_x, hot_u16, H, hot_bf16, fields, hot_fields, f_i32,
          S, w, v, pctr, logit, B, K, h.KH, dv, dt, nullptr);
    } else {
      int threads = 0;
      size_t smem = 0;
      const int rc = ffm::launch_shape(score_ffm_kernel<false, false>, S, dt,
                                       K + h.KH, &threads, &smem);
      if (rc != 0) return rc;
      score_ffm_kernel<false, false><<<B, threads, smem, s>>>(
          keys, x, hot, hot_x, hot_u16, H, hot_bf16, fields, hot_fields, f_i32,
          S, w, v, pctr, logit, B, K, h.KH, dv, dt, nullptr);
    }
  } else if (form == 1) {
    if (global_bytes > 0) {
      score_mvm_kernel<true><<<global_grid, 32 * kMvmWarps, 0, s>>>(
          keys, x, hot, hot_x, hot_u16, H, hot_bf16, fields, hot_fields, f_i32,
          S, v, pctr, logit, B, K, h.KH, D, scratch);
    } else {
      int warps = 1;
      size_t smem = 0;
      const int rc = mvm::launch_shape(score_mvm_kernel<false>, K + h.KH,
                                       kMvmWarps, &warps, &smem);
      if (rc != 0) return rc;
      const int grid = (B + warps - 1) / warps;
      score_mvm_kernel<false><<<grid, 32 * warps, smem, s>>>(
          keys, x, hot, hot_x, hot_u16, H, hot_bf16, fields, hot_fields, f_i32,
          S, v, pctr, logit, B, K, h.KH, D, nullptr);
    }
  } else {
    // v's copies: 16 or 8 bytes where D and v's alignment allow
    const auto at = reinterpret_cast<std::uintptr_t>(v);
    int rc;
    if (v == nullptr || D == 0) {
      rc = launch_fm<0>(keys, x, h, w, nullptr, pctr, logit, B, K, 0, s);
    } else if (D % 4 == 0 && at % 16 == 0) {
      rc = launch_fm<4>(keys, x, h, w, v, pctr, logit, B, K, D, s);
    } else if (D % 2 == 0 && at % 8 == 0) {
      rc = launch_fm<2>(keys, x, h, w, v, pctr, logit, B, K, D, s);
    } else {
      rc = launch_fm<1>(keys, x, h, w, v, pctr, logit, B, K, D, s);
    }
    if (rc != 0) return rc;
  }
  return static_cast<int>(cudaGetLastError());
}
