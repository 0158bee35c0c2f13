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
// Design (first, simple and right): one warp per example.  Lanes
// stride over the K slots, so the keys of one example are read
// coalesced; each live slot reads its w entry and its D-float v row
// and accumulates linear, s[d] and s2[d] in registers, CAP factors at
// a time (CAP = 8, 16 or 32, unrolled and guarded by the runtime D):
// a v wider than 32 runs in tiles of 32 factors, each re-reading the
// slots' keys (from L1/L2), so any D the reference accepts runs with
// the same registers.  Warp butterfly shuffles reduce the lanes; lane
// 0 forms the logit and the clamped sigmoid.  Nothing goes back to
// device memory between the gather and the score.  A padding slot is
// skipped before any table read: the JAX path reads row 0 and masks it
// out, this kernel never reads it.  Sums run in another order than the
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
// they are.  Bound: the keys (and x), the fields, each distinct row's
// 4 + 4 S D B and 4B out; bytes bound it, and at serving sizes the
// launch does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ffm.cuh"
#include "mvm.cuh"
#include "stage.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kMvmWarps = 8;  // at most, as the stage fits (mvm.cuh)

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

template <int CAP>
__global__ void __launch_bounds__(kThreads)
score_kernel(const int* __restrict__ keys, const float* __restrict__ x,
             const void* __restrict__ hot, const float* __restrict__ hot_x,
             int hot_u16, int H, int hot_bf16,
             const float* __restrict__ w, const float* __restrict__ v,
             float* __restrict__ pctr, float* __restrict__ logit_out,
             int B, int K, int KH, int D) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // b is warp-uniform: whole warps leave together
  const long long row = static_cast<long long>(b) * K;
  const int* krow = keys + row;
  const float* xrow = x != nullptr ? x + row : nullptr;

  float lin = 0.0f;
  float inter = 0.0f;
  float s[CAP > 0 ? CAP : 1];
  float s2[CAP > 0 ? CAP : 1];
  const int tiles = CAP > 0 ? (D + CAP - 1) / CAP : 1;
  for (int t = 0; t < tiles; ++t) {
    const int d0 = t * CAP;
#pragma unroll
    for (int d = 0; d < CAP; ++d) {
      s[d] = 0.0f;
      s2[d] = 0.0f;
    }
    for (int j = lane; j < KH + K; j += 32) {
      float xv;
      bool to_bf16;
      const int key = entry_key(krow, xrow, hot, hot_x, hot_u16, H, hot_bf16,
                                b, KH, j, xv, to_bf16);
      if (key < 0) continue;  // padding: never read, never counted
      if (t == 0) {
        const float wv = w[key];
        lin += (to_bf16 ? bf16_round(wv) : wv) * xv;
      }
      if (CAP > 0) {
        const float* vrow = v + static_cast<long long>(key) * D + d0;
#pragma unroll
        for (int d = 0; d < CAP; ++d) {
          if (d0 + d < D) {
            const float vd = to_bf16 ? bf16_round(vrow[d]) : vrow[d];
            const float vx = vd * xv;
            s[d] += vx;
            s2[d] += vx * vx;
          }
        }
      }
    }
#pragma unroll
    for (int d = 0; d < CAP; ++d) {
      if (d0 + d < D) {
        const float sd = warp_sum(s[d]);
        const float s2d = warp_sum(s2[d]);
        inter += sd * sd - s2d;
      }
    }
  }
  lin = warp_sum(lin);
  if (lane == 0) write_score(lin + inter, pctr, logit_out, b);
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

// Row b of the FFM form on the block's stage (ffm.cuh).
__device__ __forceinline__ void score_ffm_row(
    const ffm::Stage& s, long long b, const int* keys, const float* x,
    const void* hot, const float* hot_x, int hot_u16, int H, int hot_bf16,
    const void* fields, const void* hot_fields, int f_i32, int F,
    const float* w, const float* v, float* pctr, float* logit_out, int K,
    int KH, int D, int dt) {
  const int n = KH + K;
  const long long row = b * K;
  float lin = 0.0f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float xv;
    bool to_bf16;
    const int key = entry_key(keys + row, x != nullptr ? x + row : nullptr, hot,
                              hot_x, hot_u16, H, hot_bf16, b, KH, j, xv, to_bf16);
    const int f = mvm::field_of(fields, hot_fields, f_i32, b, K, KH, j);
    if (key >= 0) {
      const float wv = w[key];
      lin += (to_bf16 ? bf16_round(wv) : wv) * xv;
    }
    s.key[j] = key;
    s.x[j] = xv;
    s.fld[j] = key >= 0 && f >= 0 && f < F ? f : -1;
  }
  __syncthreads();
  const ffm::Rows rows{v, s.key, F * D};
  float pair = 0.0f;
  for (int d0 = 0; d0 < D; d0 += dt) {
    const int t = min(dt, D - d0);
    const float diag = ffm::tile_sums(s, n, F, D, d0, t, rows);
    __syncthreads();
    pair += ffm::tile_cross(s, F, t) - diag;
    __syncthreads();  // before the next tile's sums overwrite S
  }
  const float logit = ffm::block_sum(lin + 0.5f * pair, s.red);
  if (threadIdx.x == 0) write_score(logit, pctr, logit_out, static_cast<int>(b));
}

// The FFM form: one block per row.  kGlobalStage: the blocks' stages
// in the device-memory scratch `gstage` (stage.cuh), the grid looping
// over the rows; else in shared memory.
template <bool kGlobalStage>
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
      score_ffm_row(s, b, keys, x, hot, hot_x, hot_u16, H, hot_bf16, fields,
                    hot_fields, f_i32, F, w, v, pctr, logit_out, K, KH, D, dt);
    }
  } else {
    extern __shared__ float ffm_smem[];
    score_ffm_row(ffm::stage_at(ffm_smem, F, dt, n), blockIdx.x, keys, x, hot,
                  hot_x, hot_u16, H, hot_bf16, fields, hot_fields, f_i32, F, w,
                  v, pctr, logit_out, K, KH, D, dt);
  }
}

struct HotPlane {
  const void* keys;
  const float* x;
  int u16, H, bf16, KH;
};

template <int CAP>
void launch(const int* keys, const float* x, const HotPlane& h,
            const float* w, const float* v, float* pctr, float* logit, int B,
            int K, int D, cudaStream_t stream) {
  const int grid = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  score_kernel<CAP><<<grid, kThreads, 0, stream>>>(
      keys, x, h.keys, h.x, h.u16, h.H, h.bf16, w, v, pctr, logit, B, K, h.KH,
      D);
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
      score_ffm_kernel<true><<<global_grid, ffm::threads_for(S, dt), 0, s>>>(
          keys, x, hot, hot_x, hot_u16, H, hot_bf16, fields, hot_fields, f_i32,
          S, w, v, pctr, logit, B, K, h.KH, dv, dt, scratch);
    } else {
      int threads = 0;
      size_t smem = 0;
      const int rc = ffm::launch_shape(score_ffm_kernel<false>, S, dt, K + h.KH,
                                       &threads, &smem);
      if (rc != 0) return rc;
      score_ffm_kernel<false><<<B, threads, smem, s>>>(
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
  } else if (v == nullptr || D == 0) {
    launch<0>(keys, x, h, w, nullptr, pctr, logit, B, K, 0, s);
  } else if (D <= 8) {
    launch<8>(keys, x, h, w, v, pctr, logit, B, K, D, s);
  } else if (D <= 16) {
    launch<16>(keys, x, h, w, v, pctr, logit, B, K, D, s);
  } else {
    launch<32>(keys, x, h, w, v, pctr, logit, B, K, D, s);
  }
  return static_cast<int>(cudaGetLastError());
}
