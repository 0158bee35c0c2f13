// K2 — the fused sparse train step for LR and FM: forward, residual,
// per-occurrence gradients, scatter-add and the log-loss sum in one
// kernel.
//
// Replaces these XLA-lowered regions of the JAX reference's dense,
// microbatch=1 train step (xflow_tpu/parallel/step.py::
// TrainStep._train_impl, lines 1024-1129; the reference has no Pallas
// kernels, so these jnp regions are what a port turns into kernels —
// ROADMAP Queue B):
//   B4 compact  step.py:769-813 _expand_wire — key -1 = padding;
//               val = mask = (key >= 0); labels/weights from u8 planes
//   B1          step.py:815-822 training gather + models/blocks.py:41-53
//               masked_x / linear_term + utils/metrics.py:34 sigmoid_ref
//   B8 fwd/bwd  models/blocks.py:171-183 fm_pair_pieces, models/fm.py:60-75
//               logit = linear + sum_d(s_d^2 - s2_d) (no 1/2);
//               grad_v = (s_d - v_d x) x (the 1/2-form, reference quirk)
//   B2          step.py:49-87 grads_from_rows (residual
//               r = (pctr - y) * weight / num_real) + step.py:923-1022
//               _cold_keys_eff / _scatter_grads / _cold_accumulate: the
//               drop-mode scatter-add into the [T, D] gradient buffers
//   loss        utils/metrics.py:41-56 logloss_sum (clip to [1e-6, 1-1e-6])
//   B7          ops/hot.py:71 hot_gather and :122 hot_scatter, as
//               step.py:815-846 _gather_model_rows and :1008-1016
//               _scatter_grads (dense), :1194-1238 _sparse_update (the
//               hybrid) and :1327-1497 _train_sequential_hot use them
//
// Inputs: keys i32 [B, K] sentinel-coded (-1 = padding); x f32 [B, K]
// or null (null: x = 1 on live slots — the compact wire); labels and
// weights [B], u8 (compact wire) or f32 (full wire); num_real =
// max(sum(weights), 1), computed on the host; w f32 [T, 1], v f32 [T, D]
// or null (LR).  Outputs, accumulated: g_w [T, 1], g_v [T, D] (+= the
// scattered gradients), acc f64 [2] (+= log-loss sum, weight sum).
// acc is double because a launch lands one partial per block (about a
// thousand) in it, and every launch of a step (up to `microbatch` of
// them) adds into the same acc: a float32 running sum drifts by parts
// in 1e5, and at initialisation, where every example has the same
// loss, the rounding of the equal addends adds up.
//
// Index mode (slots not null; the sparse update modes, B5's
// consolidate_apply): slots i32 [B, K] is K4's
// slot plane (csrc/sparse.cu), and occurrence (b, k)'s gradient is added
// into row slots[b, k] of g_w [M, 1] and g_v [M, D] — the per-unique-key
// sums K5 then applies — instead of row key.  The forward, residual and
// log-loss are unchanged.  The atomics stay per occurrence (a hot row
// still serialises); the slot plane adds 4 B per slot read, and the
// gradient rows land in a compact [U, D] block instead of U rows
// scattered over [T, D].
//
// The hot plane (B7; KH = 0 without a hot table).  hot [B, KH] holds a
// row's hot keys, u16 (hot_u16, 0xFFFF padding) or i32 (-1 padding),
// with hot_x f32 [B, KH] or null, as x; lanes walk the KH + K entries,
// hot first (the reference's _model_view order).  On this card the
// head is rows [0, H) of the same table, so the reference's one-hot
// matmuls become ordinary row reads and atomic adds; the contract
// stays: a hot key outside [0, H) is a zero row whose gradient is
// dropped (taken here as padding); with hot_bf16 the hot rows' w and v
// are rounded to bfloat16 (nearest even) before use and each hot
// occurrence's gradient before its float32 add — hot_impl "mxu" with
// hot_dtype "bfloat16".  A hot occurrence's gradient goes to row key of
// hgw [H, 1] / hgv [H, D], whatever the cold destination: the table's
// own g (its first H rows) in dense mode, a per-table head buffer in
// the hybrid and the hot inner, which K3 then applies to rows [0, H).
//
// Window-start mode (the hot inner, snap_w not null): a cold key < H
// reads its row from the head snapshot snap_w [H, 1] / snap_v [H, D]
// taken at the window's start, as the reference gathers every cold row
// once per dispatch window (step.py:1384-1386); cold keys >= H are not
// written during a window, so the live table already holds their
// window-start values.  The cold gradients accumulate over the
// window's slices in g (dense window end) or, in index mode, in one
// gsum over the whole batch's plan (sparse window end), and K3 or K5
// closes the window: the same sums as the reference's stacked
// [B, Kc, D] gradients, in another order.
//
// Bound.  Per live slot the kernel reads its key (and x), its w entry
// and its D-float v row, and read-modify-writes g_w[key] and the D
// floats of g_v[key].  Counting each input once and each output once,
// it uses
//   B*K*(4 key + 4 x, if given) + B*(labels + weights)
//   + rows * 3 * (4 + 4D)        (w, v read; g_w, g_v read and written)
// bytes, where rows counts the distinct live keys.  A random row access
// moves whole 32-byte DRAM sectors, so the card moves at least
//   B*K*(4 + 4, if x) + B*(labels + weights)
//   + rows * 3 * (32 + ceil(4D/32) * 32)
// bytes (the sector-level bound), over 3.35 TB/s on an H100 SXM.  At
// B = 65,536, K = 40, uniform keys over T = 2^24 (about 2.5 M distinct
// rows), that is about 0.8 ms for FM (D = 10) at sector granularity.
// The arithmetic (about 9D + 4 flops per live slot) is far below the
// card's rate.  Repeated keys within a batch (skewed data) serialise
// their atomics on one address; that cost is measured, not avoided.
//
// Design (first, simple and right): one warp per example, a grid of a
// few blocks per SM looping over the examples.  Lanes stride over the
// K slots, so an example's keys are read coalesced; a padding slot is
// skipped before any table access (the JAX path reads row 0 and masks
// it; this kernel never touches it).  Each live slot accumulates
// linear, s[d], s2[d] in registers, CAP factors at a time (CAP = 8, 16
// or 32, unrolled and guarded by the runtime D; a v wider than 32 runs
// in tiles of 32, so any D the reference accepts runs with the same
// registers); xor butterflies leave the sums on every lane, so every
// lane forms the same residual and scatters its own slots with
// atomicAdd (the v row is read again, from L1/L2; with more than one
// tile the backward recomputes each tile's s but the last one's).
// Lane 0 adds the example's clipped log-loss times its weight into a
// register; each block reduces its warps' partials in shared memory
// and lands them with one atomic pair into acc.  Offsets are 64-bit.
// Sums run in another order than the plain version, and atomics in an
// order that changes from run to run, so results agree to float
// rounding, not bitwise.
//
// The MVM form (B9, fields not null; mvm.cuh has its regions and
// design): no w (gw, hgw and snap_w unread), the field planes fields
// [B, K] / hot_fields [B, KH] (u8, or int32 with f_i32) and S =
// max_fields; the residual as above, each present slot's gradient
// prod_d / own_d * x * r (zero under the guard) scattered to the same
// destinations as FM's: g or its first H rows (dense), K4's slots
// (index mode), the head buffer (hybrid, hot inner), with cold keys < H
// read from the window-start snapshot and the bf16 flag as above.
// Bound: the keys (and x), the fields, labels and weights once, and
// per distinct row 4D B of v read and 4D B of g read and written: bytes
// bound it (about 3D flops a slot and 2D per present field).  The
// atomics land one per factor per slot, lanes over the factors, so a
// slot's D adds hit one contiguous row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mvm.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kBlocksPerSm = 8;
constexpr float kLoglossEps = 1e-6f;
constexpr float kLoglossHi = 0.999999f;  // f32(1 - 1e-6), as the reference

using mvm::bf16_round;
using mvm::warp_sum;

template <typename LW>
__device__ __forceinline__ float as_float(LW v) {
  return static_cast<float>(v);
}

// The hot plane and its destinations (header); KH = 0 without one.
struct HotArgs {
  const void* keys;
  const float* x;
  int u16, H, bf16, KH;
  float* gw;
  float* gv;
  const float* snap_w;
  const float* snap_v;
};

// Entry j of row b: a hot entry j < KH, then the cold ones.  Returns
// its key (-1: padding, or a hot key outside [0, H)) and sets x and
// whether it is hot.
__device__ __forceinline__ int entry_key(const int* krow, const float* xrow,
                                         const HotArgs& h, long long b, int j,
                                         float& xv, bool& is_hot) {
  is_hot = j < h.KH;
  if (is_hot) {
    const long long at = b * h.KH + j;
    int key = h.u16 ? static_cast<int>(static_cast<const uint16_t*>(h.keys)[at])
                    : static_cast<const int*>(h.keys)[at];
    xv = h.x != nullptr ? h.x[at] : 1.0f;
    return key >= h.H ? -1 : key;
  }
  xv = xrow != nullptr ? xrow[j - h.KH] : 1.0f;
  return krow[j - h.KH];
}

// Whether a live key reads the window-start snapshot: a cold key < H
// in window-start mode.
__device__ __forceinline__ bool from_snap(const HotArgs& h, int key,
                                          bool is_hot) {
  return !is_hot && (h.snap_w != nullptr || h.snap_v != nullptr) &&
         key < h.H;
}

// Where entry j's gradient lands: the head destination for a hot
// entry (row key), else the cold destination at row key (dense) or at
// K4's slot (index mode; -1: a key K4 took for padding, dropped).
__device__ __forceinline__ long long grad_row(const int* srow, int j, int KH,
                                              int key, bool is_hot) {
  if (is_hot || srow == nullptr) return key;
  return srow[j - KH];
}

// The block's log-loss and weight partials into acc (one atomic pair).
__device__ __forceinline__ void land_loss(float ll_acc, float w_acc,
                                          double* acc) {
  __shared__ float part_ll[kWarpsPerBlock];
  __shared__ float part_w[kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  if (lane == 0) {
    part_ll[warp] = ll_acc;
    part_w[warp] = w_acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ll = 0.0f, wsum = 0.0f;
    for (int i = 0; i < warps; ++i) {
      ll += part_ll[i];
      wsum += part_w[i];
    }
    atomicAdd(acc, static_cast<double>(ll));
    atomicAdd(acc + 1, static_cast<double>(wsum));
  }
}

// The residual of example b, and its clipped log-loss times its weight
// into lane 0's partials.
template <typename LW>
__device__ __forceinline__ float residual(float logit, const LW* labels,
                                          const LW* weights, long long b,
                                          float num_real, int lane,
                                          float& ll_acc, float& w_acc) {
  float p = 1.0f / (1.0f + expf(-logit));
  if (logit < -30.0f) p = 1e-6f;
  if (logit > 30.0f) p = 1.0f;
  const float y = as_float(labels[b]);
  const float wt = as_float(weights[b]);
  if (lane == 0) {
    const float pc = fminf(fmaxf(p, kLoglossEps), kLoglossHi);
    const float ll = -(y * logf(pc) + (1.0f - y) * logf(1.0f - pc));
    ll_acc += ll * wt;
    w_acc += wt;
  }
  return (p - y) * wt / num_real;
}

template <int CAP, typename LW>
__global__ void __launch_bounds__(kThreads)
train_kernel(const int* __restrict__ keys, const float* __restrict__ x,
             const LW* __restrict__ labels, const LW* __restrict__ weights,
             float num_real, const float* __restrict__ w,
             const float* __restrict__ v, const int* __restrict__ slots,
             float* __restrict__ gw,
             float* __restrict__ gv, double* __restrict__ acc, int B, int K,
             int D, const HotArgs h) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long warps_total =
      static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  const int tiles = CAP > 0 ? (D + CAP - 1) / CAP : 1;
  float ll_acc = 0.0f;
  float w_acc = 0.0f;

  for (long long b = static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
                     warp;
       b < B; b += warps_total) {
    const long long row = b * K;
    const int* krow = keys + row;
    const int* srow = slots != nullptr ? slots + row : nullptr;
    const float* xrow = x != nullptr ? x + row : nullptr;

    float lin = 0.0f;
    float inter = 0.0f;
    float s[CAP > 0 ? CAP : 1];
    float s2[CAP > 0 ? CAP : 1];
    // the forward, tile by tile; s keeps the last tile's sums
    for (int t = 0; t < tiles; ++t) {
      const int d0 = t * CAP;
#pragma unroll
      for (int d = 0; d < CAP; ++d) {
        s[d] = 0.0f;
        s2[d] = 0.0f;
      }
      for (int j = lane; j < h.KH + K; j += 32) {
        float xv;
        bool is_hot;
        const int key = entry_key(krow, xrow, h, b, j, xv, is_hot);
        if (key < 0) continue;  // padding: never read, never written
        const bool snap = from_snap(h, key, is_hot);
        const bool to_bf16 = is_hot && h.bf16;
        if (t == 0) {
          const float wv = snap ? h.snap_w[key] : w[key];
          lin += (to_bf16 ? bf16_round(wv) : wv) * xv;
        }
        if (CAP > 0) {
          const float* vrow =
              (snap ? h.snap_v : v) + static_cast<long long>(key) * D + d0;
#pragma unroll
          for (int d = 0; d < CAP; ++d) {
            if (d0 + d < D) {
              const float vx = (to_bf16 ? bf16_round(vrow[d]) : vrow[d]) * xv;
              s[d] += vx;
              s2[d] += vx * vx;
            }
          }
        }
      }
#pragma unroll
      for (int d = 0; d < CAP; ++d) {
        if (d0 + d < D) {
          s[d] = warp_sum(s[d]);  // every lane keeps s_d for the backward
          const float s2d = warp_sum(s2[d]);
          inter += s[d] * s[d] - s2d;
        }
      }
    }
    lin = warp_sum(lin);
    const float r = residual(lin + inter, labels, weights, b, num_real, lane,
                             ll_acc, w_acc);

    // the backward, the last tile first (its sums are in s)
    for (int t = tiles - 1; t >= 0; --t) {
      const int d0 = t * CAP;
      if (t != tiles - 1) {
#pragma unroll
        for (int d = 0; d < CAP; ++d) s[d] = 0.0f;
        for (int j = lane; j < h.KH + K; j += 32) {
          float xv;
          bool is_hot;
          const int key = entry_key(krow, xrow, h, b, j, xv, is_hot);
          if (key < 0) continue;
          const bool to_bf16 = is_hot && h.bf16;
          const float* vrow = (from_snap(h, key, is_hot) ? h.snap_v : v) +
                              static_cast<long long>(key) * D + d0;
#pragma unroll
          for (int d = 0; d < CAP; ++d) {
            if (d0 + d < D) {
              s[d] += (to_bf16 ? bf16_round(vrow[d]) : vrow[d]) * xv;
            }
          }
        }
#pragma unroll
        for (int d = 0; d < CAP; ++d) {
          if (d0 + d < D) s[d] = warp_sum(s[d]);
        }
      }
      for (int j = lane; j < h.KH + K; j += 32) {
        float xv;
        bool is_hot;
        const int key = entry_key(krow, xrow, h, b, j, xv, is_hot);
        if (key < 0) continue;
        const long long dst = grad_row(srow, j, h.KH, key, is_hot);
        if (dst < 0) continue;  // a key K4 took for padding (>= T)
        const bool to_bf16 = is_hot && h.bf16;
        if (t == 0) {
          const float gwv = xv * r;
          atomicAdd((is_hot ? h.gw : gw) + dst, to_bf16 ? bf16_round(gwv) : gwv);
        }
        if (CAP > 0) {
          const float* vrow = (from_snap(h, key, is_hot) ? h.snap_v : v) +
                              static_cast<long long>(key) * D + d0;
          float* grow = (is_hot ? h.gv : gv) + dst * D + d0;
#pragma unroll
          for (int d = 0; d < CAP; ++d) {
            if (d0 + d < D) {
              const float vx = (to_bf16 ? bf16_round(vrow[d]) : vrow[d]) * xv;
              const float gvv = (s[d] - vx) * xv * r;
              atomicAdd(grow + d, to_bf16 ? bf16_round(gvv) : gvv);
            }
          }
        }
      }
    }
  }
  land_loss(ll_acc, w_acc, acc);
}

// The MVM form: slot j's v row (the head snapshot for a cold key < H in
// window-start mode) and whether it rounds to bf16 (a hot slot under
// the flag).
struct TrainRows {
  const float* v;
  const float* snap_v;
  const int* key;
  int D, KH, H, bf16;
  __device__ __forceinline__ const float* operator()(int j,
                                                     bool& to_bf16) const {
    const int k = key[j];
    const bool hot = j < KH;
    to_bf16 = hot && bf16 != 0;
    const float* base = !hot && snap_v != nullptr && k < H ? snap_v : v;
    return base + static_cast<long long>(k) * D;
  }
};

template <typename LW>
__global__ void __launch_bounds__(kThreads)
train_mvm_kernel(const int* __restrict__ keys, const float* __restrict__ x,
                 const LW* __restrict__ labels, const LW* __restrict__ weights,
                 float num_real, const float* __restrict__ v,
                 const int* __restrict__ slots, float* __restrict__ gv,
                 double* __restrict__ acc, int B, int K, int D,
                 const void* __restrict__ fields,
                 const void* __restrict__ hot_fields, int f_i32, int S,
                 const HotArgs h) {
  extern __shared__ char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long warps_total = static_cast<long long>(gridDim.x) * warps;
  const int n = h.KH + K;
  const mvm::Stage s = mvm::stage_at(smem, warp, n);
  const TrainRows rows{v, h.snap_v, s.key, D, h.KH, h.H, h.bf16};
  const int tiles = (D + mvm::kTile - 1) / mvm::kTile;
  float ll_acc = 0.0f;
  float w_acc = 0.0f;

  for (long long b = static_cast<long long>(blockIdx.x) * warps + warp; b < B;
       b += warps_total) {
    const long long row = b * K;
    const int* srow = slots != nullptr ? slots + row : nullptr;
    __syncwarp();  // the previous example's stage is read out
    for (int j = lane; j < n; j += 32) {
      float xv;
      bool is_hot;
      int key = entry_key(keys + row, x != nullptr ? x + row : nullptr, h, b,
                          j, xv, is_hot);
      int f = mvm::field_of(fields, hot_fields, f_i32, b, K, h.KH, j);
      if (key < 0 || f < 0 || f >= S) {
        key = -1;
        f = -1;
      }
      s.key[j] = key;
      s.x[j] = xv;
      s.fld[j] = f;
      s.dst[j] = key < 0 ? -1 : static_cast<int>(grad_row(srow, j, h.KH, key,
                                                          is_hot));
    }
    mvm::find_reps(s, n, lane);
    float logit = 0.0f;
    float prod = 1.0f;  // the last tile's, lane d
    for (int t = 0; t < tiles; ++t) {
      const int d0 = t * mvm::kTile;
      const int dt = min(mvm::kTile, D - d0);
      mvm::tile_sums(s, n, d0, dt, lane, rows);
      prod = mvm::tile_prod(s, n, dt, lane);
      logit += warp_sum(lane < dt ? prod - 1.0f : 0.0f);
    }
    const float r = residual(logit, labels, weights, b, num_real, lane,
                             ll_acc, w_acc);
    for (int t = tiles - 1; t >= 0; --t) {
      const int d0 = t * mvm::kTile;
      const int dt = min(mvm::kTile, D - d0);
      if (t != tiles - 1) {
        mvm::tile_sums(s, n, d0, dt, lane, rows);
        prod = mvm::tile_prod(s, n, dt, lane);
      }
      if (lane >= dt) continue;
      for (int j = 0; j < n; ++j) {
        const int dst = s.dst[j];
        if (s.fld[j] < 0 || dst < 0) continue;
        const bool hot = j < h.KH;
        const float g = mvm::slot_grad(s, j, prod, lane) * r;
        float* grow = (hot ? h.gv : gv) + static_cast<long long>(dst) * D + d0;
        atomicAdd(grow + lane, hot && h.bf16 ? bf16_round(g) : g);
      }
    }
  }
  land_loss(ll_acc, w_acc, acc);
}

int grid_for(int B, int warps_per_block) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int want = (B + warps_per_block - 1) / warps_per_block;
  const int cap = sms * kBlocksPerSm;
  return want < cap ? want : cap;
}

template <int CAP, typename LW>
void launch(const int* keys, const float* x, const void* labels,
            const void* weights, float num_real, const float* w,
            const float* v, const int* slots, float* gw, float* gv,
            double* acc, int B, int K, int D, const HotArgs& h,
            cudaStream_t stream) {
  train_kernel<CAP, LW><<<grid_for(B, kWarpsPerBlock), kThreads, 0, stream>>>(
      keys, x, static_cast<const LW*>(labels),
      static_cast<const LW*>(weights), num_real, w, v, slots, gw, gv, acc, B,
      K, D, h);
}

struct Fields {
  const void* cold;
  const void* hot;
  int i32, S;
};

template <typename LW>
int dispatch(const int* keys, const float* x, const void* labels,
             const void* weights, float num_real, const float* w,
             const float* v, const int* slots, float* gw, float* gv,
             double* acc, int B, int K, int D, const HotArgs& h,
             const Fields& f, cudaStream_t s) {
  if (f.cold != nullptr) {
    int warps = 1;
    size_t smem = 0;
    const int rc = mvm::launch_shape(train_mvm_kernel<LW>, K + h.KH,
                                     kWarpsPerBlock, &warps, &smem);
    if (rc != 0) return rc;
    train_mvm_kernel<LW><<<grid_for(B, warps), 32 * warps, smem, s>>>(
        keys, x, static_cast<const LW*>(labels),
        static_cast<const LW*>(weights), num_real, v, slots, gv, acc, B, K, D,
        f.cold, f.hot, f.i32, f.S, h);
  } else if (v == nullptr || D == 0) {
    launch<0, LW>(keys, x, labels, weights, num_real, w, nullptr, slots, gw,
                  nullptr, acc, B, K, 0, h, s);
  } else if (D <= 8) {
    launch<8, LW>(keys, x, labels, weights, num_real, w, v, slots, gw, gv,
                  acc, B, K, D, h, s);
  } else if (D <= 16) {
    launch<16, LW>(keys, x, labels, weights, num_real, w, v, slots, gw, gv,
                   acc, B, K, D, h, s);
  } else {
    launch<32, LW>(keys, x, labels, weights, num_real, w, v, slots, gw, gv,
                   acc, B, K, D, h, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int xf_mvm_bytes_per_slot() { return mvm::kBytesPerSlot; }

// Launches K2 on `stream`; labels/weights are u8 when lw_u8 != 0, else
// f32; `slots` null is the dense mode, else the index mode (header).
// KH = 0 means no hot plane (the hot_* pointers unread); snap_v null is
// the live-table mode, else the window-start mode (header).  fields not
// null selects the MVM form (w, gw, hgw, snap_w unread; f_i32: int32
// field planes, else u8; S = max_fields).  Returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue when an MVM
// row's stage does not fit the card's shared memory.
extern "C" int xf_train_step(const int* keys, const float* x,
                             const void* labels, const void* weights,
                             int lw_u8, float num_real, const float* w,
                             const float* v, const int* slots, float* gw,
                             float* gv, double* acc, int B, int K, int D,
                             const void* hot, const float* hot_x, int hot_u16,
                             int H, int hot_bf16, int KH, float* hgw,
                             float* hgv, const float* snap_w,
                             const float* snap_v, const void* fields,
                             const void* hot_fields, int f_i32, int S,
                             void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HotArgs h{hot,  hot_x, hot_u16, H,      hot_bf16, KH > 0 ? KH : 0,
                  hgw,  hgv,   snap_w,  snap_v};
  const Fields f{fields, hot_fields, f_i32, S};
  if (lw_u8 != 0) {
    return dispatch<std::uint8_t>(keys, x, labels, weights, num_real, w, v,
                                  slots, gw, gv, acc, B, K, D, h, f, s);
  }
  return dispatch<float>(keys, x, labels, weights, num_real, w, v, slots, gw,
                         gv, acc, B, K, D, h, f, s);
}
