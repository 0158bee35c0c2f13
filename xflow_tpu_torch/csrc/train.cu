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
// linear, s[d], s2[d] in registers (D unrolled to the compile-time CAP,
// guarded by the runtime D); xor butterflies leave the sums on every
// lane, so every lane forms the same residual and scatters its own
// slots with atomicAdd (the v row is read again, from L1/L2).  Lane 0
// adds the example's clipped log-loss times its weight into a register;
// each block reduces its warps' partials in shared memory and lands
// them with one atomic pair into acc.  Offsets are 64-bit.  Sums run in
// another order than the plain version, and atomics in an order that
// changes from run to run, so results agree to float rounding, not
// bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxDim = 32;
constexpr float kLoglossEps = 1e-6f;
constexpr float kLoglossHi = 0.999999f;  // f32(1 - 1e-6), as the reference

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename LW>
__device__ __forceinline__ float as_float(LW v) {
  return static_cast<float>(v);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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
// its key (-1: padding, or a hot key outside [0, H)) and sets x, the
// row it reads w and v from, and whether it is hot.
__device__ __forceinline__ int entry(const int* krow, const float* xrow,
                                     const HotArgs& h, long long b, int j,
                                     const float* w, const float* v, int D,
                                     float& xv, const float*& wp,
                                     const float*& vrow, bool& is_hot) {
  int key;
  is_hot = j < h.KH;
  if (is_hot) {
    const long long at = b * h.KH + j;
    key = h.u16 ? static_cast<int>(static_cast<const uint16_t*>(h.keys)[at])
                : static_cast<const int*>(h.keys)[at];
    if (key >= h.H) key = -1;
    xv = h.x != nullptr ? h.x[at] : 1.0f;
  } else {
    key = krow[j - h.KH];
    xv = xrow != nullptr ? xrow[j - h.KH] : 1.0f;
  }
  if (key >= 0 && !is_hot && h.snap_w != nullptr && key < h.H) {
    wp = h.snap_w + key;
    vrow = h.snap_v != nullptr ? h.snap_v + static_cast<long long>(key) * D
                               : nullptr;
  } else if (key >= 0) {
    wp = w + key;
    vrow = v != nullptr ? v + static_cast<long long>(key) * D : nullptr;
  }
  return key;
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
  __shared__ float part_ll[kWarpsPerBlock];
  __shared__ float part_w[kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long warps_total =
      static_cast<long long>(gridDim.x) * kWarpsPerBlock;
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
    float s[CAP > 0 ? CAP : 1];
    float s2[CAP > 0 ? CAP : 1];
#pragma unroll
    for (int d = 0; d < CAP; ++d) {
      s[d] = 0.0f;
      s2[d] = 0.0f;
    }
    for (int j = lane; j < h.KH + K; j += 32) {
      float xv;
      const float* wp = nullptr;
      const float* vrow = nullptr;
      bool is_hot;
      const int key = entry(krow, xrow, h, b, j, w, v, D, xv, wp, vrow, is_hot);
      if (key < 0) continue;  // padding: never read, never written
      const bool to_bf16 = is_hot && h.bf16;
      lin += (to_bf16 ? bf16_round(*wp) : *wp) * xv;
      if (CAP > 0) {
#pragma unroll
        for (int d = 0; d < CAP; ++d) {
          if (d < D) {
            const float vx = (to_bf16 ? bf16_round(vrow[d]) : vrow[d]) * xv;
            s[d] += vx;
            s2[d] += vx * vx;
          }
        }
      }
    }
    lin = warp_sum(lin);
    float inter = 0.0f;
#pragma unroll
    for (int d = 0; d < CAP; ++d) {
      if (d < D) {
        s[d] = warp_sum(s[d]);  // every lane keeps s_d for the backward
        const float s2d = warp_sum(s2[d]);
        inter += s[d] * s[d] - s2d;
      }
    }
    const float logit = lin + inter;
    float p = 1.0f / (1.0f + expf(-logit));
    if (logit < -30.0f) p = 1e-6f;
    if (logit > 30.0f) p = 1.0f;
    const float y = as_float(labels[b]);
    const float wt = as_float(weights[b]);
    const float r = (p - y) * wt / num_real;

    for (int j = lane; j < h.KH + K; j += 32) {
      float xv;
      const float* wp = nullptr;
      const float* vrow = nullptr;
      bool is_hot;
      const int key = entry(krow, xrow, h, b, j, w, v, D, xv, wp, vrow, is_hot);
      if (key < 0) continue;
      const bool to_bf16 = is_hot && h.bf16;
      long long dst = key;
      float* gwd = h.gw;
      float* gvd = h.gv;
      if (!is_hot) {
        dst = srow != nullptr ? srow[j - h.KH] : key;
        if (dst < 0) continue;  // a key K4 took for padding (>= T)
        gwd = gw;
        gvd = gv;
      }
      const float gwv = xv * r;
      atomicAdd(gwd + dst, to_bf16 ? bf16_round(gwv) : gwv);
      if (CAP > 0) {
        float* grow = gvd + dst * D;
#pragma unroll
        for (int d = 0; d < CAP; ++d) {
          if (d < D) {
            const float vx = (to_bf16 ? bf16_round(vrow[d]) : vrow[d]) * xv;
            const float gvv = (s[d] - vx) * xv * r;
            atomicAdd(grow + d, to_bf16 ? bf16_round(gvv) : gvv);
          }
        }
      }
    }

    if (lane == 0) {
      const float pc = fminf(fmaxf(p, kLoglossEps), kLoglossHi);
      const float ll = -(y * logf(pc) + (1.0f - y) * logf(1.0f - pc));
      ll_acc += ll * wt;
      w_acc += wt;
    }
  }

  if (lane == 0) {
    part_ll[warp] = ll_acc;
    part_w[warp] = w_acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ll = 0.0f, wsum = 0.0f;
#pragma unroll
    for (int i = 0; i < kWarpsPerBlock; ++i) {
      ll += part_ll[i];
      wsum += part_w[i];
    }
    atomicAdd(acc, static_cast<double>(ll));
    atomicAdd(acc + 1, static_cast<double>(wsum));
  }
}

int grid_for(int B) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int want = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int cap = sms * kBlocksPerSm;
  return want < cap ? want : cap;
}

template <int CAP, typename LW>
void launch(const int* keys, const float* x, const void* labels,
            const void* weights, float num_real, const float* w,
            const float* v, const int* slots, float* gw, float* gv,
            double* acc, int B, int K, int D, const HotArgs& h,
            cudaStream_t stream) {
  train_kernel<CAP, LW><<<grid_for(B), kThreads, 0, stream>>>(
      keys, x, static_cast<const LW*>(labels),
      static_cast<const LW*>(weights), num_real, w, v, slots, gw, gv, acc, B,
      K, D, h);
}

template <typename LW>
int dispatch(const int* keys, const float* x, const void* labels,
             const void* weights, float num_real, const float* w,
             const float* v, const int* slots, float* gw, float* gv,
             double* acc, int B, int K, int D, const HotArgs& h,
             cudaStream_t s) {
  if (v == nullptr || D == 0) {
    launch<0, LW>(keys, x, labels, weights, num_real, w, nullptr, slots, gw,
                  nullptr, acc, B, K, 0, h, s);
  } else if (D <= 8) {
    launch<8, LW>(keys, x, labels, weights, num_real, w, v, slots, gw, gv,
                  acc, B, K, D, h, s);
  } else if (D <= 16) {
    launch<16, LW>(keys, x, labels, weights, num_real, w, v, slots, gw, gv,
                   acc, B, K, D, h, s);
  } else if (D <= kMaxDim) {
    launch<kMaxDim, LW>(keys, x, labels, weights, num_real, w, v, slots, gw,
                        gv, acc, B, K, D, h, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int xf_train_max_dim() { return kMaxDim; }

// Launches K2 on `stream`; labels/weights are u8 when lw_u8 != 0, else
// f32; `slots` null is the dense mode, else the index mode (header).
// KH = 0 means no hot plane (the hot_* pointers unread); snap_w null is
// the live-table mode, else the window-start mode (header).  Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a D it has no variant for.
extern "C" int xf_train_step(const int* keys, const float* x,
                             const void* labels, const void* weights,
                             int lw_u8, float num_real, const float* w,
                             const float* v, const int* slots, float* gw,
                             float* gv, double* acc, int B, int K, int D,
                             const void* hot, const float* hot_x, int hot_u16,
                             int H, int hot_bf16, int KH, float* hgw,
                             float* hgv, const float* snap_w,
                             const float* snap_v, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HotArgs h{hot,  hot_x, hot_u16, H,      hot_bf16, KH > 0 ? KH : 0,
                  hgw,  hgv,   snap_w,  snap_v};
  if (lw_u8 != 0) {
    return dispatch<std::uint8_t>(keys, x, labels, weights, num_real, w, v,
                                  slots, gw, gv, acc, B, K, D, h, s);
  }
  return dispatch<float>(keys, x, labels, weights, num_real, w, v, slots, gw,
                         gv, acc, B, K, D, h, s);
}
