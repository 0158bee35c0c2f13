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

template <int CAP, typename LW>
__global__ void __launch_bounds__(kThreads)
train_kernel(const int* __restrict__ keys, const float* __restrict__ x,
             const LW* __restrict__ labels, const LW* __restrict__ weights,
             float num_real, const float* __restrict__ w,
             const float* __restrict__ v, const int* __restrict__ slots,
             float* __restrict__ gw,
             float* __restrict__ gv, double* __restrict__ acc, int B, int K,
             int D) {
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
    for (int k = lane; k < K; k += 32) {
      const int key = krow[k];
      if (key < 0) continue;  // padding: never read, never written
      const float xv = xrow != nullptr ? xrow[k] : 1.0f;
      lin += w[key] * xv;
      if (CAP > 0) {
        const float* vrow = v + static_cast<long long>(key) * D;
#pragma unroll
        for (int d = 0; d < CAP; ++d) {
          if (d < D) {
            const float vx = vrow[d] * xv;
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

    for (int k = lane; k < K; k += 32) {
      const int key = krow[k];
      if (key < 0) continue;
      const float xv = xrow != nullptr ? xrow[k] : 1.0f;
      const long long dst = srow != nullptr ? srow[k] : key;
      if (dst < 0) continue;  // a key K4 took for padding (>= T)
      atomicAdd(gw + dst, xv * r);
      if (CAP > 0) {
        const float* vrow = v + static_cast<long long>(key) * D;
        float* grow = gv + dst * D;
#pragma unroll
        for (int d = 0; d < CAP; ++d) {
          if (d < D) {
            const float vx = vrow[d] * xv;
            atomicAdd(grow + d, (s[d] - vx) * xv * r);
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
            double* acc, int B, int K, int D, cudaStream_t stream) {
  train_kernel<CAP, LW><<<grid_for(B), kThreads, 0, stream>>>(
      keys, x, static_cast<const LW*>(labels),
      static_cast<const LW*>(weights), num_real, w, v, slots, gw, gv, acc, B,
      K, D);
}

template <typename LW>
int dispatch(const int* keys, const float* x, const void* labels,
             const void* weights, float num_real, const float* w,
             const float* v, const int* slots, float* gw, float* gv,
             double* acc, int B, int K, int D, cudaStream_t s) {
  if (v == nullptr || D == 0) {
    launch<0, LW>(keys, x, labels, weights, num_real, w, nullptr, slots, gw,
                  nullptr, acc, B, K, 0, s);
  } else if (D <= 8) {
    launch<8, LW>(keys, x, labels, weights, num_real, w, v, slots, gw, gv,
                  acc, B, K, D, s);
  } else if (D <= 16) {
    launch<16, LW>(keys, x, labels, weights, num_real, w, v, slots, gw, gv,
                   acc, B, K, D, s);
  } else if (D <= kMaxDim) {
    launch<kMaxDim, LW>(keys, x, labels, weights, num_real, w, v, slots, gw,
                        gv, acc, B, K, D, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int xf_train_max_dim() { return kMaxDim; }

// Launches K2 on `stream`; labels/weights are u8 when lw_u8 != 0, else
// f32; `slots` null is the dense mode, else the index mode (header).
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a D it has no variant for.
extern "C" int xf_train_step(const int* keys, const float* x,
                             const void* labels, const void* weights,
                             int lw_u8, float num_real, const float* w,
                             const float* v, const int* slots, float* gw,
                             float* gv, double* acc, int B, int K, int D,
                             void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lw_u8 != 0) {
    return dispatch<std::uint8_t>(keys, x, labels, weights, num_real, w, v,
                                  slots, gw, gv, acc, B, K, D, s);
  }
  return dispatch<float>(keys, x, labels, weights, num_real, w, v, slots, gw,
                         gv, acc, B, K, D, s);
}
