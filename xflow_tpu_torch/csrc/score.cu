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
// and accumulates linear, s[d] and s2[d] in registers (D unrolled up to
// the compile-time CAP, guarded by the runtime D).  Warp butterfly
// shuffles reduce the lanes; lane 0 forms the logit and the clamped
// sigmoid.  Nothing goes back to device memory between the gather and
// the score.  A padding slot is skipped before any table read: the
// JAX path reads row 0 and masks it out, this kernel never reads it.
// Sums run in another order than the plain version (and contract to
// FMA), so results agree to float rounding, not bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kMaxDim = 32;

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
  float s[CAP > 0 ? CAP : 1];
  float s2[CAP > 0 ? CAP : 1];
#pragma unroll
  for (int d = 0; d < CAP; ++d) {
    s[d] = 0.0f;
    s2[d] = 0.0f;
  }
  for (int j = lane; j < KH + K; j += 32) {
    float xv;
    bool to_bf16;
    const int key = entry_key(krow, xrow, hot, hot_x, hot_u16, H, hot_bf16, b,
                              KH, j, xv, to_bf16);
    if (key < 0) continue;  // padding: never read, never counted
    const float wv = w[key];
    lin += (to_bf16 ? bf16_round(wv) : wv) * xv;
    if (CAP > 0) {
      const float* vrow = v + static_cast<long long>(key) * D;
#pragma unroll
      for (int d = 0; d < CAP; ++d) {
        if (d < D) {
          const float vd = to_bf16 ? bf16_round(vrow[d]) : vrow[d];
          const float vx = vd * xv;
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
      const float sd = warp_sum(s[d]);
      const float s2d = warp_sum(s2[d]);
      inter += sd * sd - s2d;
    }
  }
  if (lane == 0) {
    const float logit = lin + inter;
    float p = 1.0f / (1.0f + expf(-logit));
    if (logit < -30.0f) p = 1e-6f;
    if (logit > 30.0f) p = 1.0f;
    pctr[b] = p;
    if (logit_out != nullptr) logit_out[b] = logit;
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

extern "C" int xf_score_max_dim() { return kMaxDim; }

// Launches K1 on `stream`; KH = 0 means no hot plane (hot, hot_x
// unread).  Returns cudaGetLastError() after the launch (0 = launched),
// or cudaErrorInvalidValue for a D it has no variant for.
extern "C" int xf_score(const int* keys, const float* x, const void* hot,
                        const float* hot_x, int hot_u16, int H, int hot_bf16,
                        const float* w, const float* v, float* pctr,
                        float* logit, int B, int K, int KH, int D,
                        void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HotPlane h{hot, hot_x, hot_u16, H, hot_bf16, KH > 0 ? KH : 0};
  if (v == nullptr || D == 0) {
    launch<0>(keys, x, h, w, nullptr, pctr, logit, B, K, 0, s);
  } else if (D <= 8) {
    launch<8>(keys, x, h, w, v, pctr, logit, B, K, D, s);
  } else if (D <= 16) {
    launch<16>(keys, x, h, w, v, pctr, logit, B, K, D, s);
  } else if (D <= kMaxDim) {
    launch<kMaxDim>(keys, x, h, w, v, pctr, logit, B, K, D, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
