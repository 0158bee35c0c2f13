// K7 — field_pool, the field-sum pooling forward, and K8 —
// field_pool_grad, its backward: the embedding tower of wide_deep, dcn
// and two_tower.
//
// Replaces these XLA-lowered regions of the JAX reference (it has no
// Pallas kernels, so these jnp regions are what a port turns into
// kernels — ROADMAP Queue B, B11):
//   B11 fwd  xflow_tpu/models/blocks.py:69-87 field_sum_tower —
//            onehot = one_hot(slots, F) [B, K, F], embx = emb_rows * x,
//            einsum("bkf,bke->bfe") -> pooled [B, F, E]; a field outside
//            [0, F), negatives included, is an all-zero one-hot row and
//            drops out; with blocks.py:41-53 masked_x / linear_term, the
//            wide term sum_k w[key_k] x_k (wide_deep.py:72, dcn.py:95)
//   B11 bwd  the gradient autodiff (value_and_grad) takes of it in
//            parallel/step.py:49-74 grads_from_rows: per occurrence
//            x_k * dP[b, f_k, :] for emb (0 for an invalid field) and
//            x_k * r for w (whatever the field), where dP = dloss/dpooled
//            comes from the dense head (torch.autograd here) and r =
//            (sigmoid(logit) - y) * weight / num_real, the UNCLAMPED
//            sigmoid's (autodiff of softplus(logit) - y * logit)
//   B2       step.py:923-1022 the drop-mode scatter-add into [T, D]
//            buffers; B5 index mode (ops/sparse.py:110-119 with K4's
//            slot plane); B7 ops/hot.py:71,122 hot_gather / hot_scatter
//            (the hot plane into rows [0, H), the bf16 flag on EVERY
//            table of these families: w and emb)
//   loss     utils/metrics.py:49-56 logloss_sum of the clamped pctr
//            (sigmoid_ref)
//
// Planes (the compact, full and decoded dictionary wires): keys i32
// [B, K] sentinel-coded (-1 padding), x f32 [B, K] or null (x = 1 on
// live slots), fields u8 or i32 [B, K]; the hot plane hot [B, KH] (u16
// with 0xFFFF padding, or i32 with -1), hot_x, hot_fields; a hot key
// outside [0, H) counts as padding.  Slot j < KH is hot, then the cold
// ones: the reference's _model_view order.
//
// K7 (xf_field_pool).  Outputs pooled f32 [B, F, E] and, when w is
// given, wide f32 [B].  One block per example, the grid looping over
// the examples.  The block stages its KH + K slots in shared memory
// (key, x, field clamped to -1 when outside [0, F) or padding: 12 B a
// slot), then thread o owns output (f, e) = (o / E, o % E), striding
// by the block when F*E exceeds it: it walks the slots in order and
// adds x * emb[key, e] where the slot's field is f.  A fixed order of
// addition, no atomics, and the E threads of one field read one emb
// row together (32 B at E = 8: one sector).  Warp 0 sums the wide term
// (every live slot, the field ignored) lane-strided, then by a xor
// butterfly.  With hot_bf16 a hot slot's w and emb values are rounded
// to bfloat16 (nearest even) before use.  Window-start mode (snap_emb
// not null; the hot inner, step.py:1327-1497): a cold key < H reads
// its w and emb rows from the [H, *] head snapshots snap_w / snap_emb
// taken at the window's start, as K2's window-start mode does.
//
// K8 (xf_field_pool_grad).  Inputs dP f32 [B, F, E], r f32 [B], logit
// f32 [B], labels and weights [B] (u8 or f32), the planes above.  One
// block per example: the slots staged as in K7 with each one's
// gradient row, then
//   * w (if given): each live slot adds x * r at its row;
//   * emb: each slot with a field in [0, F) adds x * dP[b, f, e] for
//     e < E, work items (slot, e) over the block's threads: E
//     consecutive threads add into one contiguous row;
//   * thread 0 adds the clamped pctr's log-loss times the weight, and
//     the weight, into the block's partials; one double atomic pair per
//     block lands them in acc [2].
// Destinations, as K2's: a cold slot's row is its key in the [T, D]
// buffers g_w / g_emb (dense mode) or, in index mode (slots not null),
// K4's slot plane's entry (-1: dropped) in [M, D] sums; a hot slot's row
// is its key in hg_w / hg_emb [H, D] (g's first H rows in dense mode,
// the head buffers in the hybrid).  With hot_bf16 each hot gradient is
// rounded to bfloat16 before its float32 add.  Atomics land in an order
// that changes from run to run: sums agree with the plain version to
// float32 rounding.
//
// Bound.  Both are memory-bound (a few flops per byte).  K7 reads the
// planes once (4 B key, 4 B x if given, 1 or 4 B field per slot), and
// per distinct live row its w entry (4 B) and emb row (4E B), and
// writes pooled (4FE B a row) and wide (4 B a row).  K8 reads the
// planes, dP (4FE B a row), r, logit, labels and weights once, and
// read-modify-writes per distinct destination row 4 + 4E B.  At the
// flagship (B = 65,536, F = 39, E = 8) pooled and dP are 82 MB each,
// which dominates: about 0.03 ms at 3.35 TB/s for either kernel.
// Design: first simple and right — one block per row keeps the sum
// order fixed; the block's idle threads while one field's E threads
// read a row are the cost this leaves (a later PR can pool several
// rows per block).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kGradThreads = 256;
// A block stages 12 B a slot (key, x, field) in dynamic shared memory,
// within the 48 KiB a block gets without the opt-in, less 64 B kept for
// the kernels' static shared memory (K8's two partial sums).
constexpr int kBytesPerSlot = 12;
constexpr int kStageBytes = 48 * 1024 - 64;
constexpr int kMaxSlots = kStageBytes / kBytesPerSlot;
constexpr int kBlocksPerSm = 16;
constexpr float kLoglossEps = 1e-6f;
constexpr float kLoglossHi = 0.999999f;  // f32(1 - 1e-6), as the reference

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

struct Planes {
  const int* keys;
  const float* x;
  const void* fields;
  const void* hot;
  const float* hot_x;
  const void* hot_fields;
  int K, KH, H, hot_u16, f_i32, F;
};

// Slot j of row b: its key (-1: padding, or a hot key outside [0, H)),
// x and field (-1 outside [0, F) or with the key).
__device__ __forceinline__ int slot_of(const Planes& p, long long b, int j,
                                       float& xv, int& f) {
  int key;
  if (j < p.KH) {
    const long long at = b * p.KH + j;
    key = p.hot_u16 ? static_cast<int>(static_cast<const uint16_t*>(p.hot)[at])
                    : static_cast<const int*>(p.hot)[at];
    if (key >= p.H) key = -1;
    xv = p.hot_x != nullptr ? p.hot_x[at] : 1.0f;
    f = p.f_i32 ? static_cast<const int*>(p.hot_fields)[at]
                : static_cast<const uint8_t*>(p.hot_fields)[at];
  } else {
    const long long at = b * p.K + (j - p.KH);
    key = p.keys[at];
    xv = p.x != nullptr ? p.x[at] : 1.0f;
    f = p.f_i32 ? static_cast<const int*>(p.fields)[at]
                : static_cast<const uint8_t*>(p.fields)[at];
  }
  if (key < 0 || f < 0 || f >= p.F) f = -1;
  return key;
}

// Slot j's row base in `table` (or its head snapshot `snap` for a cold
// key < H in window-start mode).
__device__ __forceinline__ const float* row_base(const Planes& p, int j,
                                                 int key, const float* table,
                                                 const float* snap) {
  return snap != nullptr && j >= p.KH && key < p.H ? snap : table;
}

__global__ void __launch_bounds__(kMaxThreads)
pool_kernel(const Planes p, int bf16, const float* __restrict__ w,
            const float* __restrict__ emb, const float* __restrict__ snap_w,
            const float* __restrict__ snap_emb, int E,
            float* __restrict__ pooled, float* __restrict__ wide, int B) {
  extern __shared__ int pool_smem[];
  const int n = p.KH + p.K;
  int* skey = pool_smem;
  float* sx = reinterpret_cast<float*>(skey + n);
  int* sfld = reinterpret_cast<int*>(sx + n);
  const int outs = p.F * E;
  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    __syncthreads();  // the previous example's stage is read out
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      float xv;
      int f;
      skey[j] = slot_of(p, b, j, xv, f);
      sx[j] = xv;
      sfld[j] = f;
    }
    __syncthreads();
    float* out = pooled + b * outs;
    for (int o = threadIdx.x; o < outs; o += blockDim.x) {
      const int f = o / E;
      const int e = o - f * E;
      float acc = 0.0f;
      for (int j = 0; j < n; ++j) {
        if (sfld[j] != f) continue;
        const int key = skey[j];
        const float ev = row_base(p, j, key, emb, snap_emb)[static_cast<long long>(key) * E + e];
        acc += (j < p.KH && bf16 ? bf16_round(ev) : ev) * sx[j];
      }
      out[o] = acc;
    }
    if (wide != nullptr && threadIdx.x < 32) {
      float lin = 0.0f;
      for (int j = threadIdx.x; j < n; j += 32) {
        const int key = skey[j];
        if (key < 0) continue;
        const float wv = row_base(p, j, key, w, snap_w)[key];
        lin += (j < p.KH && bf16 ? bf16_round(wv) : wv) * sx[j];
      }
      lin = warp_sum(lin);
      if (threadIdx.x == 0) wide[b] = lin;
    }
  }
}

template <typename LW>
__global__ void __launch_bounds__(kGradThreads)
pool_grad_kernel(const Planes p, int bf16, const float* __restrict__ dP,
                 const float* __restrict__ r, const float* __restrict__ logit,
                 const LW* __restrict__ labels, const LW* __restrict__ weights,
                 const int* __restrict__ slots, float* __restrict__ gw,
                 float* __restrict__ gemb, float* __restrict__ hgw,
                 float* __restrict__ hgemb, int E, double* __restrict__ acc,
                 int B) {
  extern __shared__ int grad_smem[];
  const int n = p.KH + p.K;
  int* sdst = grad_smem;
  float* sx = reinterpret_cast<float*>(sdst + n);
  int* sfld = reinterpret_cast<int*>(sx + n);
  __shared__ float part_ll, part_w;
  if (threadIdx.x == 0) {
    part_ll = 0.0f;
    part_w = 0.0f;
  }
  const int outs = p.F * E;
  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    __syncthreads();  // the previous example's stage is read out
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      float xv;
      int f;
      const int key = slot_of(p, b, j, xv, f);
      int dst = key;
      if (key >= 0 && j >= p.KH && slots != nullptr) {
        dst = slots[b * p.K + (j - p.KH)];  // -1: a key K4 took for padding
      }
      sdst[j] = dst;
      sx[j] = xv;
      sfld[j] = dst < 0 ? -1 : f;
    }
    __syncthreads();
    const float rb = r[b];
    if (gw != nullptr) {
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        const int dst = sdst[j];
        if (dst < 0) continue;
        const bool hot = j < p.KH;
        const float g = sx[j] * rb;
        atomicAdd((hot ? hgw : gw) + dst, hot && bf16 ? bf16_round(g) : g);
      }
    }
    const float* drow = dP + b * outs;
    for (int t = threadIdx.x; t < n * E; t += blockDim.x) {
      const int j = t / E;
      const int e = t - j * E;
      const int f = sfld[j];
      if (f < 0) continue;
      const bool hot = j < p.KH;
      const float g = sx[j] * drow[f * E + e];
      float* grow = (hot ? hgemb : gemb) + static_cast<long long>(sdst[j]) * E;
      atomicAdd(grow + e, hot && bf16 ? bf16_round(g) : g);
    }
    if (threadIdx.x == 0) {
      const float lg = logit[b];
      float pc = 1.0f / (1.0f + expf(-lg));
      if (lg < -30.0f) pc = 1e-6f;
      if (lg > 30.0f) pc = 1.0f;
      pc = fminf(fmaxf(pc, kLoglossEps), kLoglossHi);
      const float y = static_cast<float>(labels[b]);
      const float wt = static_cast<float>(weights[b]);
      part_ll += -(y * logf(pc) + (1.0f - y) * logf(1.0f - pc)) * wt;
      part_w += wt;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(acc, static_cast<double>(part_ll));
    atomicAdd(acc + 1, static_cast<double>(part_w));
  }
}

int grid_for(int B) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  return static_cast<int>(B < cap ? B : cap);
}

}  // namespace

// The widest row (hot + cold slots) K7 and K8 stage.
extern "C" int xf_pool_max_slots() { return kMaxSlots; }

// Launches K7 on `stream`: pooled [B, F, E] and, with w, wide [B]
// (header).  KH = 0: no hot plane (hot, hot_x, hot_fields unread);
// snap_emb null: the live tables (else window-start mode, H rows).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int xf_field_pool(const int* keys, const float* x,
                             const void* fields, const void* hot,
                             const float* hot_x, const void* hot_fields,
                             int hot_u16, int H, int hot_bf16, int KH,
                             int f_i32, int F, const float* w,
                             const float* emb, const float* snap_w,
                             const float* snap_emb, int E, float* pooled,
                             float* wide, int B, int K, void* stream) {
  if (B <= 0) return 0;
  const Planes p{keys, x, fields, hot, hot_x, hot_fields,
                 K, KH > 0 ? KH : 0, H, hot_u16, f_i32, F};
  const int outs = F * E;
  int threads = outs < kMaxThreads ? outs : kMaxThreads;
  threads = ((threads + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (K + p.KH > kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kBytesPerSlot) * (K + p.KH);
  pool_kernel<<<grid_for(B), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      p, hot_bf16, w, emb, snap_w, snap_emb, E, pooled, wide, B);
  return static_cast<int>(cudaGetLastError());
}

// Launches K8 on `stream` (header): the w gradients (gw, hgw; null for
// a family without w) and emb gradients (gemb, hgemb) scatter-added at
// the keys' rows (dense) or at K4's slots (slots not null, index mode;
// hot slots always at their key in hgw / hgemb), and acc [2] += the
// log-loss and weight sums.  labels/weights are u8 when lw_u8 != 0,
// else f32.  Returns cudaGetLastError() after the launch.
extern "C" int xf_field_pool_grad(const int* keys, const float* x,
                                  const void* fields, const void* hot,
                                  const float* hot_x, const void* hot_fields,
                                  int hot_u16, int H, int hot_bf16, int KH,
                                  int f_i32, int F, const float* dP,
                                  const float* r, const float* logit,
                                  const void* labels, const void* weights,
                                  int lw_u8, const int* slots, float* gw,
                                  float* gemb, float* hgw, float* hgemb,
                                  int E, double* acc, int B, int K,
                                  void* stream) {
  if (B <= 0) return 0;
  const Planes p{keys, x, fields, hot, hot_x, hot_fields,
                 K, KH > 0 ? KH : 0, H, hot_u16, f_i32, F};
  if (K + p.KH > kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kBytesPerSlot) * (K + p.KH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lw_u8 != 0) {
    pool_grad_kernel<std::uint8_t><<<grid_for(B), kGradThreads, smem, s>>>(
        p, hot_bf16, dP, r, logit, static_cast<const std::uint8_t*>(labels),
        static_cast<const std::uint8_t*>(weights), slots, gw, gemb, hgw, hgemb,
        E, acc, B);
  } else {
    pool_grad_kernel<float><<<grid_for(B), kGradThreads, smem, s>>>(
        p, hot_bf16, dP, r, logit, static_cast<const float*>(labels),
        static_cast<const float*>(weights), slots, gw, gemb, hgw, hgemb, E,
        acc, B);
  }
  return static_cast<int>(cudaGetLastError());
}
