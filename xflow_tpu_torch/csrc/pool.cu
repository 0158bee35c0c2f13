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
// given, wide f32 [B].  One warp per example, kPoolWarps examples a
// block, the grid looping over the examples.  The warp stages its
// KH + K slots in shared memory (key, x, field clamped to -1 when
// outside [0, F) or padding), then lists each field's slots in slot
// order: a counting sort over a chunk of kFieldChunk fields (counts by
// shared-memory integer atomics, an exclusive warp scan, then a scatter
// whose ranks within a field come from __match_any_sync over each 32
// slots, so the sort is stable).  Lane o then owns outputs (f, e) = (o
// / E, o % E) of the chunk, striding by 32: it walks field f's own
// slots (about one a field at the flagship) and adds x * emb[key, e]
// in slot order, so each output's additions are the one-block-per-
// example form's, in its order.  Output rows are written coalesced,
// and the E lanes of one field read one emb row together (32 B at E =
// 8: one sector).  Wider F runs chunk by chunk.  The warp sums the
// wide term (every live slot, the field ignored) lane-strided, then by
// a xor butterfly.  With hot_bf16 a hot slot's w and emb values are
// rounded to bfloat16 (nearest even) before use.  Window-start mode
// (snap_emb not null; the hot inner, step.py:1327-1497): a cold key < H
// reads its w and emb rows from the [H, *] head snapshots snap_w /
// snap_emb taken at the window's start, as K2's window-start mode does.
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
// Why K7's lists: a block an example whose F * E output threads each
// walk all n slots makes 13,728 shared-memory compares for 352
// multiply-adds an example at the flagship and idles behind one
// field's E threads (21x its bound).  The lists cut each walk to the
// field's own slots; a warp an example packs four into a block, and a
// block an example at B = 512 keeps all 132 SMs fed.  K8 keeps one
// block per example.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kGradThreads = 256;
// K8's block stages 12 B a slot (key, x, field) in dynamic shared
// memory, within the 48 KiB a block gets without the opt-in, less 64 B
// kept for its static shared memory (two partial sums): the widest row
// either kernel takes (K7's warp stage below fits it with the opt-in).
constexpr int kBytesPerSlot = 12;
constexpr int kStageBytes = 48 * 1024 - 64;
constexpr int kMaxSlots = kStageBytes / kBytesPerSlot;
constexpr int kBlocksPerSm = 16;
// K7: four warps a block, pooling four examples (a warp each) or, where
// a batch would leave the card's SMs under two blocks each (B = 512),
// one (all four warps).  A group's stage: 16 B a slot (key, x, field,
// the sorted order) and the counts of a chunk of fields.  A row too
// wide for four stages in 48 KiB takes a block alone (with the opt-in
// past 48 KiB).  A thread walks kUnroll outputs side by side.  (Named
// barriers for two warps an example reserve all 16 of a block's and
// cost more than they gave.)
constexpr int kPoolWarps = 4;
constexpr int kFieldChunk = 128;
constexpr int kUnroll = 4;
constexpr int kSmallSmem = 48 * 1024;

__host__ __device__ inline int pool_stage_words(int n) {
  return 4 * n + kFieldChunk;
}
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

// A group's barrier: its warp, or the block when the block is the group.
__device__ __forceinline__ void group_sync(int threads) {
  if (threads == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

__global__ void __launch_bounds__(32 * kPoolWarps)
pool_kernel(const Planes p, int bf16, const float* __restrict__ w,
            const float* __restrict__ emb, const float* __restrict__ snap_w,
            const float* __restrict__ snap_emb, int E,
            float* __restrict__ pooled, float* __restrict__ wide, int B,
            int groups) {
  extern __shared__ int pool_smem[];
  const int threads = blockDim.x / groups;  // a group's: a multiple of 32
  const int group = threadIdx.x / threads;
  const int t = threadIdx.x - group * threads;
  const int lane = threadIdx.x & 31;
  const int warp = t >> 5;  // within the group
  const int last_warp = (threads >> 5) - 1;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  const int n = p.KH + p.K;
  int* skey = pool_smem + group * pool_stage_words(n);
  float* sx = reinterpret_cast<float*>(skey + n);
  int* sfld = reinterpret_cast<int*>(sx + n);
  int* sord = sfld + n;  // the chunk's slots, by field, in slot order
  int* cnt = sord + n;   // counts, then each field's start, then its end
  const int outs = p.F * E;
  for (long long b = static_cast<long long>(blockIdx.x) * groups + group; b < B;
       b += static_cast<long long>(gridDim.x) * groups) {
    group_sync(threads);  // the previous example's stage is read out
    for (int j = t; j < n; j += threads) {
      float xv;
      int f;
      skey[j] = slot_of(p, b, j, xv, f);
      sx[j] = xv;
      sfld[j] = f;
    }
    group_sync(threads);
    if (wide != nullptr && warp == last_warp) {
      float lin = 0.0f;
      for (int j = lane; j < n; j += 32) {
        const int key = skey[j];
        if (key < 0) continue;
        const float wv = row_base(p, j, key, w, snap_w)[key];
        lin += (j < p.KH && bf16 ? bf16_round(wv) : wv) * sx[j];
      }
      lin = warp_sum(lin);
      if (lane == 0) wide[b] = lin;
    }
    float* out = pooled + b * outs;
    for (int f0 = 0; f0 < p.F; f0 += kFieldChunk) {
      const int fw = p.F - f0 < kFieldChunk ? p.F - f0 : kFieldChunk;
      if (warp == 0) {  // the group's first warp lists each field's slots
        for (int i = lane; i < fw; i += 32) cnt[i] = 0;
        __syncwarp();
        for (int j = lane; j < n; j += 32) {
          const int f = sfld[j] - f0;
          if (f >= 0 && f < fw) atomicAdd(cnt + f, 1);
        }
        __syncwarp();
        int carry = 0;  // the exclusive scan: each field's first position
        for (int i0 = 0; i0 < fw; i0 += 32) {
          const int i = i0 + lane;
          const int c = i < fw ? cnt[i] : 0;
          int incl = c;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += y;
          }
          if (i < fw) cnt[i] = carry + incl - c;
          carry += __shfl_sync(0xffffffffu, incl, 31);
        }
        __syncwarp();
        // the stable scatter: a slot's place is its field's next
        // position plus the earlier lanes of this 32 that share its
        // field; the first such lane then moves the position past them
        for (int j0 = 0; j0 < n; j0 += 32) {
          const int j = j0 + lane;
          int f = j < n ? sfld[j] - f0 : -1;
          if (f >= fw) f = -1;
          const unsigned peers = __match_any_sync(0xffffffffu, f);
          const int pos = f >= 0 ? cnt[f] + __popc(peers & below) : 0;
          __syncwarp();
          if (f >= 0) {
            sord[pos] = j;
            if ((peers & below) == 0) cnt[f] += __popc(peers);
          }
          __syncwarp();
        }
      }
      group_sync(threads);
      // field f's slots are sord[f ? cnt[f - 1] : 0, cnt[f]); a thread
      // walks kUnroll outputs' lists side by side, so their emb reads
      // are in flight together, each output's additions in slot order
      const int total = fw * E;
      for (int o0 = t; o0 < total; o0 += threads * kUnroll) {
        int q[kUnroll], last[kUnroll], e[kUnroll];
        float acc[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int o = o0 + u * threads;
          const int f = o < total ? o / E : 0;
          e[u] = o - f * E;
          q[u] = o < total && f > 0 ? cnt[f - 1] : 0;
          last[u] = o < total ? cnt[f] : 0;
          acc[u] = 0.0f;
        }
        for (;;) {
          float ev[kUnroll], xv[kUnroll];
          bool any = false;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            ev[u] = 0.0f;
            xv[u] = 0.0f;
            if (q[u] < last[u]) {
              any = true;
              const int j = sord[q[u]];
              const int key = skey[j];
              const float val = row_base(p, j, key, emb,
                                         snap_emb)[static_cast<long long>(key) * E + e[u]];
              ev[u] = j < p.KH && bf16 ? bf16_round(val) : val;
              xv[u] = sx[j];
            }
          }
          if (!any) break;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (q[u] < last[u]) {
              acc[u] += ev[u] * xv[u];
              ++q[u];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int o = o0 + u * threads;
          if (o < total) out[f0 * E + o] = acc[u];
        }
      }
      group_sync(threads);  // the counts are read out before the next chunk
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

// The card's SM count, read once per device.
int sm_count() {
  static int cached_dev = -1, sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return sms;
  if (dev != cached_dev) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached_dev = dev;
  }
  return sms;
}

// K8's grid: a block per example, at most kBlocksPerSm an SM.
int grid_for(int B) {
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSm;
  return static_cast<int>(B < cap ? B : cap);
}

struct PoolShape {
  int groups;    // 4 when four stages fit 48 KiB, else 1
  size_t stage;  // bytes a group
  int resident[2];  // blocks an SM holds at once with 1 and 4 groups
};

// K7's stage for rows of n slots: the groups that fit 48 KiB (or one
// past it, the kernel opted in), and the blocks an SM holds at each
// group count (a grid past them would run a second, partial wave).
// Kept for the last (device, n) asked, so equal batches and slices
// read the card's attributes once.  Returns 0 or a CUDA error.
int pool_shape(int n, PoolShape* out) {
  static int key[2] = {-1, -1};  // device, n
  static PoolShape shape{};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (key[0] == dev && key[1] == n) {
    *out = shape;
    return 0;
  }
  PoolShape t{kPoolWarps, 4u * static_cast<size_t>(pool_stage_words(n)), {1, 1}};
  if (t.groups * t.stage > static_cast<size_t>(kSmallSmem)) t.groups = 1;
  if (t.stage > static_cast<size_t>(kSmallSmem)) {
    int optin = 0;
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (t.stage > static_cast<size_t>(optin)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    rc = cudaFuncSetAttribute(pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(t.stage));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  for (int i = 0; i < 2; ++i) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&t.resident[i], pool_kernel,
                                                  32 * kPoolWarps,
                                                  (i ? kPoolWarps : 1) * t.stage);
    if (t.resident[i] < 1) t.resident[i] = 1;
  }
  key[0] = dev;
  key[1] = n;
  shape = t;
  *out = t;
  return 0;
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
  if (K + p.KH > kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  PoolShape t;
  const int rc = pool_shape(K + p.KH, &t);
  if (rc != 0) return rc;
  // a warp an example while that leaves every SM two blocks, else a
  // block an example
  const long long sms = sm_count();
  const int groups =
      t.groups > 1 && (B + kPoolWarps - 1) / kPoolWarps >= 2 * sms ? kPoolWarps : 1;
  const long long want = (static_cast<long long>(B) + groups - 1) / groups;
  const long long cap = sms * t.resident[groups > 1 ? 1 : 0];
  pool_kernel<<<static_cast<int>(want < cap ? want : cap), 32 * kPoolWarps,
                groups * t.stage, static_cast<cudaStream_t>(stream)>>>(
      p, hot_bf16, w, emb, snap_w, snap_emb, E, pooled, wide, B, groups);
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
