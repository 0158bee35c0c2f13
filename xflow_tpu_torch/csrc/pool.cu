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
// f32 [B], labels and weights [B] (u8 or f32), the planes above.  It
// adds
//   * w (if given): each live slot's x * r at its row;
//   * emb: each slot with a field in [0, F) its x * dP[b, f, :] (E
//     floats) at its row;
//   * into acc [2]: the clamped pctr's log-loss times the weight, and
//     the weight, summed.
// Destinations, as K2's: a cold slot's row is its key in the [T, D]
// buffers g_w / g_emb (dense mode) or, in index mode (slots not null),
// K4's slot plane's entry (-1: dropped) in [M, D] sums; a hot slot's row
// is its key in hg_w / hg_emb [H, D] (g's first H rows in dense mode,
// the head buffers in the hybrid).  With hot_bf16 each hot gradient is
// rounded to bfloat16 before its float32 add.
//
// K8's design.  Persistent blocks, one of 32 warps an SM (four warps
// where the batch would leave SMs without a block), each walking a
// contiguous run of examples, a warp an example, with no block barrier
// between examples:
//   * the warp stages the example's slots (destination, x, field) in
//     one coalesced pass over the planes (keys, x, fields and K4's
//     slots read together), kGradChunk slots at a time, so no row width
//     needs a device-memory stage;
//   * its lanes take the (slot, group of VW factors) items and issue
//     every dP load of the example before the first add (VW = 4 where E
//     % 4 == 0 and dP and the gradient buffers are 16-byte aligned: a
//     float4 load and one 16-byte red.global.add.v4.f32, two a row at
//     E = 8; else VW = 1, scalar atomics).  The scalar form at E = 8,
//     lanes over (slot, factor) so that a row's atomics coalesce by
//     sector, took 8-85 % longer at 65,536 rows on the path's planes
//     (wide_deep in the remap's layout, dcn, two_tower) and about 20 %
//     at 512 (H100 80GB HBM3, 700 W);
//   * repeats of a destination meet in the block's direct-mapped table
//     in shared memory (the LR/FM form of K2's recipe, train.cu), 1 + E
//     float32 sums an entry keyed by destination (head row, cold row or
//     K4's slot): at most kGradEntries and at most twice the slots the
//     block walks, beside the stages in the block's shared memory.  A
//     slot adds to its entry when the entry holds its destination or is
//     free (claimed with atomicCAS), else straight to device memory, so
//     no batch is refused; each claimed entry lands once when the
//     block's run ends.  The remap puts every field's hottest ids in
//     the head's first rows (80.7 % of wide_deep's occurrences on the
//     head), so a block meets them first and keeps them: a hot row
//     costs one add a block, not one an occurrence serialised in L2.
//     Shared-memory float atomics are compare-and-swap loops on sm_90a,
//     so a block whose run is short keeps no table;
//   * each thread sums the log-loss of its share of the block's run in
//     registers, the block reduces them once, and one double atomic
//     pair lands them in acc.
// Atomics land in an order that changes from run to run: sums agree
// with the plain version to float32 rounding.
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
// block an example at B = 512 keeps all 132 SMs fed.  Why K8's table:
// a block of 256 threads an example, each slot's 1 + E scalar atomics
// straight to device memory, took wide_deep's 65,536-row batch 0.517 ms
// against dcn's 0.220 with no hot plane: its hot rows' atomics
// serialised in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "stage.cuh"

namespace {

// K7 stages a row in shared memory up to kMaxSlots slots (4,090: 16 B
// a slot and a chunk of field counts, a group's stage, with the opt-in
// past 48 KiB); a wider row takes its device-memory stage (stage.cuh:
// one a group, the counting sort's atomics then in device memory).
constexpr int kMaxSlots = 4090;
// K8: one block of 32 warps an SM, its table of at most kGradEntries
// destinations within kGradSmem beside the warps' stages (a warp stages
// kGradChunk slots at a time, 12 B each); four warps a block where the
// batch would leave SMs without a block, and no table where a block
// walks fewer than kGradTableRows examples (a 512-row slice: its init
// and flush cost more than its few repeats save).  Why one large block
// an SM (wide_deep's remap-ordered 65,536-row batch, H100 80GB HBM3 at
// 700 W): 0.145 ms against 0.201 for two blocks of 16 warps with 1,536
// entries each, 0.191 with 2,048 each and 0.301 for four blocks of 8
// warps with 768; all its warps share one table, so a hot row lands
// once an SM.  dcn and two_tower (40 cold slots) took 5-6 % longer that
// way (0.136 / 0.109 against 0.130 / 0.102).
constexpr int kGradWarps = 32;
constexpr int kGradSmallWarps = 4;
constexpr int kGradChunk = 128;
constexpr int kGradEntries = 4096;
constexpr int kGradTableRows = 32;
constexpr size_t kGradSmem = 216 * 1024;
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

// A device-memory stage's stride in words: `words` rounded up to
// stage::kAlign bytes.
__host__ __device__ inline long long global_stride_words(long long words) {
  constexpr long long kAlignWords = stage::kAlign / 4;
  return (words + kAlignWords - 1) / kAlignWords * kAlignWords;
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

// kGlobalStage: the groups' stages in the device-memory scratch
// `gstage` (header), their counting sort's atomics global ones; else
// in shared memory.
template <bool kGlobalStage>
__global__ void __launch_bounds__(32 * kPoolWarps)
pool_kernel(const Planes p, int bf16, const float* __restrict__ w,
            const float* __restrict__ emb, const float* __restrict__ snap_w,
            const float* __restrict__ snap_emb, int E,
            float* __restrict__ pooled, float* __restrict__ wide, int B,
            int groups, int* __restrict__ gstage) {
  extern __shared__ int pool_smem[];
  const int threads = blockDim.x / groups;  // a group's: a multiple of 32
  const int group = threadIdx.x / threads;
  const int t = threadIdx.x - group * threads;
  const int lane = threadIdx.x & 31;
  const int warp = t >> 5;  // within the group
  const int last_warp = (threads >> 5) - 1;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  const int n = p.KH + p.K;
  int* skey;
  if constexpr (kGlobalStage) {
    skey = gstage + (static_cast<long long>(blockIdx.x) * groups + group) *
                        global_stride_words(pool_stage_words(n));
  } else {
    skey = pool_smem + group * pool_stage_words(n);
  }
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

// K8's table (header): `entries` keys (the destination: row * 2 + 1 for
// the head, row * 2 for the cold one; kEmpty when free) and `entries`
// x (1 + E) float sums (w's, then E of emb's).  Returns the entry of
// `tag`: its one slot when that holds `tag` or is free (claimed with
// atomicCAS), else -1 (the occurrence adds to device memory directly).
constexpr unsigned kEmpty = 0xFFFFFFFFu;

__device__ __forceinline__ int table_entry(unsigned* key, int entries,
                                           unsigned tag) {
  const unsigned e =
      __umulhi(tag * 2654435761u, static_cast<unsigned>(entries));
  const unsigned k = *reinterpret_cast<volatile unsigned*>(key + e);
  if (k == tag) return static_cast<int>(e);
  if (k == kEmpty) {
    const unsigned old = atomicCAS(key + e, kEmpty, tag);
    if (old == kEmpty || old == tag) return static_cast<int>(e);
  }
  return -1;
}

// VW consecutive gradient floats into device memory: one 16-byte vector
// reduction (VW = 4, dst 16-byte aligned) or a scalar atomic.
template <int VW>
__device__ __forceinline__ void red_vec(float* dst, const float* g) {
  if constexpr (VW == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst), make_float4(g[0], g[1], g[2], g[3]));
  } else {
    atomicAdd(dst, g[0]);
  }
}

// K8 (header): blocks of `warps` warps, each walking examples
// [blockIdx.x * per_block, + per_block); `entries` 0: no table.  VW
// floats an emb item (4: E % 4 == 0, dP and the emb buffers 16-byte
// aligned).
template <typename LW, int VW>
__global__ void __launch_bounds__(32 * kGradWarps)
pool_grad_kernel(const Planes p, int bf16, const float* __restrict__ dP,
                 const float* __restrict__ r, const float* __restrict__ logit,
                 const LW* __restrict__ labels, const LW* __restrict__ weights,
                 const int* __restrict__ slots, float* __restrict__ gw,
                 float* __restrict__ gemb, float* __restrict__ hgw,
                 float* __restrict__ hgemb, int E, double* __restrict__ acc,
                 int B, int per_block, int entries) {
  constexpr int kItems = VW == 4 ? 4 : 8;  // a lane's items in flight
  extern __shared__ __align__(16) unsigned grad_smem[];
  __shared__ float part_ll[32];
  __shared__ float part_w[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int stride = 1 + E;
  unsigned* tkey = grad_smem;
  float* tval = reinterpret_cast<float*>(tkey + entries);
  int* sdst = reinterpret_cast<int*>(tval + static_cast<size_t>(entries) * stride) +
              warp * 3 * kGradChunk;
  float* sx = reinterpret_cast<float*>(sdst + kGradChunk);
  int* sfld = reinterpret_cast<int*>(sx + kGradChunk);
  const long long b0 = static_cast<long long>(blockIdx.x) * per_block;
  const long long b1 = b0 + per_block < B ? b0 + per_block : B;
  // the log-loss inputs of this thread's first example, read now so
  // that their round trip overlaps the walk (a block of a short run
  // has one example a thread)
  const long long lb = b0 + threadIdx.x;
  float lg0 = 0.0f, y0 = 0.0f, wt0 = 0.0f;
  if (lb < b1) {
    lg0 = logit[lb];
    y0 = static_cast<float>(labels[lb]);
    wt0 = static_cast<float>(weights[lb]);
  }
  for (int i = threadIdx.x; i < entries; i += blockDim.x) tkey[i] = kEmpty;
  for (int i = threadIdx.x; i < entries * stride; i += blockDim.x) tval[i] = 0.0f;
  if (entries > 0) __syncthreads();  // entries is block-uniform
  const int n = p.KH + p.K;
  const int outs = p.F * E;
  const int groups = E / VW;
  const int q32 = 32 / groups, r32 = 32 % groups;  // 32 items on
  const int i0 = lane / groups, g0 = lane - i0 * groups;
  // a slot's gradient: into its table entry, or into device memory
  auto land = [&](int dst, bool hot, int at, const float* g, int width) {
    const int e = entries > 0
                      ? table_entry(tkey, entries,
                                    static_cast<unsigned>(dst) * 2u + (hot ? 1u : 0u))
                      : -1;
    if (e >= 0) {
      float* ev = tval + static_cast<size_t>(e) * stride + at;
      for (int k = 0; k < width; ++k) atomicAdd(ev + k, g[k]);
    } else if (at == 0) {
      atomicAdd((hot ? hgw : gw) + dst, g[0]);
    } else {
      red_vec<VW>((hot ? hgemb : gemb) + static_cast<long long>(dst) * E + at - 1, g);
    }
  };
  for (long long b = b0 + warp; b < b1; b += warps) {
    const float rb = r[b];
    const float* drow = dP + b * outs;
    for (int c0 = 0; c0 < n; c0 += kGradChunk) {
      const int cn = n - c0 < kGradChunk ? n - c0 : kGradChunk;
      __syncwarp();  // the previous chunk's stage is read out
      for (int i = lane; i < cn; i += 32) {
        const int j = c0 + i;
        float xv;
        int f;
        const int key = slot_of(p, b, j, xv, f);
        int dst = key;
        if (j >= p.KH && slots != nullptr) {  // read beside the key, not after it
          const int slot = slots[b * p.K + (j - p.KH)];  // -1: a key K4 took for padding
          if (key >= 0) dst = slot;
        }
        sdst[i] = dst;
        sx[i] = xv;
        sfld[i] = dst < 0 ? -1 : f;
      }
      __syncwarp();
      // emb: every dP load of the chunk issued, then the adds; the
      // lane's items are (slot, group) i * groups + g = lane, lane + 32,
      // ..., stepped without a division
      const int items = cn * groups;
      int ii = i0, gg = g0;
      for (int base = 0; base < items; base += 32 * kItems) {
        float val[kItems][VW];
        int si[kItems], sg[kItems];  // the item's slot (-1: none) and group
#pragma unroll
        for (int u = 0; u < kItems; ++u) {
          const int i = ii, g = gg;
          ii += q32;
          gg += r32;
          if (gg >= groups) {
            gg -= groups;
            ++ii;
          }
          si[u] = -1;
          sg[u] = g;
          if (i < cn) {
            const int f = sfld[i];
            if (f >= 0) {
              si[u] = i;
              const float* src = drow + f * E + g * VW;
              if constexpr (VW == 4) {
                const float4 q = *reinterpret_cast<const float4*>(src);
                val[u][0] = q.x;
                val[u][1] = q.y;
                val[u][2] = q.z;
                val[u][3] = q.w;
              } else {
                val[u][0] = *src;
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kItems; ++u) {
          if (si[u] < 0) continue;
          const int i = si[u];
          const int g = sg[u];
          const bool hot = c0 + i < p.KH;
          float gv[VW];
#pragma unroll
          for (int k = 0; k < VW; ++k) {
            const float t = sx[i] * val[u][k];
            gv[k] = hot && bf16 ? bf16_round(t) : t;
          }
          land(sdst[i], hot, 1 + g * VW, gv, VW);
        }
      }
      // w: a lane a slot
      if (gw != nullptr) {
        for (int i = lane; i < cn; i += 32) {
          const int dst = sdst[i];
          if (dst < 0) continue;
          const bool hot = c0 + i < p.KH;
          const float t = sx[i] * rb;
          const float g = hot && bf16 ? bf16_round(t) : t;
          land(dst, hot, 0, &g, 1);
        }
      }
    }
  }
  // the log-loss of the block's run, a thread an example
  float ll = 0.0f, wsum = 0.0f;
  for (long long b = lb; b < b1; b += blockDim.x) {
    const float lg = b == lb ? lg0 : logit[b];
    const float y = b == lb ? y0 : static_cast<float>(labels[b]);
    const float wt = b == lb ? wt0 : static_cast<float>(weights[b]);
    float pc = 1.0f / (1.0f + expf(-lg));
    if (lg < -30.0f) pc = 1e-6f;
    if (lg > 30.0f) pc = 1.0f;
    pc = fminf(fmaxf(pc, kLoglossEps), kLoglossHi);
    ll += -(y * logf(pc) + (1.0f - y) * logf(1.0f - pc)) * wt;
    wsum += wt;
  }
  ll = warp_sum(ll);
  wsum = warp_sum(wsum);
  if (lane == 0) {
    part_ll[warp] = ll;
    part_w[warp] = wsum;
  }
  __syncthreads();  // every warp's adds into the table are done too
  if (threadIdx.x == 0) {
    float tl = 0.0f, tw = 0.0f;
    for (int i = 0; i < warps; ++i) {
      tl += part_ll[i];
      tw += part_w[i];
    }
    atomicAdd(acc, static_cast<double>(tl));
    atomicAdd(acc + 1, static_cast<double>(tw));
  }
  // the flush: a thread an entry, w's sum and its emb row's
  for (int e = threadIdx.x; e < entries; e += blockDim.x) {
    const unsigned tag = tkey[e];
    if (tag == kEmpty) continue;
    const long long dst = tag >> 1;
    const bool hot = (tag & 1u) != 0;
    const float* ev = tval + static_cast<size_t>(e) * stride;
    if (gw != nullptr) atomicAdd((hot ? hgw : gw) + dst, ev[0]);
    float* row = (hot ? hgemb : gemb) + dst * E;
    for (int g = 0; g < groups; ++g) red_vec<VW>(row + g * VW, ev + 1 + g * VW);
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

struct GradShape {
  int grid, warps, per_block, entries;
  size_t smem;
};

// K8's launch for B rows of n slots at width E (header): warps a block,
// the blocks (at most one an SM, each a contiguous run of per_block
// examples, none empty), the table's entries (at most kGradEntries and
// twice the slots a block walks, within kGradSmem and the card's
// opt-in beside the warps' stages; 0: off, where the block walks fewer
// than kGradTableRows examples or fewer than 32 entries fit) and the
// dynamic shared memory (launch_grad opts the kernel in past 48 KB).
GradShape grad_shape(int B, int n, int E) {
  const long long sms = sm_count();
  GradShape t{};
  t.warps = (B + kGradWarps - 1) / kGradWarps >= sms ? kGradWarps : kGradSmallWarps;
  const long long want = (static_cast<long long>(B) + t.warps - 1) / t.warps;
  const long long grid = want < sms ? want : sms;
  t.per_block = static_cast<int>((B + grid - 1) / grid);
  t.grid = (B + t.per_block - 1) / t.per_block;
  const size_t stages = static_cast<size_t>(t.warps) * 3 * kGradChunk * 4;
  const size_t entry = 4 * (2 + static_cast<size_t>(E));  // key, w, emb
  const size_t budget = std::min(kGradSmem, stage::optin_bytes() - 1024);  // 1 KB: the static part
  const long long fit = static_cast<long long>((budget - stages) / entry);
  long long e = t.per_block >= kGradTableRows ? kGradEntries : 0;
  if (e > 2LL * t.per_block * n) e = 2LL * t.per_block * n;
  if (e > fit) e = fit;
  t.entries = e >= 32 ? static_cast<int>(e) : 0;
  t.smem = stages + t.entries * entry;
  return t;
}

template <typename LW, int VW>
void launch_grad(const GradShape& t, cudaStream_t s, const Planes& p, int bf16,
                 const float* dP, const float* r, const float* logit,
                 const void* const* lw, const int* slots, float* gw, float* gemb,
                 float* hgw, float* hgemb, int E, double* acc, int B) {
  if (t.smem > static_cast<size_t>(kSmallSmem)) {
    cudaFuncSetAttribute(pool_grad_kernel<LW, VW>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(t.smem));
  }
  pool_grad_kernel<LW, VW><<<t.grid, 32 * t.warps, t.smem, s>>>(
      p, bf16, dP, r, logit, static_cast<const LW*>(lw[0]),
      static_cast<const LW*>(lw[1]), slots, gw, gemb, hgw, hgemb, E, acc, B,
      t.per_block, t.entries);
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
    rc = cudaFuncSetAttribute(pool_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(t.stage));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  for (int i = 0; i < 2; ++i) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&t.resident[i], pool_kernel<false>,
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

// The widest row (hot + cold slots) K7 stages in shared memory; wider
// rows take its device-memory stage.
extern "C" int xf_pool_max_slots() { return kMaxSlots; }

namespace {

// A group count for K7 over B rows: a warp an example while that
// leaves every SM two blocks, else a block an example.
int pool_groups(int B, int fit_groups) {
  return fit_groups > 1 && (B + kPoolWarps - 1) / kPoolWarps >= 2 * sm_count()
             ? kPoolWarps
             : 1;
}

// The device-memory form of K7 for B rows of n slots: the grid and the
// scratch bytes (0: the row fits the shared-memory stage).
int pool_plan(int B, int n, size_t* bytes) {
  *bytes = 0;
  if (n <= kMaxSlots) return 0;
  const int groups = pool_groups(B, kPoolWarps);
  const size_t per = 4 * static_cast<size_t>(global_stride_words(pool_stage_words(n)));
  const int grid = stage::blocks((static_cast<long long>(B) + groups - 1) / groups,
                                 32 * kPoolWarps, groups * per);
  *bytes = static_cast<size_t>(grid) * groups * per;
  return grid;
}

}  // namespace

// The device-memory scratch K7 needs for B rows of K + KH slots (bytes;
// 0: none).  K8 needs none: a warp stages kGradChunk slots at a time.
extern "C" long long xf_pool_stage_bytes(int B, int K, int KH) {
  size_t bytes = 0;
  if (B > 0) pool_plan(B, K + (KH > 0 ? KH : 0), &bytes);
  return static_cast<long long>(bytes);
}

// Launches K7 on `stream`: pooled [B, F, E] and, with w, wide [B]
// (header).  KH = 0: no hot plane (hot, hot_x, hot_fields unread);
// snap_emb null: the live tables (else window-start mode, H rows).  A
// row past kMaxSlots stages in `gstage`, xf_pool_stage_bytes(...) of
// device memory.  Returns cudaGetLastError() after the launch (0 =
// launched), cudaErrorInvalidValue for such a row without its scratch.
extern "C" int xf_field_pool(const int* keys, const float* x,
                             const void* fields, const void* hot,
                             const float* hot_x, const void* hot_fields,
                             int hot_u16, int H, int hot_bf16, int KH,
                             int f_i32, int F, const float* w,
                             const float* emb, const float* snap_w,
                             const float* snap_emb, int E, float* pooled,
                             float* wide, int B, int K, void* gstage,
                             void* stream) {
  if (B <= 0) return 0;
  const Planes p{keys, x, fields, hot, hot_x, hot_fields,
                 K, KH > 0 ? KH : 0, H, hot_u16, f_i32, F};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t global_bytes = 0;
  const int global_grid = pool_plan(B, K + p.KH, &global_bytes);
  if (global_bytes > 0) {
    if (gstage == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    pool_kernel<true><<<global_grid, 32 * kPoolWarps, 0, s>>>(
        p, hot_bf16, w, emb, snap_w, snap_emb, E, pooled, wide, B,
        pool_groups(B, kPoolWarps), static_cast<int*>(gstage));
    return static_cast<int>(cudaGetLastError());
  }
  PoolShape t;
  const int rc = pool_shape(K + p.KH, &t);
  if (rc != 0) return rc;
  const long long sms = sm_count();
  const int groups = pool_groups(B, t.groups);
  const long long want = (static_cast<long long>(B) + groups - 1) / groups;
  const long long cap = sms * t.resident[groups > 1 ? 1 : 0];
  pool_kernel<false><<<static_cast<int>(want < cap ? want : cap), 32 * kPoolWarps,
                       groups * t.stage, s>>>(
      p, hot_bf16, w, emb, snap_w, snap_emb, E, pooled, wide, B, groups, nullptr);
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
  const GradShape t = grad_shape(B, K + p.KH, E);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte items where E, dP and every emb buffer allow them
  const auto aligned = [](const void* q) {
    return (reinterpret_cast<std::uintptr_t>(q) & 15u) == 0;
  };
  const bool vec = E % 4 == 0 && aligned(dP) && aligned(gemb) &&
                   (hgemb == nullptr || aligned(hgemb));
  const void* lw[2] = {labels, weights};
  if (lw_u8 != 0 && vec) {
    launch_grad<std::uint8_t, 4>(t, s, p, hot_bf16, dP, r, logit, lw, slots, gw, gemb,
                                 hgw, hgemb, E, acc, B);
  } else if (lw_u8 != 0) {
    launch_grad<std::uint8_t, 1>(t, s, p, hot_bf16, dP, r, logit, lw, slots, gw, gemb,
                                 hgw, hgemb, E, acc, B);
  } else if (vec) {
    launch_grad<float, 4>(t, s, p, hot_bf16, dP, r, logit, lw, slots, gw, gemb, hgw,
                          hgemb, E, acc, B);
  } else {
    launch_grad<float, 1>(t, s, p, hot_bf16, dP, r, logit, lw, slots, gw, gemb, hgw,
                          hgemb, E, acc, B);
  }
  return static_cast<int>(cudaGetLastError());
}
