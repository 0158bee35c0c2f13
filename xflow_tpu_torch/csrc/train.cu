// K2 — the fused sparse train step for LR and FM: forward, residual,
// per-occurrence gradients, scatter-add (repeats summed in shared
// memory first) and the log-loss sum in one kernel.
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
// log-loss are unchanged.  Repeats sum in the block's table as in
// dense mode (below), keyed by slot; the slot plane adds 4 B per slot
// read, and the gradient rows land in a compact [U, D] block instead of
// U rows scattered over [T, D].
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
// card's rate.  What held the first form of this kernel far above that
// bound was skew: the path's traffic is zipf(1.2) over 100,000 ids a
// field, so a field's hottest row takes about a fifth of its
// occurrences, some 12,800 in a 65,536-row batch, and each occurrence's
// 1 + D float atomics on one address serialise in L2 (about 22 ns an
// occurrence on an H100: 0.28 ms for one such row alone).
//
// Design.  One warp per example: lanes stride over the KH + K slots,
// so an example's keys are read coalesced; a padding slot is skipped
// before any table access (the JAX path reads row 0 and masks it; this
// kernel never touches it).  Each live slot accumulates linear, s[d],
// s2[d] in registers, CAP factors at a time (CAP = 8, 16 or 32,
// unrolled and guarded by the runtime D; a v wider than 32 runs in
// tiles of 32, so any D the reference accepts runs with the same
// registers); xor butterflies leave the sums on every lane, so every
// lane forms the same residual and the gradients of its own slots
// (the v row is read again, from L1/L2; with more than one tile the
// backward recomputes each tile's s but the last one's).
//
// Privatised accumulation.  The grid is two large persistent blocks of
// 16 warps an SM for D <= 16 (one for D <= 32), so a block walks about
// 250 examples of a 65,536-row batch and a hot row's repeats meet in
// it.  Each block keeps a direct-mapped table in shared memory, keyed
// by the gradient's destination (a row of the cold buffer or of the
// head buffer hgw/hgv; K4's slot in index mode), each entry 1 + D
// float32 sums: at most 768 entries, and at most twice the slots the
// block walks, so a 512-row slice clears a small one.  A slot hashes
// its destination to one entry; it adds its w and v gradient there
// with shared-memory atomics when the entry holds that destination or
// is free (claimed with atomicCAS on the key word), and otherwise adds
// to global memory directly: no batch is refused, and an occupied
// entry costs the slot one shared-memory read.  Entries go to the
// destinations the block meets first, and on skewed traffic those are
// the hot rows.  When the block's examples are done, each claimed
// entry goes to global memory once.  A hot row then costs one global
// add per block (264) and shared-memory adds, not 12,800 serialised
// ones.  Every global add of a v row, direct or from the flush, uses
// Hopper's 8- and 16-byte vector reductions (red.global.add.v2/v4.f32,
// as far as the row's alignment allows): 3 for D = 10 where the first
// form made 10.  Why this shape (timed on an H100 80GB HBM3 at 700 W
// against the other shapes and designs while the kernel was
// redesigned, on a batch drawn as the training path's; PERF.md): the
// vector reductions alone took the path's FM batch from 0.89 to 0.40
// ms; shared-memory float atomics compile to compare-and-swap loops
// (ATOMS.CAST.SPIN) on sm_90a, so a table large enough to hold a
// block's cold rows (2,394 entries with linear probing) cost more than
// it saved (0.82 ms), while a small direct-mapped one keeps mostly hot
// rows and took it to 0.31 ms (Zipf-1 keys: 1.49 to 0.38 ms; uniform
// keys, where almost nothing repeats, 0.76 to 0.81 ms).  For D > 32
// (tiles; the v_dim = 64 path) the table is off and every slot adds
// directly: one tile's sums would need a table per tile.  Only the
// order in which gradients are summed changes: the residual and its
// clamp, the 1/2-form backward, bf16 rounding of hot rows and of each
// hot occurrence's gradient (before its float32 add, now into the
// table), the sentinel and padding rules and the float64 log-loss
// accumulator are as they were.
//
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
// gradients land as float reductions, lanes over (slot, factor) pairs
// so that a warp's reductions into a row coalesce by sector (mvm.cuh,
// step 6); the device-memory stage lands a slot's row from one lane
// with red_row's vector reductions.
//
// The FFM form (B10, form 2; ffm.cuh has its regions, bound and
// design): w and v [T, S * D], the field planes as the MVM form's; one
// block per example, a grid of as many blocks as fit the card looping
// over the examples.  The residual is the UNCLAMPED sigmoid's, (1 / (1
// + exp(-logit)) - y) * weight / num_real: the reference takes FFM's
// gradient by autodiff of softplus(logit) - y * logit (step.py:59-74),
// whose derivative is the plain logistic; pctr's clamp stays in the
// log-loss.  Each live slot's w gradient x * r lands at its row (an
// out-of-range field included: the linear term reads masked_x), each
// slot with a field in [0, S) adds its F * D gradient row, coalesced
// atomics along the row, to the same destinations as FM's (g or its
// first H rows, K4's slots, the head buffer).  hot_bf16 rounds w's hot
// rows and hot gradients alone: FFM's v opts out of the hot path
// (TableSpec.hot=False), so its hot rows and gradients stay float32.
// There is no window-start mode (the hot inner alone uses it, and FFM
// refuses it).  Bound: the keys (and x), fields, labels and weights
// once, per distinct row 4 + 4 S D B of w and v read and as much of g
// read and written; bytes bound it (ffm.cuh).  Where one tile holds all
// of D and D % 4 == 0 (the flagship's F = 39, D = 4), each (slot, f2,
// 4 factors) group of a gradient row lands with one 16-byte vector
// reduction (red.global.add.v4.f32), the groups spread over the
// block's threads: 39 a slot at the flagship where the scalar form
// made 156 atomics (ffm.cuh says why no shared-memory table sums them
// first).  The tiled shapes and D % 4 != 0 keep one atomic a column.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "ffm.cuh"
#include "mvm.cuh"
#include "stage.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;  // the MVM form's
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kBlocksPerSm = 8;
constexpr int kSeg = 16;  // the MVM form's gradient factors a lane lands
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
  __shared__ float part_ll[32];
  __shared__ float part_w[32];
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
// into lane 0's partials.  With `unclamped` (the FFM form) the residual
// takes the plain logistic, the log-loss still the clamped pctr.
template <typename LW>
__device__ __forceinline__ float residual(float logit, const LW* labels,
                                          const LW* weights, long long b,
                                          float num_real, int lane,
                                          float& ll_acc, float& w_acc,
                                          bool unclamped = false) {
  float p = 1.0f / (1.0f + expf(-logit));
  const float logistic = p;
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
  return ((unclamped ? logistic : p) - y) * wt / num_real;
}

// The LR/FM form's privatised gradient table (header): a block's
// direct-mapped table in shared memory, `entries` keys (the
// destination: row * 2 + 1 for the head buffer, row * 2 for the cold
// one; kEmpty when free) and `entries` x `stride` float sums (w's, then
// D of v's).  Returns the entry of `tag`: its one slot when that holds
// `tag` or is free (claimed with atomicCAS), else -1 (the occurrence
// then adds to global memory directly).
constexpr unsigned kEmpty = 0xFFFFFFFFu;
// The LR/FM form's launch shape (header): 16 warps a block, two blocks
// an SM (one for D > 16), at most 768 table entries a block.
constexpr int kTableWarps = 16;
constexpr int kTableBlocksPerSm = 2;
constexpr int kTableEntries = 768;

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

// Global float reductions of n <= CAP consecutive values at dst:
// Hopper's 8- and 16-byte vector reductions where dst's alignment
// allows (A: dst's float offset mod 4), one float each elsewhere.
__device__ __forceinline__ void red2(float* p, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
}

__device__ __forceinline__ void red4(float* p, float a, float b, float c,
                                     float d) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
}

template <int CAP, int A>
__device__ __forceinline__ void red_row_at(float* dst, const float* v, int n) {
  // the head, up to the first 16-byte boundary: A = 1 one float and a
  // pair, A = 2 a pair, A = 3 one float
  constexpr int H = (4 - A) & 3;
  if (A == 1 || A == 3) {
    if (n > 0) atomicAdd(dst, v[0]);
  }
  if (A == 1 || A == 2) {
    constexpr int P = A == 1 ? 1 : 0;
    if (n > P + 1) {
      red2(dst + P, v[P], v[P + 1]);
    } else if (n > P) {
      atomicAdd(dst + P, v[P]);
    }
  }
#pragma unroll
  for (int d = H; d < CAP; d += 4) {
    if (d + 3 < CAP && d + 3 < n) {
      red4(dst + d, v[d], v[d + 1], v[d + 2], v[d + 3]);
    } else if (d + 1 < CAP && d + 1 < n) {  // the tail: a pair, one float
      red2(dst + d, v[d], v[d + 1]);
      if (d + 2 < CAP && d + 2 < n) atomicAdd(dst + d + 2, v[d + 2]);
    } else if (d < n) {
      atomicAdd(dst + d, v[d]);
    }
  }
}

template <int CAP>
__device__ __forceinline__ void red_row(float* dst, const float* v, int n) {
  switch ((reinterpret_cast<std::uintptr_t>(dst) >> 2) & 3u) {
    case 0: red_row_at<CAP, 0>(dst, v, n); break;
    case 1: red_row_at<CAP, 1>(dst, v, n); break;
    case 2: red_row_at<CAP, 2>(dst, v, n); break;
    default: red_row_at<CAP, 3>(dst, v, n); break;
  }
}

// One slot's gradients: w's and the tile's v ones (d0 on, at most CAP;
// zeros past D), each rounded to bf16 when to_bf16.
template <int CAP>
__device__ __forceinline__ void slot_grads(float* gv, float& gw, float xv,
                                           float r, const float* vrow,
                                           const float* s, int d0, int D,
                                           bool to_bf16) {
  const float gwv = xv * r;
  gw = to_bf16 ? bf16_round(gwv) : gwv;
#pragma unroll
  for (int d = 0; d < CAP; ++d) {
    gv[d] = 0.0f;
    if (d0 + d < D) {
      const float vx = (to_bf16 ? bf16_round(vrow[d]) : vrow[d]) * xv;
      const float gvv = (s[d] - vx) * xv * r;
      gv[d] = to_bf16 ? bf16_round(gvv) : gvv;
    }
  }
}

// two blocks an SM at 64 registers a thread for D <= 16, one above
template <int CAP, typename LW>
__global__ void __launch_bounds__(32 * kTableWarps,
                                  CAP <= 16 ? kTableBlocksPerSm : 1)
train_kernel(const int* __restrict__ keys, const float* __restrict__ x,
             const LW* __restrict__ labels, const LW* __restrict__ weights,
             float num_real, const float* __restrict__ w,
             const float* __restrict__ v, const int* __restrict__ slots,
             float* __restrict__ gw,
             float* __restrict__ gv, double* __restrict__ acc, int B, int K,
             int D, const HotArgs h, int entries) {
  extern __shared__ float table_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long warps_total = static_cast<long long>(gridDim.x) * warps;
  const int tiles = CAP > 0 ? (D + CAP - 1) / CAP : 1;
  // the table holds one tile's sums; wider v adds directly (header)
  const bool use_table = entries > 0 && tiles == 1;
  const int stride = 1 + (CAP > 0 ? D : 0);
  unsigned* tkey = reinterpret_cast<unsigned*>(table_smem);
  float* tval = table_smem + entries;
  if (use_table) {
    for (int i = threadIdx.x; i < entries; i += blockDim.x) tkey[i] = kEmpty;
    for (int i = threadIdx.x; i < entries * stride; i += blockDim.x) {
      tval[i] = 0.0f;
    }
    __syncthreads();
  }
  float ll_acc = 0.0f;
  float w_acc = 0.0f;

  for (long long b = static_cast<long long>(blockIdx.x) * warps + warp; b < B;
       b += warps_total) {
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
        const float* vrow = CAP > 0 ? (from_snap(h, key, is_hot) ? h.snap_v : v) +
                                          static_cast<long long>(key) * D + d0
                                    : nullptr;
        float gvs[CAP > 0 ? CAP : 1];
        float gws;
        slot_grads<CAP>(gvs, gws, xv, r, vrow, s, d0, D, to_bf16);
        // this slot's sums go to its table entry, else to the global rows
        const int e = use_table
                          ? table_entry(tkey, entries,
                                        static_cast<unsigned>(dst) * 2u +
                                            (is_hot ? 1u : 0u))
                          : -1;
        if (e >= 0) {
          float* ew = tval + static_cast<long long>(e) * stride;
          atomicAdd(ew, gws);
#pragma unroll
          for (int d = 0; d < CAP; ++d) {
            if (d < D) atomicAdd(ew + 1 + d, gvs[d]);
          }
        } else {
          if (t == 0) atomicAdd((is_hot ? h.gw : gw) + dst, gws);
          if constexpr (CAP > 0) {
            red_row<CAP>((is_hot ? h.gv : gv) + dst * D + d0, gvs,
                         D - d0 < CAP ? D - d0 : CAP);
          }
        }
      }
    }
  }
  if (use_table) {
    // the flush: a thread an entry, its w sum and then its v row's, with
    // vector reductions where the row's alignment allows
    __syncthreads();
    for (int e = threadIdx.x; e < entries; e += blockDim.x) {
      const unsigned tag = tkey[e];
      if (tag == kEmpty) continue;
      const long long dst = tag >> 1;
      const bool hot = (tag & 1u) != 0;
      const float* ev = tval + static_cast<long long>(e) * stride;
      atomicAdd((hot ? h.gw : gw) + dst, ev[0]);
      if constexpr (CAP > 0) {
        float vals[CAP > 0 ? CAP : 1];
#pragma unroll
        for (int d = 0; d < CAP; ++d) vals[d] = d < D ? ev[1 + d] : 0.0f;
        red_row<CAP>((hot ? h.gv : gv) + dst * D, vals, D);
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

// Slot j's factor-d gradient of the loss, prod / own * x * r, zero
// where |own| < kGuardEps (mvm.py:104-112), rounded to bf16 when
// `to_bf16` (a hot slot under the flag); rj is j's representative.
__device__ __forceinline__ float mvm_grad(const mvm::Stage& s, int rj, int j,
                                         int d, int dt, float r, bool to_bf16) {
  const float own = 1.0f + s.val[rj * dt + d];
  const float g = (fabsf(own) < mvm::kGuardEps ? 0.0f : s.prod[d] / own) * s.x[j] * r;
  return to_bf16 ? bf16_round(g) : g;
}

// kGlobalStage: the warps' stages in the device-memory scratch
// `gstage` (stage.cuh); else in shared memory.
// Three blocks an SM where the stage is in shared memory (85 registers:
// a dense batch is bound by how many examples are in flight).
template <typename LW, bool kGlobalStage>
__global__ void __launch_bounds__(kThreads, kGlobalStage ? 1 : 3)
train_mvm_kernel(const int* __restrict__ keys, const float* __restrict__ x,
                 const LW* __restrict__ labels, const LW* __restrict__ weights,
                 float num_real, const float* __restrict__ v,
                 const int* __restrict__ slots, float* __restrict__ gv,
                 double* __restrict__ acc, int B, int K, int D,
                 const void* __restrict__ fields,
                 const void* __restrict__ hot_fields, int f_i32, int S,
                 const HotArgs h, char* __restrict__ gstage) {
  extern __shared__ char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long warps_total = static_cast<long long>(gridDim.x) * warps;
  const int n = h.KH + K;
  mvm::Stage s;
  if constexpr (kGlobalStage) {
    s = mvm::global_stage_at(gstage, static_cast<long long>(blockIdx.x) * warps + warp, n);
  } else {
    s = mvm::stage_at(smem, warp, n);
  }
  const TrainRows rows{v, h.snap_v, s.key, D, h.KH, h.H, h.bf16};
  const int tiles = (D + mvm::kTile - 1) / mvm::kTile;
  float ll_acc = 0.0f;
  float w_acc = 0.0f;
  mvm::clear_heads(s, S, lane);

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
    int nr = 0;
    const bool repeats = mvm::link_fields(s, n, S, lane, nr);
    float logit = 0.0f;
    for (int t = 0; t < tiles; ++t) {
      const int d0 = t * mvm::kTile;
      const int dt = min(mvm::kTile, D - d0);
      const float prod = mvm::tile_forward<kGlobalStage>(s, n, nr, repeats, d0, dt, lane, rows);
      logit += warp_sum(lane < dt ? prod - 1.0f : 0.0f);
    }
    const float r = residual(logit, labels, weights, b, num_real, lane,
                             ll_acc, w_acc);
    for (int t = tiles - 1; t >= 0; --t) {
      const int d0 = t * mvm::kTile;
      const int dt = min(mvm::kTile, D - d0);
      if (t != tiles - 1) mvm::tile_forward<kGlobalStage>(s, n, nr, repeats, d0, dt, lane, rows);
      if constexpr (kGlobalStage) {
        // a lane a (slot, segment of kSeg factors), landed with vector
        // reductions: the device-memory stage's reads of a slot's
        // factors are independent of the reductions before them
        const int segs = (dt + kSeg - 1) / kSeg;
        for (int it = lane; it < n * segs; it += 32) {
          const int j = segs == 1 ? it : it / segs;
          const int rj = s.rep[j];
          const int dst = s.dst[j];
          if (rj < 0 || dst < 0) continue;
          const int e0 = (it - j * segs) * kSeg;
          const int len = min(kSeg, dt - e0);
          const bool hot = j < h.KH;
          float g[kSeg];
#pragma unroll
          for (int e = 0; e < kSeg; ++e) {
            g[e] = e < len ? mvm_grad(s, rj, j, e0 + e, dt, r, hot && h.bf16) : 0.0f;
          }
          red_row<kSeg>((hot ? h.gv : gv) + static_cast<long long>(dst) * D + d0 + e0,
                        g, len);
        }
      } else {
        // a lane a (slot, factor) pair, consecutive lanes on consecutive
        // factors of a row: a warp's reductions into one row coalesce
        // into its sectors
        const int step_j = 32 / dt;
        const int step_d = 32 - step_j * dt;
        int j = lane / dt;
        int d = lane - j * dt;
        for (int p = lane; p < n * dt; p += 32) {
          const int rj = s.rep[j];
          const int dst = s.dst[j];
          if (rj >= 0 && dst >= 0) {
            const bool hot = j < h.KH;
            atomicAdd((hot ? h.gv : gv) + static_cast<long long>(dst) * D + d0 + d,
                      mvm_grad(s, rj, j, d, dt, r, hot && h.bf16));
          }
          j += step_j;
          d += step_d;
          if (d >= dt) {
            d -= dt;
            ++j;
          }
        }
      }
    }
  }
  land_loss(ll_acc, w_acc, acc);
}

// The FFM form: one block per example, the grid looping over them
// (ffm.cuh; the header says what it computes).
// kGlobalStage: the blocks' stages in the device-memory scratch
// `gstage` (stage.cuh); else in shared memory.
template <typename LW, bool kGlobalStage>
__global__ void __launch_bounds__(ffm::kMaxThreads)
train_ffm_kernel(const int* __restrict__ keys, const float* __restrict__ x,
                 const LW* __restrict__ labels, const LW* __restrict__ weights,
                 float num_real, const float* __restrict__ w,
                 const float* __restrict__ v, const int* __restrict__ slots,
                 float* __restrict__ gw, float* __restrict__ gv,
                 double* __restrict__ acc, int B, int K, int D, int dt,
                 const void* __restrict__ fields,
                 const void* __restrict__ hot_fields, int f_i32, int F,
                 const HotArgs h, int vec, char* __restrict__ gstage) {
  extern __shared__ __align__(16) float ffm_smem[];
  const int n = h.KH + K;
  const int E = F * D;
  ffm::Stage s;
  if constexpr (kGlobalStage) {
    s = ffm::global_stage_at(gstage, blockIdx.x, F, dt, n);
  } else {
    s = ffm::stage_at(ffm_smem, F, dt, n);
  }
  const ffm::Rows rows{v, s.key, E};
  const int tiles = (D + dt - 1) / dt;
  float ll_acc = 0.0f;
  float w_acc = 0.0f;

  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    const long long row = b * K;
    const int* srow = slots != nullptr ? slots + row : nullptr;
    __syncthreads();  // the previous example's stage and sums are read out
    float lin = 0.0f;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      float xv;
      bool is_hot;
      const int key = entry_key(keys + row, x != nullptr ? x + row : nullptr, h,
                                b, j, xv, is_hot);
      const int f = mvm::field_of(fields, hot_fields, f_i32, b, K, h.KH, j);
      if (key >= 0) {
        const float wv = w[key];
        lin += (is_hot && h.bf16 ? bf16_round(wv) : wv) * xv;
      }
      s.key[j] = key;
      s.x[j] = xv;
      s.fld[j] = key >= 0 && f >= 0 && f < F ? f : -1;
      s.dst[j] = key < 0 ? -1 : static_cast<int>(grad_row(srow, j, h.KH, key,
                                                          is_hot));
    }
    __syncthreads();
    // the forward, tile by tile; S keeps the last tile's sums
    float pair = 0.0f;
    for (int t = 0; t < tiles; ++t) {
      const int d0 = t * dt;
      const int tw = min(dt, D - d0);
      const float diag = ffm::tile_sums(s, n, F, D, d0, tw, rows);
      __syncthreads();
      pair += ffm::tile_cross(s, F, tw) - diag;
      if (t != tiles - 1) __syncthreads();
    }
    const float logit = ffm::block_sum(lin + 0.5f * pair, s.red);
    const float r = residual(logit, labels, weights, b, num_real,
                             static_cast<int>(threadIdx.x), ll_acc, w_acc,
                             true);
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int dst = s.dst[j];
      if (dst < 0) continue;
      const bool hot = j < h.KH;
      const float g = s.x[j] * r;
      atomicAdd((hot ? h.gw : gw) + dst, hot && h.bf16 ? bf16_round(g) : g);
    }
    if (vec) {
      // one tile, D % 4 == 0: work items (slot, 16-byte group of its
      // row), consecutive threads on consecutive groups of one row; a
      // group is S[f2, f_j, 4 factors] (one 16-byte shared read), the
      // own field's less x v unfused as below, landed with one vector
      // reduction
      const int groups = E >> 2;
      const int per_field = D >> 2;
      for (int u = threadIdx.x; u < n * groups; u += blockDim.x) {
        const int j = u / groups;
        const int at = (u - j * groups) << 2;  // f2 * D + dd, dd % 4 == 0
        const int fj = s.fld[j];
        const int dst = s.dst[j];
        if (fj < 0 || dst < 0) continue;
        const int f2 = (at >> 2) / per_field;
        const float xj = s.x[j];
        const float4 sv =
            *reinterpret_cast<const float4*>(s.S + f2 * E + fj * D + at - f2 * D);
        float g[4] = {sv.x, sv.y, sv.z, sv.w};
        if (f2 == fj) {
          const float* vrow = rows(j) + at;
#pragma unroll
          for (int q = 0; q < 4; ++q) g[q] -= __fmul_rn(vrow[q], xj);
        }
        red4((j < h.KH ? h.gv : gv) + static_cast<long long>(dst) * E + at,
             g[0] * xj * r, g[1] * xj * r, g[2] * xj * r, g[3] * xj * r);
      }
      continue;
    }
    // the backward, the last tile first (its sums are in S)
    for (int t = tiles - 1; t >= 0; --t) {
      const int d0 = t * dt;
      const int tw = min(dt, D - d0);
      const int cols = F * tw;
      if (t != tiles - 1) {
        __syncthreads();  // the later tile's gradients have read S
        ffm::tile_sums(s, n, F, D, d0, tw, rows);
        __syncthreads();
      }
      for (int j = 0; j < n; ++j) {
        const int fj = s.fld[j];
        const int dst = s.dst[j];
        if (fj < 0 || dst < 0) continue;
        const float xj = s.x[j];
        const float* vrow = rows(j);
        float* grow = (j < h.KH ? h.gv : gv) + static_cast<long long>(dst) * E;
        for (int c = threadIdx.x; c < cols; c += blockDim.x) {
          const int f2 = c / tw;
          const int dd = c - f2 * tw;
          const int at = f2 * D + d0 + dd;
          float g = s.S[f2 * cols + fj * tw + dd];
          // unfused, as the sum was formed: a slot alone in its field
          // gets exactly 0 here, as autodiff gives it in the reference
          if (f2 == fj) g -= __fmul_rn(vrow[at], xj);
          atomicAdd(grow + at, g * xj * r);
        }
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

struct TableShape {
  int grid, warps, entries;
  size_t smem;
};

// The LR/FM form's launch shape for a batch of B rows of K cold and KH
// hot slots at v width D: the grid, warps a block, the table's entries
// (0: off) and the dynamic shared memory; opts the kernel in to that
// much shared memory.  Each instantiation keeps the shape of the last
// (device, B, K, KH, D) it was asked for, so the sequential paths' run
// of equal slices reads the card's attributes and the kernel's
// occupancy once, not once a launch.  Returns 0 or a CUDA error.
template <int CAP, typename LW>
int table_shape(int B, int K, int KH, int D, TableShape* out) {
  struct Cache {
    int key[5] = {-1, -1, -1, -1, -1};  // device, B, K, KH, D
    TableShape shape{};
    int opted_dev = -1;
    size_t opted_in = 0;
  };
  static Cache c;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int key[5] = {dev, B, K, KH, D};
  if (std::equal(key, key + 5, c.key)) {
    *out = c.shape;
    return 0;
  }
  int sms = 132, per_sm = 233472;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                         dev);
  TableShape t{0, kTableWarps, 0, 0};
  const int tiles = CAP > 0 ? (D + CAP - 1) / CAP : 1;
  const int stride = 1 + (CAP > 0 ? D : 0);
  if (tiles == 1) {
    // at most kTableEntries, at most twice the slots the block walks
    // (a small slice clears a small table), and within the block's
    // share of the SM's shared memory (1 KB a block is the system's,
    // 256 B land_loss's, 512 B spare)
    const long long blocks = static_cast<long long>(sms) * kTableBlocksPerSm;
    const long long rows =
        (B + blocks * t.warps - 1) / (blocks * t.warps) * t.warps;
    const long long occ = 2LL * rows * (static_cast<long long>(K) + KH);
    const long long fit = (per_sm / kTableBlocksPerSm - 1024 - 256 - 512) /
                          (4LL * (1 + stride));
    long long e = kTableEntries;
    if (e > occ) e = occ;
    if (e > fit) e = fit;
    t.entries = static_cast<int>(e > 32 ? e : 32);
  }
  t.smem = static_cast<size_t>(t.entries) * 4u * static_cast<size_t>(1 + stride);
  if (dev != c.opted_dev) {
    c.opted_dev = dev;
    c.opted_in = 0;
  }
  if (t.smem > c.opted_in) {
    rc = cudaFuncSetAttribute(train_kernel<CAP, LW>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(t.smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    c.opted_in = t.smem;
  }
  // as many blocks as are resident at once: a second wave would leave
  // most of the card idle behind the first one's tail
  int resident = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, train_kernel<CAP, LW>,
                                                32 * t.warps, t.smem);
  const int per_sm_blocks =
      resident < kTableBlocksPerSm ? (resident > 0 ? resident : 1)
                                   : kTableBlocksPerSm;
  const int want = (B + t.warps - 1) / t.warps;
  const int cap = sms * per_sm_blocks;
  t.grid = want < cap ? want : cap;
  std::copy(key, key + 5, c.key);
  c.shape = t;
  *out = t;
  return 0;
}

template <int CAP, typename LW>
int launch(const int* keys, const float* x, const void* labels,
           const void* weights, float num_real, const float* w,
           const float* v, const int* slots, float* gw, float* gv,
           double* acc, int B, int K, int D, const HotArgs& h,
           cudaStream_t stream) {
  TableShape t;
  const int rc = table_shape<CAP, LW>(B, K, h.KH, D, &t);
  if (rc != 0) return rc;
  train_kernel<CAP, LW><<<t.grid, 32 * t.warps, t.smem, stream>>>(
      keys, x, static_cast<const LW*>(labels),
      static_cast<const LW*>(weights), num_real, w, v, slots, gw, gv, acc, B,
      K, D, h, t.entries);
  return 0;
}

// table_shape for the instantiation K2 launches at this D (v width, 0
// for LR).
template <typename LW>
int shape_for(int B, int K, int KH, int D, TableShape* t) {
  if (D == 0) return table_shape<0, LW>(B, K, KH, D, t);
  if (D <= 8) return table_shape<8, LW>(B, K, KH, D, t);
  if (D <= 16) return table_shape<16, LW>(B, K, KH, D, t);
  return table_shape<32, LW>(B, K, KH, D, t);
}

struct FfmShape {
  int dt, threads;
  long long cap;  // blocks resident at once on the card
  size_t smem;
};

// The FFM form's launch shape for F fields of dv factors and n slots a
// row: the tile, threads, dynamic shared memory (the kernel opted in)
// and the resident blocks.  Each instantiation keeps the shape of the
// last (device, F, dv, n) it was asked for, so a run of equal batches
// or slices reads the card's attributes and the occupancy once.
// Returns 0 or a CUDA error (cudaErrorInvalidValue: the stage does not
// fit the card's shared memory).
template <typename LW>
int ffm_shape(int F, int dv, int n, FfmShape* out) {
  struct Cache {
    int key[4] = {-1, -1, -1, -1};  // device, F, dv, n
    FfmShape shape{};
  };
  static Cache c;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int key[4] = {dev, F, dv, n};
  if (std::equal(key, key + 4, c.key)) {
    *out = c.shape;
    return 0;
  }
  FfmShape t{};
  t.dt = ffm::tile_factors(F, dv, n);
  const int rc = ffm::launch_shape(train_ffm_kernel<LW, false>, F, t.dt, n,
                                   &t.threads, &t.smem);
  if (rc != 0) return rc;
  int sms = 132, per_sm = 1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                train_ffm_kernel<LW, false>,
                                                t.threads, t.smem);
  t.cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  std::copy(key, key + 4, c.key);
  c.shape = t;
  *out = t;
  return 0;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

struct Fields {
  int form;  // 0 LR / FM, 1 MVM, 2 FFM
  const void* cold;
  const void* hot;
  int i32, S;
};

template <typename LW>
int dispatch(const int* keys, const float* x, const void* labels,
             const void* weights, float num_real, const float* w,
             const float* v, const int* slots, float* gw, float* gv,
             double* acc, int B, int K, int D, const HotArgs& h,
             const Fields& f, char* gstage, cudaStream_t s) {
  size_t global_bytes = 0;
  const int global_grid = field_stage_plan(f.form, f.S, B, K + h.KH, D,
                                           kWarpsPerBlock, &global_bytes);
  if (global_bytes > 0 && gstage == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (f.form == 2) {
    const int dv = D / f.S;
    if (global_bytes > 0) {
      const int dt = ffm::tile_factors(f.S, dv, K + h.KH);
      const int vec = dt == dv && dv % 4 == 0 && aligned16(gv) &&
                      (h.KH == 0 || aligned16(h.gv));
      train_ffm_kernel<LW, true>
          <<<global_grid, ffm::threads_for(f.S, dt), 0, s>>>(
              keys, x, static_cast<const LW*>(labels),
              static_cast<const LW*>(weights), num_real, w, v, slots, gw, gv,
              acc, B, K, dv, dt, f.cold, f.hot, f.i32, f.S, h, vec, gstage);
      return static_cast<int>(cudaGetLastError());
    }
    FfmShape t;
    const int rc = ffm_shape<LW>(f.S, dv, K + h.KH, &t);
    if (rc != 0) return rc;
    const int grid = static_cast<int>(B < t.cap ? B : t.cap);
    // the vector reductions want one tile, whole 16-byte groups and
    // 16-byte aligned gradient rows (E % 4 == 0 and aligned bases)
    const int vec = t.dt == dv && dv % 4 == 0 && aligned16(gv) &&
                    (h.KH == 0 || aligned16(h.gv));
    train_ffm_kernel<LW, false><<<grid, t.threads, t.smem, s>>>(
        keys, x, static_cast<const LW*>(labels),
        static_cast<const LW*>(weights), num_real, w, v, slots, gw, gv, acc, B,
        K, dv, t.dt, f.cold, f.hot, f.i32, f.S, h, vec, nullptr);
  } else if (f.form == 1) {
    if (global_bytes > 0) {
      train_mvm_kernel<LW, true><<<global_grid, kThreads, 0, s>>>(
          keys, x, static_cast<const LW*>(labels),
          static_cast<const LW*>(weights), num_real, v, slots, gv, acc, B, K, D,
          f.cold, f.hot, f.i32, f.S, h, gstage);
      return static_cast<int>(cudaGetLastError());
    }
    int warps = 1;
    size_t smem = 0;
    const int rc = mvm::launch_shape(train_mvm_kernel<LW, false>, K + h.KH,
                                     kWarpsPerBlock, &warps, &smem);
    if (rc != 0) return rc;
    train_mvm_kernel<LW, false><<<grid_for(B, warps), 32 * warps, smem, s>>>(
        keys, x, static_cast<const LW*>(labels),
        static_cast<const LW*>(weights), num_real, v, slots, gv, acc, B, K, D,
        f.cold, f.hot, f.i32, f.S, h, nullptr);
  } else {
    int rc = 0;
    if (v == nullptr || D == 0) {
      rc = launch<0, LW>(keys, x, labels, weights, num_real, w, nullptr, slots,
                         gw, nullptr, acc, B, K, 0, h, s);
    } else if (D <= 8) {
      rc = launch<8, LW>(keys, x, labels, weights, num_real, w, v, slots, gw,
                         gv, acc, B, K, D, h, s);
    } else if (D <= 16) {
      rc = launch<16, LW>(keys, x, labels, weights, num_real, w, v, slots, gw,
                          gv, acc, B, K, D, h, s);
    } else {
      rc = launch<32, LW>(keys, x, labels, weights, num_real, w, v, slots, gw,
                          gv, acc, B, K, D, h, s);
    }
    if (rc != 0) return rc;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The LR/FM form's launch shape for a batch of B rows of K cold and KH
// hot slots at v width D (0: LR): grid, warps a block and the table's
// entries a block (0: off), as K2 would launch it.  Returns 0 or a CUDA
// error.
extern "C" int xf_train_table_shape(int B, int K, int KH, int D, int lw_u8,
                                    int* grid, int* warps, int* entries) {
  TableShape t;
  const int rc = lw_u8 != 0 ? shape_for<std::uint8_t>(B, K, KH, D, &t)
                            : shape_for<float>(B, K, KH, D, &t);
  if (rc != 0) return rc;
  *grid = t.grid;
  *warps = t.warps;
  *entries = t.entries;
  return 0;
}

extern "C" int xf_mvm_bytes_per_slot() { return mvm::kBytesPerSlot; }
extern "C" int xf_mvm_warp_bytes() { return mvm::kWarpBytes; }
extern "C" int xf_ffm_stage_bytes(int F, int n, int dt) {
  return static_cast<int>(ffm::stage_bytes(F, n, dt));
}
extern "C" int xf_ffm_tile(int F, int D, int n) {
  return ffm::tile_factors(F, D, n);
}

// The device-memory scratch xf_train_step needs for these shapes
// (bytes; 0: none, the field form stages in shared memory, or another
// form).
extern "C" long long xf_train_stage_bytes(int form, int S, int B, int K,
                                          int KH, int D) {
  size_t bytes = 0;
  if (B > 0) {
    field_stage_plan(form, S, B, K + (KH > 0 ? KH : 0), D, kWarpsPerBlock, &bytes);
  }
  return static_cast<long long>(bytes);
}

// Launches K2 on `stream`; labels/weights are u8 when lw_u8 != 0, else
// f32; `slots` null is the dense mode, else the index mode (header).
// KH = 0 means no hot plane (the hot_* pointers unread); snap_v null is
// the live-table mode, else the window-start mode (header).  form 0 is
// LR (v null) or FM, 1 the MVM form (w, gw, hgw, snap_w unread), 2 the
// FFM form (D is v's row width, S * the factors; snap_* unread); the
// field forms read the field planes (f_i32: int32, else u8; S =
// max_fields).  A field form whose row does not fit shared memory
// stages it in `gstage`, xf_train_stage_bytes of device memory
// (stage.cuh).  Returns cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue when such a row comes without
// its scratch.
extern "C" int xf_train_step(const int* keys, const float* x,
                             const void* labels, const void* weights,
                             int lw_u8, float num_real, const float* w,
                             const float* v, const int* slots, float* gw,
                             float* gv, double* acc, int B, int K, int D,
                             const void* hot, const float* hot_x, int hot_u16,
                             int H, int hot_bf16, int KH, float* hgw,
                             float* hgv, const float* snap_w,
                             const float* snap_v, int form,
                             const void* fields, const void* hot_fields,
                             int f_i32, int S, void* gstage, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HotArgs h{hot,  hot_x, hot_u16, H,      hot_bf16, KH > 0 ? KH : 0,
                  hgw,  hgv,   snap_w,  snap_v};
  const Fields f{form, fields, hot_fields, f_i32, S};
  char* scratch = static_cast<char*>(gstage);
  if (lw_u8 != 0) {
    return dispatch<std::uint8_t>(keys, x, labels, weights, num_real, w, v,
                                  slots, gw, gv, acc, B, K, D, h, f, scratch, s);
  }
  return dispatch<float>(keys, x, labels, weights, num_real, w, v, slots, gw,
                         gv, acc, B, K, D, h, f, scratch, s);
}
