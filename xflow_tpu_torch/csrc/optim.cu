// K3 — the dense-mode optimizer pass: FTRL or SGD over every element
// of a [T, D] table, in place, clearing the gradient buffer for the
// next step; elements whose gradient group is zero are left as they
// are, which is what the update would write (below).
//
// Replaces these XLA-lowered regions of the JAX reference's dense train
// step (the reference has no Pallas kernels, so these jnp regions are
// what a port turns into kernels — ROADMAP Queue B, B3):
//   xflow_tpu/optim/ftrl.py:50-69  FTRL.update_rows — ftrl.h:58-74:
//     n' = n + g*g;  sigma = (sqrt(n') - sqrt(n)) / alpha;
//     z' = z + g - sigma*w;
//     w' = |z'| <= l1 ? 0 : (sign(z')*l1 - z') / ((beta + sqrt(n'))/alpha + l2)
//     with sign(0) = 0, and w' = w where n' == 0 (never-touched rows
//     keep their init)
//   xflow_tpu/optim/sgd.py:24-27   SGD.update_rows — w' = w - lr*g
//   xflow_tpu/parallel/step.py:1123-1126  applied to the whole table,
//     and step.py:1075-1081's per-step zeroed [T, D] gradient buffer,
//     which the port keeps in its state and this kernel clears (g = 0).
//
// Inputs / outputs (all f32, `count` = T*D elements, contiguous):
//   FTRL: reads w, n, z, g; writes w, n, z and g = 0;
//   SGD:  reads w, g;       writes w and g = 0.
//
// Bound.  K3 runs on the [T, D] gradient buffer that one batch's K2
// filled: the path's FM batch touches about 2 % of T = 2^24 rows, and
// FTRL and SGD leave a row whose gradient is exactly 0 as it was (below).
// So the least work is to read g once (4 B an element) and, for each
// 16-byte group of g that is not zero, read and write that group's
// state and clear it: FTRL w, n, z in and out and g out (28 B an
// element), SGD w in and out and g out (12 B), counted at 32-byte
// sectors.  For the path's g that is about 0.7-0.8 GB (0.2-0.25 ms at
// 3.35 TB/s) for FM's v (D = 10) at T = 2^24, against 5.37 GB (FTRL,
// 1.60 ms) or 2.68 GB (SGD, 0.80 ms) for a pass that rewrites every
// element; a g with no zero group still costs that full pass.  The
// arithmetic (two sqrtf, two divisions, a handful of FMAs per touched
// element) is far below the card's rate.
//
// Design: a grid-stride loop over float4 groups, kUnroll = 2 groups a
// thread an iteration.  Each group of g is read first, with a streaming load
// (__ldcs: g is read once).  Where all four lanes are +0.0 bit
// for bit, nothing else is touched: w, n and z are neither loaded nor
// stored, and the zeros g already holds are not stored again.  Any
// other group (a -0.0 lane included) takes exactly the old full
// update, ftrl_one or w - lr * g on all four lanes, and g = 0.  The
// test is per 16-byte group, so a group that straddles a touched and
// an untouched row takes the full update, which is exact as well; the
// kernel needs no row boundaries.  The port's tables are fresh
// allocations of T = 2^table_size_log2 rows, so every pointer is
// 16-byte aligned and T*D is a multiple of 4; anything else is refused
// (cudaErrorInvalidValue), never run on a slower path.  The grid is 8
// blocks of 256 threads an SM: on an H100 80GB HBM3 at 700 W, timed
// against 4-32 blocks an SM and 1-4 groups a thread while the kernel
// was redesigned (PERF.md, Findings), every shape came within 10 % of
// it on the path's g (0.43 ms FTRL, 0.31 ms SGD at
// T = 2^24, D = 10; the g read alone is 0.20 ms), and a prefetch of
// the next iteration's g gained nothing.  What is left is the touched
// groups' state: 32-byte sectors read and written at random.
//
// Exactness of the skip.  On a group with g == +0.0, the old full pass
// wrote back its input bit for bit, for every state that ftrl_one
// produced: n' = fma(g, g, n) = n; sigma = (sqrt(n) - sqrt(n)) / alpha
// = +0; z' = z + 0 - 0 * w = z (z is never -0.0: it starts at +0.0,
// and a sum that cancels exactly rounds to +0.0); w' is recomputed from
// the same (z, n) by the same ftrl_one that last wrote it, or kept
// where n' == 0 (never-touched rows keep their init); SGD's w - lr * 0
// = w.  So skipping changes nothing for such states.  The one
// exception is a state imported with a w that ftrl_one did not compute
// from its (z, n), such as a JAX checkpoint converted by convert.py:
// the old pass rewrote w there to within rounding of its value, and
// this kernel keeps it until the row is touched.  Both stay within the
// parity bar (rtol 1e-5 / atol 1e-6 against the reference).
// Numerics: the recurrence is ftrl_one in ftrl.cuh, shared with K5
// (sparse.cu), so the dense and the touched-rows updates cannot drift.

#include <cuda_runtime.h>

#include <cstdint>

#include "ftrl.cuh"

namespace {

// The launch shape (header): 8 blocks of 256 threads an SM, each thread
// kUnroll float4 groups an iteration.
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kUnroll = 2;

__device__ __forceinline__ bool all_zero(const float4& a) {
  return (__float_as_uint(a.x) | __float_as_uint(a.y) | __float_as_uint(a.z) |
          __float_as_uint(a.w)) == 0u;
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// kUnroll float4 groups of g from `base` on, kThreads apart (zeros past
// the end), with streaming loads: g is read once.
__device__ __forceinline__ void load_g(float4 (&gv)[kUnroll], const float4* g,
                                       long long base, long long groups) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + static_cast<long long>(u) * kThreads;
    gv[u] = i < groups ? __ldcs(g + i) : zero4();
  }
}

// Each thread walks kUnroll groups an iteration, grid-stride: their g
// first, then the state of the touched ones.
__global__ void __launch_bounds__(kThreads)
ftrl_vec_kernel(float4* __restrict__ w, float4* __restrict__ n,
                float4* __restrict__ z, float4* __restrict__ g,
                long long groups, FtrlParams p) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads * kUnroll;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads * kUnroll +
                        threadIdx.x;
       base < groups; base += stride) {
    float4 gv[kUnroll];
    load_g(gv, g, base, groups);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (all_zero(gv[u])) continue;  // also every group past the end
      const long long i = base + static_cast<long long>(u) * kThreads;
      float4 wv = w[i], nv = n[i], zv = z[i];
      ftrl_one(wv.x, nv.x, zv.x, gv[u].x, p);
      ftrl_one(wv.y, nv.y, zv.y, gv[u].y, p);
      ftrl_one(wv.z, nv.z, zv.z, gv[u].z, p);
      ftrl_one(wv.w, nv.w, zv.w, gv[u].w, p);
      w[i] = wv;
      n[i] = nv;
      z[i] = zv;
      g[i] = zero4();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sgd_vec_kernel(float4* __restrict__ w, float4* __restrict__ g,
               long long groups, float lr) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads * kUnroll;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads * kUnroll +
                        threadIdx.x;
       base < groups; base += stride) {
    float4 gv[kUnroll];
    load_g(gv, g, base, groups);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (all_zero(gv[u])) continue;
      const long long i = base + static_cast<long long>(u) * kThreads;
      float4 wv = w[i];
      wv.x = wv.x - lr * gv[u].x;
      wv.y = wv.y - lr * gv[u].y;
      wv.z = wv.z - lr * gv[u].z;
      wv.w = wv.w - lr * gv[u].w;
      w[i] = wv;
      g[i] = zero4();
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

bool vectorisable(long long count, const void* a, const void* b) {
  return count % 4 == 0 && aligned16(a) && aligned16(b);
}

int grid_for(long long groups) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  const long long want = (groups + per_block - 1) / per_block;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

}  // namespace

// FTRL over `count` elements on `stream`; returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue when a
// pointer is not 16-byte aligned or count % 4 != 0.
extern "C" int xf_ftrl_update(float* w, float* n, float* z, float* g,
                              long long count, float alpha, float beta,
                              float l1, float l2, void* stream) {
  if (count <= 0) return 0;
  if (!vectorisable(count, w, n) || !vectorisable(count, z, g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long groups = count / 4;
  ftrl_vec_kernel<<<grid_for(groups), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<float4*>(w), reinterpret_cast<float4*>(n),
      reinterpret_cast<float4*>(z), reinterpret_cast<float4*>(g), groups,
      FtrlParams{alpha, beta, l1, l2});
  return static_cast<int>(cudaGetLastError());
}

// SGD over `count` elements on `stream`; returns as xf_ftrl_update.
extern "C" int xf_sgd_update(float* w, float* g, long long count, float lr,
                             void* stream) {
  if (count <= 0) return 0;
  if (!vectorisable(count, w, g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long groups = count / 4;
  sgd_vec_kernel<<<grid_for(groups), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<float4*>(w), reinterpret_cast<float4*>(g), groups, lr);
  return static_cast<int>(cudaGetLastError());
}
