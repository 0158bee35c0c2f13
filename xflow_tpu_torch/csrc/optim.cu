// K3 — the dense-mode optimizer pass: FTRL or SGD over every element
// of a [T, D] table, in place, clearing the gradient buffer for the
// next step.
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
// Bound.  Elementwise and bound by bytes: FTRL moves 8 x 4 B per
// element (4 reads, 4 writes), SGD 4 x 4 B.  At T = 2^24 that is
// 0.54 GB (0.16 ms at 3.35 TB/s) for FM's or LR's w (D = 1) and 5.37 GB
// (1.60 ms) for FM's v (D = 10).  The arithmetic (two sqrtf, two
// divisions, a handful of FMAs per element) is far below the card's
// rate.
//
// Design (first, simple and right): a grid-stride loop over float4
// groups, so every thread makes 16-byte loads and stores and
// neighbouring threads touch neighbouring addresses.  The port's tables
// are fresh allocations of T = 2^table_size_log2 rows, so every pointer
// is 16-byte aligned and T*D is a multiple of 4; anything else is
// refused (cudaErrorInvalidValue), never run on a slower path.  The
// grid is a few blocks per SM, enough to keep loads in flight.
// Numerics: the recurrence is ftrl_one in ftrl.cuh, shared with K5
// (sparse.cu), so the dense and the touched-rows updates cannot drift.

#include <cuda_runtime.h>

#include <cstdint>

#include "ftrl.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads)
ftrl_vec_kernel(float4* __restrict__ w, float4* __restrict__ n,
                float4* __restrict__ z, float4* __restrict__ g,
                long long groups, FtrlParams p) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < groups; i += stride) {
    float4 wv = w[i], nv = n[i], zv = z[i];
    const float4 gv = g[i];
    ftrl_one(wv.x, nv.x, zv.x, gv.x, p);
    ftrl_one(wv.y, nv.y, zv.y, gv.y, p);
    ftrl_one(wv.z, nv.z, zv.z, gv.z, p);
    ftrl_one(wv.w, nv.w, zv.w, gv.w, p);
    w[i] = wv;
    n[i] = nv;
    z[i] = zv;
    g[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

__global__ void __launch_bounds__(kThreads)
sgd_vec_kernel(float4* __restrict__ w, float4* __restrict__ g,
               long long groups, float lr) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < groups; i += stride) {
    float4 wv = w[i];
    const float4 gv = g[i];
    wv.x = wv.x - lr * gv.x;
    wv.y = wv.y - lr * gv.y;
    wv.z = wv.z - lr * gv.z;
    wv.w = wv.w - lr * gv.w;
    w[i] = wv;
    g[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

bool vectorisable(long long count, const void* a, const void* b) {
  return count % 4 == 0 && aligned16(a) && aligned16(b);
}

int grid_for(long long items) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long want = (items + kThreads - 1) / kThreads;
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
