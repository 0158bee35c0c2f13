// The FTRL-proximal recurrence for one element, shared by K3 (optim.cu,
// the dense full-table pass) and K5 (sparse.cu, the touched-rows
// update), so the two update paths cannot drift apart.
//
// xflow_tpu/optim/ftrl.py:50-69 FTRL.update_rows — ftrl.h:58-74:
//   n' = n + g*g;  sigma = (sqrt(n') - sqrt(n)) / alpha;
//   z' = z + g - sigma*w;
//   w' = |z'| <= l1 ? 0 : (sign(z')*l1 - z') / ((beta + sqrt(n'))/alpha + l2)
// with sign(0) = 0, and w' = w where n' == 0 (never-touched rows keep
// their init).  The soft threshold is continuous in z', so a last-ulp
// difference in z' at |z'| = l1 moves w' by at most that difference
// over the denominator.  Built without --use_fast_math: sqrtf and the
// divisions are IEEE-rounded, and nvcc's default FMA contraction turns
// n + g*g into fma(g, g, n), as jitted XLA does.

#pragma once

struct FtrlParams {
  float alpha, beta, l1, l2;
};

__device__ __forceinline__ void ftrl_one(float& w, float& n, float& z,
                                         float g, const FtrlParams p) {
  const float n_new = n + g * g;
  const float sigma = (sqrtf(n_new) - sqrtf(n)) / p.alpha;
  const float z_new = z + g - sigma * w;
  const float sgn = z_new > 0.0f ? 1.0f : (z_new < 0.0f ? -1.0f : 0.0f);
  const float shrink =
      (sgn * p.l1 - z_new) / ((p.beta + sqrtf(n_new)) / p.alpha + p.l2);
  float w_new = fabsf(z_new) <= p.l1 ? 0.0f : shrink;
  if (n_new == 0.0f) w_new = w;
  w = w_new;
  n = n_new;
  z = z_new;
}
