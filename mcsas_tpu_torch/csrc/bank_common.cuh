// float64 helpers shared by the post pass's bank kernels (cyl_bank.cu,
// kho_bank.cu): the port's own J1, ops/special.py::bessel_j1 and
// j1_over_x (Abramowitz & Stegun 9.4.4 / 9.4.6, its coefficients and its
// |x| <= 3 switch), not CUDA's j1(): the two differ by the polynomial's
// ~1e-8.  Each product and sum is rounded as PyTorch rounds it (_rn
// intrinsics, no FMA).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

// ops/special.py::_poly on float64 coefficients: acc = c6, then acc t + ci,
// each product and sum rounded
__device__ __forceinline__ double cb_poly7(double t, double c0, double c1,
                                           double c2, double c3, double c4,
                                           double c5, double c6) {
  double acc = c6;
  acc = __dadd_rn(__dmul_rn(acc, t), c5);
  acc = __dadd_rn(__dmul_rn(acc, t), c4);
  acc = __dadd_rn(__dmul_rn(acc, t), c3);
  acc = __dadd_rn(__dmul_rn(acc, t), c2);
  acc = __dadd_rn(__dmul_rn(acc, t), c1);
  return __dadd_rn(__dmul_rn(acc, t), c0);
}

// ops/special.py::bessel_j1 in float64: ax / 3.0 a division (PyTorch's on
// the CPU), 3.0 / ax the reciprocal times 3 (Tensor.__rtruediv__)
__device__ __forceinline__ double cb_j1(double x) {
  const double ax = fabs(x);
  double j;
  if (ax <= 3.0) {
    double t = __ddiv_rn(ax, 3.0);
    t = __dmul_rn(t, t);
    j = __dmul_rn(ax, cb_poly7(t, 0.5, -0.56249985, 0.21093573, -0.03954289,
                               0.00443319, -0.00031761, 0.00001109));
  } else {
    const double t = __dmul_rn(__drcp_rn(ax), 3.0);
    const double f1 = cb_poly7(t, 0.79788456, 0.00000156, 0.01659667,
                               0.00017105, -0.00249511, 0.00113653,
                               -0.00020033);
    const double th = __dadd_rn(
        ax, cb_poly7(t, -2.35619449, 0.12499612, 0.00005650, -0.00637879,
                     0.00074348, 0.00079824, -0.00029166));
    j = __ddiv_rn(__dmul_rn(f1, cos(th)), __dsqrt_rn(ax));
  }
  const double sign = x > 0.0 ? 1.0 : (x < 0.0 ? -1.0 : 0.0);
  return __dmul_rn(sign, j);
}

// ops/special.py::j1_over_x: 1/2 - x^2/16 below |x| < 1e-6
__device__ __forceinline__ double cb_j1_over_x(double x) {
  if (fabs(x) < 1e-6)
    return __dsub_rn(0.5, __dmul_rn(__dmul_rn(x, x), 0.0625));
  return __ddiv_rn(cb_j1(x), x);
}
