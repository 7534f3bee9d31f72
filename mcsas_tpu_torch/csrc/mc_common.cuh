// Device functions shared by the MC chunk kernels (mc_chunk.cuh,
// mc_prefetch.cuh): the closed-form scale/background solve, one point's
// terms of its sums, the sum over a group of lanes, the best-of-K tie rule
// and its reduction over the block.  Rounding follows the plain PyTorch
// versions (ops/mc_kernel.py, fitcore.solve_scale_bg): float64 arithmetic
// with explicit _rn intrinsics so nvcc does not contract into FMAs,
// results rounded to float32.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#define MC_MAX_P 8          // active parameters of a chunk

// closed-form weighted 2x2 solve of fitcore.solve_scale_bg, float64, with
// its scale-invariant degeneracy guards
__device__ __forceinline__ void mc_solve_scale_bg(
    double sx, double sxx, double sxy, double s_u, double s_uy, int find_bg,
    int pos_bg, float* a_out, float* b_out) {
  const bool xx_zero = sxx <= 0.0;
  const double a_nobg = xx_zero ? 0.0 : __ddiv_rn(sxy, sxx);
  double a = a_nobg, b = 0.0;
  if (find_bg) {
    const double denom = __dmul_rn(s_u, sxx);
    const double det = __dsub_rn(denom, __dmul_rn(sx, sx));
    const bool degen = xx_zero || det <= __dmul_rn(1e-6, denom);
    if (degen) {
      b = __ddiv_rn(__dsub_rn(s_uy, __dmul_rn(a_nobg, sx)), s_u);
    } else {
      a = __ddiv_rn(__dsub_rn(__dmul_rn(s_u, sxy), __dmul_rn(sx, s_uy)),
                    det);
      b = __ddiv_rn(__dsub_rn(s_uy, __dmul_rn(a, sx)), s_u);
    }
    if (pos_bg && b < 0.0) {
      a = a_nobg;
      b = 0.0;
    }
  }
  *a_out = (float)a;
  *b_out = (float)b;
}

// best-of-K order: lowest chi2 wins, the lowest k on ties
__device__ __forceinline__ bool mc_better(float c, int k, float best_c,
                                          int best_k) {
  return c < best_c || (c == best_c && k < best_k);
}

// The lanes of this thread's group: kG (a power of two <= 32) aligned
// lanes of its warp.
template <int kG>
__device__ __forceinline__ unsigned mc_group_mask() {
  if (kG == 32) return 0xffffffffu;
  return ((1u << kG) - 1u) << ((threadIdx.x & 31) & ~(kG - 1));
}

// The float64 sum of v over the kG lanes of a group (mask: the group's
// lanes, all of which call it), in a fixed order: a butterfly tree over
// the lane offsets kG/2, ..., 2, 1.  For kG = 8 every lane gets
// ((v0 + v4) + (v2 + v6)) + ((v1 + v5) + (v3 + v7)), bit for bit the same
// in each lane, since IEEE addition is commutative.
template <int kG>
__device__ __forceinline__ double mc_group_sum(double v, unsigned mask) {
#pragma unroll
  for (int off = kG / 2; off > 0; off >>= 1)
    v = __dadd_rn(v, __shfl_xor_sync(mask, v, off, kG));
  return v;
}

// one point's terms of the solve's sums, pt = (q, ft - bank[ri], u, y):
// x = pt.y + row; u x, u x x and u x y, each rounded to float32, added in
// float64
__device__ __forceinline__ void mc_moments(float4 pt, float row, double& sx,
                                           double& sxx, double& sxy) {
  const float x = __fadd_rn(pt.y, row);
  const float ux = __fmul_rn(pt.z, x);
  sx = __dadd_rn(sx, (double)ux);
  sxx = __dadd_rn(sxx, (double)__fmul_rn(ux, x));
  sxy = __dadd_rn(sxy, (double)__fmul_rn(ux, pt.w));
}

// one point's residual term u (y - a x - b)^2, rounded to float32
__device__ __forceinline__ double mc_residual(float4 pt, float row, float a,
                                              float b) {
  const float x = __fadd_rn(pt.y, row);
  const float res = __fsub_rn(__fsub_rn(pt.w, __fmul_rn(a, x)), b);
  return (double)__fmul_rn(__fmul_rn(pt.z, res), res);
}

// Best-of-K over the block, from each group's best (c, kb), the same in
// the kG lanes of a group: shuffles across the groups of a warp, one value
// per warp through shared memory (red_chi, red_k: a slot per warp), and
// every warp reduces those values itself, so that no thread waits for a
// broadcast.  Holds one block barrier; every thread returns with the
// block's best in (c, kb).
template <int kG>
__device__ __forceinline__ void mc_block_best(float& c, int& kb,
                                              float* red_chi, int* red_k,
                                              int n_warps) {
#pragma unroll
  for (int off = 16; off >= kG; off >>= 1) {
    const float oc = __shfl_xor_sync(0xffffffffu, c, off);
    const int oi = __shfl_xor_sync(0xffffffffu, kb, off);
    if (mc_better(oc, oi, c, kb)) {
      c = oc;
      kb = oi;
    }
  }
  if ((threadIdx.x & 31) == 0) {
    red_chi[threadIdx.x >> 5] = c;
    red_k[threadIdx.x >> 5] = kb;
  }
  __syncthreads();
  const int wl = threadIdx.x & 31;
  c = wl < n_warps ? red_chi[wl] : INFINITY;
  kb = wl < n_warps ? red_k[wl] : INT_MAX;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float oc = __shfl_xor_sync(0xffffffffu, c, off);
    const int oi = __shfl_xor_sync(0xffffffffu, kb, off);
    if (mc_better(oc, oi, c, kb)) {
      c = oc;
      kb = oi;
    }
  }
}
