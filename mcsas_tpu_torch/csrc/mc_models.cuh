// Device functions of the fused chunk kernel K1 (mc_chunk.cu) and of its
// latency probe K3 (mc_probe.cu): the Philox stream, the proposal
// transform and the elementwise models, one K1Model<id> each (the ids of
// ops/mc_kernel.py, _K1_MODELS).
//
// Rounding follows the plain PyTorch versions (models/*.py, ops/special.py
// and IntensityKernel.row in core/engine.py) operation by operation, so
// that a candidate's row, and so its chi2, equals the plain version's on
// the card bit for bit:
// * float32 arithmetic with __fmul_rn/__fadd_rn/__fdiv_rn, which nvcc
//   never contracts into FMAs; the precise sincosf, expf and powf (build
//   without --use_fast_math);
// * a model's parameter is a Python float where it is fixed and a tensor
//   where it is active.  The plain version then evaluates a sub-expression
//   of fixed values alone in float64 and rounds it to float32 where it
//   meets a tensor.  MV carries a value with that tag, and its operations
//   repeat what PyTorch does on CUDA with a host scalar: float64 when both
//   operands are fixed; otherwise float32 with the fixed operand rounded,
//   a division by a fixed value as a multiplication by its float32
//   reciprocal, and a fixed value divided by an active one as the
//   reciprocal times the value (Tensor.__rtruediv__);
// * integer powers multiply in the order of ops/special.py::ipow, and
//   tensor ** scalar takes PyTorch's special cases (torch_powf).
// What the float64 side cannot repeat bit for bit -- C's pow -- the
// wrapper folds on the host: LMADenseSphere's automatic standoff with a
// fixed volume fraction, and the weight of a volume without an active
// parameter (ChunkParams.vol_fixed / sw_fixed).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mc_common.cuh"

#define MC_MAX_MODEL_P 8    // parameters of a model, fixed ones included
#define MC_N_MODELS 4

// ------------------------------------------------------------ proposals

__device__ __forceinline__ uint32_t philox_x0(uint32_t c0, uint32_t c1,
                                              uint32_t c2, uint32_t c3,
                                              uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return c0;
}

// (10^(u*dec) - 1) / 10^dec for logdecN, identity for uniform
__device__ __forceinline__ float gen_transform(float u, int g) {
  if (g == 0) return u;
  const float dec = (float)g;
  const float top = g == 1 ? 10.0f : (g == 2 ? 100.0f : 1000.0f);
  return __fdiv_rn(__fsub_rn(powf(10.0f, __fmul_rn(u, dec)), 1.0f), top);
}

// ------------------------------------------------------- mixed values

struct MV {
  double d;     // the float64 value, where fixed
  float f;      // the float32 value the tensor side sees
  bool fixed;
};

__device__ __forceinline__ MV mv_fix(double d) {
  MV m;
  m.d = d;
  m.f = (float)d;
  m.fixed = true;
  return m;
}

__device__ __forceinline__ MV mv_act(float f) {
  MV m;
  m.d = 0.0;
  m.f = f;
  m.fixed = false;
  return m;
}

__device__ __forceinline__ MV mv_add(MV a, MV b) {
  return (a.fixed && b.fixed) ? mv_fix(__dadd_rn(a.d, b.d))
                              : mv_act(__fadd_rn(a.f, b.f));
}

__device__ __forceinline__ MV mv_sub(MV a, MV b) {
  return (a.fixed && b.fixed) ? mv_fix(__dsub_rn(a.d, b.d))
                              : mv_act(__fsub_rn(a.f, b.f));
}

__device__ __forceinline__ MV mv_mul(MV a, MV b) {
  return (a.fixed && b.fixed) ? mv_fix(__dmul_rn(a.d, b.d))
                              : mv_act(__fmul_rn(a.f, b.f));
}

__device__ __forceinline__ MV mv_div(MV a, MV b) {
  if (a.fixed && b.fixed) return mv_fix(__ddiv_rn(a.d, b.d));
  if (b.fixed) return mv_act(__fmul_rn(a.f, __fdiv_rn(1.0f, b.f)));
  if (a.fixed) return mv_act(__fmul_rn(__fdiv_rn(1.0f, b.f), a.f));
  return mv_act(__fdiv_rn(a.f, b.f));
}

// x**n, n >= 1, in the multiplication order of ops/special.py::ipow
__device__ __forceinline__ MV mv_ipow(MV x, int n) {
  MV acc = x;
  bool have = false;
  while (n > 0) {
    if (n & 1) {
      acc = have ? mv_mul(acc, x) : x;
      have = true;
    }
    n >>= 1;
    if (n > 0) x = mv_mul(x, x);
  }
  return acc;
}

// float32 tensor ** scalar as PyTorch computes it on CUDA: its special
// cases, else powf with the exponent rounded to float32
__device__ __forceinline__ float torch_powf(float x, double e) {
  if (e == 0.0) return 1.0f;
  if (e == 1.0) return x;
  if (e == 0.5) return __fsqrt_rn(x);
  if (e == 2.0) return __fmul_rn(x, x);
  if (e == 3.0) return __fmul_rn(__fmul_rn(x, x), x);
  if (e == -0.5) return rsqrtf(x);
  if (e == -1.0) return __fdiv_rn(1.0f, x);
  if (e == -2.0) return (float)__ddiv_rn(1.0, (double)__fmul_rn(x, x));
  return powf(x, (float)e);
}

__device__ __forceinline__ MV mv_pow(MV x, double e) {
  return x.fixed ? mv_fix(pow(x.d, e)) : mv_act(torch_powf(x.f, e));
}

// ------------------------------------------- special functions, float32

// ops/special.py::sphere_ff: 3(sin x - x cos x)/x^3, series below 0.5
__device__ __forceinline__ float sphere_ff(float x) {
  if (fabsf(x) < 0.5f) {
    const float x2 = __fmul_rn(x, x);
    float t = __fmul_rn(x2, (float)(-1.0 / 15120.0));
    t = __fmul_rn(x2, __fadd_rn((float)(1.0 / 280.0), t));
    t = __fmul_rn(x2, __fadd_rn((float)(-1.0 / 10.0), t));
    return __fadd_rn(1.0f, t);
  }
  float s, c;
  sincosf(x, &s, &c);
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  return __fdiv_rn(__fmul_rn(3.0f, __fsub_rn(s, __fmul_rn(x, c))), x3);
}

// c0 + a*(c1 + a*(c2 + a*c3)) in PyTorch's order
__device__ __forceinline__ float series3(float a, double c0, double c1,
                                         double c2, double c3) {
  float t = __fmul_rn(a, (float)c3);
  t = __fmul_rn(a, __fadd_rn(t, (float)c2));
  t = __fmul_rn(a, __fadd_rn(t, (float)c1));
  return __fadd_rn(t, (float)c0);
}

// ops/special.py::py_G_over_A, series below |A| < 1
__device__ __forceinline__ float py_g_over_a(float A, float alpha,
                                             float beta, float gamma) {
  float g1, g2, g3;
  if (fabsf(A) < 1.0f) {
    const float a2 = __fmul_rn(A, A);
    g1 = series3(a2, 1.0 / 3.0, -1.0 / 30.0, 1.0 / 840.0, -1.0 / 45360.0);
    g2 = series3(a2, 1.0 / 4.0, -1.0 / 36.0, 1.0 / 960.0, -1.0 / 50400.0);
    g3 = series3(a2, 1.0 / 6.0, -1.0 / 48.0, 1.0 / 1200.0,
                 -1.0 / 60480.0);
  } else {
    float s, c;
    sincosf(A, &s, &c);
    const float a2 = __fmul_rn(A, A);
    const float a3 = __fmul_rn(A, a2);
    const float a4 = __fmul_rn(a2, a2);
    const float a6 = __fmul_rn(a2, a4);
    g1 = __fdiv_rn(__fsub_rn(s, __fmul_rn(A, c)), a3);
    const float n2 = __fsub_rn(
        __fadd_rn(__fmul_rn(__fmul_rn(2.0f, A), s),
                  __fmul_rn(__fsub_rn(2.0f, a2), c)),
        2.0f);
    g2 = __fdiv_rn(n2, a4);
    const float in3 = __fadd_rn(
        __fadd_rn(__fmul_rn(__fsub_rn(__fmul_rn(3.0f, a2), 6.0f), c),
                  __fmul_rn(__fsub_rn(a3, __fmul_rn(6.0f, A)), s)),
        6.0f);
    g3 = __fdiv_rn(__fadd_rn(__fmul_rn(-a4, c), __fmul_rn(4.0f, in3)), a6);
  }
  return __fadd_rn(__fadd_rn(__fmul_rn(alpha, g1), __fmul_rn(beta, g2)),
                   __fmul_rn(gamma, g3));
}

// models/chains.py::gauss_debye_over_u, series below |u| < 0.3; u / 360
// is PyTorch's multiplication by the float32 reciprocal on CUDA
__device__ __forceinline__ float gauss_debye_over_u(float u) {
  if (fabsf(u) < 0.3f) {
    float t = __fmul_rn(u, __fdiv_rn(1.0f, 360.0f));
    t = __fmul_rn(u, __fadd_rn(t, (float)(-1.0 / 60.0)));
    t = __fmul_rn(u, __fadd_rn(t, (float)(1.0 / 12.0)));
    t = __fmul_rn(u, __fadd_rn(t, (float)(-1.0 / 3.0)));
    return __fsqrt_rn(__fadd_rn(t, 1.0f));
  }
  const float x = __fadd_rn(__fsub_rn(expf(-u), 1.0f), u);
  return __fdiv_rn(__fsqrt_rn(__fmul_rn(2.0f, x)), u);
}

// Horner of ops/special.py::_poly for seven coefficients: each rounded to
// float32 first, the start zeros_like(t) + c6, then acc * t + c_i
__device__ __forceinline__ float poly7(float t, double c0, double c1,
                                       double c2, double c3, double c4,
                                       double c5, double c6) {
  float acc = (float)c6;
  acc = __fadd_rn(__fmul_rn(acc, t), (float)c5);
  acc = __fadd_rn(__fmul_rn(acc, t), (float)c4);
  acc = __fadd_rn(__fmul_rn(acc, t), (float)c3);
  acc = __fadd_rn(__fmul_rn(acc, t), (float)c2);
  acc = __fadd_rn(__fmul_rn(acc, t), (float)c1);
  return __fadd_rn(__fmul_rn(acc, t), (float)c0);
}

// ops/special.py::bessel_j1 (Abramowitz & Stegun 9.4.4 / 9.4.6): ax / 3.0
// is PyTorch's multiplication by the float32 reciprocal on CUDA, 3.0 / ax
// the tensor's reciprocal times 3 (Tensor.__rtruediv__); cosf and the
// correctly rounded square root and division; torch.sign gives 0 for 0
__device__ __forceinline__ float bessel_j1f(float x) {
  const float sign = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  const float ax = fabsf(x);
  float j;
  if (ax <= 3.0f) {
    float t = __fmul_rn(ax, __fdiv_rn(1.0f, 3.0f));
    t = __fmul_rn(t, t);
    j = __fmul_rn(ax, poly7(t, 0.5, -0.56249985, 0.21093573, -0.03954289,
                            0.00443319, -0.00031761, 0.00001109));
  } else {
    const float t = __fmul_rn(__fdiv_rn(1.0f, ax), 3.0f);
    const float f1 = poly7(t, 0.79788456, 0.00000156, 0.01659667,
                           0.00017105, -0.00249511, 0.00113653, -0.00020033);
    const float th = __fadd_rn(
        ax, poly7(t, -2.35619449, 0.12499612, 0.00005650, -0.00637879,
                  0.00074348, 0.00079824, -0.00029166));
    j = __fdiv_rn(__fmul_rn(f1, cosf(th)), __fsqrt_rn(ax));
  }
  return __fmul_rn(sign, j);
}

// ops/special.py::j1_over_x: J1(x)/x, 1/2 - x^2/16 below |x| < 1e-6
__device__ __forceinline__ float j1_over_x(float x) {
  if (fabsf(x) < (float)1e-6)
    return __fsub_rn(0.5f, __fmul_rn(__fmul_rn(x, x), 0.0625f));
  return __fdiv_rn(bessel_j1f(x), x);
}

// the Kholodenko worm's circular cross-section 2 j1(q r)/(q r) at one point
// (models/chains.py, the table lookup: 2.0 * j1_over_x(q * radius))
__device__ __forceinline__ float cross_section(float q, float r) {
  return __fmul_rn(2.0f, j1_over_x(__fmul_rn(q, r)));
}

// ------------------------------------------------------------ models
//
// K1Model<id>: setup(pv) turns one candidate's full parameter list (in
// the model's declaration order) into the per-candidate scalars of the
// row; volume(pv) is the model's volume; ff(q, c) the form factor at one
// q point.  Row = (ff * sqrt(w))^2 clamped, as IntensityKernel.row.

#define MC_PI43 (4.0 * 3.14159265358979323846 / 3.0)

template <int kModel>
struct K1Model;

// 0: Sphere (radius, sld)
template <>
struct K1Model<0> {
  struct Cand {
    float r;
  };
  __device__ static Cand setup(const MV* pv) { return {pv[0].f}; }
  __device__ static MV volume(const MV* pv) {
    return mv_mul(mv_fix(MC_PI43), mv_ipow(pv[0], 3));
  }
  __device__ static float ff(float q, const Cand& c) {
    return sphere_ff(__fmul_rn(q, c.r));
  }
};

// 1: LMADenseSphere (radius, volFrac, mf, sld): sqrt(max(ff^2 S, 0))
template <>
struct K1Model<1> {
  struct Cand {
    float r, mfr, alpha, beta, gamma, c24;
  };
  __device__ static Cand setup(const MV* pv) {
    const MV r = pv[0], mu = pv[1];
    const MV mf = pv[2].d == -1.0 && pv[2].fixed
                      ? mv_pow(mv_div(mv_fix(0.634), mu), 1.0 / 3.0)
                      : pv[2];
    const MV d4 = mv_ipow(mv_sub(mv_fix(1.0), mu), 4);
    const MV alpha = mv_div(
        mv_ipow(mv_add(mv_fix(1.0), mv_mul(mv_fix(2.0), mu)), 2), d4);
    const MV beta = mv_div(
        mv_mul(mv_mul(mv_fix(-6.0), mu),
               mv_ipow(mv_add(mv_fix(1.0), mv_div(mu, mv_fix(2.0))), 2)),
        d4);
    const MV gamma = mv_div(mv_mul(mu, alpha), mv_fix(2.0));
    return {r.f, mv_mul(mf, r).f, alpha.f, beta.f, gamma.f,
            mv_mul(mv_fix(24.0), mu).f};
  }
  __device__ static MV volume(const MV* pv) {
    return mv_mul(mv_fix(MC_PI43), mv_ipow(pv[0], 3));
  }
  __device__ static float ff(float q, const Cand& c) {
    const float f = sphere_ff(__fmul_rn(q, c.r));
    const float A = __fmul_rn(__fmul_rn(2.0f, q), c.mfr);
    const float g = py_g_over_a(A, c.alpha, c.beta, c.gamma);
    const float S = __fdiv_rn(1.0f, __fadd_rn(__fmul_rn(c.c24, g), 1.0f));
    float v = __fmul_rn(__fmul_rn(f, f), S);
    if (!isnan(v)) v = fmaxf(v, 0.0f);     // clamp_min keeps a NaN
    return __fsqrt_rn(v);
  }
};

// 2: GaussianChain (rg, bp, etas, k)
template <>
struct K1Model<2> {
  struct Cand {
    float rg, beta;
  };
  __device__ static Cand setup(const MV* pv) {
    const MV beta =
        mv_sub(pv[1], mv_mul(mv_mul(pv[3], mv_ipow(pv[0], 2)), pv[2]));
    return {pv[0].f, beta.f};
  }
  __device__ static MV volume(const MV* pv) {
    return mv_mul(pv[3], mv_ipow(pv[0], 2));
  }
  __device__ static float ff(float q, const Cand& c) {
    const float qr = __fmul_rn(q, c.rg);
    const float res =
        __fmul_rn(gauss_debye_over_u(__fmul_rn(qr, qr)), c.beta);
    return q <= 0.0f ? c.beta : res;
  }
};

// 3: SphericalCoreShell (radius, t, eta_c, eta_s, eta_sol)
template <>
struct K1Model<3> {
  struct Cand {
    float r, rt, ratio, ds, dc;
  };
  __device__ static Cand setup(const MV* pv) {
    const MV rt = mv_add(pv[0], pv[1]);
    const MV vc = mv_mul(mv_fix(MC_PI43), mv_ipow(pv[0], 3));
    const MV vt = mv_mul(mv_fix(MC_PI43), mv_ipow(rt, 3));
    return {pv[0].f, rt.f, mv_div(vc, vt).f, mv_sub(pv[3], pv[4]).f,
            mv_sub(pv[3], pv[2]).f};
  }
  __device__ static MV volume(const MV* pv) {
    return mv_mul(mv_fix(MC_PI43), mv_ipow(mv_add(pv[0], pv[1]), 3));
  }
  __device__ static float ff(float q, const Cand& c) {
    const float ks = __fmul_rn(c.ds, sphere_ff(__fmul_rn(q, c.rt)));
    const float kc = __fmul_rn(c.dc, sphere_ff(__fmul_rn(q, c.r)));
    return __fsub_rn(ks, __fmul_rn(c.ratio, kc));
  }
};
