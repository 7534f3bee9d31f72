// The float64 partial-intensity bank of the Kholodenko worm for the post
// pass, on NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package evaluates this bank as jnp
// (mcsas_tpu/post/histogram.py over mcsas_tpu/models/chains.py), and the
// port's plain version is the eager chain of post/histogram.py::_bank_eager
// over models/chains.py::_kho_ff, whose converged rule (_kho_conv_rule)
// runs 512 recurrence steps of about 18 elementwise launches each on a
// (contributions, points) float64 state, then the 64 nodes of
// ops/special.py::sine_integral and the 64-node tail: about 11,000 launches
// a bank, each moving a few MB and computing almost nothing.  Added because
// that chain was the largest part of a worm fit on an H100, its pace set
// by the host's launches, not by the card.  Wrapper: ops/kho_bank.py,
// run_kho_bank.
//
// What it computes, for contribution b (radius r, Kuhn length k, x = 3
// contour / k, weight w = volume^comp2) and fit point i with grid row g
// (the fit q, or the slit's n_off points locs[i, :] with weights smear_w):
//
//   out[b, i] = w sum_off sw[off] (sqrt(P(t, x)) 2 j1_over_x(g r))^2,
//   t = g k / 3,
//
// P the converged rule of _kho_conv_rule on the nodes z_j = h j, j = 0..2N,
// h = min(x, Z_CUT) / 2N: for t < 1 Boole's rule over sinh(e z)/(e sinh z),
// e = sqrt(1 - t^2), sinh(e z_j) by the hyperbolic recurrence; else the
// closed form of the singular part, (2/x)[Si(FX) - (1 - cos FX)/(F x)],
// plus Filon-Simpson over sin(F z) phi(z), F = sqrt(t^2 - 1), sin(F z_j)
// by the rotation recurrence; for x > Z_CUT the 64-node Gauss-Legendre
// tail of _kho_fz beyond; P clamped at 0.  Every branch is the plain
// version's operations in its order, rounded as it rounds them (_rn
// intrinsics, no FMA): a recurrence step, Boole's and Filon's sums node 0
// first with a_o on odd and a_e on even nodes, Si's Taylor series and its
// Gauss-Laguerre nodes, the tail node by node.  A division by a constant
// is a division (PyTorch's on the CPU; on the card PyTorch multiplies by
// the reciprocal).  Only the branch an element takes is computed (the plain
// version computes both and selects).  What is left to differ is the math
// library's last bit, which the recurrences carry over their steps, and
// the order of the slit's sum.  J1 is the port's own (bank_common.cuh).
//
// What bounds it on this card: float64 arithmetic.  An element costs about
// 5,000 (t >= 1) to 11,000 (t < 1) float64 instructions: a step of the
// rotation is eight operations, of the hyperbolic recurrence ten and a
// division; an output writes 8 bytes.  Design: one block a contribution.
// Its threads first put the arrays that depend on x alone (phi, 1/sinh z
// and Boole's weight times g, 3 (2N + 1) doubles) and the rule's constants
// (the tail's and Si's nodes and weights, Si's Taylor coefficients) into
// shared memory; then one thread a fit point carries each of its offsets'
// recurrences in registers, reads the node arrays as broadcasts, and sums
// over the offsets in a register: no reduction across threads, one store a
// point.  A block has the fit points' count of threads rounded up to a
// warp, at most 256 (looping beyond); the bank of a fit (3000
// contributions) is 3000 blocks, a few waves over 132 SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bank_common.cuh"

#define KB_MAX_THREADS 256
#define KB_MAX_SMEM 49152  // bytes of shared memory without an opt-in
#define KB_EPS 1e-12       // the rule's clamp of 1 - t^2 and t^2 - 1
#define KB_HALF_PI 1.57079632679489661923  // np.pi / 2.0

struct KhoBankParams {
  const double* grid;     // (nq, n_off): q (n_off 1) or the slit's locs
  const double* smear_w;  // (n_off,); null: unsmeared, weight 1
  const double* radius;   // (n_contribs,)
  const double* kuhn;     // (n_contribs,): the Kuhn length
  const double* x;        // (n_contribs,): 3 contour / kuhn
  const double* weight;   // (n_contribs,): volume^comp2
  const double* rule;     // the tail's nodes and weights (n_tail each), Si's
                          // Laguerre u^2, w and w u (n_lag each), Si's
                          // Taylor coefficients of y^2k (n_taylor)
  double* out;            // (n_contribs, nq)
  double z_cut;           // Z_CUT: the head's window ends at min(x, z_cut)
  double si_cut;          // Si: Taylor below, Gauss-Laguerre from here
  int32_t n_contribs;
  int32_t nq;
  int32_t n_off;
  int32_t n_steps;        // 2N, a multiple of 4 (Boole)
  int32_t n_tail;
  int32_t n_lag;
  int32_t n_taylor;
  int32_t device;
};

// torch.clamp_min(v, lo) for v not NaN; a NaN stays NaN
__device__ __forceinline__ double kb_clamp_min(double v, double lo) {
  return v < lo ? lo : v;
}

// ops/special.py::sine_integral for y >= 0: the Taylor series below
// si_cut, else pi/2 - f cos y - g sin y with f, g by Gauss-Laguerre, the
// nodes in order
__device__ __forceinline__ double kb_sine_integral(
    double y, const KhoBankParams& p, const double* lag_u2,
    const double* lag_w, const double* lag_wu, const double* taylor) {
  if (y < p.si_cut) {
    const double t = __dmul_rn(y, y);
    double acc = taylor[p.n_taylor - 1];
    for (int k = p.n_taylor - 2; k >= 0; --k)
      acc = __dadd_rn(__dmul_rn(acc, t), taylor[k]);
    return __dmul_rn(y, acc);
  }
  const double y2 = __dmul_rn(y, y);
  double den = __drcp_rn(__dadd_rn(y2, lag_u2[0]));
  double f = __dmul_rn(den, lag_w[0]);
  double g = __dmul_rn(den, lag_wu[0]);
  for (int k = 1; k < p.n_lag; ++k) {
    den = __drcp_rn(__dadd_rn(y2, lag_u2[k]));
    f = __dadd_rn(f, __dmul_rn(den, lag_w[k]));
    g = __dadd_rn(g, __dmul_rn(den, lag_wu[k]));
  }
  f = __dmul_rn(f, y);
  return __dsub_rn(__dsub_rn(KB_HALF_PI, __dmul_rn(f, cos(y))),
                   __dmul_rn(g, sin(y)));
}

// models/chains.py::_kho_fz at z > 0 on the branch of t: sub (t < 1, with
// e) or sup (with f = F)
__device__ __forceinline__ double kb_fz(double z, bool below, double ef) {
  const double one_m_em2z = -expm1(__dmul_rn(-2.0, z));
  const double den = __dmul_rn(ef, __dadd_rn(one_m_em2z, KB_EPS));
  if (below) {
    const double num = __dmul_rn(exp(__dmul_rn(__dsub_rn(ef, 1.0), z)),
                                 -expm1(__dmul_rn(__dmul_rn(-2.0, ef), z)));
    return __ddiv_rn(num, den);
  }
  const double num = __dmul_rn(__dmul_rn(2.0, sin(__dmul_rn(ef, z))),
                               exp(-z));
  return __ddiv_rn(num, den);
}

// _kho_conv_rule of one element (t, x): X = min(x, z_cut), h = X / 2N,
// two_x = 2 / x, the node arrays of x in shared memory
__device__ __forceinline__ double kb_rule(
    double t, double x, double X, double h, double two_x,
    const KhoBankParams& p, const double* phi, const double* inv_sinh,
    const double* gw, const double* rule) {
  const int n2 = p.n_steps;
  const bool below = t < 1.0;
  const double tt = __dmul_rn(t, t);
  // e (t < 1) or F (t >= 1)
  const double ef = __dsqrt_rn(
      kb_clamp_min(below ? __dsub_rn(1.0, tt) : __dsub_rn(tt, 1.0), KB_EPS));
  const double eh = __dmul_rn(ef, h);
  double total;
  if (below) {
    // Boole's rule over f_sub(z_k) = sinh(e z_k)/(e sinh z_k); node 0 is
    // its limit 1
    const double sinh_d = sinh(eh), cosh_d = cosh(eh);
    double she = 0.0, che = 1.0;
    double a_sub = gw[0];
    for (int k = 1; k <= n2; ++k) {
      const double s1 = __dadd_rn(__dmul_rn(she, cosh_d),
                                  __dmul_rn(che, sinh_d));
      che = __dadd_rn(__dmul_rn(che, cosh_d), __dmul_rn(she, sinh_d));
      she = s1;
      a_sub = __dadd_rn(a_sub, __dmul_rn(gw[k],
                                         __ddiv_rn(__dmul_rn(she, inv_sinh[k]),
                                                   ef)));
    }
    total = a_sub;
  } else {
    const double sin_d = sin(eh), cos_d = cos(eh);
    double sF = 0.0, cF = 1.0;
    double a_e = __dmul_rn(phi[0], sF), a_o = 0.0;
    for (int k = 1; k <= n2; ++k) {
      const double s1 = __dadd_rn(__dmul_rn(sF, cos_d),
                                  __dmul_rn(cF, sin_d));
      cF = __dsub_rn(__dmul_rn(cF, cos_d), __dmul_rn(sF, sin_d));
      sF = s1;
      if (k & 1)
        a_o = __dadd_rn(a_o, __dmul_rn(phi[k], sF));
      else
        a_e = __dadd_rn(a_e, __dmul_rn(phi[k], sF));
    }
    // Filon-Simpson's alpha, beta, gamma of th = F h (_filon_coeffs)
    const double th = eh;
    double alpha, beta, gamma;
    if (th < 0.05) {
      // the series, innermost term first
      const double t2 = __dmul_rn(th, th);
      double in = __dsub_rn(2.0 / 315.0, __dmul_rn(t2, 2.0 / 4725.0));
      alpha = __dmul_rn(__dmul_rn(th, t2),
                        __dsub_rn(2.0 / 45.0, __dmul_rn(t2, in)));
      in = __dsub_rn(4.0 / 105.0, __dmul_rn(t2, 2.0 / 567.0));
      in = __dsub_rn(2.0 / 15.0, __dmul_rn(t2, in));
      beta = __dadd_rn(2.0 / 3.0, __dmul_rn(t2, in));
      in = __dsub_rn(1.0 / 210.0, __ddiv_rn(t2, 11340.0));
      in = __dsub_rn(2.0 / 15.0, __dmul_rn(t2, in));
      gamma = __dsub_rn(4.0 / 3.0, __dmul_rn(t2, in));
    } else {
      const double s = sin(th), c = cos(th);
      const double two_s = __dmul_rn(2.0, s);
      const double s2 = __dmul_rn(two_s, c), c2 = __dmul_rn(c, c);
      const double ts2 = __dmul_rn(th, th);
      const double ts3 = __dmul_rn(ts2, th);
      alpha = __dsub_rn(
          __dadd_rn(__drcp_rn(th), __ddiv_rn(s2, __dmul_rn(2.0, ts2))),
          __ddiv_rn(__dmul_rn(two_s, s), ts3));
      beta = __dmul_rn(2.0, __dsub_rn(__ddiv_rn(__dadd_rn(1.0, c2), ts2),
                                      __ddiv_rn(s2, ts3)));
      gamma = __dmul_rn(4.0, __dsub_rn(__ddiv_rn(s, ts3),
                                       __ddiv_rn(c, ts2)));
    }
    const double fx = __dmul_rn(ef, X);
    const double sXF = sin(fx), cXF = cos(fx);
    const double phi_end = phi[n2];
    const double S_e =
        __dsub_rn(a_e, __dmul_rn(__dmul_rn(0.5, phi_end), sXF));
    const double filon = __dmul_rn(
        h, __dadd_rn(__dadd_rn(__dmul_rn(__dmul_rn(-alpha, phi_end), cXF),
                               __dmul_rn(beta, S_e)),
                     __dmul_rn(gamma, a_o)));
    const int nt = p.n_tail;
    const double si = kb_sine_integral(fx, p, rule + 2 * nt,
                                       rule + 2 * nt + p.n_lag,
                                       rule + 2 * nt + 2 * p.n_lag,
                                       rule + 2 * nt + 3 * p.n_lag);
    const double sing = __dmul_rn(
        two_x, __dsub_rn(si, __ddiv_rn(__dsub_rn(1.0, cXF),
                                       __dmul_rn(ef, x))));
    total = __ddiv_rn(__dadd_rn(sing, __dmul_rn(2.0, filon)), ef);
  }
  if (x > p.z_cut) {
    // the smooth tail on [Z_CUT, x], node by node
    const double span = __dsub_rn(x, X);
    double tail = 0.0;
    for (int j = 0; j < p.n_tail; ++j) {
      const double zt = __dadd_rn(X, __dmul_rn(span, rule[j]));
      const double core = __dmul_rn(
          __dmul_rn(kb_fz(zt, below, ef), two_x),
          __dsub_rn(1.0, __ddiv_rn(zt, x)));
      tail = __dadd_rn(tail, __dmul_rn(__dmul_rn(span, rule[p.n_tail + j]),
                                       core));
    }
    total = __dadd_rn(total, tail);
  } else {
    total = __dadd_rn(total, 0.0);
  }
  return kb_clamp_min(total, 0.0);
}

__global__ void __launch_bounds__(KB_MAX_THREADS)
    kho_bank_kernel(const KhoBankParams p) {
  extern __shared__ double smem[];
  const int n2 = p.n_steps;
  double* phi = smem;
  double* inv_sinh = phi + (n2 + 1);
  double* gw = inv_sinh + (n2 + 1);
  double* rule = gw + (n2 + 1);
  const int n_rule = 2 * p.n_tail + 3 * p.n_lag + p.n_taylor;
  const int b = blockIdx.x;
  const double x = __ldg(p.x + b);
  const double X = x > p.z_cut ? p.z_cut : x;
  const double h = __ddiv_rn(X, (double)n2);
  const double two_x = __dmul_rn(__drcp_rn(x), 2.0);
  const double boole = __ddiv_rn(__dmul_rn(2.0, h), 45.0);
  for (int r = threadIdx.x; r < n_rule; r += blockDim.x)
    rule[r] = __ldg(p.rule + r);
  // the node arrays of x: g = (2/x)(1 - z/x), s(z) = 1/(2 sinh z) - 1/(2z)
  // (its series below 0.1), phi = g s, 1/sinh z (0 at z = 0), Boole's
  // weight [7, 32, 12, 32, 14, ..., 32, 7] times 2h/45 times g
  for (int j = threadIdx.x; j <= n2; j += blockDim.x) {
    const double z = __dmul_rn(h, (double)j);
    const double g = __dmul_rn(two_x, __dsub_rn(1.0, __ddiv_rn(z, x)));
    const double sh = z > 0.0 ? sinh(z) : 1.0;
    double s;
    if (z < 0.1) {
      const double z2 = __dmul_rn(z, z);
      const double in = __dsub_rn(7.0 / 720.0, __dmul_rn(z2, 31.0 / 30240.0));
      s = __dmul_rn(z, __dadd_rn(-1.0 / 12.0, __dmul_rn(z2, in)));
    } else {
      s = __dsub_rn(__dmul_rn(__drcp_rn(sh), 0.5),
                    __dmul_rn(__drcp_rn(z), 0.5));
    }
    phi[j] = __dmul_rn(g, s);
    inv_sinh[j] = z <= 0.0 ? 0.0 : __drcp_rn(sh);
    const double wb = (j == 0 || j == n2) ? 7.0
                      : (j & 1)           ? 32.0
                      : (j & 3) == 2      ? 12.0
                                          : 14.0;
    gw[j] = __dmul_rn(__dmul_rn(wb, boole), g);
  }
  __syncthreads();
  const double R = __ldg(p.radius + b);
  const double K = __ldg(p.kuhn + b);
  const double w = __ldg(p.weight + b);
  for (int i = threadIdx.x; i < p.nq; i += blockDim.x) {
    const double* g = p.grid + (size_t)i * p.n_off;
    double acc = 0.0;
    for (int off = 0; off < p.n_off; ++off) {
      const double gv = __ldg(g + off);
      const double t = __ddiv_rn(__dmul_rn(gv, K), 3.0);
      const double P = kb_rule(t, x, X, h, two_x, p, phi, inv_sinh, gw,
                               rule);
      const double pcs = __dmul_rn(2.0, cb_j1_over_x(__dmul_rn(gv, R)));
      const double f = __dmul_rn(__dsqrt_rn(P), pcs);
      const double it = __dmul_rn(f, f);
      acc = p.smear_w ? __dadd_rn(acc, __dmul_rn(it, __ldg(p.smear_w + off)))
                      : it;
    }
    p.out[(size_t)b * p.nq + i] = __dmul_rn(acc, w);
  }
}

static inline int kb_threads(const KhoBankParams& p) {
  const int warps = (p.nq + 31) / 32;
  return warps * 32 < KB_MAX_THREADS ? warps * 32 : KB_MAX_THREADS;
}

static inline size_t kb_smem(const KhoBankParams& p) {
  return sizeof(double) * ((size_t)3 * (p.n_steps + 1) + 2 * p.n_tail +
                           3 * p.n_lag + p.n_taylor);
}

static inline int kb_check(const KhoBankParams& p) {
  if (!p.grid || !p.radius || !p.kuhn || !p.x || !p.weight || !p.rule ||
      p.n_contribs < 1 || p.nq < 1 || p.n_off < 1 || p.n_steps < 4 ||
      p.n_steps % 4 != 0 || p.n_tail < 1 || p.n_lag < 1 || p.n_taylor < 1 ||
      (p.n_off > 1 && !p.smear_w) || kb_smem(p) > KB_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

static int kb_go(const KhoBankParams* hp, cudaStream_t stream, int* out) {
  const KhoBankParams p = *hp;
  int err = kb_check(p);
  if (err != (int)cudaSuccess) return err;
  err = (int)cudaSetDevice(p.device);
  if (err != (int)cudaSuccess) return err;
  const int threads = kb_threads(p);
  const size_t smem = kb_smem(p);
  if (out) {
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(&attr, kho_bank_kernel);
    out[0] = threads;
    out[1] = p.n_contribs;
    out[2] = (int)smem;
    out[3] = e == cudaSuccess ? attr.numRegs : -1;
    out[4] = e == cudaSuccess ? (int)attr.localSizeBytes : -1;
    return (int)e;
  }
  kho_bank_kernel<<<(unsigned)p.n_contribs, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int kho_bank_params_size(void) {
  return (int)sizeof(KhoBankParams);
}

extern "C" const char* kho_bank_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches the bank on `stream`; returns a cudaError_t code (0: launched).
extern "C" int kho_bank_launch(const KhoBankParams* hp, void* stream) {
  if (!hp->out) return (int)cudaErrorInvalidValue;
  return kb_go(hp, (cudaStream_t)stream, nullptr);
}

// The launch shape into out[5]: threads per block, blocks, shared memory
// bytes per block, registers and local memory bytes per thread.
extern "C" int kho_bank_shape(const KhoBankParams* hp, int* out) {
  return kb_go(hp, nullptr, out);
}
