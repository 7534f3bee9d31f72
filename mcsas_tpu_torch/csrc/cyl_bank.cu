// The float64 partial-intensity bank of orientation-averaged cylinders
// (CylindersIsotropic) for the post pass, on NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package evaluates this bank as jnp
// (mcsas_tpu/post/histogram.py), and the port's plain version is the
// eager chain of post/histogram.py::_bank_eager over models/cylinders.py::
// _cyl_iso_ff_ab, which materializes a (block, Nq, n_off, nodes) float64
// temporary for each of its twenty-odd elementwise operations.  Added
// because that chain set the pace of a slit-smeared cylinder fit (the post
// pass three quarters of it on an H100).  Wrapper: ops/cyl_bank.py,
// run_cyl_bank.
//
// What it computes, for contribution b (radius R, length L = 2 half, weight
// w = volume^comp2) and fit point i, with g the point's grid row -- the fit
// q, or the slit's n_off evaluation points locs[i, :] with weights
// smear_w -- and x_j = linspace(0, 1, n):
//
//   out[b, i] = 16 step w  sum_off sw[off] ( sum_{0<j<n-1} f_j^2
//                                            + (f_0^2 + f_{n-1}^2) / 2 )
//   f_j     = J1(a s_j) sin(c x_j / 2) / ((a s_j)(c x_j)),  s_j = sqrt(1-x_j^2)
//   f_0     = j1_over_x(a) / 2,   f_{n-1} = sinc_sin(c / 2),
//   a = g R,  c = g L,
//
// the trapezoid of _cyl_iso_ff_ab with ff^2 = (sqrt(16 integral))^2 taken as
// 16 integral and the contraction with smear_w moved inside the sum (all
// terms are positive: this changes the last bits only).  J1 is the port's
// own approximation (ops/special.py::bessel_j1, Abramowitz & Stegun 9.4.4 /
// 9.4.6, its coefficients and its |x| <= 3 switch; bank_common.cuh, shared
// with kho_bank.cu), not CUDA's j1(): the two differ by the polynomial's
// ~1e-8.  The operations that feed sin and
// cos (a s_j, c x_j, the phase ax + theta(3/ax)) are the plain version's,
// in its order and rounded as it rounds them (_rn intrinsics, no FMA), so
// that the arguments of the transcendentals are the same bits; what is
// left to differ is the math library's last bit and the order of the sum.
//
// What bounds it on this card: float64 arithmetic.  A node costs two
// transcendentals, a square root, a reciprocal and two divisions, about 150
// float64 instructions, and reads four values that every block shares (L1
// hits); the only write is the (B, Nq) bank.  Design: a group of kG lanes
// per output (32 where an output has 256 interior pairs or more, else 8,
// so that few lanes idle on the unsmeared 98 pairs); the lanes stride over the flattened interior pairs,
// then over the offsets' endpoint pairs, and sum in float64 registers; a
// shuffle tree reduces the group and one lane stores.  256 threads a block;
// the 1D bank of a fit (3000 contributions x 100 points) is 9,375 or
// 37,500 blocks, many waves over 132 SMs, so the tail is small.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bank_common.cuh"

#define CB_THREADS 256

struct CylBankParams {
  const double* grid;     // (nq, n_off): q (n_off 1) or the slit's locs
  const double* smear_w;  // (n_off,); null: unsmeared, weight 1
  const double* radius;   // (n_contribs,)
  const double* length;   // (n_contribs,): 2 x the half-length
  const double* weight;   // (n_contribs,): volume^comp2
  const double* x;        // (n_nodes - 2,): linspace(0, 1, n_nodes)[1:-1]
  const double* s;        // (n_nodes - 2,): sqrt(1 - x^2)
  double* out;            // (n_contribs, nq)
  double step;            // the trapezoid's step, 1 / (n_nodes - 1)
  int32_t n_contribs;
  int32_t nq;
  int32_t n_off;
  int32_t n_nodes;        // >= 2
  int32_t device;
};

// ops/special.py::sinc_sin in float64: the series below |x| < 0.05
__device__ __forceinline__ double cb_sinc_sin(double x) {
  if (fabs(x) < 0.05) {
    const double x2 = __dmul_rn(x, x);
    const double inner = __dadd_rn(-1.0 / 6.0, __dmul_rn(x2, 1.0 / 120.0));
    return __dadd_rn(1.0, __dmul_rn(x2, inner));
  }
  return __ddiv_rn(sin(x), x);
}

template <int kG>
__global__ void __launch_bounds__(CB_THREADS)
    cyl_bank_kernel(const CylBankParams p) {
  const int lane = threadIdx.x & (kG - 1);
  const long long total = (long long)p.n_contribs * p.nq;
  const long long o_raw =
      (long long)blockIdx.x * (CB_THREADS / kG) + threadIdx.x / kG;
  // a group past the end computes the last output again and stores
  // nothing: every lane of the warp stays for the shuffles
  const long long o = o_raw < total ? o_raw : total - 1;
  const int b = (int)(o / p.nq);
  const int qi = (int)(o - (long long)b * p.nq);
  const double R = __ldg(p.radius + b);
  const double L = __ldg(p.length + b);
  const double* g = p.grid + (size_t)qi * p.n_off;
  const double* sw = p.smear_w;
  const int m = p.n_nodes - 2;
  double acc = 0.0;
  // interior nodes: the (offset, node) pairs of this output, flattened
  const int pairs = m * p.n_off;
  int off = m > 0 ? lane / m : 0;
  int j = lane - off * m;
  for (int k = lane; k < pairs; k += kG) {
    const double gv = __ldg(g + off);
    const double qr = __dmul_rn(__dmul_rn(gv, R), __ldg(p.s + j));
    const double ql = __dmul_rn(__dmul_rn(gv, L), __ldg(p.x + j));
    const double num = __dmul_rn(cb_j1(qr), sin(__dmul_rn(ql, 0.5)));
    const double f = __ddiv_rn(num, __dmul_rn(qr, ql));
    double t = f * f;
    if (sw) t *= __ldg(sw + off);
    acc += t;
    j += kG;
    while (j >= m) {
      j -= m;
      ++off;
    }
  }
  // the endpoints' limits at half weight, one offset a lane
  for (int e = lane; e < p.n_off; e += kG) {
    const double gv = __ldg(g + e);
    const double f0 = 0.5 * cb_j1_over_x(__dmul_rn(gv, R));
    const double f1 = cb_sinc_sin(__dmul_rn(gv, L) * 0.5);
    double t = 0.5 * (f0 * f0 + f1 * f1);
    if (sw) t *= __ldg(sw + e);
    acc += t;
  }
#pragma unroll
  for (int d = kG / 2; d > 0; d >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, d, kG);
  if (lane == 0 && o_raw < total)
    p.out[o] = 16.0 * p.step * acc * __ldg(p.weight + b);
}

// lanes per output: 32 where an output has enough interior pairs to keep
// a warp's lanes busy, else 8
static inline int cb_group(const CylBankParams& p) {
  return (long long)(p.n_nodes - 2) * p.n_off >= 256 ? 32 : 8;
}

static inline int cb_check(const CylBankParams& p) {
  if (!p.grid || !p.radius || !p.length || !p.weight ||
      p.n_contribs < 1 || p.nq < 1 || p.n_off < 1 || p.n_nodes < 2 ||
      (p.n_nodes > 2 && (!p.x || !p.s)) || (p.n_off > 1 && !p.smear_w))
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

template <int kG>
static int cb_run(const CylBankParams& p, cudaStream_t stream, int* out) {
  const long long total = (long long)p.n_contribs * p.nq;
  constexpr int per_block = CB_THREADS / kG;
  const long long blocks = (total + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(p.device);
  if (err != cudaSuccess) return (int)err;
  if (out) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, cyl_bank_kernel<kG>);
    out[0] = kG;
    out[1] = CB_THREADS;
    out[2] = (int)blocks;
    out[3] = err == cudaSuccess ? attr.numRegs : -1;
    out[4] = err == cudaSuccess ? (int)attr.localSizeBytes : -1;
    return (int)err;
  }
  cyl_bank_kernel<kG><<<(unsigned)blocks, CB_THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

static int cb_go(const CylBankParams* hp, cudaStream_t stream, int* out) {
  const CylBankParams p = *hp;
  const int err = cb_check(p);
  if (err != (int)cudaSuccess) return err;
  return cb_group(p) == 32 ? cb_run<32>(p, stream, out)
                           : cb_run<8>(p, stream, out);
}

extern "C" int cyl_bank_params_size(void) {
  return (int)sizeof(CylBankParams);
}

extern "C" const char* cyl_bank_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches the bank on `stream`; returns a cudaError_t code (0: launched).
extern "C" int cyl_bank_launch(const CylBankParams* hp, void* stream) {
  if (!hp->out) return (int)cudaErrorInvalidValue;
  return cb_go(hp, (cudaStream_t)stream, nullptr);
}

// The launch shape into out[5]: lanes per output, threads per block,
// blocks, registers and local memory bytes per thread.
extern "C" int cyl_bank_shape(const CylBankParams* hp, int* out) {
  return cb_go(hp, nullptr, out);
}
