// Fused Monte-Carlo chunk kernel for NVIDIA Hopper (sm_90a).
//
// Replaces: mcsas_tpu/ops/mc_kernel.py, build_chunk_fn -- the Pallas TPU
// kernel (its body `kernel` and `_candidate_solve`) that runs a whole chunk
// of accept/reject MC steps for every repetition in one launch.
//
// What bounds it on this card: latency.  A chunk is n_steps strictly
// sequential steps per repetition.  A step evaluates K candidate rows over
// Nq points (one sin/cos pair per point: K*Nq = 12,800 at the headline
// shape K=128, Nq=100), four float64 sums per candidate, a K-way
// first-minimum reduction and a conditional state update, with block
// barriers in between.  It moves little memory: one bank row (Nq floats)
// in and at most one out per step.
//
// Design (simple and right first):
// * One block per repetition; threads over the K candidates, each looping
//   over q.  Only R of the 132 SMs are busy (10 at the headline shape);
//   warp-level candidate tiling, more blocks per repetition and CUDA
//   graphs are later work.
// * q, y, u, ft and ft - bank[ri] live in shared memory.  The (R, N, Nq)
//   bank stays in global memory; a step touches only row ri.  Candidate
//   rows go to a global scratch laid out (R, Nq, K), so neighbouring
//   threads write neighbouring addresses and the rows stay in L1/L2 until
//   the accepted one is copied into the bank.
// * Rounding follows the plain PyTorch version (ops/mc_kernel.py,
//   chunk_reference; the solve and the tie rule are in mc_common.cuh):
//   __fmul_rn/__fadd_rn keep nvcc from contracting into
//   FMAs, the solve's sums accumulate in float64, rows, ft and the stored
//   state stay float32.  The transcendentals are the precise sincosf, powf
//   and expf: build without --use_fast_math (approximate transcendentals
//   stalled the convergence of a sphere kernel before).
// * Best-of-K: lowest chi2 wins, the lowest k on ties; a NaN chi2 counts
//   as +inf and so is never accepted.
// * Proposals: injected (S, R, K, P) tensor, or Philox4x32-10 keyed by
//   (seed, rep) and counted by (step, k, parameter, 0); the top 24 bits of
//   word 0 make a unit uniform.
// * The launcher returns cudaGetLastError(); it neither synchronizes nor
//   allocates.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mc_common.cuh"

#define MC_MAX_P 8
#define MC_MAX_THREADS 256

// Field order and types mirror _ChunkParams in ops/mc_kernel.py.
struct ChunkParams {
  const float* q;          // (nq,) fit grid
  const float* y;          // (nq,) data
  const float* u;          // (nq,) weights 1/sigma^2
  float* rset;             // (R, N, P)
  float* ibank;            // (R, N, nq)
  float* ft;               // (R, nq)
  float* scale;            // (R,)
  float* background;       // (R,)
  float* conval;           // (R,)
  int32_t* n_iter;         // (R,)
  int32_t* n_moves;        // (R,)
  float* rows;             // scratch (R, nq, K)
  const float* proposals;  // (S, R, K, P) or null: Philox mode
  int32_t* trace;          // (S, R) chosen k or -1, or null
  double s_u;
  double s_uy;
  float lo[MC_MAX_P];
  float hi[MC_MAX_P];
  float crit;
  float local_scale;
  float inv_v_ref;
  float comp2;
  float inv_i_ref;
  float row_clamp;
  int32_t gen[MC_MAX_P];   // 0 uniform, 1..3 logdec1..3
  int32_t n_reps;
  int32_t n_contribs;
  int32_t nq;
  int32_t n_params;
  int32_t k_cand;
  int32_t k_global;
  int32_t n_steps;
  int32_t ri0;
  int32_t max_iter;
  int32_t n_fit;
  int32_t model_id;        // 0: Sphere
  int32_t find_bg;
  int32_t pos_bg;
  int32_t device;
  uint32_t seed;
};

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

// 3(sin x - x cos x)/x^3 with the float32 Taylor switch of ops/special.py
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

// sqrt of the normalized weight (v*inv_v_ref)^comp2 / i_ref of one sphere
__device__ __forceinline__ float sphere_sqrt_weight(float radius,
                                                    const ChunkParams& p) {
  const float pi43 = (float)(4.0 * 3.14159265358979323846 / 3.0);
  const float v = __fmul_rn(pi43, __fmul_rn(__fmul_rn(radius, radius),
                                            radius));
  const float w = __fmul_rn(powf(__fmul_rn(v, p.inv_v_ref), p.comp2),
                            p.inv_i_ref);
  return __fsqrt_rn(w);
}

// amplitude-level row (ff*sqrt(w))^2, clamped (NaN stays NaN)
__device__ __forceinline__ float sphere_row(float q, float radius, float sw,
                                            float clamp) {
  const float fs = __fmul_rn(sphere_ff(__fmul_rn(q, radius)), sw);
  const float row = __fmul_rn(fs, fs);
  return row > clamp ? clamp : row;
}

__global__ void __launch_bounds__(MC_MAX_THREADS)
mc_chunk_kernel(const ChunkParams p) {
  extern __shared__ float smem[];
  __shared__ float red_chi[MC_MAX_THREADS / 32];
  __shared__ int red_k[MC_MAX_THREADS / 32];
  __shared__ float sh_conval, sh_scale, sh_bg;
  __shared__ int sh_niter, sh_nmoves, sh_best_k, sh_accept, sh_active;

  const int nq = p.nq, K = p.k_cand, P = p.n_params, N = p.n_contribs;
  const int r = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  float* s_q = smem;
  float* s_y = s_q + nq;
  float* s_u = s_y + nq;
  float* s_ft = s_u + nq;
  float* s_base = s_ft + nq;
  float* bank = p.ibank + (size_t)r * N * nq;
  float* rows = p.rows + (size_t)r * nq * K;
  float* rset = p.rset + (size_t)r * N * P;

  // drift-free start: rebuild the totals from the bank (float64 sum)
  for (int i = tid; i < nq; i += nthr) {
    s_q[i] = p.q[i];
    s_y[i] = p.y[i];
    s_u[i] = p.u[i];
    double acc = 0.0;
    for (int n = 0; n < N; ++n) acc += (double)bank[(size_t)n * nq + i];
    s_ft[i] = (float)acc;
  }
  if (tid == 0) {
    sh_conval = p.conval[r];
    sh_scale = p.scale[r];
    sh_bg = p.background[r];
    sh_niter = p.n_iter[r];
    sh_nmoves = p.n_moves[r];
  }
  __syncthreads();

  for (int s = 0; s < p.n_steps; ++s) {
    const int ri = (int)(((long long)p.ri0 + s) % N);
    float* bank_row = bank + (size_t)ri * nq;
    if (tid == 0)
      sh_active = sh_conval > p.crit && sh_niter < p.max_iter;
    for (int i = tid; i < nq; i += nthr)
      s_base[i] = __fsub_rn(s_ft[i], bank_row[i]);
    __syncthreads();
    if (!sh_active) {
      // nothing changes for an inactive repetition: its state, and so its
      // activity, stay as they are for the rest of the chunk
      if (p.trace)
        for (int t = s + tid; t < p.n_steps; t += nthr)
          p.trace[(size_t)t * p.n_reps + r] = -1;
      break;
    }

    float my_chi = INFINITY, my_a = 0.0f, my_b = 0.0f;
    int my_k = INT_MAX;
    float my_p[MC_MAX_P];
    for (int k = tid; k < K; k += nthr) {
      float prm[MC_MAX_P];
#pragma unroll
      for (int ip = 0; ip < MC_MAX_P; ++ip) {
        if (ip >= P) break;
        float v;
        if (p.proposals) {
          v = p.proposals[(((size_t)s * p.n_reps + r) * K + k) * P + ip];
        } else {
          const uint32_t bits = philox_x0((uint32_t)s, (uint32_t)k,
                                          (uint32_t)ip, 0u, p.seed,
                                          (uint32_t)r);
          v = __fmul_rn((float)(bits >> 8), 5.9604644775390625e-08f);
          if (k < p.k_global)
            v = __fadd_rn(__fmul_rn(gen_transform(v, p.gen[ip]),
                                    __fsub_rn(p.hi[ip], p.lo[ip])),
                          p.lo[ip]);
        }
        if (k >= p.k_global) {
          // local move: the slot's value times exp((2v - 1) * scale)
          const float cur = rset[(size_t)ri * P + ip];
          const float f = expf(__fmul_rn(
              __fsub_rn(__fmul_rn(2.0f, v), 1.0f), p.local_scale));
          v = fminf(fmaxf(__fmul_rn(cur, f), p.lo[ip]), p.hi[ip]);
        }
        prm[ip] = v;
      }

      const float radius = prm[0];
      const float sw = sphere_sqrt_weight(radius, p);
      double sx = 0.0, sxx = 0.0, sxy = 0.0;
      for (int i = 0; i < nq; ++i) {
        const float row = sphere_row(s_q[i], radius, sw, p.row_clamp);
        rows[(size_t)i * K + k] = row;
        const float x = __fadd_rn(s_base[i], row);
        const float ux = __fmul_rn(s_u[i], x);
        sx += (double)ux;
        sxx += (double)__fmul_rn(ux, x);
        sxy += (double)__fmul_rn(ux, s_y[i]);
      }
      float a, b;
      mc_solve_scale_bg(sx, sxx, sxy, p.s_u, p.s_uy, p.find_bg, p.pos_bg,
                        &a, &b);
      double srr = 0.0;
      for (int i = 0; i < nq; ++i) {
        const float x = __fadd_rn(s_base[i], rows[(size_t)i * K + k]);
        const float res = __fsub_rn(__fsub_rn(s_y[i], __fmul_rn(a, x)), b);
        srr += (double)__fmul_rn(__fmul_rn(s_u[i], res), res);
      }
      float chi = (float)(srr / (double)p.n_fit);
      if (isnan(chi)) chi = INFINITY;
      if (mc_better(chi, k, my_chi, my_k)) {
        my_chi = chi;
        my_k = k;
        my_a = a;
        my_b = b;
#pragma unroll
        for (int ip = 0; ip < MC_MAX_P; ++ip) my_p[ip] = prm[ip];
      }
    }

    // best-of-K: warp shuffles, then one value per warp through smem
    float red_c = my_chi;
    int red_i = my_k;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float oc = __shfl_down_sync(0xffffffffu, red_c, off);
      const int oi = __shfl_down_sync(0xffffffffu, red_i, off);
      if (mc_better(oc, oi, red_c, red_i)) {
        red_c = oc;
        red_i = oi;
      }
    }
    if ((tid & 31) == 0) {
      red_chi[tid >> 5] = red_c;
      red_k[tid >> 5] = red_i;
    }
    __syncthreads();
    if (tid == 0) {
      float c = red_chi[0];
      int kb = red_k[0];
      for (int w = 1; w < nthr / 32; ++w)
        if (mc_better(red_chi[w], red_k[w], c, kb)) {
          c = red_chi[w];
          kb = red_k[w];
        }
      const int accept = c < sh_conval;
      sh_best_k = kb;
      sh_accept = accept;
      sh_niter += K;
      if (accept) {
        sh_conval = c;
        sh_nmoves += 1;
      }
      if (p.trace) p.trace[(size_t)s * p.n_reps + r] = accept ? kb : -1;
    }
    __syncthreads();
    if (sh_accept) {
      const int kb = sh_best_k;
      for (int i = tid; i < nq; i += nthr) {
        const float row = rows[(size_t)i * K + kb];
        bank_row[i] = row;
        s_ft[i] = __fadd_rn(s_base[i], row);
      }
      if (my_k == kb) {
        for (int ip = 0; ip < P; ++ip) rset[(size_t)ri * P + ip] = my_p[ip];
        sh_scale = my_a;
        sh_bg = my_b;
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < nq; i += nthr) p.ft[(size_t)r * nq + i] = s_ft[i];
  if (tid == 0) {
    p.scale[r] = sh_scale;
    p.background[r] = sh_bg;
    p.conval[r] = sh_conval;
    p.n_iter[r] = sh_niter;
    p.n_moves[r] = sh_nmoves;
  }
}

extern "C" int mc_chunk_params_size(void) {
  return (int)sizeof(ChunkParams);
}

extern "C" const char* mc_chunk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches one chunk on `stream`; returns a cudaError_t code (0: launched).
extern "C" int mc_chunk_launch(const ChunkParams* hp, void* stream) {
  const ChunkParams p = *hp;
  if (p.model_id != 0 || p.n_params < 1 || p.n_params > MC_MAX_P ||
      p.k_cand < 1 || p.k_global < 0 || p.k_global > p.k_cand ||
      p.nq < 1 || p.n_reps < 1 || p.n_contribs < 1 || p.n_steps < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(p.device);
  if (err != cudaSuccess) return (int)err;
  int threads = ((p.k_cand + 31) / 32) * 32;
  if (threads > MC_MAX_THREADS) threads = MC_MAX_THREADS;
  const size_t smem = (size_t)5 * p.nq * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(mc_chunk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mc_chunk_kernel<<<p.n_reps, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
