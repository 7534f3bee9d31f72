// The step loop of the fused chunk kernel K1, templated on the model
// (K1Model<kModel>, mc_models.cuh) and on how much of the step runs
// (kLevel).  mc_chunk.cu instantiates the whole step, MC_LV_FULL, for
// each model; the latency probe mc_probe.cu (K3) instantiates the rungs
// that cut the same step short, so that it measures the code that runs.
//
// Replaces: mcsas_tpu/ops/mc_kernel.py, build_chunk_fn -- the Pallas TPU
// kernel (its body `kernel` and `_candidate_solve`) that runs a whole chunk
// of accept/reject MC steps for every repetition in one launch.
//
// What bounds it on this card: latency.  A chunk is n_steps strictly
// sequential steps per repetition.  A step evaluates K candidate rows over
// Nq points (one or two sin/cos pairs, or an exp, per point: K*Nq = 12,800
// points at the headline shape K=128, Nq=100), four float64 sums per
// candidate, a K-way first-minimum reduction and a conditional state
// update, with block barriers in between.  It moves little memory: one
// bank row (Nq floats) in and at most one out per step.
//
// Design (simple and right first):
// * One block per repetition; threads over the K candidates, each looping
//   over q.  Only R of the 132 SMs are busy (10 at the headline shape).
// * q, y, u, ft and ft - bank[ri] live in shared memory.  The (R, N, Nq)
//   bank stays in global memory; a step touches only row ri.  Candidate
//   rows go to a global scratch laid out (R, Nq, K), so neighbouring
//   threads write neighbouring addresses and the rows stay in L1/L2 until
//   the accepted one is copied into the bank.
// * The model is a template parameter: the block takes one branch of the
//   host's switch on model_id, so no thread diverges on it.
// * Rounding follows the plain PyTorch version (ops/mc_kernel.py,
//   chunk_reference; the rows as mc_models.cuh says, the solve and the
//   tie rule in mc_common.cuh): the solve's sums accumulate in float64,
//   rows, ft and the stored state stay float32.
// * Best-of-K: lowest chi2 wins, the lowest k on ties; a NaN chi2 counts
//   as +inf and so is never accepted.
// * Proposals: injected (S, R, K, P) tensor, or Philox4x32-10 keyed by
//   (seed, rep) and counted by (step, k, parameter, 0); the top 24 bits of
//   word 0 make a unit uniform.
// * The launcher returns cudaGetLastError(); it neither synchronizes nor
//   allocates.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mc_common.cuh"
#include "mc_models.cuh"

#define MC_MAX_THREADS 256

// how much of a step runs (the rungs of the probe, tools/kern_probe.py)
enum {
  MC_LV_LOOP = 0,       // cursor, activity, ft - bank[ri], barriers
  MC_LV_RNG = 1,        // + the K proposals (Philox or injected, local)
  MC_LV_FF = 2,         // + the K candidate rows into the scratch
  MC_LV_SOLVE = 3,      // + float64 sums, solve, residual pass, best-of-K
  MC_LV_SOLVE_MOM = 4,  // SOLVE with chi2 from the moments, no residual
                        //   pass: that idea's ceiling, never production
  MC_LV_FULL = 5        // + accept and state writes: K1 itself
};

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
  double comp2;            // 2 * compensation exponent
  double pfix[MC_MAX_MODEL_P];   // each model parameter's fixed value
  float lo[MC_MAX_P];
  float hi[MC_MAX_P];
  float crit;
  float local_scale;
  float inv_v_ref;
  float inv_i_ref;
  float row_clamp;
  float sw_fixed;          // sqrt(w) where the volume has no active param
  int32_t gen[MC_MAX_P];   // 0 uniform, 1..3 logdec1..3
  int32_t pcol[MC_MAX_MODEL_P];  // its active column, or -1: fixed
  int32_t n_reps;
  int32_t n_contribs;
  int32_t nq;
  int32_t n_params;
  int32_t n_model_params;
  int32_t k_cand;
  int32_t k_global;
  int32_t n_steps;
  int32_t ri0;
  int32_t max_iter;
  int32_t n_fit;
  int32_t model_id;        // mc_models.cuh: 0 Sphere, 1 LMADenseSphere,
                           // 2 GaussianChain, 3 SphericalCoreShell
  int32_t vol_fixed;       // 1: rows use sw_fixed
  int32_t find_bg;
  int32_t pos_bg;
  int32_t device;
  uint32_t seed;
};

// sqrt of the normalized weight (v*inv_v_ref)^comp2 / i_ref
__device__ __forceinline__ float mc_sqrt_weight(MV v, const ChunkParams& p) {
  if (p.vol_fixed) return p.sw_fixed;
  const float w = __fmul_rn(
      torch_powf(__fmul_rn(v.f, p.inv_v_ref), p.comp2), p.inv_i_ref);
  return __fsqrt_rn(w);
}

template <int kModel, int kLevel>
__global__ void __launch_bounds__(MC_MAX_THREADS)
mc_chunk_kernel(const ChunkParams p) {
  using Model = K1Model<kModel>;
  extern __shared__ float smem[];
  __shared__ float red_chi[MC_MAX_THREADS / 32];
  __shared__ int red_k[MC_MAX_THREADS / 32];
  __shared__ float sh_conval, sh_scale, sh_bg;
  __shared__ int sh_niter, sh_nmoves, sh_best_k, sh_accept, sh_active;
  __shared__ double sh_uyy;

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
  if (kLevel == MC_LV_SOLVE_MOM) {
    if (tid == 0) {
      double acc = 0.0;
      for (int i = 0; i < nq; ++i)
        acc += (double)__fmul_rn(__fmul_rn(s_u[i], s_y[i]), s_y[i]);
      sh_uyy = acc;
    }
    __syncthreads();
  }
  float sink = 0.0f;   // what a rung below FULL leaves behind

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
    if (kLevel == MC_LV_LOOP) sink = __fadd_rn(sink, s_base[tid % nq]);

    float my_chi = INFINITY, my_a = 0.0f, my_b = 0.0f;
    int my_k = INT_MAX;
    float my_p[MC_MAX_P];
    for (int k = tid; k < (kLevel >= MC_LV_RNG ? K : 0); k += nthr) {
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
        if (kLevel == MC_LV_RNG) sink = __fadd_rn(sink, v);
      }
      if (kLevel == MC_LV_RNG) continue;

      // the candidate's full parameter list: active columns and the fixed
      // values, in the model's declaration order (BoundModel.pdict)
      MV pv[MC_MAX_MODEL_P];
#pragma unroll
      for (int j = 0; j < MC_MAX_MODEL_P; ++j) {
        if (j >= p.n_model_params) break;
        const int col = p.pcol[j];
        float v = 0.0f;   // prm[col], without indexing prm at run time
#pragma unroll
        for (int c = 0; c < MC_MAX_P; ++c)
          if (c == col) v = prm[c];
        pv[j] = col >= 0 ? mv_act(v) : mv_fix(p.pfix[j]);
      }
      const typename Model::Cand cand = Model::setup(pv);
      const float sw = mc_sqrt_weight(Model::volume(pv), p);
      double sx = 0.0, sxx = 0.0, sxy = 0.0;
      float fsum = 0.0f;
      for (int i = 0; i < nq; ++i) {
        // amplitude-level row (ff*sqrt(w))^2, clamped (NaN stays NaN)
        const float fs = __fmul_rn(Model::ff(s_q[i], cand), sw);
        float row = __fmul_rn(fs, fs);
        row = row > p.row_clamp ? p.row_clamp : row;
        rows[(size_t)i * K + k] = row;
        if (kLevel == MC_LV_FF) {
          fsum = __fadd_rn(fsum, row);
          continue;
        }
        const float x = __fadd_rn(s_base[i], row);
        const float ux = __fmul_rn(s_u[i], x);
        sx += (double)ux;
        sxx += (double)__fmul_rn(ux, x);
        sxy += (double)__fmul_rn(ux, s_y[i]);
      }
      if (kLevel == MC_LV_FF) {
        sink = __fadd_rn(sink, fsum);
        continue;
      }
      float a, b;
      mc_solve_scale_bg(sx, sxx, sxy, p.s_u, p.s_uy, p.find_bg, p.pos_bg,
                        &a, &b);
      float chi;
      if (kLevel == MC_LV_SOLVE_MOM) {
        // sum u(y - a x - b)^2 expanded into the moments in hand
        const double da = a, db = b;
        const double srr = sh_uyy - 2.0 * da * sxy - 2.0 * db * p.s_uy +
                           da * da * sxx + 2.0 * da * db * sx +
                           db * db * p.s_u;
        chi = (float)(srr / (double)p.n_fit);
      } else {
        double srr = 0.0;
        for (int i = 0; i < nq; ++i) {
          const float x = __fadd_rn(s_base[i], rows[(size_t)i * K + k]);
          const float res =
              __fsub_rn(__fsub_rn(s_y[i], __fmul_rn(a, x)), b);
          srr += (double)__fmul_rn(__fmul_rn(s_u[i], res), res);
        }
        chi = (float)(srr / (double)p.n_fit);
      }
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

    if (kLevel < MC_LV_SOLVE) {
      __syncthreads();
      continue;
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
      sh_accept = kLevel == MC_LV_FULL && accept;
      if (kLevel == MC_LV_FULL) {
        sh_niter += K;
        if (accept) {
          sh_conval = c;
          sh_nmoves += 1;
        }
        if (p.trace) p.trace[(size_t)s * p.n_reps + r] = accept ? kb : -1;
      } else {
        sink = __fadd_rn(sink, c);
      }
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

  if constexpr (kLevel != MC_LV_FULL) {
    // a rung's product, so that the compiler keeps its work
    if (tid < nq * K) rows[tid] = sink;
  } else {
    for (int i = tid; i < nq; i += nthr)
      p.ft[(size_t)r * nq + i] = s_ft[i];
    if (tid == 0) {
      p.scale[r] = sh_scale;
      p.background[r] = sh_bg;
      p.conval[r] = sh_conval;
      p.n_iter[r] = sh_niter;
      p.n_moves[r] = sh_nmoves;
    }
  }
}

// refuses what the kernel cannot run; cudaSuccess otherwise
static inline int mc_chunk_check(const ChunkParams& p) {
  if (p.model_id < 0 || p.model_id >= MC_N_MODELS || p.n_params < 1 ||
      p.n_params > MC_MAX_P || p.n_model_params < 1 ||
      p.n_model_params > MC_MAX_MODEL_P || p.k_cand < 1 ||
      p.k_global < 0 || p.k_global > p.k_cand || p.nq < 1 ||
      p.n_reps < 1 || p.n_contribs < 1 || p.n_steps < 0)
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < p.n_model_params; ++j)
    if (p.pcol[j] >= p.n_params) return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

// launches one chunk of kernel <kModel, kLevel> on `stream`
template <int kModel, int kLevel>
static int mc_chunk_launch_one(const ChunkParams& p, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(p.device);
  if (err != cudaSuccess) return (int)err;
  int threads = ((p.k_cand + 31) / 32) * 32;
  if (threads > MC_MAX_THREADS) threads = MC_MAX_THREADS;
  const size_t smem = (size_t)5 * p.nq * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(mc_chunk_kernel<kModel, kLevel>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mc_chunk_kernel<kModel, kLevel><<<p.n_reps, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// the switch on model_id for one level
template <int kLevel>
static int mc_chunk_launch_level(const ChunkParams& p, cudaStream_t stream) {
  switch (p.model_id) {
    case 0: return mc_chunk_launch_one<0, kLevel>(p, stream);
    case 1: return mc_chunk_launch_one<1, kLevel>(p, stream);
    case 2: return mc_chunk_launch_one<2, kLevel>(p, stream);
    case 3: return mc_chunk_launch_one<3, kLevel>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
