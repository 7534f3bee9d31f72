// Prefetch Monte-Carlo chunk kernel (K2) for NVIDIA Hopper (sm_90a).
//
// Replaces: mcsas_tpu/ops/mc_kernel.py:719, build_prefetch_chunk_fn -- the
// Pallas TPU kernel that runs the solve/accept sequence of one segment of
// MC steps on pre-drawn candidates and their pre-evaluated rows (the
// parameter-table tier: the rows are multilinear blends of baked form
// factor rows, computed before the launch by plain PyTorch on the card).
//
// Contract (the JAX wrapper's): rows (S, R, K, nq) and candidates
// (S, R, K, P) float32; the state as RepState -- rset (R, N, P), ibank
// (R, N, nq), ft (R, nq), scale/background/conval (R,), n_iter/n_moves
// (R,) int32 -- updated in place.  Step s works on slot (ri0 + s) mod N.
// Per repetition and segment: ft is rebuilt from the bank (float64 sum);
// every step forms x = (ft - bank[slot]) + rows[s, r, k] for each of the K
// candidates, solves its scale/background in closed form with float64
// sums, takes the first minimum chi2 (NaN counts as +inf) and accepts it
// iff the repetition is active and chi2 improves; n_iter grows by K per
// active step, n_moves by the accepts.
//
// What bounds it on this card: latency.  A segment is S strictly
// sequential steps per repetition.  Per step a repetition reads
// K*nq*4 B of staged rows (51 KB at K=128, nq=100) and then walks a
// dependent chain -- two passes over q with float64 adds per candidate, a
// K-way first-minimum reduction and a conditional state update, with
// block barriers in between.  With one block per repetition only R of the
// 132 SMs are busy (10 at the cylinder suite shape), so it is neither the
// bytes nor the arithmetic but the chain length per step that sets the
// time.
//
// Design (simple and right first):
// * One block per repetition; a loop over the segment's steps inside the
//   block replaces the TPU's sequential grid axis.
// * y, u, ft and the base row ft - bank[slot] live in shared memory; the
//   bank, the staged rows and the candidates stay in global memory.
// * One thread per candidate (K1's scheme), each looping over q.  It
//   keeps each candidate's sums in the q order of K1 and needs no
//   cross-lane reduction per candidate; the price is uncoalesced row
//   reads (neighbouring lanes are nq floats apart), which L1 absorbs
//   because a lane walks its own 128-byte lines over consecutive q.
// * Best-of-K as in K1: warp shuffles, then one value per warp through
//   shared memory (mc_better: lowest chi2, the lowest k on ties).
// * Rounding follows the plain PyTorch version (ops/mc_kernel.py,
//   prefetch_reference): __fmul_rn/__fadd_rn/__fsub_rn keep nvcc from
//   contracting into FMAs, the solve's sums accumulate in float64, rows,
//   ft and the stored state stay float32.  With the rows given there are
//   no transcendentals, so the kernel and its plain version agree exactly.
// * Later work (ROADMAP B2): move the 2^P row blend into the kernel (the
//   table is 1.6 MB and fits in L2) and drop the (S, R, K, nq) staging
//   tensor; split a repetition's candidates over more SMs.
// * The launcher returns cudaGetLastError(); it neither synchronizes nor
//   allocates.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mc_common.cuh"

#define MC_MAX_P 8
#define MC_MAX_THREADS 256

// Field order and types mirror _PrefetchParams in ops/mc_kernel.py.
struct PrefetchParams {
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
  const float* rows;       // (S, R, K, nq)
  const float* cands;      // (S, R, K, P)
  int32_t* trace;          // (S, R) chosen k or -1, or null
  double s_u;
  double s_uy;
  float crit;
  int32_t n_reps;
  int32_t n_contribs;
  int32_t nq;
  int32_t n_params;
  int32_t k_cand;
  int32_t n_steps;
  int32_t ri0;
  int32_t max_iter;
  int32_t n_fit;
  int32_t find_bg;
  int32_t pos_bg;
  int32_t device;
};

__global__ void __launch_bounds__(MC_MAX_THREADS)
mc_prefetch_kernel(const PrefetchParams p) {
  extern __shared__ float smem[];
  __shared__ float red_chi[MC_MAX_THREADS / 32];
  __shared__ int red_k[MC_MAX_THREADS / 32];
  __shared__ float sh_conval, sh_scale, sh_bg;
  __shared__ int sh_niter, sh_nmoves, sh_best_k, sh_accept, sh_active;

  const int nq = p.nq, K = p.k_cand, P = p.n_params, N = p.n_contribs;
  const int r = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  float* s_y = smem;
  float* s_u = s_y + nq;
  float* s_ft = s_u + nq;
  float* s_base = s_ft + nq;
  float* bank = p.ibank + (size_t)r * N * nq;
  float* rset = p.rset + (size_t)r * N * P;

  // drift-free segment start: rebuild the totals from the bank (float64)
  for (int i = tid; i < nq; i += nthr) {
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
    const size_t step_rep = (size_t)s * p.n_reps + r;
    const float* step_rows = p.rows + step_rep * K * nq;
    const float* step_cands = p.cands + step_rep * K * P;
    if (tid == 0)
      sh_active = sh_conval > p.crit && sh_niter < p.max_iter;
    for (int i = tid; i < nq; i += nthr)
      s_base[i] = __fsub_rn(s_ft[i], bank_row[i]);
    __syncthreads();
    if (!sh_active) {
      // nothing changes for an inactive repetition: its state, and so its
      // activity, stay as they are for the rest of the segment
      if (p.trace)
        for (int t = s + tid; t < p.n_steps; t += nthr)
          p.trace[(size_t)t * p.n_reps + r] = -1;
      break;
    }

    float my_chi = INFINITY, my_a = 0.0f, my_b = 0.0f;
    int my_k = INT_MAX;
    for (int k = tid; k < K; k += nthr) {
      const float* row = step_rows + (size_t)k * nq;
      double sx = 0.0, sxx = 0.0, sxy = 0.0;
      for (int i = 0; i < nq; ++i) {
        const float x = __fadd_rn(s_base[i], row[i]);
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
        const float x = __fadd_rn(s_base[i], row[i]);
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
      if (p.trace) p.trace[step_rep] = accept ? kb : -1;
    }
    __syncthreads();
    if (sh_accept) {
      const int kb = sh_best_k;
      const float* row = step_rows + (size_t)kb * nq;
      for (int i = tid; i < nq; i += nthr) {
        const float v = row[i];
        bank_row[i] = v;
        s_ft[i] = __fadd_rn(s_base[i], v);
      }
      if (my_k == kb) {
        for (int ip = 0; ip < P; ++ip)
          rset[(size_t)ri * P + ip] = step_cands[(size_t)kb * P + ip];
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

extern "C" int mc_prefetch_params_size(void) {
  return (int)sizeof(PrefetchParams);
}

extern "C" const char* mc_prefetch_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches one segment on `stream`; returns a cudaError_t code (0: launched).
extern "C" int mc_prefetch_launch(const PrefetchParams* hp, void* stream) {
  const PrefetchParams p = *hp;
  if (p.n_params < 1 || p.n_params > MC_MAX_P || p.k_cand < 1 ||
      p.nq < 1 || p.n_reps < 1 || p.n_contribs < 1 || p.n_steps < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(p.device);
  if (err != cudaSuccess) return (int)err;
  int threads = ((p.k_cand + 31) / 32) * 32;
  if (threads > MC_MAX_THREADS) threads = MC_MAX_THREADS;
  const size_t smem = (size_t)4 * p.nq * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(mc_prefetch_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mc_prefetch_kernel<<<p.n_reps, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
