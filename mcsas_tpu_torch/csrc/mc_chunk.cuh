// The step loop of the fused chunk kernel K1, templated on the model
// (K1Model<kModel>, mc_models.cuh), on how much of the step runs (kLevel)
// and on the lanes per candidate (kG).  mc_chunk.cu instantiates the whole
// step, MC_LV_FULL, for each model at MC_K1_GROUP lanes; the latency probe
// mc_probe.cu (K3) instantiates the rungs that cut the same step short,
// and the ff and solve rungs at every group width, so that it measures
// the code that runs.
//
// Replaces: mcsas_tpu/ops/mc_kernel.py, build_chunk_fn -- the Pallas TPU
// kernel (its body `kernel` and `_candidate_solve`) that runs a whole chunk
// of accept/reject MC steps for every repetition in one launch.
//
// What bounds it on this card: a step is sequential, and within it the
// instructions one SM issues.  A chunk is n_steps strictly sequential
// steps per repetition.  A step evaluates K candidate rows over Nq points
// (one or two sin/cos pairs, or an exp, per point, each with IEEE
// divisions: K*Nq = 12,800 points at the headline shape K=128, Nq=100),
// four float64 sums per candidate (four float32 -> float64 conversions a
// point), a K-way first-minimum reduction and a conditional state update,
// with block barriers in between.  It moves little memory: one bank row
// (Nq floats) in and at most one out per step.
//
// Design: spread a step's points over all the threads a block can hold,
// so that the SM's schedulers always have a ready warp.
// * One block per repetition (R of the 132 SMs busy).  A group of kG
//   lanes evaluates one candidate, lanes over q: lane l takes the points
//   l, l + kG, l + 2 kG, ... and keeps its row values in registers (the
//   first MC_ROW_REG_POINTS points of the grid, 13 a lane at kG = 8; a
//   point beyond them is evaluated again where a later pass needs it).
//   The block holds min(K, MC_BLOCK_THREADS / kG) groups; group g loops
//   over the candidates g, g + n_groups, ...  At K = 128 and kG = 8 every
//   candidate is in flight at once, in 1024 threads of 64 registers.
// * Lane ip < P draws parameter ip of the group's candidate; shuffles hand
//   the values to the group, and every lane runs the model's set-up and
//   the weight on them (the same instructions, no broadcast).
// * Each point as (q, ft - bank[ri], u, y) in shared memory: one 16-byte
//   load gives a point's row its q and its sums their three operands.
// * The solve: each lane sums its own points in float64 as it evaluates
//   them, a butterfly tree over the group reduces the sums (mc_group_sum,
//   mc_common.cuh), and every lane solves; the residual pass reads the
//   rows from registers and is reduced the same way.  That summation order
//   differs from the plain version's; both sum float32 terms in float64,
//   where 100 terms almost always sum exactly, and round afterwards.
// * Best-of-K: every lane carries its group's best (chi2, k); shuffles
//   across the groups of a warp, one value per warp through shared
//   memory, and every warp reduces those itself, so no thread waits for a
//   broadcast.  The block's conval, n_iter and n_moves live in registers,
//   identical in every thread.  The winning group writes its row from
//   registers into the bank and ft: no row scratch in global memory.
// * Three barriers per step: the base row, best-of-K, the accept.
// * The (R, N, Nq) bank stays in global memory; a step touches only row
//   ri.  ft lives in shared memory.
// * The model is a template parameter: the block takes one branch of the
//   host's switch on model_id, so no thread diverges on it.
// * Rounding follows the plain PyTorch version (ops/mc_kernel.py,
//   chunk_reference; the rows as mc_models.cuh says, the solve and the
//   tie rule in mc_common.cuh): the solve's sums accumulate in float64,
//   rows, ft and the stored state stay float32.
// * Best-of-K: lowest chi2 wins, the lowest k on ties; a NaN chi2 counts
//   as +inf and so is never accepted.
// * Proposals: injected (S, R, K, P) tensor, or Philox4x32-10 keyed by
//   (seed, rep_base + rep) and counted by (step, k, parameter, 0); the top
//   24 bits of word 0 make a unit uniform.  A launch on a shard of the
//   repetitions (rep_base its first) draws what the launch on all of them
//   draws for its repetitions.
// * The launcher returns cudaGetLastError(); it neither synchronizes nor
//   allocates.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mc_common.cuh"
#include "mc_models.cuh"

// q points of a candidate's row that its group keeps in registers
#define MC_ROW_REG_POINTS 104

// how much of a step runs (the rungs of the probe, tools/kern_probe.py)
enum {
  MC_LV_LOOP = 0,       // cursor, activity, ft - bank[ri], barriers
  MC_LV_RNG = 1,        // + the K proposals (Philox or injected, local)
  MC_LV_FF = 2,         // + the K candidate rows into registers
  MC_LV_SOLVE = 3,      // + float64 sums, solve, residual pass, best-of-K
  MC_LV_SOLVE_MOM = 4,  // SOLVE with chi2 from the moments, no residual
                        //   pass: that idea's ceiling, never production
  MC_LV_FULL = 5        // + accept and state writes: K1 itself
};

// K1's lanes per candidate, and the most threads of a block (at 1024 a
// thread has at most 64 registers).  On the H100, 8 lanes beat 16 and 32
// for every model, and 1024 threads with a few spilled registers beat 512
// without (PERF.md, PR 4).
#define MC_K1_GROUP 8
#define MC_BLOCK_THREADS 1024

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
  float* sink;             // K3 below MC_LV_FULL: (R, threads); else null
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
  int32_t rep_base;        // global index of repetition 0 of this launch
  uint32_t seed;
};

// sqrt of the normalized weight (v*inv_v_ref)^comp2 / i_ref
__device__ __forceinline__ float mc_sqrt_weight(MV v, const ChunkParams& p) {
  if (p.vol_fixed) return p.sw_fixed;
  const float w = __fmul_rn(
      torch_powf(__fmul_rn(v.f, p.inv_v_ref), p.comp2), p.inv_i_ref);
  return __fsqrt_rn(w);
}

// amplitude-level row (ff*sqrt(w))^2 at one q point, clamped (NaN stays
// NaN)
template <class Model>
__device__ __forceinline__ float mc_row(float q,
                                        const typename Model::Cand& c,
                                        float sw, float clamp) {
  const float fs = __fmul_rn(Model::ff(q, c), sw);
  const float row = __fmul_rn(fs, fs);
  return row > clamp ? clamp : row;
}

// lane ip < P: parameter ip of candidate k at step s (injected, or drawn
// from the Philox stream), a local move for k >= k_global
__device__ __forceinline__ float mc_propose(const ChunkParams& p, int s,
                                            int r, int k, int ip,
                                            const float* slot) {
  float v;
  if (p.proposals) {
    v = p.proposals[(((size_t)s * p.n_reps + r) * p.k_cand + k) * p.n_params
                    + ip];
  } else {
    const uint32_t bits = philox_x0((uint32_t)s, (uint32_t)k, (uint32_t)ip,
                                    0u, p.seed,
                                    (uint32_t)(p.rep_base + r));
    v = __fmul_rn((float)(bits >> 8), 5.9604644775390625e-08f);
    if (k < p.k_global)
      v = __fadd_rn(__fmul_rn(gen_transform(v, p.gen[ip]),
                              __fsub_rn(p.hi[ip], p.lo[ip])),
                    p.lo[ip]);
  }
  if (k >= p.k_global) {
    // local move: the slot's value times exp((2v - 1) * scale)
    const float f = expf(__fmul_rn(__fsub_rn(__fmul_rn(2.0f, v), 1.0f),
                                   p.local_scale));
    v = fminf(fmaxf(__fmul_rn(slot[ip], f), p.lo[ip]), p.hi[ip]);
  }
  return v;
}

// A candidate's row scalars and sqrt(w), in every lane of its group, from
// the parameter value `v` of each lane ip < P: the candidate's full
// parameter list (active columns shuffled from the lane that drew them,
// fixed values) in the model's declaration order (BoundModel.pdict).
template <class Model>
struct MCCand {
  typename Model::Cand c;
  float sw;
};

template <class Model, int kG>
__device__ __forceinline__ MCCand<Model> mc_candidate(
    const ChunkParams& p, float v, unsigned gmask) {
  MV pv[MC_MAX_MODEL_P];
#pragma unroll
  for (int j = 0; j < MC_MAX_MODEL_P; ++j) {
    if (j >= p.n_model_params) break;
    const int col = p.pcol[j];
    const float a = __shfl_sync(gmask, v, col < 0 ? 0 : col, kG);
    pv[j] = col >= 0 ? mv_act(a) : mv_fix(p.pfix[j]);
  }
  return {Model::setup(pv), mc_sqrt_weight(Model::volume(pv), p)};
}

template <int kModel, int kLevel, int kG>
__global__ void __launch_bounds__(MC_BLOCK_THREADS)
mc_chunk_kernel(const ChunkParams p) {
  using Model = K1Model<kModel>;
  constexpr int kRegs = (MC_ROW_REG_POINTS + kG - 1) / kG;
  constexpr int kMaxWarps = MC_BLOCK_THREADS / 32;
  static_assert(kG == 8 || kG == 16 || kG == 32, "8, 16 or 32 lanes");
  static_assert(kG >= MC_MAX_P, "a lane per active parameter");
  extern __shared__ float4 smem[];
  __shared__ float red_chi[kMaxWarps];
  __shared__ int red_k[kMaxWarps];
  __shared__ float sh_scale, sh_bg;
  __shared__ double sh_uyy;

  const int nq = p.nq, K = p.k_cand, P = p.n_params, N = p.n_contribs;
  const int r = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid % kG, group = tid / kG, n_groups = nthr / kG;
  const int n_warps = nthr / 32;
  const unsigned gmask = mc_group_mask<kG>();
  // each point as (q, ft - bank[ri], u, y): one 16-byte load a point
  float4* s_pt = smem;
  float* s_ft = reinterpret_cast<float*>(s_pt + nq);
  float* bank = p.ibank + (size_t)r * N * nq;
  float* rset = p.rset + (size_t)r * N * P;

  // drift-free start: rebuild the totals from the bank (float64 sum)
  for (int i = tid; i < nq; i += nthr) {
    s_pt[i] = make_float4(p.q[i], 0.0f, p.u[i], p.y[i]);
    double acc = 0.0;
    for (int n = 0; n < N; ++n) acc += (double)bank[(size_t)n * nq + i];
    s_ft[i] = (float)acc;
  }
  // the repetition's counters, the same in every thread
  float conval = p.conval[r];
  int niter = p.n_iter[r], nmoves = p.n_moves[r];
  if (tid == 0) {
    sh_scale = p.scale[r];
    sh_bg = p.background[r];
  }
  __syncthreads();
  if (kLevel == MC_LV_SOLVE_MOM) {
    if (tid == 0) {
      double acc = 0.0;
      for (int i = 0; i < nq; ++i)
        acc += (double)__fmul_rn(__fmul_rn(s_pt[i].z, s_pt[i].w),
                                 s_pt[i].w);
      sh_uyy = acc;
    }
    __syncthreads();
  }
  float sink = 0.0f;   // what a rung below FULL leaves behind

  for (int s = 0; s < p.n_steps; ++s) {
    if (!(conval > p.crit && niter < p.max_iter)) {
      // nothing changes for an inactive repetition: its state, and so its
      // activity, stay as they are for the rest of the chunk
      if (p.trace)
        for (int t = s + tid; t < p.n_steps; t += nthr)
          p.trace[(size_t)t * p.n_reps + r] = -1;
      break;
    }
    const int ri = (int)(((long long)p.ri0 + s) % N);
    float* bank_row = bank + (size_t)ri * nq;
    const float* slot = rset + (size_t)ri * P;
    for (int i = tid; i < nq; i += nthr)
      s_pt[i].y = __fsub_rn(s_ft[i], bank_row[i]);
    __syncthreads();
    if (kLevel == MC_LV_LOOP) sink = __fadd_rn(sink, s_pt[tid % nq].y);

    // the group's best candidate so far (its parameter in lane ip < P),
    // and the rows of its last one
    float my_chi = INFINITY, my_a = 0.0f, my_b = 0.0f, my_v = 0.0f;
    int my_k = INT_MAX, last_k = -1;
    float row[kRegs];
    for (int k = group; k < (kLevel >= MC_LV_RNG ? K : 0); k += n_groups) {
      const float v = lane < P ? mc_propose(p, s, r, k, lane, slot) : 0.0f;
      if (kLevel == MC_LV_RNG) {
        sink = __fadd_rn(sink, v);
        continue;
      }
      const MCCand<Model> mc = mc_candidate<Model, kG>(p, v, gmask);
      // the rows into registers and this lane's float64 sums over its
      // points, in the order of q
      double sx = 0.0, sxx = 0.0, sxy = 0.0;
      float fsum = 0.0f;
#pragma unroll
      for (int j = 0; j < kRegs; ++j) {
        const int i = lane + j * kG;
        if (i < nq) {
          const float4 pt = s_pt[i];
          row[j] = mc_row<Model>(pt.x, mc.c, mc.sw, p.row_clamp);
          if (kLevel == MC_LV_FF)
            fsum = __fadd_rn(fsum, row[j]);
          else
            mc_moments(pt, row[j], sx, sxx, sxy);
        }
      }
      for (int i = lane + kRegs * kG; i < nq; i += kG) {
        const float4 pt = s_pt[i];
        const float rw = mc_row<Model>(pt.x, mc.c, mc.sw, p.row_clamp);
        if (kLevel == MC_LV_FF)
          fsum = __fadd_rn(fsum, rw);
        else
          mc_moments(pt, rw, sx, sxx, sxy);
      }
      last_k = k;
      if (kLevel == MC_LV_FF) {
        sink = __fadd_rn(sink, fsum);
        continue;
      }
      sx = mc_group_sum<kG>(sx, gmask);
      sxx = mc_group_sum<kG>(sxx, gmask);
      sxy = mc_group_sum<kG>(sxy, gmask);
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
        // the residual pass, on the rows in registers
        double srr = 0.0;
#pragma unroll
        for (int j = 0; j < kRegs; ++j) {
          const int i = lane + j * kG;
          if (i < nq) srr = __dadd_rn(srr, mc_residual(s_pt[i], row[j], a, b));
        }
        for (int i = lane + kRegs * kG; i < nq; i += kG) {
          const float4 pt = s_pt[i];
          srr = __dadd_rn(srr, mc_residual(
              pt, mc_row<Model>(pt.x, mc.c, mc.sw, p.row_clamp), a, b));
        }
        srr = mc_group_sum<kG>(srr, gmask);
        chi = (float)(srr / (double)p.n_fit);
      }
      if (isnan(chi)) chi = INFINITY;
      if (mc_better(chi, k, my_chi, my_k)) {
        my_chi = chi;
        my_k = k;
        my_a = a;
        my_b = b;
        my_v = v;
      }
    }

    if (kLevel < MC_LV_SOLVE) {
      __syncthreads();
      continue;
    }
    // best-of-K over the block (mc_block_best: one barrier)
    float c = my_chi;
    int kb = my_k;
    mc_block_best<kG>(c, kb, red_chi, red_k, n_warps);
    if (kLevel != MC_LV_FULL) {
      sink = __fadd_rn(sink, c);
      __syncthreads();
      continue;
    }
    const bool accept = c < conval;
    niter += K;
    if (accept) {
      conval = c;
      nmoves += 1;
    }
    if (tid == 0 && p.trace)
      p.trace[(size_t)s * p.n_reps + r] = accept ? kb : -1;
    if (accept && my_k == kb) {
      // the winning group: its row into the bank and ft, its parameters
      // into the slot; a row not in registers is evaluated again
      const bool again = kb != last_k;
      if (again || nq > kRegs * kG) {
        const MCCand<Model> mc = mc_candidate<Model, kG>(p, my_v, gmask);
        if (again) {
#pragma unroll
          for (int j = 0; j < kRegs; ++j) {
            const int i = lane + j * kG;
            if (i < nq)
              row[j] = mc_row<Model>(s_pt[i].x, mc.c, mc.sw, p.row_clamp);
          }
        }
        for (int i = lane + kRegs * kG; i < nq; i += kG) {
          const float4 pt = s_pt[i];
          const float rw = mc_row<Model>(pt.x, mc.c, mc.sw, p.row_clamp);
          bank_row[i] = rw;
          s_ft[i] = __fadd_rn(pt.y, rw);
        }
      }
#pragma unroll
      for (int j = 0; j < kRegs; ++j) {
        const int i = lane + j * kG;
        if (i < nq) {
          bank_row[i] = row[j];
          s_ft[i] = __fadd_rn(s_pt[i].y, row[j]);
        }
      }
      if (lane < P) rset[(size_t)ri * P + lane] = my_v;
      if (lane == 0) {
        sh_scale = my_a;
        sh_bg = my_b;
      }
    }
    __syncthreads();
  }

  if constexpr (kLevel != MC_LV_FULL) {
    // a rung's product, so that the compiler keeps its work
    p.sink[(size_t)r * nthr + tid] = sink;
  } else {
    for (int i = tid; i < nq; i += nthr)
      p.ft[(size_t)r * nq + i] = s_ft[i];
    if (tid == 0) {
      p.scale[r] = sh_scale;
      p.background[r] = sh_bg;
      p.conval[r] = conval;
      p.n_iter[r] = niter;
      p.n_moves[r] = nmoves;
    }
  }
}

// refuses what the kernel cannot run; cudaSuccess otherwise
static inline int mc_chunk_check(const ChunkParams& p) {
  if (p.model_id < 0 || p.model_id >= MC_N_MODELS || p.n_params < 1 ||
      p.n_params > MC_MAX_P || p.n_model_params < 1 ||
      p.n_model_params > MC_MAX_MODEL_P || p.k_cand < 1 ||
      p.k_global < 0 || p.k_global > p.k_cand || p.nq < 1 ||
      p.n_reps < 1 || p.n_contribs < 1 || p.n_steps < 0 || p.ri0 < 0 ||
      p.ri0 >= p.n_contribs)
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < p.n_model_params; ++j)
    if (p.pcol[j] >= p.n_params) return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

// The launch shape of kernel <kModel, kLevel, kG> for these parameters:
// out[0] lanes per candidate, out[1] threads per block (groups of kG
// lanes, at most one per candidate, rounded up to whole warps), out[2]
// registers per thread, out[3] local memory bytes per thread.
template <int kModel, int kLevel, int kG>
static int mc_chunk_shape_one(const ChunkParams& p, int* out) {
  constexpr int kMaxGroups = MC_BLOCK_THREADS / kG;
  const int groups = p.k_cand < kMaxGroups ? p.k_cand : kMaxGroups;
  out[0] = kG;
  out[1] = (groups * kG + 31) / 32 * 32;
  cudaFuncAttributes attr;
  cudaError_t err = cudaSetDevice(p.device);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, mc_chunk_kernel<kModel, kLevel, kG>);
  out[2] = err == cudaSuccess ? attr.numRegs : -1;
  out[3] = err == cudaSuccess ? (int)attr.localSizeBytes : -1;
  return (int)err;
}

// launches one chunk of kernel <kModel, kLevel, kG> on `stream`
template <int kModel, int kLevel, int kG>
static int mc_chunk_launch_one(const ChunkParams& p, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(p.device);
  if (err != cudaSuccess) return (int)err;
  constexpr int kMaxGroups = MC_BLOCK_THREADS / kG;
  const int groups = p.k_cand < kMaxGroups ? p.k_cand : kMaxGroups;
  const int threads = (groups * kG + 31) / 32 * 32;
  const size_t smem = (size_t)5 * p.nq * sizeof(float);   // s_pt, s_ft
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(mc_chunk_kernel<kModel, kLevel, kG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mc_chunk_kernel<kModel, kLevel, kG><<<p.n_reps, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// K1 at its group width: launch (out == null) or shape
template <int kModel, int kLevel>
static int mc_chunk_run_model(const ChunkParams& p, cudaStream_t stream,
                              int* out) {
  return out ? mc_chunk_shape_one<kModel, kLevel, MC_K1_GROUP>(p, out)
             : mc_chunk_launch_one<kModel, kLevel, MC_K1_GROUP>(p, stream);
}

// the switch on model_id for one level, at K1's group width
template <int kLevel>
static int mc_chunk_run_level(const ChunkParams& p, cudaStream_t stream,
                              int* out) {
  switch (p.model_id) {
    case 0: return mc_chunk_run_model<0, kLevel>(p, stream, out);
    case 1: return mc_chunk_run_model<1, kLevel>(p, stream, out);
    case 2: return mc_chunk_run_model<2, kLevel>(p, stream, out);
    case 3: return mc_chunk_run_model<3, kLevel>(p, stream, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
