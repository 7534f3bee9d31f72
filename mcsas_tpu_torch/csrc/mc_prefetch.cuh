// The step loop of the prefetch chunk kernel K2, templated on where a
// candidate's row comes from (kSrc), on how much of the step runs (kLevel)
// and on the factor a table's lookup applies to its blend (kXs).
// mc_prefetch.cu instantiates the whole step, MC2_LV_FULL, for each row
// source (the table sources with and without the factor); the latency probe mc_probe.cu (K3) instantiates the
// rungs that cut the same step short, so that it measures the code that
// runs.
//
// Replaces: mcsas_tpu/ops/mc_kernel.py, build_prefetch_chunk_fn -- the
// Pallas TPU kernel (its body `kernel`) that runs the solve/accept
// sequence of one segment of MC steps on pre-drawn candidates, streaming
// their pre-evaluated rows through the grid pipeline.
//
// Contract.  Candidates (S, R, K, P) float32; the state as RepState --
// rset (R, N, P), ibank (R, N, nq), ft (R, nq), scale/background/conval
// (R,), n_iter/n_moves (R,) int32 -- updated in place.  Step s works on
// slot (ri0 + s) mod N.  Per repetition and segment: ft is rebuilt from
// the bank (float64 sum); every step forms x = (ft - bank[slot]) + row_k
// for each of the K candidates, solves its scale/background in closed form
// with float64 sums, takes the first minimum chi2 (NaN counts as +inf) and
// accepts it iff the repetition is active and chi2 improves; n_iter grows
// by K per active step, n_moves by the accepts.  Two entries give row_k:
// * rows in (the TPU kernel's own contract): rows (S, R, K, nq) float32,
//   evaluated before the launch;
// * table in (the fit path): the parameter table `table` (n_rows, nq), its
//   axes and a factor per candidate sw (S, R, K); the kernel blends each
//   candidate's row itself, exactly as ops/tables.py lookup_param_table
//   followed by IntensityKernel.row: per table axis, last axis first,
//   f = (log(max(v, 0)) - l0) / dl clamped to [0, hi] (hi: n - 1.000001
//   rounded to float32 on the host), i = floor(f), w = f - i; the 2^A
//   corners, last axis fastest, each vals[clamp(c)] * cw with cw the
//   chained product of (1 - w) or w, added in that order.  An amplitude
//   table (rows ff, `intensity` 0) takes sw = sqrt(w): fs = blend * sw,
//   row = min(fs * fs, row_clamp).  An intensity table (rows of a smeared
//   fit, ff^2(locs) @ smear_w, `intensity` 1) takes sw = w itself:
//   row = min(blend * sw, row_clamp) -- w, not sqrt(w)^2, which differ in
//   float32.  A lookup that multiplies its blend by a factor of each point
//   and candidate (`xs_kind`, MC2_XS_*) has it applied to the blend before
//   sw: the Kholodenko worm's circular cross-section (MC2_XS_CROSS_SECTION),
//   p0 = blend * 2 j1(q r)/(q r) with q the fit grid and r the candidate's
//   radius (its active column xs_col, or the fixed xs_fixed), then
//   fs = p0 * sw as above.  A NaN stays a NaN in every clamp.  At most
//   MC_MAX_TABLE_AXES table axes (the wrapper refuses more).
//
// What bounds it on this card: a step is sequential, and within it what
// one SM issues and moves through its shared memory.  A segment is S
// strictly sequential steps per repetition, one block (one SM) per
// repetition, so R of the 132 SMs work.  A step brings in K rows of nq
// floats (51 KB at K=128, nq=100 as staged rows; twice that as 2^A = 2
// table rows per candidate out of L2), then every candidate's chain:
// float64 sums over q (each point's operands a 16-byte shared load, twice
// a step), the closed-form solve, the residual pass, a K-way
// first-minimum reduction and a conditional state update, with three
// block barriers in between (~0.5 us each with 32 warps).  It moves few
// bytes of device memory and does few operations against the card's
// peaks: the bound (bytes for rows in, operations for table in) is three
// orders of magnitude below its time.
//
// Design: K1's scheme (mc_chunk.cuh), without a form factor.
// * A group of 8 lanes per candidate, lanes over q: lane l takes the
//   points l, l + 8, ... and keeps its 13 row values (the first 104
//   points) in registers; a point beyond them is read (or blended) again
//   where a later pass needs it.  Up to 1024 threads: at K = 128 every
//   candidate is in flight at once.
// * Each point as (0, ft - bank[ri], u, y) in shared memory: one 16-byte
//   load gives the three sums their operands.  Each lane sums its own
//   points in float64, a butterfly tree over the group reduces the sums
//   (mc_group_sum), every lane solves; the residual pass reads the rows
//   from registers.
// * Best-of-K: mc_block_best (every warp reduces the per-warp winners
//   itself).  conval, n_iter and n_moves live in registers, identical in
//   every thread.  The winning group writes its row from registers into
//   the bank and ft, one lane per parameter copies the candidate into the
//   slot.  Three barriers per step: the base row, best-of-K, the accept.
// * Rows a step ahead (rows in): step s + 1's block rows[s + 1, r] is
//   K*nq*4 contiguous bytes and independent of step s; cp.async copies it
//   in 16-byte pieces into the second of two shared-memory buffers while
//   step s solves (commit a group per step, wait_group 1 before the
//   step's first barrier).
// * The shape rule, decided by the launcher (mc_prefetch_plan) and
//   reported by mc_prefetch_shape: rows in runs staged (two buffers) when
//   K*nq is a multiple of 4, `rows` is 16-byte aligned and the two
//   buffers fit beside the base in the block's opt-in shared memory
//   (227 KB); else direct: the lanes read the rows from global memory, 8
//   neighbouring floats a group.  Table in copies the corner rows a
//   step ahead too (below) when every candidate has a group of its own
//   (K <= 128), the grid fits the registers (nq <= 104), nq is a multiple
//   of 4, the table is 16-byte aligned and the K * 2^A corner rows fit;
//   else it reads them straight from the table (L2 hits, 32 contiguous
//   bytes a group and point).  Where the shared memory is short, fewer
//   warps share the segment-start sum before a source falls back.
// * Corner rows a step ahead (table in): a step's 2^A corner rows per
//   candidate are 102 KB out of L2 at K=128, nq=100, A=1; read inside the
//   step they cost ~3.8 us of it (H100 80GB HBM3, 700 W), as long as the
//   solve, and as 16-byte cp.async a step ahead they still load the SM's
//   load/store path (1.3-2.3 us a step more than this).  So one lane of a
//   group copies its candidate's corner rows for step s + 1 with the TMA
//   unit's 1D bulk copy (cp.async.bulk, one instruction a row) into the
//   group's own region of shared memory (2^A * nq floats, read by no
//   other group), right after the group has blended step s's values out
//   of it into registers (a warp-level sync and a proxy fence before the
//   copy); the rows land while step s solves.  One mbarrier counts a
//   step's copies: every issuing lane arrives with its bytes, every
//   thread waits for the phase before it blends.  A candidate's place on
//   the axes (a logf and a division each) is computed once, a step ahead,
//   and kept in registers for the blend.
// * Segment start: the N bank rows are split over the block's warps
//   (warp w adds rows w, w + parts, ... in float64, lanes along q, so
//   the reads coalesce), then thread i adds the partials of point i in
//   the order of the warps.  A fixed order, but not the serial order n =
//   0..N-1; both sum float32 values in float64, which is exact unless the
//   bank's values at one point span more than ~2^20, and round once.
// * Inactive repetitions leave the loop at once and fill the trace with
//   -1.
// * Rounding follows the plain PyTorch versions (ops/mc_kernel.py,
//   prefetch_reference and prefetch_table_reference): logf and IEEE
//   __fdiv_rn/__fmul_rn/__fadd_rn/__fsub_rn, so nvcc contracts nothing,
//   the solve's sums in float64, rows, ft and the stored state float32.
// * The launcher returns cudaGetLastError(); it neither synchronizes nor
//   allocates.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mc_common.cuh"
#include "mc_models.cuh"

#define MC2_GROUP 8             // lanes per candidate
#define MC2_BLOCK_THREADS 1024
#define MC2_ROW_REG_POINTS 104  // q points a group keeps in registers
#define MC_MAX_TABLE_AXES 2
#define MC2_CORNERS (1 << MC_MAX_TABLE_AXES)

// where a candidate's row comes from
enum {
  MC2_SRC_STAGED = 0,  // rows in, a step ahead through shared memory
  MC2_SRC_DIRECT = 1,  // rows in, read from global memory
  MC2_SRC_TABLE = 2,   // table in, the corner rows read from the table
  MC2_SRC_AHEAD = 3    // table in, the corner rows copied a step ahead
};

// the factor a table's lookup applies to its blend (table in)
enum {
  MC2_XS_NONE = 0,
  MC2_XS_CROSS_SECTION = 1   // 2 j1(q r)/(q r), mc_models.cuh cross_section
};

// how much of a step runs (the rungs of the probe, tools/kern_probe.py)
enum {
  MC2_LV_LOOP = 0,   // cursor, activity, ft - bank[ri], barriers
  MC2_LV_ROWS = 1,   // + the K rows into registers (staged, read or blended)
  MC2_LV_SOLVE = 2,  // + float64 sums, solve, residual pass, best-of-K
  MC2_LV_FULL = 3    // + accept and state writes: K2 itself
};

// Field order and types mirror _PrefetchParams in ops/mc_kernel.py.
struct PrefetchParams {
  const float* q;          // (nq,) fit grid; table in with a factor
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
  const float* rows;       // (S, R, K, nq), or null: table in
  const float* cands;      // (S, R, K, P)
  const float* table;      // (n_table_rows, nq); table in
  const float* sw;         // (S, R, K) sqrt(w), or w (intensity); table in
  float* sink;             // K3 below MC2_LV_FULL: (R, threads); else null
  int32_t* trace;          // (S, R) chosen k or -1, or null
  double s_u;
  double s_uy;
  float crit;
  float row_clamp;
  float xs_fixed;          // the factor's parameter where xs_col < 0
  // the table's axes with more than one node, first axis first
  float ax_l0[MC_MAX_TABLE_AXES];     // log of the first node
  float ax_dl[MC_MAX_TABLE_AXES];     // log spacing
  float ax_hi[MC_MAX_TABLE_AXES];     // n - 1.000001, float32
  float ax_fixed[MC_MAX_TABLE_AXES];  // its value where ax_col < 0
  int32_t ax_n[MC_MAX_TABLE_AXES];
  int32_t ax_col[MC_MAX_TABLE_AXES];  // its active column, or -1: fixed
  int32_t n_axes;
  int32_t n_table_rows;
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
  int32_t intensity;       // table in: the rows are intensities, sw is w
  int32_t xs_kind;         // table in: the blend's factor, MC2_XS_*
  int32_t xs_col;          // its parameter's active column, or -1: fixed
};

// what the launcher decides from the shape (mc_prefetch_plan)
struct PrefetchPlan {
  int src;           // MC2_SRC_*
  int threads;
  int parts;         // warps that share the segment-start sum of the bank
  int stage_floats;  // floats of shared memory that hold rows or corners
  int smem;          // dynamic shared memory, bytes
};

// 16-byte asynchronous copies of n_floats (a multiple of 4) floats from
// global to shared memory, spread over the block; no commit
__device__ __forceinline__ void mc2_stage(float* dst, const float* src,
                                          int n_floats) {
  const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
  for (int c = threadIdx.x * 4; c < n_floats; c += blockDim.x * 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
                     "r"(base + 4u * (unsigned)c),
                     "l"(__cvta_generic_to_global(src + c))
                 : "memory");
}

// A candidate's row, point by point, from source kSrc with the lookup's
// factor kXs (MC2_XS_*; table in only).  Rows in: a pointer to its nq
// floats (in the staged block or in global memory).
template <int kSrc, int kXs>
struct K2Cand {
  const float* row;
  __device__ __forceinline__ float at(int i, const PrefetchParams&) const {
    return row[i];
  }
};

// Table in: the offsets of a candidate's corner rows in the table, their
// weights, its factor (sqrt(w), or w for an intensity table) and the
// parameter of the lookup's factor of each point (xs_kind).
struct K2Blend {
  int off[MC2_CORNERS];
  float cw[MC2_CORNERS];
  float sw;
  float xr;
  int nc;
  // the row at point i from its corner values fetch(c), c < nc, times
  // the lookup's factor kXs
  template <int kXs, class Fetch>
  __device__ __forceinline__ float blend(const PrefetchParams& p, int i,
                                         Fetch fetch) const {
    float acc = __fmul_rn(fetch(0), cw[0]);
#pragma unroll
    for (int c = 1; c < MC2_CORNERS; ++c)
      if (c < nc) acc = __fadd_rn(acc, __fmul_rn(fetch(c), cw[c]));
    // an instantiation of its own: as a select on a flag it cost the
    // tables without a factor 0.4-0.6 us of a 9.9 us step (K3's full rung,
    // H100 80GB HBM3 at 700 W)
    if constexpr (kXs == MC2_XS_CROSS_SECTION)
      acc = __fmul_rn(acc, cross_section(__ldg(p.q + i), xr));
    // the same branch in every thread of the launch: a select, not a
    // further instantiation of the step loop
    const float fs = __fmul_rn(acc, sw);
    const float row = p.intensity ? fs : __fmul_rn(fs, fs);
    return row > p.row_clamp ? p.row_clamp : row;   // a NaN stays a NaN
  }
};

// ... its corner values read from the table
template <int kXs>
struct K2Cand<MC2_SRC_TABLE, kXs> : K2Blend {
  __device__ __forceinline__ float at(int i, const PrefetchParams& p) const {
    return blend<kXs>(p, i,
                      [&](int c) { return __ldg(p.table + off[c] + i); });
  }
};

// ... its corner rows copied a step ahead into its group's region of
// shared memory, corner c at region[c * nq]
template <int kXs>
struct K2Cand<MC2_SRC_AHEAD, kXs> : K2Blend {
  const float* region;
  __device__ __forceinline__ float at(int i, const PrefetchParams& p) const {
    return blend<kXs>(p, i, [&](int c) { return region[c * p.nq + i]; });
  }
};

// Where candidate k of the step whose (step, repetition) index is
// step_rep lies on each table axis: f = (log(max(v, 0)) - l0) / dl,
// clamped to [0, hi] (a NaN stays a NaN)
__device__ __forceinline__ void mc2_axis_coords(const PrefetchParams& p,
                                                size_t step_rep, int k,
                                                float f_ax[MC_MAX_TABLE_AXES]) {
  const float* cand = p.cands + (step_rep * p.k_cand + k) * p.n_params;
#pragma unroll
  for (int a = 0; a < MC_MAX_TABLE_AXES; ++a)
    if (a < p.n_axes) {
      float v = p.ax_col[a] >= 0 ? __ldg(cand + p.ax_col[a]) : p.ax_fixed[a];
      v = v < 0.0f ? 0.0f : v;
      float f = __fdiv_rn(__fsub_rn(logf(v), p.ax_l0[a]), p.ax_dl[a]);
      f = f < 0.0f ? 0.0f : f;
      f_ax[a] = f > p.ax_hi[a] ? p.ax_hi[a] : f;
    }
}

// the parameter of the lookup's factor kXs of candidate k of that step (0
// without a factor)
template <int kXs>
__device__ __forceinline__ float mc2_factor_param(const PrefetchParams& p,
                                                  size_t step_rep, int k) {
  if constexpr (kXs == MC2_XS_NONE)
    return 0.0f;
  else
    return p.xs_col >= 0
               ? __ldg(p.cands + (step_rep * p.k_cand + k) * p.n_params +
                       p.xs_col)
               : p.xs_fixed;
}

// the blend of a candidate at the axis coordinates f_ax with factor sw and
// the parameter xr of the lookup's factor: lookup_param_table's corner
// indices and weights
__device__ __forceinline__ void mc2_blend_setup(
    const PrefetchParams& p, const float f_ax[MC_MAX_TABLE_AXES], float sw,
    float xr, K2Blend& cd) {
  int idx[MC2_CORNERS];
  idx[0] = 0;
  cd.cw[0] = 1.0f;
  int stride = 1;
  // axis by axis, the last first; t axes done: 2^t corners so far
#pragma unroll
  for (int t = 0; t < MC_MAX_TABLE_AXES; ++t) {
    if (t >= p.n_axes) break;
    const int a = p.n_axes - 1 - t;
    const int nc = 1 << t;
    float f = 0.0f;   // f_ax[a], indexed statically to stay in registers
#pragma unroll
    for (int b = 0; b < MC_MAX_TABLE_AXES; ++b)
      if (b == a) f = f_ax[b];
    const float fl = floorf(f);
    const int i = (int)fl;              // 0 for a NaN
    const float w = __fsub_rn(f, fl);
    const float w1 = __fsub_rn(1.0f, w);
#pragma unroll
    for (int c = 0; c < nc; ++c) {
      idx[c + nc] = idx[c] + (i + 1) * stride;
      cd.cw[c + nc] = __fmul_rn(cd.cw[c], w);
      idx[c] = idx[c] + i * stride;
      cd.cw[c] = __fmul_rn(cd.cw[c], w1);
    }
    stride *= p.ax_n[a];
  }
  cd.nc = 1 << p.n_axes;
  const int last = p.n_table_rows - 1;
#pragma unroll
  for (int c = 0; c < MC2_CORNERS; ++c)
    if (c < cd.nc)
      cd.off[c] = (idx[c] < 0 ? 0 : (idx[c] > last ? last : idx[c])) * p.nq;
  cd.sw = sw;
  cd.xr = xr;
}

// candidate k of that step; `staged`: the step's block of rows in shared
// memory (MC2_SRC_STAGED), or the group's region (MC2_SRC_AHEAD)
template <int kSrc, int kXs>
__device__ __forceinline__ K2Cand<kSrc, kXs> mc2_candidate(
    const PrefetchParams& p, size_t step_rep, int k, const float* staged) {
  K2Cand<kSrc, kXs> cd;
  if constexpr (kSrc == MC2_SRC_STAGED) {
    cd.row = staged + (size_t)k * p.nq;
  } else if constexpr (kSrc == MC2_SRC_DIRECT) {
    cd.row = p.rows + (step_rep * p.k_cand + k) * p.nq;
  } else {
    float f[MC_MAX_TABLE_AXES];
    mc2_axis_coords(p, step_rep, k, f);
    mc2_blend_setup(p, f, __ldg(p.sw + step_rep * p.k_cand + k),
                    mc2_factor_param<kXs>(p, step_rep, k), cd);
    if constexpr (kSrc == MC2_SRC_AHEAD) cd.region = staged;
  }
  return cd;
}

// The mbarrier that counts a step's bulk copies (MC2_SRC_AHEAD): `count`
// arrivals, one per issuing group, and their bytes complete a phase.
__device__ __forceinline__ void mc2_bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::
                   "r"((unsigned)__cvta_generic_to_shared(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// waits until the phase of that parity has completed; a wait that does not
// end (a byte count that the copies never reach) stops the kernel with an
// error instead of hanging the card
__device__ __forceinline__ void mc2_bar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(bar);
  for (unsigned spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 24)) __trap();
  }
}

// One thread of a group: bulk copies (the TMA unit's 1D copy) of its
// candidate's corner rows (nq a multiple of 4, the table 16-byte aligned)
// from the table into the group's region, which its lanes have finished
// reading; the copies' bytes are announced to and counted by `bar`.
__device__ __forceinline__ void mc2_bulk_corners(const PrefetchParams& p,
                                                 const K2Blend& cd,
                                                 float* region,
                                                 uint64_t* bar) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(region);
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  const unsigned row_bytes = 4u * (unsigned)p.nq;
  // the lanes' reads of the region, before the copies' writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(b), "r"(row_bytes * (unsigned)cd.nc)
               : "memory");
#pragma unroll
  for (int c = 0; c < MC2_CORNERS; ++c)
    if (c < cd.nc)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::
              "r"(dst + row_bytes * (unsigned)c),
              "l"(__cvta_generic_to_global(p.table + cd.off[c])),
              "r"(row_bytes), "r"(b)
          : "memory");
}

template <int kSrc, int kLevel, int kXs>
__global__ void __launch_bounds__(MC2_BLOCK_THREADS)
mc_prefetch_kernel(const PrefetchParams p, const int ft_parts,
                   const int stage_floats) {
  constexpr int kG = MC2_GROUP;
  constexpr int kRegs = MC2_ROW_REG_POINTS / kG;
  constexpr int kMaxWarps = MC2_BLOCK_THREADS / 32;
  constexpr bool kStage = kSrc == MC2_SRC_STAGED && kLevel >= MC2_LV_ROWS;
  constexpr bool kAhead = kSrc == MC2_SRC_AHEAD && kLevel >= MC2_LV_ROWS;
  static_assert(kG >= MC_MAX_P, "a lane per active parameter");
  extern __shared__ float4 smem[];
  __shared__ float red_chi[kMaxWarps];
  __shared__ int red_k[kMaxWarps];
  __shared__ float sh_scale, sh_bg;
  __shared__ uint64_t sh_bar;   // counts a step's bulk copies (kAhead)

  const int nq = p.nq, K = p.k_cand, P = p.n_params, N = p.n_contribs;
  const int r = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid % kG, group = tid / kG, n_groups = nthr / kG;
  const int n_warps = nthr / 32;
  const unsigned gmask = mc_group_mask<kG>();
  const int block_floats = K * nq;       // one step's rows
  // each point as (0, ft - bank[ri], u, y): one 16-byte load a point;
  // then the two staged blocks of rows (or every group's corner rows),
  // the partial sums of the bank, ft
  float4* s_pt = smem;
  float* s_rows = reinterpret_cast<float*>(s_pt + nq);
  double* s_part = reinterpret_cast<double*>(s_rows + stage_floats);
  float* s_ft = reinterpret_cast<float*>(s_part + (size_t)ft_parts * nq);
  float* bank = p.ibank + (size_t)r * N * nq;
  float* rset = p.rset + (size_t)r * N * P;

  if (kStage) {
    // the first step's rows, under way while ft is rebuilt
    if (p.n_steps > 0)
      mc2_stage(s_rows, p.rows + (size_t)r * block_floats, block_floats);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  // corners a step ahead: where the group's candidate of the coming step
  // lies on the table's axes (one candidate a group: the shape rule gives
  // this source at most as many candidates as groups)
  float cf[MC_MAX_TABLE_AXES];
  float* const region = s_rows + group * ((1 << p.n_axes) * nq);
  if (kAhead) {
    if (tid == 0) mc2_bar_init(&sh_bar, K);
    __syncthreads();
    // the corner rows of the first step's candidates
    if (p.n_steps > 0 && group < K) {
      K2Blend first;
      mc2_axis_coords(p, (size_t)r, group, cf);
      mc2_blend_setup(p, cf, 0.0f, 0.0f, first);
      if (lane == 0) mc2_bulk_corners(p, first, region, &sh_bar);
    }
  }
  // drift-free start: rebuild the totals from the bank (float64 sum), the
  // bank's rows split over ft_parts warps, the partials added in order
  for (int i = tid; i < nq; i += nthr)
    s_pt[i] = make_float4(0.0f, 0.0f, p.u[i], p.y[i]);
  {
    const int w = tid >> 5;
    if (w < ft_parts)
      for (int i = tid & 31; i < nq; i += 32) {
        double acc = 0.0;
        for (int n = w; n < N; n += ft_parts)
          acc = __dadd_rn(acc, (double)bank[(size_t)n * nq + i]);
        s_part[(size_t)w * nq + i] = acc;
      }
  }
  __syncthreads();
  for (int i = tid; i < nq; i += nthr) {
    double acc = s_part[i];
    for (int w = 1; w < ft_parts; ++w)
      acc = __dadd_rn(acc, s_part[(size_t)w * nq + i]);
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
  float sink = 0.0f;   // what a rung below FULL leaves behind

  for (int s = 0; s < p.n_steps; ++s) {
    if (!(conval > p.crit && niter < p.max_iter)) {
      // nothing changes for an inactive repetition: its state, and so its
      // activity, stay as they are for the rest of the segment
      if (p.trace)
        for (int t = s + tid; t < p.n_steps; t += nthr)
          p.trace[(size_t)t * p.n_reps + r] = -1;
      // this step's corner rows are under way: let them land
      if (kAhead && group < K) mc2_bar_wait(&sh_bar, s & 1);
      break;
    }
    const int ri = (int)(((long long)p.ri0 + s) % N);
    float* bank_row = bank + (size_t)ri * nq;
    const size_t step_rep = (size_t)s * p.n_reps + r;
    // corners a step ahead: what this step's blend and the next step's
    // copies need of the group's candidates, under way across the barrier
    float nf[MC_MAX_TABLE_AXES], csw = 0.0f, cxr = 0.0f;
    if (kAhead && group < K) {
      csw = __ldg(p.sw + step_rep * K + group);
      cxr = mc2_factor_param<kXs>(p, step_rep, group);
      if (s + 1 < p.n_steps)
        mc2_axis_coords(p, step_rep + p.n_reps, group, nf);
    }
    for (int i = tid; i < nq; i += nthr)
      s_pt[i].y = __fsub_rn(s_ft[i], bank_row[i]);
    if (kStage) {
      // the next step's rows into the other block (last read two barriers
      // ago); then this thread's pieces of this step's rows have landed
      if (s + 1 < p.n_steps)
        mc2_stage(s_rows + ((s + 1) & 1) * block_floats,
                  p.rows + (step_rep + p.n_reps) * block_floats,
                  block_floats);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    }
    __syncthreads();
    if (kLevel == MC2_LV_LOOP) sink = __fadd_rn(sink, s_pt[tid % nq].y);
    const float* staged =
        kSrc == MC2_SRC_AHEAD ? region : s_rows + (s & 1) * block_floats;

    // the group's best candidate so far, and the rows of its last one
    float my_chi = INFINITY, my_a = 0.0f, my_b = 0.0f;
    int my_k = INT_MAX, last_k = -1;
    float row[kRegs];
    for (int k = group; k < (kLevel >= MC2_LV_ROWS ? K : 0); k += n_groups) {
      K2Cand<kSrc, kXs> cd;
      if constexpr (kSrc == MC2_SRC_AHEAD) {
        mc2_blend_setup(p, cf, csw, cxr, cd);
        cd.region = staged;
      } else {
        cd = mc2_candidate<kSrc, kXs>(p, step_rep, k, staged);
      }
      // the block's corner rows, copied during the last step
      if (kAhead) mc2_bar_wait(&sh_bar, s & 1);
      // the rows into registers and this lane's float64 sums over its
      // points, in the order of q
      double sx = 0.0, sxx = 0.0, sxy = 0.0;
      float fsum = 0.0f;
#pragma unroll
      for (int j = 0; j < kRegs; ++j) {
        const int i = lane + j * kG;
        if (i < nq) {
          row[j] = cd.at(i, p);
          if (kLevel == MC2_LV_ROWS)
            fsum = __fadd_rn(fsum, row[j]);
          else
            mc_moments(s_pt[i], row[j], sx, sxx, sxy);
        }
      }
      for (int i = lane + kRegs * kG; i < nq; i += kG) {
        const float rw = cd.at(i, p);
        if (kLevel == MC2_LV_ROWS)
          fsum = __fadd_rn(fsum, rw);
        else
          mc_moments(s_pt[i], rw, sx, sxx, sxy);
      }
      last_k = k;
      if (kAhead) {
        // the next step's corner rows into the region that the group's
        // lanes have just read
        __syncwarp(gmask);
        if (s + 1 < p.n_steps) {
          K2Blend next;
          mc2_blend_setup(p, nf, 0.0f, 0.0f, next);
          if (lane == 0) mc2_bulk_corners(p, next, region, &sh_bar);
#pragma unroll
          for (int a = 0; a < MC_MAX_TABLE_AXES; ++a) cf[a] = nf[a];
        }
      }
      if (kLevel == MC2_LV_ROWS) {
        sink = __fadd_rn(sink, fsum);
        continue;
      }
      sx = mc_group_sum<kG>(sx, gmask);
      sxx = mc_group_sum<kG>(sxx, gmask);
      sxy = mc_group_sum<kG>(sxy, gmask);
      float a, b;
      mc_solve_scale_bg(sx, sxx, sxy, p.s_u, p.s_uy, p.find_bg, p.pos_bg,
                        &a, &b);
      // the residual pass, on the rows in registers
      double srr = 0.0;
#pragma unroll
      for (int j = 0; j < kRegs; ++j) {
        const int i = lane + j * kG;
        if (i < nq) srr = __dadd_rn(srr, mc_residual(s_pt[i], row[j], a, b));
      }
      for (int i = lane + kRegs * kG; i < nq; i += kG)
        srr = __dadd_rn(srr, mc_residual(s_pt[i], cd.at(i, p), a, b));
      srr = mc_group_sum<kG>(srr, gmask);
      float chi = (float)(srr / (double)p.n_fit);
      if (isnan(chi)) chi = INFINITY;
      if (mc_better(chi, k, my_chi, my_k)) {
        my_chi = chi;
        my_k = k;
        my_a = a;
        my_b = b;
      }
    }

    if (kLevel < MC2_LV_SOLVE) {
      __syncthreads();
      continue;
    }
    // best-of-K over the block (mc_block_best: one barrier)
    float c = my_chi;
    int kb = my_k;
    mc_block_best<kG>(c, kb, red_chi, red_k, n_warps);
    if (kLevel != MC2_LV_FULL) {
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
    if (tid == 0 && p.trace) p.trace[step_rep] = accept ? kb : -1;
    if (accept && my_k == kb) {
      // the winning group: its row into the bank and ft, its candidate
      // into the slot; a row not in registers is read (or blended) again
      // (never with the corners a step ahead: the shape rule)
      const bool again = kb != last_k;
      if (kSrc != MC2_SRC_AHEAD && (again || nq > kRegs * kG)) {
        const K2Cand<kSrc, kXs> cd =
            mc2_candidate<kSrc, kXs>(p, step_rep, kb, staged);
        if (again) {
#pragma unroll
          for (int j = 0; j < kRegs; ++j) {
            const int i = lane + j * kG;
            if (i < nq) row[j] = cd.at(i, p);
          }
        }
        for (int i = lane + kRegs * kG; i < nq; i += kG) {
          const float rw = cd.at(i, p);
          bank_row[i] = rw;
          s_ft[i] = __fadd_rn(s_pt[i].y, rw);
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
      if (lane < P)
        rset[(size_t)ri * P + lane] =
            p.cands[(step_rep * K + kb) * P + lane];
      if (lane == 0) {
        sh_scale = my_a;
        sh_bg = my_b;
      }
    }
    __syncthreads();
  }

  // copies still under way (a repetition that left the loop early)
  if (kStage) asm volatile("cp.async.wait_all;\n" ::: "memory");
  if constexpr (kLevel != MC2_LV_FULL) {
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

// Refuses what the kernel cannot run, else decides the launch shape: a
// group of 8 lanes per candidate, at most one group per candidate and
// 1024 threads, in whole warps; the row source (the header's shape rule);
// as many warps to share the segment-start sum as the shared memory left
// beside the base holds (all of them at any usual grid).
static int mc_prefetch_plan(const PrefetchParams& p, PrefetchPlan* plan) {
  if (p.n_params < 1 || p.n_params > MC_MAX_P ||
      p.k_cand < 1 || p.nq < 1 || p.n_reps < 1 || p.n_contribs < 1 ||
      p.n_steps < 0 || p.ri0 < 0 || p.ri0 >= p.n_contribs)
    return (int)cudaErrorInvalidValue;
  if (!p.rows) {
    if (!p.table || p.n_axes < 0 || p.n_axes > MC_MAX_TABLE_AXES ||
        p.n_table_rows < 1 ||
        (long long)p.n_table_rows * p.nq > (long long)INT_MAX)
      return (int)cudaErrorInvalidValue;
    long long n_rows = 1;
    for (int a = 0; a < p.n_axes; ++a) {
      if (p.ax_n[a] < 2 || p.ax_col[a] >= p.n_params)
        return (int)cudaErrorInvalidValue;
      n_rows *= p.ax_n[a];
    }
    if (n_rows != p.n_table_rows) return (int)cudaErrorInvalidValue;
    if (p.xs_kind < MC2_XS_NONE || p.xs_kind > MC2_XS_CROSS_SECTION ||
        (p.xs_kind != MC2_XS_NONE && (!p.q || p.xs_col >= p.n_params)))
      return (int)cudaErrorInvalidValue;
  } else if (p.xs_kind != MC2_XS_NONE) {
    return (int)cudaErrorInvalidValue;     // rows in: the rows are whole
  }
  cudaError_t err = cudaSetDevice(p.device);
  if (err != cudaSuccess) return (int)err;
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               p.device);
  if (err != cudaSuccess) return (int)err;
  limit -= 1024;   // the kernel's static shared memory, with room to spare
  constexpr int kMaxGroups = MC2_BLOCK_THREADS / MC2_GROUP;
  const int groups = p.k_cand < kMaxGroups ? p.k_cand : kMaxGroups;
  plan->threads = (groups * MC2_GROUP + 31) / 32 * 32;
  const int n_warps = plan->threads / 32;
  const long long base = 20LL * p.nq;           // s_pt and s_ft
  const long long part = 8LL * p.nq;            // one warp's partial sums
  // rows (or corner rows) a step ahead where the shape allows it and the
  // shared memory holds them beside the base and one warp's partial sums
  plan->src = p.rows ? MC2_SRC_DIRECT : MC2_SRC_TABLE;
  long long stage = 0;
  if (p.rows) {
    if (((long long)p.k_cand * p.nq) % 4 == 0 && (uintptr_t)p.rows % 16 == 0) {
      plan->src = MC2_SRC_STAGED;
      stage = 2LL * p.k_cand * p.nq;            // two blocks of rows
    }
  } else if (p.k_cand <= kMaxGroups && p.nq <= MC2_ROW_REG_POINTS &&
             p.nq % 4 == 0 && (uintptr_t)p.table % 16 == 0) {
    plan->src = MC2_SRC_AHEAD;                  // every group's region
    stage = (1LL << p.n_axes) * p.nq * p.k_cand;
  }
  if (base + part + 4 * stage > limit) {
    plan->src = p.rows ? MC2_SRC_DIRECT : MC2_SRC_TABLE;
    stage = 0;
  }
  long long parts = (limit - base - 4 * stage) / part;
  if (parts < 1) return (int)cudaErrorInvalidValue;
  plan->parts = (int)(parts < n_warps ? parts : n_warps);
  plan->stage_floats = (int)stage;
  plan->smem = (int)(base + part * plan->parts + 4 * stage);
  return (int)cudaSuccess;
}

// kernel <kSrc, kLevel, kXs> with this plan: launched on `stream` (out null),
// or its shape into out[7]: lanes per candidate, threads per block,
// registers and local memory bytes per thread, the row source (MC2_SRC_*),
// dynamic shared memory bytes, the warps sharing the segment-start sum
template <int kSrc, int kLevel, int kXs>
static int mc_prefetch_go(const PrefetchParams& p, const PrefetchPlan& plan,
                          cudaStream_t stream, int* out) {
  cudaError_t err;
  if (out) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr,
                                mc_prefetch_kernel<kSrc, kLevel, kXs>);
    out[0] = MC2_GROUP;
    out[1] = plan.threads;
    out[2] = err == cudaSuccess ? attr.numRegs : -1;
    out[3] = err == cudaSuccess ? (int)attr.localSizeBytes : -1;
    out[4] = plan.src;
    out[5] = plan.smem;
    out[6] = plan.parts;
    return (int)err;
  }
  if (plan.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(mc_prefetch_kernel<kSrc, kLevel, kXs>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               plan.smem);
    if (err != cudaSuccess) return (int)err;
  }
  mc_prefetch_kernel<kSrc, kLevel, kXs>
      <<<p.n_reps, plan.threads, plan.smem, stream>>>(p, plan.parts,
                                                      plan.stage_floats);
  return (int)cudaGetLastError();
}

// one segment cut at kLevel: launch (out == null) or shape
template <int kLevel>
static int mc_prefetch_run(const PrefetchParams* hp, cudaStream_t stream,
                           int* out) {
  const PrefetchParams p = *hp;
  PrefetchPlan plan;
  const int err = mc_prefetch_plan(p, &plan);
  if (err != (int)cudaSuccess) return err;
  // a launch needs its inputs: the factors for table in, a rung's sink
  if (!out && ((!p.rows && !p.sw) || (kLevel != MC2_LV_FULL && !p.sink)))
    return (int)cudaErrorInvalidValue;
  constexpr int kNo = MC2_XS_NONE, kXs = MC2_XS_CROSS_SECTION;
  const bool xs = p.xs_kind == MC2_XS_CROSS_SECTION;
  switch (plan.src) {
    case MC2_SRC_STAGED:
      return mc_prefetch_go<MC2_SRC_STAGED, kLevel, kNo>(p, plan, stream, out);
    case MC2_SRC_DIRECT:
      return mc_prefetch_go<MC2_SRC_DIRECT, kLevel, kNo>(p, plan, stream, out);
    case MC2_SRC_TABLE:
      return xs ? mc_prefetch_go<MC2_SRC_TABLE, kLevel, kXs>(p, plan, stream,
                                                             out)
                : mc_prefetch_go<MC2_SRC_TABLE, kLevel, kNo>(p, plan, stream,
                                                             out);
    default:
      return xs ? mc_prefetch_go<MC2_SRC_AHEAD, kLevel, kXs>(p, plan, stream,
                                                             out)
                : mc_prefetch_go<MC2_SRC_AHEAD, kLevel, kNo>(p, plan, stream,
                                                             out);
  }
}
