// Latency probe K3 for NVIDIA Hopper (sm_90a): K1's step loop
// (mc_chunk.cuh) and K2's (mc_prefetch.cuh) cut short at each rung of
// their ladders, so that the time a rung adds is the time that part of
// the step costs.
//
// Replaces: tools/kern_probe.py, build -- the ladder of stripped-down
// Pallas TPU kernels (loop / prng / ff / solve / solve_mom / writes) that
// split the TPU kernel's per-step latency.  Here the rungs are the real
// K1 step cut at MC_LV_LOOP, _RNG, _FF, _SOLVE, _SOLVE_MOM and _FULL; the
// FULL rung is K1 itself, compiled again in this library, and is held
// bit for bit against K1 (chip_smoke.py).
//
// What bounds it: as K1, latency; it moves the same few bytes per step.
// A rung below FULL changes no state: it leaves one float per thread of
// what it computed in a sink (R, threads), so the compiler keeps its work.
// The ff and solve rungs also run at 8, 16 and 32 lanes per candidate, to
// compare K1's group widths.  K2's rungs are MC2_LV_LOOP, _ROWS (the rows
// staged, read or blended, no solve), _SOLVE and _FULL of either entry;
// its FULL rung is K2 compiled again and is held bit for bit against it.
// Wrappers: ops/mc_kernel.py, run_probe and run_prefetch_probe; runner:
// tools/kern_probe.py.

#include "mc_chunk.cuh"
#include "mc_prefetch.cuh"

extern "C" int mc_probe_params_size(void) {
  return (int)sizeof(ChunkParams);
}

extern "C" const char* mc_probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// <kModel, kLevel> at group width kG: launch (out == null) or shape
template <int kModel, int kLevel, int kG>
static int mc_probe_one(const ChunkParams& p, cudaStream_t st, int* out) {
  return out ? mc_chunk_shape_one<kModel, kLevel, kG>(p, out)
             : mc_chunk_launch_one<kModel, kLevel, kG>(p, st);
}

// rung kLevel of model kModel at `group` lanes per candidate (0: K1's)
template <int kModel, int kLevel>
static int mc_probe_group(const ChunkParams& p, int group, cudaStream_t st,
                          int* out) {
  switch (group) {
    case 0: return mc_chunk_run_model<kModel, kLevel>(p, st, out);
    case 8: return mc_probe_one<kModel, kLevel, 8>(p, st, out);
    case 16: return mc_probe_one<kModel, kLevel, 16>(p, st, out);
    case 32: return mc_probe_one<kModel, kLevel, 32>(p, st, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the switch on model_id for a rung that runs at every group width
template <int kLevel>
static int mc_probe_level(const ChunkParams& p, int group, cudaStream_t st,
                          int* out) {
  switch (p.model_id) {
    case 0: return mc_probe_group<0, kLevel>(p, group, st, out);
    case 1: return mc_probe_group<1, kLevel>(p, group, st, out);
    case 2: return mc_probe_group<2, kLevel>(p, group, st, out);
    case 3: return mc_probe_group<3, kLevel>(p, group, st, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One chunk cut at `level` (MC_LV_*) with `group` lanes per candidate (0:
// K1's own width; 8, 16 or 32 for the ff and solve rungs): launched on
// `stream` when out is null, else its launch shape into out[4] as
// mc_chunk_shape gives it.  The loop and proposal rungs do not evaluate
// the model and run as model 0.
static int mc_probe_run(const ChunkParams* hp, int level, int group,
                        cudaStream_t st, int* out) {
  const ChunkParams p = *hp;
  const int err = mc_chunk_check(p);
  if (err != (int)cudaSuccess) return err;
  if (group != 0 && level != MC_LV_FF && level != MC_LV_SOLVE)
    return (int)cudaErrorInvalidValue;
  switch (level) {
    case MC_LV_LOOP: return mc_chunk_run_model<0, MC_LV_LOOP>(p, st, out);
    case MC_LV_RNG: return mc_chunk_run_model<0, MC_LV_RNG>(p, st, out);
    case MC_LV_FF: return mc_probe_level<MC_LV_FF>(p, group, st, out);
    case MC_LV_SOLVE: return mc_probe_level<MC_LV_SOLVE>(p, group, st, out);
    case MC_LV_SOLVE_MOM:
      return mc_chunk_run_level<MC_LV_SOLVE_MOM>(p, st, out);
    case MC_LV_FULL: return mc_chunk_run_level<MC_LV_FULL>(p, st, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launches one chunk cut at `level` on `stream`; returns a cudaError_t
// code (0: launched).
extern "C" int mc_probe_launch(const ChunkParams* hp, int level, int group,
                               void* stream) {
  return mc_probe_run(hp, level, group, (cudaStream_t)stream, nullptr);
}

// That chunk's launch shape into out[4]: lanes per candidate, threads per
// block, registers and local memory bytes per thread.
extern "C" int mc_probe_shape(const ChunkParams* hp, int level, int group,
                              int* out) {
  return mc_probe_run(hp, level, group, nullptr, out);
}

// ---------------------------------------------------------- K2's rungs

extern "C" int mc_probe_prefetch_params_size(void) {
  return (int)sizeof(PrefetchParams);
}

// one K2 segment cut at `level` (MC2_LV_*): launch (out == null) or shape
static int mc_probe_prefetch_run(const PrefetchParams* hp, int level,
                                 cudaStream_t st, int* out) {
  switch (level) {
    case MC2_LV_LOOP: return mc_prefetch_run<MC2_LV_LOOP>(hp, st, out);
    case MC2_LV_ROWS: return mc_prefetch_run<MC2_LV_ROWS>(hp, st, out);
    case MC2_LV_SOLVE: return mc_prefetch_run<MC2_LV_SOLVE>(hp, st, out);
    case MC2_LV_FULL: return mc_prefetch_run<MC2_LV_FULL>(hp, st, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launches one K2 segment cut at `level` on `stream`; returns a
// cudaError_t code (0: launched).
extern "C" int mc_probe_prefetch_launch(const PrefetchParams* hp, int level,
                                        void* stream) {
  return mc_probe_prefetch_run(hp, level, (cudaStream_t)stream, nullptr);
}

// That segment's launch shape into out[7] (mc_prefetch_go).
extern "C" int mc_probe_prefetch_shape(const PrefetchParams* hp, int level,
                                       int* out) {
  return mc_probe_prefetch_run(hp, level, nullptr, out);
}
