// Latency probe K3 for NVIDIA Hopper (sm_90a): K1's step loop
// (mc_chunk.cuh) cut short at each rung of the ladder, so that the time a
// rung adds is the time that part of K1's step costs.
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
// what it computed in the row scratch, so the compiler keeps its work.
// Wrapper: ops/mc_kernel.py, run_probe; runner: tools/kern_probe.py.

#include "mc_chunk.cuh"

extern "C" int mc_probe_params_size(void) {
  return (int)sizeof(ChunkParams);
}

extern "C" const char* mc_probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches one chunk cut at `level` (MC_LV_*) on `stream`; returns a
// cudaError_t code (0: launched).  The loop and proposal rungs do not
// evaluate the model and run as model 0.
extern "C" int mc_probe_launch(const ChunkParams* hp, int level,
                               void* stream) {
  const ChunkParams p = *hp;
  const int err = mc_chunk_check(p);
  if (err != (int)cudaSuccess) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (level) {
    case MC_LV_LOOP: return mc_chunk_launch_one<0, MC_LV_LOOP>(p, st);
    case MC_LV_RNG: return mc_chunk_launch_one<0, MC_LV_RNG>(p, st);
    case MC_LV_FF: return mc_chunk_launch_level<MC_LV_FF>(p, st);
    case MC_LV_SOLVE: return mc_chunk_launch_level<MC_LV_SOLVE>(p, st);
    case MC_LV_SOLVE_MOM:
      return mc_chunk_launch_level<MC_LV_SOLVE_MOM>(p, st);
    case MC_LV_FULL: return mc_chunk_launch_level<MC_LV_FULL>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
