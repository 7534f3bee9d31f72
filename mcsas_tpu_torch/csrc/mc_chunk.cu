// Fused Monte-Carlo chunk kernel K1 for NVIDIA Hopper (sm_90a): the whole
// step (MC_LV_FULL) of mc_chunk.cuh for each model of mc_models.cuh.
//
// Replaces: mcsas_tpu/ops/mc_kernel.py, build_chunk_fn (the Pallas TPU
// kernel of the elementwise models Sphere, LMADenseSphere, GaussianChain
// and SphericalCoreShell).  What bounds it and how it is laid out:
// mc_chunk.cuh.  Wrapper: ops/mc_kernel.py, run_chunk.

#include "mc_chunk.cuh"

extern "C" int mc_chunk_params_size(void) {
  return (int)sizeof(ChunkParams);
}

extern "C" const char* mc_chunk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches one chunk on `stream`; returns a cudaError_t code (0: launched).
extern "C" int mc_chunk_launch(const ChunkParams* hp, void* stream) {
  const ChunkParams p = *hp;
  const int err = mc_chunk_check(p);
  if (err != (int)cudaSuccess) return err;
  return mc_chunk_run_level<MC_LV_FULL>(p, (cudaStream_t)stream, nullptr);
}

// The launch shape of that chunk into out[4]: lanes per candidate,
// threads per block, registers and local memory bytes per thread.
extern "C" int mc_chunk_shape(const ChunkParams* hp, int* out) {
  const ChunkParams p = *hp;
  const int err = mc_chunk_check(p);
  if (err != (int)cudaSuccess) return err;
  return mc_chunk_run_level<MC_LV_FULL>(p, nullptr, out);
}
