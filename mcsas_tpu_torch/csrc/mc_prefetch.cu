// Prefetch Monte-Carlo chunk kernel K2 for NVIDIA Hopper (sm_90a): the
// whole step (MC2_LV_FULL) of mc_prefetch.cuh for each row source -- the
// rows-in entry (rows staged a step ahead through shared memory, or read
// from global memory where the shape rule says so) and the table-in entry
// (the parameter table's row blend inside the kernel; the fit path).
//
// Replaces: mcsas_tpu/ops/mc_kernel.py:719, build_prefetch_chunk_fn (the
// Pallas TPU kernel of the parameter-table tier).  The contract, what
// bounds it on this card, the shape rule and the rounding contract:
// mc_prefetch.cuh.  Wrappers: ops/mc_kernel.py, run_prefetch_chunk (rows
// in) and run_prefetch_table_chunk (table in).

#include "mc_prefetch.cuh"

extern "C" int mc_prefetch_params_size(void) {
  return (int)sizeof(PrefetchParams);
}

extern "C" const char* mc_prefetch_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches one segment on `stream` (rows in where hp->rows is set, else
// table in); returns a cudaError_t code (0: launched).
extern "C" int mc_prefetch_launch(const PrefetchParams* hp, void* stream) {
  return mc_prefetch_run<MC2_LV_FULL>(hp, (cudaStream_t)stream, nullptr);
}

// The launch shape of that segment into out[7] (mc_prefetch_go).
extern "C" int mc_prefetch_shape(const PrefetchParams* hp, int* out) {
  return mc_prefetch_run<MC2_LV_FULL>(hp, nullptr, out);
}
