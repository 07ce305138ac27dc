// The fused pair of steps (K2) and the chunked state read (K4) on bf16
// state: the C entries of collide_stream2.cuh with S = __nv_bfloat16,
// under the fp32 entries' names with _bf16 appended and the same
// arguments, the state pointers pointing at bf16 words. Its own
// translation unit, so nvcc builds it beside the fp32 instances
// (kernels/_build.py).

#include "collide_stream2.cuh"

using bf16 = __nv_bfloat16;

extern "C" {

const char* lbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int lbm_pair_unit(int axis) { return pair_unit(axis); }

int lbm_pair_block_size() { return kPairThreads; }

int lbm_pair_blocks_per_sm(int key) {
  return pair_blocks_per_sm<bf16>(key);
}

long long lbm_pair_smem_bytes() {
  return (long long)kPairSmem;
}

int lbm_collide_stream2_bf16(const void* src, void* dst, const int8_t* mask,
                             int nx, int ny, int nz, const int* coll_int,
                             const float* coll_float, int n_bc,
                             const int* bc_int, const float* bc_float,
                             const void* const* valid_ptrs,
                             const void* const* phi_t,
                             const void* const* phi_t1, const int* units,
                             int n_units, double* partials, int n_partials,
                             double* series, int slot, void* stream) {
  return collide_stream2<bf16>(
      static_cast<const bf16*>(src), static_cast<bf16*>(dst), mask, nx, ny,
      nz, coll_int, coll_float, n_bc, bc_int, bc_float, valid_ptrs, phi_t,
      phi_t1, units, n_units, partials, n_partials, series, slot, stream);
}

int lbm_extract_rows_bf16(const void* f, void* out, int X, int Y, int Z,
                          int x0, int wx, void* stream) {
  return extract_rows<bf16>(static_cast<const bf16*>(f),
                            static_cast<bf16*>(out), X, Y, Z, x0, wx, stream);
}

}  // extern "C"
