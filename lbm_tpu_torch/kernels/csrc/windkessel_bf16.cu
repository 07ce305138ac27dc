// The windkessel fold on bf16 state: lbm_collide_stream_wk_bf16, the C
// entry of windkessel.cuh with S = __nv_bfloat16 and lbm_collide_stream
// _wk's arguments, the state pointers (src, dst) pointing at bf16 words.
// Its own translation unit, built beside windkessel.cu
// (kernels/_build.py).

#include "windkessel.cuh"

using bf16 = __nv_bfloat16;

extern "C" {

int lbm_block_size() { return kBlock; }

const char* lbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int lbm_collide_stream_wk_bf16(const void* src, void* dst,
                               const int8_t* mask, int nx, int ny, int nz,
                               const int* coll_int, const float* coll_float,
                               int n_bc, const int* bc_int,
                               const float* bc_float,
                               const void* const* valid_ptrs,
                               const void* const* phi_ptrs, const int* bc_wk,
                               const int* cells, int n_listed,
                               double* partials, int n_partials,
                               double* series, int t, int n_wk,
                               const int* wk_int, const float* wk_float,
                               const float* weights, const int* foot,
                               int n_foot, float* terms, float* q, float* pc,
                               void* stream) {
  return collide_stream_fold<bf16>(
      static_cast<const bf16*>(src), static_cast<bf16*>(dst), mask, nx, ny,
      nz, coll_int, coll_float, n_bc, bc_int, bc_float, valid_ptrs, phi_ptrs,
      bc_wk, cells, n_listed, partials, n_partials, series, t, n_wk, wk_int,
      wk_float, weights, foot, n_foot, terms, q, pc, stream);
}

}  // extern "C"
