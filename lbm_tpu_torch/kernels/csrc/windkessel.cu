// The windkessel (RCR) outlets on fp32 state, and the flux kernel that
// primes the fold on either storage: the C entries of windkessel.cuh
// (lbm_collide_stream_wk with S = float; lbm_windkessel_flux and
// lbm_windkessel_flux_bf16). Its own translation unit, so nvcc builds the
// fold's instances beside the others (kernels/_build.py). Every pointer
// and the stream cross as void*-sized ctypes values; each entry returns
// cudaGetLastError() or cudaErrorInvalidValue for a malformed call.

#include "windkessel.cuh"

extern "C" {

int lbm_windkessel_block_size() { return kWKBlock; }

int lbm_windkessel_max() { return kMaxWK; }

int lbm_block_size() { return kBlock; }

const char* lbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int lbm_collide_stream_wk(const float* src, float* dst, const int8_t* mask,
                          int nx, int ny, int nz, const int* coll_int,
                          const float* coll_float, int n_bc,
                          const int* bc_int, const float* bc_float,
                          const void* const* valid_ptrs,
                          const void* const* phi_ptrs, const int* bc_wk,
                          const int* cells, int n_listed, double* partials,
                          int n_partials, double* series, int t, int n_wk,
                          const int* wk_int, const float* wk_float,
                          const float* weights, const int* foot, int n_foot,
                          float* terms, float* q, float* pc, void* stream) {
  return collide_stream_fold<float>(
      src, dst, mask, nx, ny, nz, coll_int, coll_float, n_bc, bc_int,
      bc_float, valid_ptrs, phi_ptrs, bc_wk, cells, n_listed, partials,
      n_partials, series, t, n_wk, wk_int, wk_float, weights, foot, n_foot,
      terms, q, pc, stream);
}

int lbm_windkessel_flux(const float* src, long long n_cells, int n_wk,
                        const int* wk_int, const float* wk_float,
                        const float* half_force, const int* cells,
                        const float* weights, float* terms, float* q,
                        void* stream) {
  return windkessel_prime<float>(src, n_cells, n_wk, wk_int, wk_float,
                                 half_force, cells, weights, terms, q,
                                 stream);
}

int lbm_windkessel_flux_bf16(const void* src, long long n_cells, int n_wk,
                             const int* wk_int, const float* wk_float,
                             const float* half_force, const int* cells,
                             const float* weights, float* terms, float* q,
                             void* stream) {
  return windkessel_prime<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(src), n_cells, n_wk, wk_int,
      wk_float, half_force, cells, weights, terms, q, stream);
}

}  // extern "C"
