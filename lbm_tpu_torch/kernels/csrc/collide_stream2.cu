// The fused pair of steps (K2) and the chunked state read (K4) on fp32
// state: the C entries of collide_stream2.cuh with S = float. Each entry
// returns cudaGetLastError() or cudaErrorInvalidValue for a malformed
// call.

#include "collide_stream2.cuh"

extern "C" {

const char* lbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int lbm_pair_unit(int axis) { return pair_unit(axis); }

int lbm_pair_block_size() { return kPairThreads; }

int lbm_pair_blocks_per_sm(int key) {
  return pair_blocks_per_sm<float>(key);
}

long long lbm_pair_smem_bytes() {
  return (long long)kPairSmem;
}

int lbm_collide_stream2(const float* src, float* dst, const int8_t* mask,
                        int nx, int ny, int nz, const int* coll_int,
                        const float* coll_float, int n_bc, const int* bc_int,
                        const float* bc_float, const void* const* valid_ptrs,
                        const void* const* phi_t, const void* const* phi_t1,
                        const int* units, int n_units, double* partials,
                        int n_partials, double* series, int slot,
                        void* stream) {
  return collide_stream2<float>(src, dst, mask, nx, ny, nz, coll_int,
                                coll_float, n_bc, bc_int, bc_float,
                                valid_ptrs, phi_t, phi_t1, units, n_units,
                                partials, n_partials, series, slot, stream);
}

int lbm_extract_rows(const float* f, float* out, int X, int Y, int Z, int x0,
                     int wx, void* stream) {
  return extract_rows<float>(f, out, X, Y, Z, x0, wx, stream);
}

}  // extern "C"
