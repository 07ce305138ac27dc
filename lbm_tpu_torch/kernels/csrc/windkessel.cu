// The windkessel (RCR) outlet flux and P_c update for NVIDIA Hopper
// (sm_90a), on fp32 or bf16 state: lbm_windkessel_flux and
// lbm_windkessel_flux_bf16.
//
// lbm_tpu evaluates a windkessel outlet inside its fixup
// (lbm_tpu/engine/step.py apply_bc_fixup, run after its kernel by
// kernels/collide_stream.py::_fix_xy_plane_windowed and, through K6 and
// K5, ::_fix_z_plane_windowed): the outward flux Q = flow_sign * sum of
// flow_weight * u_prev[axis] over the outlet's footprint on its consumer
// plane, u_prev the moments of the PRE-step populations (with the Guo
// half force), then one backward-Euler step of the RCR model,
//   P_c' = (P_c + Q / C) / (1 + 1 / (Rd C)),   P_in = Q Rp + P_c',
// and the rewrite's rho* = rho_fixed + 3 P_in. Here the collide-stream
// kernel rewrites the outlet plane in its own pass (a descriptor whose
// rho_dyn points at rho_star[k]), so this kernel runs before it on the
// same stream: it reads only the pre-step state and writes only wk and
// rho_star, which the collide-stream launch reads.
//
// One block a windkessel outlet. Its footprint is a host-built list of
// cell ids (cells[begin, end)) with their fp32 weights. Thread j sums the
// weighted u[axis] of cells begin + j, begin + j + kWKBlock, ... in that
// order, from 0, and the block adds the partial sums in a fixed tree
// (no float atomics), so a run repeats bit for bit and the plain version
// (kernels/collide_stream.windkessel_flux_plain) repeats the same order.
// Thread 0 then applies the update in fp32, in lbm_tpu's operation order
// (the build has -fmad=false; 1 + 1/(Rd C) comes composed in fp32 from the
// host, as lbm_tpu folds it at trace time).

#include "d3q19.cuh"

namespace {

constexpr int kMaxWK = 12;     // the collide-stream kernel's 4 + 8 planes
constexpr int kWKBlock = 256;
constexpr int kWKInts = 3;     // axis, begin, end
constexpr int kWKFloats = 5;   // sign, Rp, C, 1 + 1/(Rd C), rho_fixed

struct WK {
  int axis;        // the velocity component of the flux
  int begin, end;  // the footprint's rows of cells / weights
  float sign;      // flow_sign = -normal
  float rp, cap, denom;
  float rho_fixed;
};

struct WKSet {
  int n;
  WK wk[kMaxWK];
  float half_force[3];
};

template <bool FORCE, typename S>
__global__ void __launch_bounds__(kWKBlock)
windkessel_flux_kernel(const S* __restrict__ src, long long n_cells,
                       const __grid_constant__ WKSet set,
                       const int* __restrict__ cells,
                       const float* __restrict__ weights,
                       float* __restrict__ wk, float* __restrict__ rho_star) {
  const WK& d = set.wk[blockIdx.x];
  float acc = 0.0f;
  for (int k = d.begin + threadIdx.x; k < d.end; k += kWKBlock) {
    const long long cell = cells[k];
    float p[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) p[i] = widen(src[i * n_cells + cell]);
    float rho, ux, uy, uz;
    moments19<FORCE>(p, set.half_force, rho, ux, uy, uz);
    const float ua = d.axis == 0 ? ux : (d.axis == 1 ? uy : uz);
    acc = acc + weights[k] * ua;
  }
  __shared__ float red[kWKBlock];
  red[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (unsigned s = kWKBlock / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] = red[threadIdx.x] + red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float q = d.sign * red[0];
    const float p_new = (wk[blockIdx.x] + q / d.cap) / d.denom;
    const float p_in = q * d.rp + p_new;
    wk[blockIdx.x] = p_new;
    rho_star[blockIdx.x] = d.rho_fixed + 3.0f * p_in;
  }
}

// wk_int rows (axis, begin, end) and wk_float rows (sign, Rp, C,
// 1 + 1/(Rd C), rho_fixed), one a windkessel outlet in the carried
// vector's order, on the host; half_force: null or the host F/2
// 3-vector; cells, weights: the footprints' cell ids and fp32 weights on
// the device; wk: the (n_wk,) fp32 P_c, updated in place; rho_star:
// (n_wk,) fp32 out. Returns cudaGetLastError().
template <typename S>
int windkessel_flux(const S* src, long long n_cells, int n_wk,
                    const int* wk_int, const float* wk_float,
                    const float* half_force, const int* cells,
                    const float* weights, float* wk, float* rho_star,
                    void* stream) {
  if (n_wk <= 0 || n_wk > kMaxWK || n_cells <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  WKSet set = {};
  set.n = n_wk;
  for (int b = 0; b < n_wk; ++b) {
    const int* r = wk_int + b * kWKInts;
    const float* f = wk_float + b * kWKFloats;
    WK& d = set.wk[b];
    d.axis = r[0];
    d.begin = r[1];
    d.end = r[2];
    if (d.axis < 0 || d.axis > 2 || d.begin < 0 || d.end < d.begin) {
      return (int)cudaErrorInvalidValue;
    }
    d.sign = f[0];
    d.rp = f[1];
    d.cap = f[2];
    d.denom = f[3];
    d.rho_fixed = f[4];
  }
  for (int a = 0; a < 3; ++a) set.half_force[a] = half_force ? half_force[a] : 0.0f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (half_force) {
    windkessel_flux_kernel<true, S><<<n_wk, kWKBlock, 0, s>>>(
        src, n_cells, set, cells, weights, wk, rho_star);
  } else {
    windkessel_flux_kernel<false, S><<<n_wk, kWKBlock, 0, s>>>(
        src, n_cells, set, cells, weights, wk, rho_star);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lbm_windkessel_block_size() { return kWKBlock; }

int lbm_windkessel_max() { return kMaxWK; }

const char* lbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int lbm_windkessel_flux(const float* src, long long n_cells, int n_wk,
                        const int* wk_int, const float* wk_float,
                        const float* half_force, const int* cells,
                        const float* weights, float* wk, float* rho_star,
                        void* stream) {
  return windkessel_flux<float>(src, n_cells, n_wk, wk_int, wk_float,
                                half_force, cells, weights, wk, rho_star,
                                stream);
}

int lbm_windkessel_flux_bf16(const void* src, long long n_cells, int n_wk,
                             const int* wk_int, const float* wk_float,
                             const float* half_force, const int* cells,
                             const float* weights, float* wk,
                             float* rho_star, void* stream) {
  return windkessel_flux<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(src), n_cells, n_wk, wk_int,
      wk_float, half_force, cells, weights, wk, rho_star, stream);
}

}  // extern "C"
