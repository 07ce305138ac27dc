// D3Q19 BGK collide-stream and moments kernels for NVIDIA Hopper (sm_90a).
//
// lbm_collide_stream_bgk (K1a) replaces lbm_tpu/kernels/collide_stream.py
// ::_kernel (its BGK branch, body _subtile_compute), ::_row_fix (the
// in-kernel NEE rows) and the per-tile velsum. lbm_macro (K3) replaces
// ::packed_macro.
//
// State layout: f[19][nx][ny][nz] fp32, z contiguous, two ping-pong
// buffers (the kernel reads `src` and writes `dst`, never in place, so a
// cell's NEE rewrite always sees its own PRE-step populations). The mask
// is int8 (GHOST -1 and MOVING -2 are negative labels).
//
// Semantics are those of the dense step (lbm_tpu_torch/engine/step.py):
// the pull wraps modulo on all three axes, exactly like torch.roll, so
// the kernel needs no padding ring. Arithmetic follows the dense step's
// operation order (moments summed in direction order, phi as
// w*(1 + 3cu + 4.5cu^2 - 1.5|u|^2), BGK dividing by tau), and the build
// turns off FMA contraction (kernels/_build.py), so the result is bit
// for bit the dense step's.
//
// What bounds it: bytes first. A fluid cell reads 19 floats and writes
// 19 (152 B), plus 18 one-byte neighbor mask reads that mostly hit
// L1/L2; the ~250 flops are below the card's ratio, but the instruction
// count (22 IEEE divisions, cell-index div/mod, 18 wraps) and 80
// registers a thread keep this first version short of the bandwidth
// roofline. It is one thread per cell with z the fastest thread index,
// so the 18 neighbor gathers of a warp are 32 consecutive floats each
// (shifted by at most one element along z) and coalesce. Velsum partials are
// reduced in double and in a fixed order, so the stop rule fires at the
// same step in every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 19;
constexpr int kMaxBCs = 4;
constexpr int kMaxDirs = 5;
constexpr int kBlock = 256;
constexpr int kReduceBlock = 1024;
constexpr int kBCInts = 6 + kMaxDirs;  // layout of one row of bc_int
constexpr int8_t kWall = 1;
constexpr int8_t kFluid = 4;

__host__ __device__ constexpr int EX(int i) {
  constexpr int v[Q] = {0, 1, -1, 0, 0, 0, 0, 1, 1, -1, -1,
                        1, 1, -1, -1, 0, 0, 0, 0};
  return v[i];
}
__host__ __device__ constexpr int EY(int i) {
  constexpr int v[Q] = {0, 0, 0, 1, -1, 0, 0, 1, -1, 1, -1,
                        0, 0, 0, 0, 1, -1, 1, -1};
  return v[i];
}
__host__ __device__ constexpr int EZ(int i) {
  constexpr int v[Q] = {0, 0, 0, 0, 0, 1, -1, 0, 0, 0, 0,
                        1, -1, 1, -1, 1, 1, -1, -1};
  return v[i];
}
__host__ __device__ constexpr int OPP(int i) {
  constexpr int v[Q] = {0, 2, 1, 4, 3, 6, 5, 10, 9, 8, 7,
                        14, 13, 12, 11, 18, 17, 16, 15};
  return v[i];
}
__host__ __device__ constexpr float WGT(int i) {
  return i == 0 ? 1.0f / 3.0f : (i < 7 ? 1.0f / 18.0f : 1.0f / 36.0f);
}

// One NEE boundary on its consumer plane (axis 0 or 1). The lateral
// axes are (y, z) for axis 0 and (x, z) for axis 1, so a plane cell's
// lateral index is a * nz + z with a = y or x; tables are (D, A, nz).
struct BCDesc {
  int axis;
  int coord;       // consumer-plane coordinate along axis
  int lat_a;       // A, the first lateral extent
  int rho_is_fixed;
  int u_extrap;    // 1: u* = u_prev (phi* = phi_prev), no phi_star table
  float rho_fixed;
  float omega;     // 1 - 1/tau
  int slot[Q];     // slot[i] = d if direction i is the plane's d-th, else -1
  const uint8_t* valid;   // (D, A, nz) bytes
  const float* phi_star;  // (D, A, nz) fp32, or null when u_extrap
};

struct BCSet {
  int n;
  BCDesc bc[kMaxBCs];
};

__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// e_i . u summed x, y, z in order, as engine/step's signed sums do.
__device__ __forceinline__ float e_dot(int i, float ux, float uy, float uz) {
  float cu = 0.0f;
  if (EX(i) > 0) cu += ux;
  if (EX(i) < 0) cu -= ux;
  if (EY(i) > 0) cu += uy;
  if (EY(i) < 0) cu -= uy;
  if (EZ(i) > 0) cu += uz;
  if (EZ(i) < 0) cu -= uz;
  return cu;
}

__device__ __forceinline__ float phi_i(int i, float ux, float uy, float uz,
                                       float usq) {
  const float cu = e_dot(i, ux, uy, uz);
  return WGT(i) * (1.0f + 3.0f * cu + 4.5f * cu * cu - 1.5f * usq);
}

// rho and u = m / rho (rho == 0 read as 1) of 19 populations.
__device__ __forceinline__ void moments19(const float* p, float& rho,
                                          float& ux, float& uy, float& uz) {
  rho = p[0];
#pragma unroll
  for (int i = 1; i < Q; ++i) rho += p[i];
  float mx = 0.0f, my = 0.0f, mz = 0.0f;
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    if (EX(i) > 0) mx += p[i];
    if (EX(i) < 0) mx -= p[i];
    if (EY(i) > 0) my += p[i];
    if (EY(i) < 0) my -= p[i];
    if (EZ(i) > 0) mz += p[i];
    if (EZ(i) < 0) mz -= p[i];
  }
  const float safe = rho == 0.0f ? 1.0f : rho;
  ux = mx / safe;
  uy = my / safe;
  uz = mz / safe;
}

// Rewrite the pulled populations of one consumer-plane cell with the
// NEE formula: p_i = rho* phi*_i + (f_i(x) - rho_prev phi_i(u_prev)) omega
// for each prescribed direction whose lateral cell is valid.
__device__ __forceinline__ void nee_fix(const BCDesc& bc,
                                        const float* __restrict__ src,
                                        long long n_cells, int cell,
                                        long long lat, long long plane,
                                        float* p) {
  float own[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) own[i] = src[(long long)i * n_cells + cell];
  float rp, uxp, uyp, uzp;
  moments19(own, rp, uxp, uyp, uzp);
  const float usqp = uxp * uxp + uyp * uyp + uzp * uzp;
  const float rho_star = bc.rho_is_fixed ? bc.rho_fixed : rp;
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    const int d = bc.slot[i];
    if (d < 0 || !bc.valid[d * plane + lat]) continue;
    const float phi_nbr = phi_i(i, uxp, uyp, uzp, usqp);
    const float phi_star = bc.u_extrap ? phi_nbr : bc.phi_star[d * plane + lat];
    const float feq_nbr = rp * phi_nbr;
    p[i] = rho_star * phi_star + (own[i] - feq_nbr) * bc.omega;
  }
}

__global__ void __launch_bounds__(kBlock)
collide_stream_bgk_kernel(const float* __restrict__ src,
                          float* __restrict__ dst,
                          const int8_t* __restrict__ mask, int nx, int ny,
                          int nz, float tau, BCSet bcs,
                          double* __restrict__ partials) {
  const long long n_cells = (long long)nx * ny * nz;  // < 2^31 (host check)
  const long long cell_ll = (long long)blockIdx.x * kBlock + threadIdx.x;
  float speed = 0.0f;
  if (cell_ll < n_cells) {
    const int cell = (int)cell_ll;
    if (mask[cell] != kFluid) {
      // non-fluid cells keep their populations in both buffers
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const long long o = (long long)i * n_cells + cell;
        dst[o] = src[o];
      }
    } else {
      const int z = cell % nz;
      const int xy = cell / nz;
      const int y = xy % ny;
      const int x = xy / ny;
      float p[Q];
      p[0] = src[cell];
#pragma unroll
      for (int i = 1; i < Q; ++i) {
        const int xs = wrap(x - EX(i), nx);
        const int ys = wrap(y - EY(i), ny);
        const int zs = wrap(z - EZ(i), nz);
        const int nb = (xs * ny + ys) * nz + zs;
        // half-way bounce-back: a wall source returns the cell's own
        // opposite population
        p[i] = mask[nb] == kWall ? src[(long long)OPP(i) * n_cells + cell]
                                 : src[(long long)i * n_cells + nb];
      }
#pragma unroll
      for (int b = 0; b < kMaxBCs; ++b) {
        if (b >= bcs.n) break;
        const BCDesc& bc = bcs.bc[b];
        if ((bc.axis == 0 ? x : y) != bc.coord) continue;
        const long long lat = (long long)(bc.axis == 0 ? y : x) * nz + z;
        const long long plane = (long long)bc.lat_a * nz;
        nee_fix(bc, src, n_cells, cell, lat, plane, p);
      }
      float rho, ux, uy, uz;
      moments19(p, rho, ux, uy, uz);
      const float usq = ux * ux + uy * uy + uz * uz;
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const float feq = rho * phi_i(i, ux, uy, uz, usq);
        dst[(long long)i * n_cells + cell] = p[i] - (p[i] - feq) / tau;
      }
      speed = sqrtf(usq);
    }
  }
  // fixed-order block sum of the fluid speeds, in double
  __shared__ double red[kBlock];
  red[threadIdx.x] = (double)speed;
  __syncthreads();
#pragma unroll
  for (unsigned s = kBlock / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[blockIdx.x] = red[0];
}

// series[t] = sum of the block partials, in a fixed order.
__global__ void __launch_bounds__(kReduceBlock)
velsum_reduce_kernel(const double* __restrict__ partials, int n,
                     double* __restrict__ series, int t) {
  __shared__ double red[kReduceBlock];
  double acc = 0.0;
  for (int k = threadIdx.x; k < n; k += kReduceBlock) acc += partials[k];
  red[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (unsigned s = kReduceBlock / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) series[t] = red[0];
}

__global__ void __launch_bounds__(kBlock)
macro_kernel(const float* __restrict__ f, float* __restrict__ rho_out,
             float* __restrict__ u_out, long long n_cells) {
  const long long cell = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (cell >= n_cells) return;
  float p[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) p[i] = f[i * n_cells + cell];
  float rho, ux, uy, uz;
  moments19(p, rho, ux, uy, uz);
  rho_out[cell] = rho;
  u_out[cell] = ux;
  u_out[n_cells + cell] = uy;
  u_out[2 * n_cells + cell] = uz;
}

}  // namespace

extern "C" {

int lbm_block_size() { return kBlock; }

const char* lbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One BGK step from src into dst; series[t] = sum over fluid cells of |u|.
// bc_int rows: axis, coord, lat_a, rho_is_fixed, u_extrap, ndirs,
// dirs[kMaxDirs]; bc_float rows: rho_fixed, omega. partials holds
// ceil(nx*ny*nz / lbm_block_size()) doubles. Returns cudaGetLastError().
int lbm_collide_stream_bgk(const float* src, float* dst, const int8_t* mask,
                           int nx, int ny, int nz, float tau, int n_bc,
                           const int* bc_int, const float* bc_float,
                           const void* const* valid_ptrs,
                           const void* const* phi_ptrs, double* partials,
                           int n_partials, double* series, int t,
                           void* stream) {
  const long long n_cells = (long long)nx * ny * nz;
  const long long blocks = (n_cells + kBlock - 1) / kBlock;
  if (n_bc < 0 || n_bc > kMaxBCs || n_cells <= 0 ||
      n_cells > 0x7fffffffLL || blocks != n_partials) {
    return (int)cudaErrorInvalidValue;
  }
  BCSet bcs = {};
  bcs.n = n_bc;
  for (int b = 0; b < n_bc; ++b) {
    const int* row = bc_int + b * kBCInts;
    BCDesc& d = bcs.bc[b];
    d.axis = row[0];
    d.coord = row[1];
    d.lat_a = row[2];
    d.rho_is_fixed = row[3];
    d.u_extrap = row[4];
    const int ndirs = row[5];
    if (ndirs < 0 || ndirs > kMaxDirs || (d.axis != 0 && d.axis != 1)) {
      return (int)cudaErrorInvalidValue;
    }
    for (int i = 0; i < Q; ++i) d.slot[i] = -1;
    for (int k = 0; k < ndirs; ++k) {
      const int i = row[6 + k];
      if (i <= 0 || i >= Q) return (int)cudaErrorInvalidValue;
      d.slot[i] = k;
    }
    d.rho_fixed = bc_float[2 * b];
    d.omega = bc_float[2 * b + 1];
    d.valid = static_cast<const uint8_t*>(valid_ptrs[b]);
    d.phi_star = static_cast<const float*>(phi_ptrs[b]);
    if (!d.u_extrap && d.phi_star == nullptr) {
      return (int)cudaErrorInvalidValue;
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  collide_stream_bgk_kernel<<<(unsigned)blocks, kBlock, 0, s>>>(
      src, dst, mask, nx, ny, nz, tau, bcs, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  velsum_reduce_kernel<<<1, kReduceBlock, 0, s>>>(partials, n_partials,
                                                   series, t);
  return (int)cudaGetLastError();
}

// rho = sum_i f_i and u = sum_i e_i f_i / rho (rho == 0 read as 1) per
// cell; rho (n_cells,), u (3, n_cells). Returns cudaGetLastError().
int lbm_macro(const float* f, float* rho, float* u, long long n_cells,
              void* stream) {
  if (n_cells <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_cells + kBlock - 1) / kBlock;
  macro_kernel<<<(unsigned)blocks, kBlock, 0,
                 static_cast<cudaStream_t>(stream)>>>(f, rho, u, n_cells);
  return (int)cudaGetLastError();
}

}  // extern "C"
