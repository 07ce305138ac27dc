// D3Q7 advection-diffusion kernel for NVIDIA Hopper (sm_90a).
//
// lbm_scalar_stream (K7 and K8) replaces lbm_tpu/kernels/
// scalar_stream.py::_kernel7: its frozen-field body _subtile7 (K7: the
// velocity is a static, projected field) and its coupled body
// _subtile7f (K8: the velocity is rebuilt per cell from the flow
// kernel's post-collision D3Q19 state, optionally with the Boussinesq
// force of the pre-update scalar). It also does, inside the same launch,
// what lbm_tpu runs outside its kernel as dense recomputes on 3-plane
// slabs cut and spliced with ::_extract_z_slab and
// ::_splice_z_plane_inplace at nch=7: the boundary planes' NEE-style
// rewrite, the Dirichlet (anti-bounce-back) walls, and the per-step
// record of each boundary's mean concentration.
//
// One step of dc/dt + u.grad(c) = D lap(c) + s on the seven directions
// rest, +-x, +-y, +-z (the first seven of the D3Q19 order), for cell x:
//
//   v_i = g_i(x - e_i)                     pulled, wrapped on every axis
//       = g_opp(i)(x)                      off a WALL or MOVING source
//       = 2 w_i c_w(x - e_i) - g_opp(i)(x) off a Dirichlet wall (c_w finite)
//       = c* phi_d + (g_d(x) - c_prev phi_d) omega
//                          on a boundary's consumer plane, direction d,
//                          c_prev = sum_i g_i(x), c* given or c_prev
//   c = sum_i v_i,  phi_0 = 1/4, phi_i = 1/8 (1 +- 4 u_a)
//   g_i'(x) = v_i - (v_i - c phi_i) / tau_g  [+ c comp w_i] [+ s w_i]
//
// written for fluid cells only. State layout: g[7][nx][ny][nz] fp32, z
// contiguous, two ping-pong buffers. Non-fluid cells are never written:
// both buffers hold the same values there from set-up on (zeros), as the
// flow state's non-fluid cells do. Because the source buffer stays
// intact, every rewrite above is local to the consumer cell, so no slab
// copy and no second pass are needed. Semantics and operation order are
// those of the plain pass (lbm_tpu_torch/engine/scalar.transport_pass):
// sums in channel order, 1/tau_g a multiplication by the fp32
// reciprocal, the build without FMA contraction, so g is bit for bit the
// plain version's.
//
// K8's velocity: rho and m summed over the cell's own 19 post-collision
// populations in direction order, u = (m - F/2) * (1 / rho) with rho ==
// 0 read as 1, each component zeroed where a neighbor along its axis
// blocks (the impermeability projection); F = buoy (c_prev - c_ref) +
// base at fluid cells under FORCE.
//
// The record: a cell on a boundary's consumer plane under its footprint
// stores its post-stream c into that boundary's plane buffer; a second
// small kernel sums each buffer over the footprint's list of lateral
// indices (built once on the host) in double, in a fixed order, divides
// by the footprint's size and writes one row of the (steps, boundaries)
// series. No atomics, no host read per step. The footprint of a vessel's
// outlet is a few hundred cells of a plane of up to 10^5.
//
// What bounds it: bytes. A fluid cell reads 7 floats of g, 3 of u and
// one of comp (K7) or 19 of f' (K8), six mask bytes, and writes 7
// floats; the ~40 flops are far below the card's ratio. One thread per
// cell, z fastest, so a warp's pulls are 32 consecutive floats. Vessel
// trees launch over an ascending list of the cells the step touches: the
// fluid cells and the cells under a footprint on its consumer plane,
// whose c the record reads (engine/scalar.compile_scalar), so warps
// carry those cells densely (17% of the lanes of the coronary's live
// 256-cell blocks hold a fluid cell).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int Q7 = 7;
constexpr int Q19 = 19;
constexpr int kBlock = 256;
constexpr int kRecordBlock = 256;
constexpr int kMaxBCs = 8;
constexpr int kBCInts = 4;    // axis, consumer coord, direction, c* given
constexpr int kBCFloats = 2;  // c*, footprint size
constexpr int8_t kWall = 1;
constexpr int8_t kFluid = 4;
constexpr int8_t kMoving = -2;

// Offsets of the parameter rows: SINT and SFLOAT in
// kernels/scalar_stream.py (a CPU test compares them).
enum SInt {
  SI_live = 0, SI_comp = 1, SI_force = 2, SI_dirichlet = 3, SI_source = 4,
  SI_n = 5
};
enum SFloat {
  SF_inv_tau = 0, SF_omega = 1, SF_source = 2, SF_buoy = 3, SF_c_ref = 6,
  SF_base = 7, SF_n = 10
};

__host__ __device__ constexpr int EX7(int i) {
  return i == 1 ? 1 : (i == 2 ? -1 : 0);
}
__host__ __device__ constexpr int EY7(int i) {
  return i == 3 ? 1 : (i == 4 ? -1 : 0);
}
__host__ __device__ constexpr int EZ7(int i) {
  return i == 5 ? 1 : (i == 6 ? -1 : 0);
}
__host__ __device__ constexpr int OPP7(int i) {
  return i == 0 ? 0 : (i % 2 == 1 ? i + 1 : i - 1);
}
__host__ __device__ constexpr float W7(int i) {
  return i == 0 ? 0.25f : 0.125f;
}
__host__ __device__ constexpr int EX19(int i) {
  constexpr int v[Q19] = {0, 1, -1, 0, 0, 0, 0, 1, 1, -1, -1,
                          1, 1, -1, -1, 0, 0, 0, 0};
  return v[i];
}
__host__ __device__ constexpr int EY19(int i) {
  constexpr int v[Q19] = {0, 0, 0, 1, -1, 0, 0, 1, -1, 1, -1,
                          0, 0, 0, 0, 1, -1, 1, -1};
  return v[i];
}
__host__ __device__ constexpr int EZ19(int i) {
  constexpr int v[Q19] = {0, 0, 0, 0, 0, 1, -1, 0, 0, 0, 0,
                          1, -1, 1, -1, 1, 1, -1, -1};
  return v[i];
}

struct SParams {
  float inv_tau;   // fp32 1 / tau_g
  float omega;     // fp32 1 - 1 / tau_g
  float source;    // s
  float buoy[3];   // FORCE: F = buoy (c_prev - c_ref) + base
  float c_ref;
  float base[3];
  int has_source;
};

// One boundary on its consumer plane. Lateral index of a plane cell:
// y * nz + z (axis 0), x * nz + z (axis 1), x * ny + y (axis 2).
struct SBC {
  int axis;
  int coord;      // consumer-plane coordinate along axis
  int dir;        // the one D3Q7 direction that crosses the plane
  int fixed;      // 1: c* = c_star; 0: zero gradient, c* = c_prev
  float c_star;
  double count;   // cells of the footprint
  int foot_lo, foot_hi;    // the footprint's lateral indices in the list
  const uint8_t* valid;    // (A, B) bytes, the footprint
  float* cplane;           // (A, B) post-stream c of the footprint cells
};

struct SBCSet {
  int n;
  SBC bc[kMaxBCs];
};

__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// The lateral index of cell (x, y, z) on the boundary's consumer plane
// if it lies there under the footprint, else -1.
__device__ __forceinline__ long long plane_lat(const SBC& bc, int x, int y,
                                               int z, int ny, int nz) {
  const int along = bc.axis == 0 ? x : (bc.axis == 1 ? y : z);
  if (along != bc.coord) return -1;
  const long long lat = bc.axis == 0 ? (long long)y * nz + z
                        : bc.axis == 1 ? (long long)x * nz + z
                                       : (long long)x * ny + y;
  return bc.valid[lat] ? lat : -1;
}

// Thread k of the launch steps the k-th cell of the list `cells`
// (n_listed ids, ascending), or cell k of the box when `cells` is null.
// The boundary set is a __grid_constant__ parameter: the loops over it
// index the parameter bank and copy nothing.
template <bool LIVE, bool COMP, bool FORCE, bool DIRICHLET>
__global__ void __launch_bounds__(kBlock)
scalar_stream_kernel(const float* __restrict__ src, float* __restrict__ dst,
                     const int8_t* __restrict__ mask, int nx, int ny, int nz,
                     const float* __restrict__ u, const float* __restrict__ f,
                     const float* __restrict__ comp,
                     const float* __restrict__ wall_c, SParams p,
                     const __grid_constant__ SBCSet bcs,
                     const int* __restrict__ cells, int n_listed) {
  const long long n_cells = (long long)nx * ny * nz;  // < 2^31 (host check)
  const long long k = (long long)blockIdx.x * kBlock + threadIdx.x;
  const long long cell_ll =
      cells ? (k < n_listed ? (long long)cells[k] : n_cells) : k;
  if (cell_ll >= n_cells) return;
  const int cell = (int)cell_ll;
  const bool fluid = mask[cell] == kFluid;
  const int z = cell % nz;
  const int xy = cell / nz;
  const int y = xy % ny;
  const int x = xy / ny;
  bool on_plane = false;
  for (int b = 0; b < bcs.n; ++b) {
    on_plane = on_plane || plane_lat(bcs.bc[b], x, y, z, ny, nz) >= 0;
  }
  // a non-fluid cell keeps its g; under a footprint its c is recorded
  if (!fluid && !on_plane) return;

  float own[Q7];
#pragma unroll
  for (int i = 0; i < Q7; ++i) own[i] = src[(long long)i * n_cells + cell];
  float c_prev = own[0];
#pragma unroll
  for (int i = 1; i < Q7; ++i) c_prev += own[i];

  // pull with bounce-back, then the Dirichlet override
  float v[Q7];
  bool blocked[Q7];
  v[0] = own[0];
  blocked[0] = false;
#pragma unroll
  for (int i = 1; i < Q7; ++i) {
    const int xs = wrap(x - EX7(i), nx);
    const int ys = wrap(y - EY7(i), ny);
    const int zs = wrap(z - EZ7(i), nz);
    const int nb = (xs * ny + ys) * nz + zs;
    const int8_t m = mask[nb];
    blocked[i] = m == kWall || m == kMoving;
    v[i] = blocked[i] ? own[OPP7(i)] : src[(long long)i * n_cells + nb];
    if constexpr (DIRICHLET) {
      if (blocked[i]) {
        const float cw = wall_c[nb];
        if (isfinite(cw)) v[i] = (2.0f * W7(i)) * cw - own[OPP7(i)];
      }
    }
  }

  // the advecting velocity
  float ua[3];
  if constexpr (LIVE) {
    float q[Q19];
#pragma unroll
    for (int i = 0; i < Q19; ++i) q[i] = f[(long long)i * n_cells + cell];
    float rho = q[0];
#pragma unroll
    for (int i = 1; i < Q19; ++i) rho += q[i];
    float mom[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 1; i < Q19; ++i) {
      if (EX19(i) > 0) mom[0] += q[i];
      if (EX19(i) < 0) mom[0] -= q[i];
      if (EY19(i) > 0) mom[1] += q[i];
      if (EY19(i) < 0) mom[1] -= q[i];
      if (EZ19(i) > 0) mom[2] += q[i];
      if (EZ19(i) < 0) mom[2] -= q[i];
    }
    if constexpr (FORCE) {
      const float dc = fluid ? c_prev - p.c_ref : 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float F = p.buoy[a] * dc + p.base[a];
        mom[a] = mom[a] - 0.5f * F;
      }
    }
    const float inv_rho = 1.0f / (rho == 0.0f ? 1.0f : rho);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      ua[a] = (blocked[1 + 2 * a] || blocked[2 + 2 * a]) ? 0.0f
                                                         : mom[a] * inv_rho;
    }
  } else {
#pragma unroll
    for (int a = 0; a < 3; ++a) ua[a] = u[(long long)a * n_cells + cell];
  }
  float phi[Q7];
  phi[0] = W7(0);
#pragma unroll
  for (int i = 1; i < Q7; ++i) {
    const float s = (i % 2 == 1) ? 4.0f : -4.0f;
    phi[i] = W7(i) * (1.0f + s * ua[(i - 1) / 2]);
  }

  // the boundary planes' rewrite of their one crossing direction
  for (int b = 0; b < bcs.n; ++b) {
    const SBC& bc = bcs.bc[b];
    if (plane_lat(bc, x, y, z, ny, nz) < 0) continue;
    const float c_star = bc.fixed ? bc.c_star : c_prev;
    // a select per direction: indexing v by bc.dir would move the
    // thread's arrays from registers to local memory
#pragma unroll
    for (int i = 1; i < Q7; ++i) {
      const float val =
          c_star * phi[i] + (own[i] - c_prev * phi[i]) * p.omega;
      v[i] = i == bc.dir ? val : v[i];
    }
  }

  float c = v[0];
#pragma unroll
  for (int i = 1; i < Q7; ++i) c += v[i];
  for (int b = 0; b < bcs.n; ++b) {
    const long long lat = plane_lat(bcs.bc[b], x, y, z, ny, nz);
    if (lat >= 0) bcs.bc[b].cplane[lat] = c;
  }
  if (!fluid) return;

  float c_comp = 0.0f;
  if constexpr (COMP) c_comp = c * comp[cell];
#pragma unroll
  for (int i = 0; i < Q7; ++i) {
    float post = v[i] - (v[i] - c * phi[i]) * p.inv_tau;
    if constexpr (COMP) post = post + c_comp * W7(i);
    if (p.has_source) post = post + p.source * W7(i);
    dst[(long long)i * n_cells + cell] = post;
  }
}

// row[b] = the mean of boundary b's plane buffer over its footprint: one
// block a boundary, a fixed-order sum in double over the footprint's
// lateral indices foot[bc.foot_lo ... bc.foot_hi - 1].
__global__ void __launch_bounds__(kRecordBlock)
scalar_record_kernel(const __grid_constant__ SBCSet bcs,
                     const int* __restrict__ foot, double* __restrict__ row) {
  __shared__ double red[kRecordBlock];
  const SBC& bc = bcs.bc[blockIdx.x];
  double acc = 0.0;
  for (int k = bc.foot_lo + threadIdx.x; k < bc.foot_hi; k += kRecordBlock) {
    acc += (double)bc.cplane[foot[k]];
  }
  red[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (unsigned s = kRecordBlock / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) row[blockIdx.x] = red[0] / bc.count;
}

struct SArgs {
  const float* src;
  float* dst;
  const int8_t* mask;
  int nx, ny, nz;
  const float* u;
  const float* f;
  const float* comp;
  const float* wall_c;
  const int* cells;
  int n_listed;
  unsigned grid;
  cudaStream_t stream;
};

template <bool LIVE, bool COMP, bool FORCE, bool DIRICHLET>
void launch(const SArgs& a, const SParams& p, const SBCSet& b) {
  scalar_stream_kernel<LIVE, COMP, FORCE, DIRICHLET>
      <<<a.grid, kBlock, 0, a.stream>>>(a.src, a.dst, a.mask, a.nx, a.ny,
                                        a.nz, a.u, a.f, a.comp, a.wall_c, p,
                                        b, a.cells, a.n_listed);
}

template <bool LIVE, bool X>
void launch_dirichlet(bool dirichlet, const SArgs& a, const SParams& p,
                      const SBCSet& b) {
  // X: comp of a frozen launch, force of a live one
  if (dirichlet) {
    launch<LIVE, !LIVE && X, LIVE && X, true>(a, p, b);
  } else {
    launch<LIVE, !LIVE && X, LIVE && X, false>(a, p, b);
  }
}

}  // namespace

extern "C" {

int lbm_scalar_block_size() { return kBlock; }

const char* lbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One D3Q7 step from src into dst (fluid cells only). s_int/s_float: the
// parameter rows (SInt/SFloat). u: the frozen projected velocity
// (3, n_cells) when SI_live == 0; f: the flow's post-collision state
// (19, n_cells) when SI_live == 1; comp (n_cells) under SI_comp; wall_c
// (n_cells, NaN = adiabatic) under SI_dirichlet. Boundary rows: bc_int
// (axis, consumer coord, direction, c* given), bc_float (c*, footprint
// size), valid_ptrs[b] the footprint bytes, cplane_ptrs[b] the plane
// buffer; foot: a device list of every boundary's footprint, the
// ascending lateral indices of its valid cells, boundary b's at
// foot[foot_off[b] ... foot_off[b + 1] - 1] (foot_off: n_bc + 1 host
// ints). cells: null (every cell) or a device list of n_listed cell
// ids, ascending, holding every fluid cell and every cell under a
// footprint on its consumer plane (the others are left as they are).
// record_row: null, or n_bc doubles that get each boundary's mean
// post-stream concentration. Returns cudaGetLastError().
int lbm_scalar_stream(const float* src, float* dst, const int8_t* mask,
                      int nx, int ny, int nz, const float* u, const float* f,
                      const float* comp, const float* wall_c,
                      const int* s_int, const float* s_float, int n_bc,
                      const int* bc_int, const float* bc_float,
                      const void* const* valid_ptrs,
                      void* const* cplane_ptrs, const int* foot,
                      const int* foot_off, const int* cells, int n_listed,
                      double* record_row, void* stream) {
  const long long n_cells = (long long)nx * ny * nz;
  const long long grid = ((cells ? n_listed : n_cells) + kBlock - 1) / kBlock;
  const bool live = s_int[SI_live] != 0, has_comp = s_int[SI_comp] != 0;
  const bool force = s_int[SI_force] != 0;
  const bool dirichlet = s_int[SI_dirichlet] != 0;
  if (n_bc < 0 || n_bc > kMaxBCs || n_cells <= 0 ||
      n_cells > 0x7fffffffLL || (cells && (n_listed <= 0 ||
                                           n_listed > n_cells)) ||
      (n_bc > 0 && (foot == nullptr || foot_off == nullptr)) ||
      src == dst || (live ? f == nullptr : u == nullptr) ||
      (live && has_comp) || (!live && force) ||
      (has_comp && comp == nullptr) || (dirichlet && wall_c == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  SParams p = {};
  p.inv_tau = s_float[SF_inv_tau];
  p.omega = s_float[SF_omega];
  p.source = s_float[SF_source];
  p.has_source = s_int[SI_source];
  for (int a = 0; a < 3; ++a) {
    p.buoy[a] = s_float[SF_buoy + a];
    p.base[a] = s_float[SF_base + a];
  }
  p.c_ref = s_float[SF_c_ref];
  SBCSet bcs = {};
  bcs.n = n_bc;
  const int extent[3] = {nx, ny, nz};
  for (int b = 0; b < n_bc; ++b) {
    SBC& d = bcs.bc[b];
    const int* row = bc_int + b * kBCInts;
    d.axis = row[0];
    d.coord = row[1];
    d.dir = row[2];
    d.fixed = row[3];
    if (d.axis < 0 || d.axis > 2 || d.coord < 0 ||
        d.coord >= extent[d.axis] || d.dir < 1 || d.dir >= Q7 ||
        (d.dir - 1) / 2 != d.axis || valid_ptrs[b] == nullptr ||
        cplane_ptrs[b] == nullptr || foot_off[b] < 0 ||
        foot_off[b + 1] < foot_off[b] ||
        foot_off[b + 1] - foot_off[b] > n_cells / extent[d.axis]) {
      return (int)cudaErrorInvalidValue;
    }
    d.c_star = bc_float[b * kBCFloats];
    d.count = (double)bc_float[b * kBCFloats + 1];
    d.foot_lo = foot_off[b];
    d.foot_hi = foot_off[b + 1];
    d.valid = static_cast<const uint8_t*>(valid_ptrs[b]);
    d.cplane = static_cast<float*>(cplane_ptrs[b]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SArgs args = {src, dst, mask, nx, ny, nz, u, f, comp, wall_c,
                      cells, n_listed, (unsigned)grid, s};
  if (live) {
    if (force) {
      launch_dirichlet<true, true>(dirichlet, args, p, bcs);
    } else {
      launch_dirichlet<true, false>(dirichlet, args, p, bcs);
    }
  } else if (has_comp) {
    launch_dirichlet<false, true>(dirichlet, args, p, bcs);
  } else {
    launch_dirichlet<false, false>(dirichlet, args, p, bcs);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || record_row == nullptr || n_bc == 0) {
    return (int)err;
  }
  scalar_record_kernel<<<n_bc, kRecordBlock, 0, s>>>(bcs, foot, record_row);
  return (int)cudaGetLastError();
}

}  // extern "C"
