// D3Q19 collide-stream, z-plane fixup and moments kernels for NVIDIA
// Hopper (sm_90a).
//
// lbm_collide_stream (K1a + K1b + K1c) replaces lbm_tpu/kernels/
// collide_stream.py::_kernel: its BGK body _subtile_compute, the K1b
// branches (TRT, the Guo body force, Ladd moving walls, the per-cell tau
// closures of LES and rheology, MRT), ::_row_fix (the in-kernel NEE rows,
// series phases included), the per-tile velsum and the live-tile list
// (`tids`, ::live_tile_ids). lbm_fix_z_plane replaces ::_extract_z_slab
// (K6), ::_splice_z_plane_inplace (K5) and the XLA arithmetic of
// ::_fix_z_plane_windowed between them, with the same branches.
// lbm_macro (K3) replaces ::packed_macro, with its F/2 force shift.
// The force-field instances (K1e) replace the same _kernel's `fforce`
// mode: the Boussinesq force F = buoy (c - c_ref) per fluid cell, c the
// sum of the cell's seven pre-step D3Q7 populations g (read from the
// scalar state's source buffer, 7 loads at the own cell), with the Guo
// half shift and the parity-split source per cell.
//
// State layout: f[19][nx][ny][nz] fp32, z contiguous, two ping-pong
// buffers (the kernels read `src` and write `dst`, never in place, so a
// cell's NEE rewrite always sees its own PRE-step populations). The mask
// is int8 (GHOST -1 and MOVING -2 are negative labels).
//
// Semantics are those of the dense step (lbm_tpu_torch/engine/step.py):
// the pull wraps modulo on all three axes, exactly like torch.roll, so
// the kernels need no padding ring. Arithmetic follows the dense step's
// operation order (moments summed in direction order, u = (m + F/2) /
// rho by division, phi as w*(1 + 3cu + 4.5cu^2 - 1.5|u|^2), BGK and TRT
// dividing by tau, 2 tau and 2 tau_minus, the Guo source as cp g_even +
// cm g_odd with the dense step's fp32 constants, the closures' Picard
// loop with IEEE logf/expf/log1pf/sqrtf), and the build turns off FMA
// contraction (kernels/_build.py), so BGK, TRT, force and moving walls
// are bit for bit the dense step's. MRT multiplies f - feq by the dense
// step's fp32 19x19 K in its summation order (a zero entry adds a zero),
// so it is bit-equal too: lbm_tpu's kernel form, the rank update over the
// ten tunable moment rows (core/mrt.py mrt_rank_update), rounds
// differently and drifted to a max abs error of 1.9e-6 against the dense
// step after 200 steps of the 64^3 cavity on the H100. K's entries come
// by value and are read from the constant bank, not registers.
//
// The collision branch is a template: <collision, closure?, force (none,
// constant, field), moving>, 18 valid instances per kernel (a closure
// needs BGK or TRT; a force excludes MRT and closures, as lbm_tpu's
// kernel does). The
// closure's kind (Smagorinsky, power law, Carreau(-Yasuda), Casson) is a
// uniform runtime switch inside the closure instance: one template
// instance per kind took the build from 4 s to 60 s on the H100. The
// host entry picks the instance from the case's descriptor, so the BGK
// instance is the BGK-only kernel's code and pays for no branch it does
// not take.
//
// What bounds K1a: bytes first. A fluid cell reads 19 floats and writes
// 19 (152 B), plus 18 one-byte neighbor mask reads that mostly hit
// L1/L2; the ~250 flops of BGK are below the card's ratio, but the
// instruction count (22 IEEE divisions, cell-index div/mod, 18 wraps) and
// 78 registers a thread keep this first version short of the bandwidth
// roofline. The K1b branches move the same bytes; a closure adds a few
// dozen transcendental calls a fluid cell and MRT ~720 flops, so they
// add registers (and spills) before they add time. It is one thread per
// cell with z the fastest thread index, so the 18 neighbor gathers of a
// warp are 32 consecutive floats each (shifted by at most one element
// along z) and coalesce. In a vessel tree most 256-cell blocks are all
// DEAD (93% at the full-size coronary): the launch then takes a list of
// the live blocks and never touches the others, whose cells hold the same
// values in both buffers. Velsum partials are reduced in double and in a
// fixed order, so the stop rule fires at the same step in every run.
//
// lbm_fix_z_plane runs after K1a, once per z-plane boundary, over the
// boundary's static window on its consumer plane: it pulls from the
// intact source buffer (the slab copy K6 made on the TPU is this read),
// applies the NEE rewrite with the same device function as K1a, collides
// and writes the plane's fluid cells into the destination (K5's splice).
// A window is a few thousand cells, so it is bound by launch latency.
// It adds sum |u_fixed| - |u_pre-NEE| over the cells it rewrote to the
// step's velsum, since K1a counted those cells before the rewrite.

#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <utility>

namespace {

constexpr int Q = 19;
constexpr int kMaxBCs = 4;
constexpr int kMaxDirs = 5;
constexpr int kBlock = 256;
constexpr int kReduceBlock = 1024;
constexpr int kBCInts = 6 + kMaxDirs;  // layout of one row of bc_int
constexpr int8_t kWall = 1;
constexpr int8_t kFluid = 4;
constexpr int8_t kMoving = -2;
constexpr int kClosureConsts = 6;
constexpr float kTiny = 1e-30f;

enum CollisionKind { kBGK = 0, kTRT = 1, kMRT = 2 };
enum ClosureKind { kNone = 0, kSmag = 1, kPlaw = 2, kCY = 3, kCasson = 4 };

// Offsets of the collision descriptor's int and float rows: CINT and
// CFLOAT in kernels/collide_stream.py (a CPU test compares them).
enum CInt {
  CI_coll = 0, CI_closure = 1, CI_force = 2, CI_moving = 3, CI_iters = 4,
  CI_square = 5, CI_n = 6
};
enum CFloat {
  CF_tau = 0, CF_two_tau = 1, CF_two_tau_m = 2, CF_cp = 3,
  CF_half_force = 4, CF_force = 7, CF_e_f = 10, CF_cm_odd = 29, CF_bb = 48,
  CF_mrt_k = 67, CF_t0 = 428, CF_lam = 429, CF_lo = 430, CF_hi = 431,
  CF_c = 432, CF_cm = 438, CF_buoy = 439, CF_c_ref = 442, CF_n = 443
};
// CI_force: no force, the constant CaseSpec.force, the Boussinesq field.
enum ForceKind { kNoForce = 0, kConstForce = 1, kFieldForce = 2 };

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

// The collision branch's operands, passed by value (see CFloat/CInt).
struct Collision {
  float tau;              // BGK divisor
  float two_tau;          // TRT divisors 2 tau, 2 tau_minus
  float two_tau_m;
  float cp;               // Guo prefactor of the even half
  float half_force[3];    // F/2
  float force[3];         // F
  float e_f[Q];           // e_i . F
  float cm_odd[Q];        // cm * 3 w_i (e_i . F)
  float bb[Q];            // Ladd terms 6 w_i (e_i . u_w)
  float mrt_k[Q][Q];      // MRT collision matrix K (fp32)
  float t0;               // closure: tau
  float lam;              // TRT + closure: (tau - 1/2)(tau_minus - 1/2)
  float lo, hi;           // closure clip
  float c[kClosureConsts];  // closure constants (kernels/collide_stream.py)
  int closure;            // ClosureKind
  int iters;              // Picard iterations
  int square;             // Carreau with a == 2
  float cm;               // Guo prefactor of the odd half (field force)
  float buoy[3];          // field force: F = buoy (c - c_ref)
  float c_ref;
  const float* gfield;    // field force: the scalar state g[7][n_cells]
};

// One NEE boundary on its consumer plane. The lateral axes are (y, z)
// for axis 0, (x, z) for axis 1 and (x, y) for axis 2, so a plane cell's
// lateral index is a * B + b; tables are (D, A, B).
struct BCDesc {
  int axis;
  int coord;       // consumer-plane coordinate along axis
  int lat_a;       // A, the first lateral extent
  int rho_is_fixed;
  int u_extrap;    // 1: u* = u_prev (phi* = phi_prev), no phi_star table
  float rho_fixed;
  float omega;     // 1 - 1/tau
  long long plane; // A * B
  int slot[Q];     // slot[i] = d if direction i is the plane's d-th, else -1
  const uint8_t* valid;   // (D, A, B) bytes
  const float* phi_star;  // (D, A, B) fp32 of this step's phase, or null
                          // when u_extrap
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

// rho and u = (m + F/2) / rho (rho == 0 read as 1; F/2 only with FORCE)
// of 19 populations.
template <bool FORCE>
__device__ __forceinline__ void moments19(const float* p,
                                          const float* half_force,
                                          float& rho, float& ux, float& uy,
                                          float& uz) {
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
  if constexpr (FORCE) {
    mx = mx + half_force[0];
    my = my + half_force[1];
    mz = mz + half_force[2];
  }
  const float safe = rho == 0.0f ? 1.0f : rho;
  ux = mx / safe;
  uy = my / safe;
  uz = mz / safe;
}

// The pulled populations of cell (x, y, z): the value at x - e_i,
// wrapped, or with half-way bounce-back off a wall source the cell's own
// opposite population, plus the Ladd term bb[i] off a MOVING source.
template <bool MOVING>
__device__ __forceinline__ void pull19(const float* __restrict__ src,
                                       const int8_t* __restrict__ mask,
                                       int x, int y, int z, int nx, int ny,
                                       int nz, long long n_cells, int cell,
                                       const float* bb, float* p) {
  p[0] = src[cell];
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    const int xs = wrap(x - EX(i), nx);
    const int ys = wrap(y - EY(i), ny);
    const int zs = wrap(z - EZ(i), nz);
    const int nb = (xs * ny + ys) * nz + zs;
    if constexpr (MOVING) {
      // one load a direction, from a selected address and with no branch
      // (reading the own opposite population in every direction doubled
      // the bytes: 1.96 ms against BGK's 1.16 at lid 256^3 on the H100)
      const int8_t m = mask[nb];
      const bool own = m == kWall || m == kMoving;
      const float v = src[own ? (long long)OPP(i) * n_cells + cell
                              : (long long)i * n_cells + nb];
      p[i] = m == kMoving ? v + bb[i] : v;
    } else {
      p[i] = mask[nb] == kWall ? src[(long long)OPP(i) * n_cells + cell]
                               : src[(long long)i * n_cells + nb];
    }
  }
}

// Rewrite the pulled populations of one consumer-plane cell with the
// NEE formula: p_i = rho* phi*_i + (f_i(x) - rho_prev phi_i(u_prev)) omega
// for each prescribed direction whose lateral cell is valid (u_prev with
// the F/2 shift under FORCE).
template <bool FORCE>
__device__ __forceinline__ void nee_fix(const BCDesc& bc,
                                        const float* __restrict__ src,
                                        long long n_cells, int cell,
                                        long long lat,
                                        const float* half_force, float* p) {
  float own[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) own[i] = src[(long long)i * n_cells + cell];
  float rp, uxp, uyp, uzp;
  moments19<FORCE>(own, half_force, rp, uxp, uyp, uzp);
  const float usqp = uxp * uxp + uyp * uyp + uzp * uzp;
  const float rho_star = bc.rho_is_fixed ? bc.rho_fixed : rp;
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    const int d = bc.slot[i];
    if (d < 0 || !bc.valid[d * bc.plane + lat]) continue;
    const float phi_nbr = phi_i(i, uxp, uyp, uzp, usqp);
    const float phi_star =
        bc.u_extrap ? phi_nbr : bc.phi_star[d * bc.plane + lat];
    const float feq_nbr = rp * phi_nbr;
    p[i] = rho_star * phi_star + (own[i] - feq_nbr) * bc.omega;
  }
}

// P = sqrt(2 Pi:Pi), Pi_ab = sum_i e_ia e_ib fneq_i in direction order
// (engine/step.pi_norm).
__device__ __forceinline__ float pi_norm(const float* fneq) {
  float pxx = 0.0f, pyy = 0.0f, pzz = 0.0f;
  float pxy = 0.0f, pxz = 0.0f, pyz = 0.0f;
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    if (EX(i) != 0) pxx += fneq[i];
    if (EY(i) != 0) pyy += fneq[i];
    if (EZ(i) != 0) pzz += fneq[i];
    if (EX(i) * EY(i) > 0) pxy += fneq[i];
    if (EX(i) * EY(i) < 0) pxy -= fneq[i];
    if (EX(i) * EZ(i) > 0) pxz += fneq[i];
    if (EX(i) * EZ(i) < 0) pxz -= fneq[i];
    if (EY(i) * EZ(i) > 0) pyz += fneq[i];
    if (EY(i) * EZ(i) < 0) pyz -= fneq[i];
  }
  const float s = pxx * pxx + pyy * pyy + pzz * pzz +
                  2.0f * (pxy * pxy + pxz * pxz + pyz * pyz);
  return sqrtf(2.0f * s);
}

// Per-cell tau_eff of the closure c.closure from P and 1/rho
// (core/rheology.py tau_eff_from_p, in its operation order).
__device__ __forceinline__ float tau_eff(float P, float inv_rho,
                                         const Collision& c) {
  const float t0 = c.t0;
  if (c.closure == kSmag) {
    return 0.5f * (t0 + sqrtf(t0 * t0 + c.c[0] * P * inv_rho));
  } else if (c.closure == kCasson) {
    const float g = fmaxf(1.5f * P * inv_rho, kTiny);
    const float a = 1.0f - c.c[2] / g;
    const float cq = c.c[1] / sqrtf(g);
    const float disc = cq * cq + 4.0f * a * c.c[0];
    const float s = (cq + sqrtf(fmaxf(disc, 0.0f))) /
                    (2.0f * fmaxf(a, kTiny));
    const float te = a > 0.0f ? s * s : c.hi;
    return fminf(fmaxf(te, c.lo), c.hi);
  } else {
    const float g0 = 1.5f * P * inv_rho;
    float te = t0;
    for (int k = 0; k < c.iters; ++k) {
      if (c.closure == kPlaw) {
        const float lg = logf(fmaxf(g0 / te, kTiny));
        te = fminf(fmaxf(0.5f + c.c[1] * expf(c.c[0] * lg), c.lo), c.hi);
      } else {  // Carreau(-Yasuda)
        float x;
        if (c.square) {
          const float z = c.c[4] * g0 / te;
          x = z * z;
        } else {
          const float lg = logf(fmaxf(c.c[4] * g0 / te, kTiny));
          x = expf(c.c[2] * lg);
        }
        const float nu3 = c.c[0] * expf(c.c[3] * log1pf(x));
        te = fminf(fmaxf(c.c[1] + nu3, c.lo), c.hi);
      }
    }
    return te;
  }
}

// Collide the pulled populations into dst with the instance's branch;
// returns the |u|^2 of the collide's moments (u with the F/2 shift).
// The field force of one fluid cell and its half, F/2, from the cell's
// pre-step scalar: c = sum of g's seven channels in order, F = buoy (c -
// c_ref).
__device__ __forceinline__ void field_force(const Collision& c,
                                            long long n_cells, int cell,
                                            float* F, float* half) {
  float cs = c.gfield[cell];
#pragma unroll
  for (int i = 1; i < 7; ++i) cs += c.gfield[(long long)i * n_cells + cell];
  const float dc = cs - c.c_ref;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    F[a] = c.buoy[a] * dc;
    half[a] = 0.5f * F[a];
  }
}

// F and half: the cell's force and F/2, read under FORCE (the
// descriptor's constants, or field_force's).
template <int COLL, bool CLOSURE, int FORCE>
__device__ __forceinline__ float collide_store(const float* p,
                                               const Collision& c,
                                               const float* F,
                                               const float* half,
                                               float* __restrict__ dst,
                                               long long n_cells, int cell) {
  float rho, ux, uy, uz;
  moments19<FORCE != kNoForce>(p, half, rho, ux, uy, uz);
  const float usq = ux * ux + uy * uy + uz * uz;
  if constexpr (COLL == kBGK && !CLOSURE && FORCE == kNoForce) {
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const float feq = rho * phi_i(i, ux, uy, uz, usq);
      dst[(long long)i * n_cells + cell] = p[i] - (p[i] - feq) / c.tau;
    }
  } else {
    float feq[Q], post[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) feq[i] = rho * phi_i(i, ux, uy, uz, usq);
    if constexpr (CLOSURE) {
      float fneq[Q];
#pragma unroll
      for (int i = 0; i < Q; ++i) fneq[i] = p[i] - feq[i];
      const float safe = rho == 0.0f ? 1.0f : rho;
      const float te = tau_eff(pi_norm(fneq), 1.0f / safe, c);
      if constexpr (COLL == kTRT) {
        // constant magic Lambda: the odd rate follows tau_eff
        const float te_m = 0.5f + c.lam / (te - 0.5f);
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          const float s = fneq[i] + fneq[OPP(i)];
          const float d = fneq[i] - fneq[OPP(i)];
          post[i] = p[i] - s / (2.0f * te) - d / (2.0f * te_m);
        }
      } else {
#pragma unroll
        for (int i = 0; i < Q; ++i) post[i] = p[i] - fneq[i] / te;
      }
    } else if constexpr (COLL == kBGK) {
#pragma unroll
      for (int i = 0; i < Q; ++i) post[i] = p[i] - (p[i] - feq[i]) / c.tau;
    } else if constexpr (COLL == kTRT) {
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const int o = OPP(i);
        const float s = (p[i] + p[o]) - (feq[i] + feq[o]);
        const float d = (p[i] - p[o]) - (feq[i] - feq[o]);
        post[i] = p[i] - s / c.two_tau - d / c.two_tau_m;
      }
    } else {
      // MRT: f - K (f - feq), each row summed in column order
      float fneq[Q];
#pragma unroll
      for (int j = 0; j < Q; ++j) fneq[j] = p[j] - feq[j];
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < Q; ++j) acc = acc + c.mrt_k[i][j] * fneq[j];
        post[i] = p[i] - acc;
      }
    }
    if constexpr (FORCE != kNoForce) {
      // Guo source, parity split: cp g_even + cm g_odd
      const float uf = ux * F[0] + uy * F[1] + uz * F[2];
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const float eu = e_dot(i, ux, uy, uz);
        if constexpr (FORCE == kFieldForce) {
          const float e_f = e_dot(i, F[0], F[1], F[2]);
          const float g_even = WGT(i) * (9.0f * eu * e_f - 3.0f * uf);
          const float g_odd = (3.0f * WGT(i)) * e_f;
          post[i] = post[i] + (c.cp * g_even + c.cm * g_odd);
        } else {
          const float g_even = WGT(i) * (9.0f * eu * c.e_f[i] - 3.0f * uf);
          post[i] = post[i] + (c.cp * g_even + c.cm_odd[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < Q; ++i) dst[(long long)i * n_cells + cell] = post[i];
  }
  return usq;
}

// Fixed-order block sum in double, written to partials[blockIdx.x].
__device__ __forceinline__ void block_sum(double v,
                                          double* __restrict__ partials) {
  __shared__ double red[kBlock];
  red[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (unsigned s = kBlock / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[blockIdx.x] = red[0];
}

// Launch block b works on cells blocks[b] * kBlock ... + kBlock - 1, or
// on block b itself when `blocks` is null.
template <int COLL, bool CLOSURE, int FORCE, bool MOVING>
__global__ void __launch_bounds__(kBlock)
collide_stream_kernel(const float* __restrict__ src,
                      float* __restrict__ dst,
                      const int8_t* __restrict__ mask, int nx, int ny,
                      int nz, const __grid_constant__ Collision coll,
                      BCSet bcs, const int* __restrict__ blocks,
                      double* __restrict__ partials) {
  const long long n_cells = (long long)nx * ny * nz;  // < 2^31 (host check)
  const long long blk = blocks ? (long long)blocks[blockIdx.x] : blockIdx.x;
  const long long cell_ll = blk * kBlock + threadIdx.x;
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
      pull19<MOVING>(src, mask, x, y, z, nx, ny, nz, n_cells, cell, coll.bb,
                     p);
#pragma unroll
      for (int b = 0; b < kMaxBCs; ++b) {
        if (b >= bcs.n) break;
        const BCDesc& bc = bcs.bc[b];
        if ((bc.axis == 0 ? x : y) != bc.coord) continue;
        const long long lat = (long long)(bc.axis == 0 ? y : x) * nz + z;
        // the NEE rewrite keeps the static force (none under a field)
        nee_fix<FORCE == kConstForce>(bc, src, n_cells, cell, lat,
                                      coll.half_force, p);
      }
      float ff[3], fh[3];
      const float* F = coll.force;
      const float* half = coll.half_force;
      if constexpr (FORCE == kFieldForce) {
        field_force(coll, n_cells, cell, ff, fh);
        F = ff;
        half = fh;
      }
      speed = sqrtf(collide_store<COLL, CLOSURE, FORCE>(p, coll, F, half, dst,
                                                         n_cells, cell));
    }
  }
  block_sum((double)speed, partials);
}

// One z-plane boundary over its window [x0, x0+wx) x [y0, y0+wy) of the
// consumer plane z = bc.coord: the whole step again for the window's
// fluid cells, now with the NEE rewrite. partials[block] gets the sum of
// |u_fixed| - |u_pre-NEE| over its cells.
template <int COLL, bool CLOSURE, int FORCE, bool MOVING>
__global__ void __launch_bounds__(kBlock)
fix_z_plane_kernel(const float* __restrict__ src, float* __restrict__ dst,
                   const int8_t* __restrict__ mask, int nx, int ny, int nz,
                   const __grid_constant__ Collision coll, BCDesc bc, int x0,
                   int wx, int y0, int wy, double* __restrict__ partials) {
  const long long n_cells = (long long)nx * ny * nz;
  const int k = blockIdx.x * kBlock + threadIdx.x;
  double delta = 0.0;
  if (k < wx * wy) {
    const int x = x0 + k / wy;
    const int y = y0 + k % wy;
    const int z = bc.coord;
    const int cell = (x * ny + y) * nz + z;
    if (mask[cell] == kFluid) {
      float p[Q];
      pull19<MOVING>(src, mask, x, y, z, nx, ny, nz, n_cells, cell, coll.bb,
                     p);
      float ff[3], fh[3];
      const float* F = coll.force;
      const float* half = coll.half_force;
      if constexpr (FORCE == kFieldForce) {
        field_force(coll, n_cells, cell, ff, fh);
        F = ff;
        half = fh;
      }
      float rho, ux, uy, uz;
      moments19<FORCE != kNoForce>(p, half, rho, ux, uy, uz);
      const float before = sqrtf(ux * ux + uy * uy + uz * uz);
      nee_fix<FORCE == kConstForce>(bc, src, n_cells, cell,
                                    (long long)x * ny + y, coll.half_force,
                                    p);
      const float after = sqrtf(collide_store<COLL, CLOSURE, FORCE>(
          p, coll, F, half, dst, n_cells, cell));
      delta = (double)after - (double)before;
    }
  }
  block_sum(delta, partials);
}

// series[t] = (or +=, when accumulate) the sum of the block partials, in
// a fixed order.
__global__ void __launch_bounds__(kReduceBlock)
velsum_reduce_kernel(const double* __restrict__ partials, int n,
                     double* __restrict__ series, int t, int accumulate) {
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
  if (threadIdx.x == 0) series[t] = accumulate ? series[t] + red[0] : red[0];
}

template <bool FORCE>
__global__ void __launch_bounds__(kBlock)
macro_kernel(const float* __restrict__ f, float* __restrict__ rho_out,
             float* __restrict__ u_out, long long n_cells, float h0,
             float h1, float h2) {
  const long long cell = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (cell >= n_cells) return;
  float p[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) p[i] = f[i * n_cells + cell];
  const float half_force[3] = {h0, h1, h2};
  float rho, ux, uy, uz;
  moments19<FORCE>(p, half_force, rho, ux, uy, uz);
  rho_out[cell] = rho;
  u_out[cell] = ux;
  u_out[n_cells + cell] = uy;
  u_out[2 * n_cells + cell] = uz;
}

// Fill a BCDesc from its descriptor row. bc_int row: axis, coord,
// lat_a, rho_is_fixed, u_extrap, ndirs, dirs[kMaxDirs]; bc_float row:
// rho_fixed, omega. Returns false on a malformed row.
bool parse_bc(const int* row, const float* frow, const void* valid,
              const void* phi, int nx, int ny, int nz, BCDesc& d) {
  d.axis = row[0];
  d.coord = row[1];
  d.lat_a = row[2];
  d.rho_is_fixed = row[3];
  d.u_extrap = row[4];
  const int ndirs = row[5];
  if (ndirs < 0 || ndirs > kMaxDirs || d.axis < 0 || d.axis > 2) {
    return false;
  }
  const int extent[3] = {nx, ny, nz};
  const int a = d.axis == 0 ? ny : nx;
  const int b = d.axis == 2 ? ny : nz;
  if (d.lat_a != a || d.coord < 0 || d.coord >= extent[d.axis]) return false;
  d.plane = (long long)a * b;
  for (int i = 0; i < Q; ++i) d.slot[i] = -1;
  for (int k = 0; k < ndirs; ++k) {
    const int i = row[6 + k];
    if (i <= 0 || i >= Q) return false;
    d.slot[i] = k;
  }
  d.rho_fixed = frow[0];
  d.omega = frow[1];
  d.valid = static_cast<const uint8_t*>(valid);
  d.phi_star = static_cast<const float*>(phi);
  return d.valid != nullptr && (d.u_extrap || d.phi_star != nullptr);
}

// The instance key of a (collision, closure?, force, moving) branch and
// whether the kernels have that instance.
constexpr int kNumKeys = 3 * 2 * 3 * 2;
constexpr int instance_key(int coll, int closure, int force, int moving) {
  return ((coll * 2 + closure) * 3 + force) * 2 + moving;
}
template <int K>
struct Inst {
  static constexpr int kColl = K / 12;
  static constexpr bool kClosure = (K / 6) % 2 == 1;
  static constexpr int kForce = (K / 2) % 3;
  static constexpr bool kMovingWall = K % 2 == 1;
  static constexpr bool kValid =
      !(kClosure && kColl == kMRT) &&
      !(kForce != kNoForce && (kColl == kMRT || kClosure));
};

// Fill a Collision from its descriptor rows and the scalar state of a
// field force; returns the instance key, or -1 on a malformed row or a
// branch without an instance.
int parse_collision(const int* ci, const float* cf, const float* gfield,
                    Collision& c) {
  const int coll = ci[CI_coll], clo = ci[CI_closure];
  const int force = ci[CI_force], moving = ci[CI_moving];
  if (coll < 0 || coll > 2 || clo < 0 || clo > 4 || force < 0 ||
      force > 2 || (moving & ~1) || ci[CI_iters] < 0 ||
      ci[CI_iters] > 1000 || ((force == kFieldForce) != (gfield != nullptr))) {
    return -1;
  }
  c.cm = cf[CF_cm];
  for (int a = 0; a < 3; ++a) c.buoy[a] = cf[CF_buoy + a];
  c.c_ref = cf[CF_c_ref];
  c.gfield = gfield;
  c.tau = cf[CF_tau];
  c.two_tau = cf[CF_two_tau];
  c.two_tau_m = cf[CF_two_tau_m];
  c.cp = cf[CF_cp];
  for (int a = 0; a < 3; ++a) {
    c.half_force[a] = cf[CF_half_force + a];
    c.force[a] = cf[CF_force + a];
  }
  for (int i = 0; i < Q; ++i) {
    c.e_f[i] = cf[CF_e_f + i];
    c.cm_odd[i] = cf[CF_cm_odd + i];
    c.bb[i] = cf[CF_bb + i];
  }
  for (int i = 0; i < Q; ++i) {
    for (int j = 0; j < Q; ++j) c.mrt_k[i][j] = cf[CF_mrt_k + i * Q + j];
  }
  c.t0 = cf[CF_t0];
  c.lam = cf[CF_lam];
  c.lo = cf[CF_lo];
  c.hi = cf[CF_hi];
  for (int k = 0; k < kClosureConsts; ++k) c.c[k] = cf[CF_c + k];
  c.closure = clo;
  c.iters = ci[CI_iters];
  c.square = ci[CI_square];
  return instance_key(coll, clo != kNone, force, moving);
}

struct StepArgs {
  const float* src;
  float* dst;
  const int8_t* mask;
  int nx, ny, nz;
  const int* blocks;
  double* partials;
  unsigned grid;
  cudaStream_t stream;
};

struct FixArgs {
  const float* src;
  float* dst;
  const int8_t* mask;
  int nx, ny, nz;
  int x0, wx, y0, wy;
  double* partials;
  unsigned grid;
  cudaStream_t stream;
};

template <int K>
void launch_step(const StepArgs& a, const Collision& c, const BCSet& b) {
  using I = Inst<K>;
  collide_stream_kernel<I::kColl, I::kClosure, I::kForce, I::kMovingWall>
      <<<a.grid, kBlock, 0, a.stream>>>(a.src, a.dst, a.mask, a.nx, a.ny,
                                        a.nz, c, b, a.blocks, a.partials);
}

template <int K>
void launch_fix(const FixArgs& a, const Collision& c, const BCDesc& b) {
  using I = Inst<K>;
  fix_z_plane_kernel<I::kColl, I::kClosure, I::kForce, I::kMovingWall>
      <<<a.grid, kBlock, 0, a.stream>>>(a.src, a.dst, a.mask, a.nx, a.ny,
                                        a.nz, c, b, a.x0, a.wx, a.y0, a.wy,
                                        a.partials);
}

using StepLauncher = void (*)(const StepArgs&, const Collision&,
                              const BCSet&);
using FixLauncher = void (*)(const FixArgs&, const Collision&,
                             const BCDesc&);

template <int K>
constexpr StepLauncher step_entry() {
  if constexpr (Inst<K>::kValid) {
    return &launch_step<K>;
  } else {
    return nullptr;
  }
}
template <int K>
constexpr FixLauncher fix_entry() {
  if constexpr (Inst<K>::kValid) {
    return &launch_fix<K>;
  } else {
    return nullptr;
  }
}
template <int... K>
constexpr std::array<StepLauncher, kNumKeys> step_table(
    std::integer_sequence<int, K...>) {
  return {step_entry<K>()...};
}
template <int... K>
constexpr std::array<FixLauncher, kNumKeys> fix_table(
    std::integer_sequence<int, K...>) {
  return {fix_entry<K>()...};
}
constexpr std::array<StepLauncher, kNumKeys> kStepTable =
    step_table(std::make_integer_sequence<int, kNumKeys>{});
constexpr std::array<FixLauncher, kNumKeys> kFixTable =
    fix_table(std::make_integer_sequence<int, kNumKeys>{});

}  // namespace

extern "C" {

int lbm_block_size() { return kBlock; }

const char* lbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One step from src into dst with the collision branch of the descriptor
// rows coll_int/coll_float (CInt/CFloat) and the x/y-plane boundaries;
// series[t] = sum over fluid cells of |u|. gfield: the pre-step scalar
// state g[7][n_cells] of a field force (CI_force == 2), else null. blocks: null (every block) or
// a device list of n_blocks block ids to update; the blocks left out must
// hold no fluid cell and be equal in src and dst. partials holds one
// double per launched block (n_partials). Boundary rows as parse_bc;
// phi_ptrs[b] is this step's phase table of a series boundary. Returns
// cudaGetLastError().
int lbm_collide_stream(const float* src, float* dst, const int8_t* mask,
                       int nx, int ny, int nz, const int* coll_int,
                       const float* coll_float, int n_bc, const int* bc_int,
                       const float* bc_float, const void* const* valid_ptrs,
                       const void* const* phi_ptrs, const int* blocks,
                       int n_blocks, double* partials, int n_partials,
                       double* series, int t, const float* gfield,
                       void* stream) {
  const long long n_cells = (long long)nx * ny * nz;
  const long long all_blocks = (n_cells + kBlock - 1) / kBlock;
  const long long grid = blocks ? n_blocks : all_blocks;
  if (n_bc < 0 || n_bc > kMaxBCs || n_cells <= 0 ||
      n_cells > 0x7fffffffLL || grid <= 0 || grid > all_blocks ||
      grid != n_partials) {
    return (int)cudaErrorInvalidValue;
  }
  Collision coll = {};
  const int key = parse_collision(coll_int, coll_float, gfield, coll);
  if (key < 0 || kStepTable[key] == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  BCSet bcs = {};
  bcs.n = n_bc;
  for (int b = 0; b < n_bc; ++b) {
    if (!parse_bc(bc_int + b * kBCInts, bc_float + 2 * b, valid_ptrs[b],
                  phi_ptrs[b], nx, ny, nz, bcs.bc[b]) ||
        bcs.bc[b].axis == 2) {
      return (int)cudaErrorInvalidValue;
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const StepArgs args = {src, dst, mask, nx, ny, nz, blocks, partials,
                         (unsigned)grid, s};
  kStepTable[key](args, coll, bcs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  velsum_reduce_kernel<<<1, kReduceBlock, 0, s>>>(partials, n_partials,
                                                   series, t, 0);
  return (int)cudaGetLastError();
}

// The z-plane NEE fixup of one boundary (descriptor row as parse_bc,
// axis 2) with the collision branch of coll_int/coll_float, over the
// window [x0, x1) x [y0, y1) of its consumer plane: src is the pre-step
// state, dst the collide-stream kernel's output; series[t] += sum
// |u_fixed| - |u_pre-NEE| over the rewritten cells. gfield as in
// lbm_collide_stream. partials holds
// ceil((x1-x0)*(y1-y0) / lbm_block_size()) doubles. Returns
// cudaGetLastError().
int lbm_fix_z_plane(const float* src, float* dst, const int8_t* mask,
                    int nx, int ny, int nz, const int* coll_int,
                    const float* coll_float, const int* bc_int,
                    const float* bc_float, const void* valid,
                    const void* phi, int x0, int x1, int y0, int y1,
                    double* partials, int n_partials, double* series, int t,
                    const float* gfield, void* stream) {
  const long long n_cells = (long long)nx * ny * nz;
  const int wx = x1 - x0, wy = y1 - y0;
  BCDesc bc = {};
  if (n_cells <= 0 || n_cells > 0x7fffffffLL || x0 < 0 || y0 < 0 ||
      wx <= 0 || wy <= 0 || x1 > nx || y1 > ny ||
      !parse_bc(bc_int, bc_float, valid, phi, nx, ny, nz, bc) ||
      bc.axis != 2) {
    return (int)cudaErrorInvalidValue;
  }
  Collision coll = {};
  const int key = parse_collision(coll_int, coll_float, gfield, coll);
  if (key < 0 || kFixTable[key] == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const long long grid = ((long long)wx * wy + kBlock - 1) / kBlock;
  if (grid != n_partials) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FixArgs args = {src, dst, mask, nx, ny, nz, x0, wx, y0, wy,
                        partials, (unsigned)grid, s};
  kFixTable[key](args, coll, bc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  velsum_reduce_kernel<<<1, kReduceBlock, 0, s>>>(partials, n_partials,
                                                   series, t, 1);
  return (int)cudaGetLastError();
}

// rho = sum_i f_i and u = (sum_i e_i f_i + F/2) / rho (rho == 0 read as
// 1) per cell; rho (n_cells,), u (3, n_cells). half_force: null, or the
// host (F/2) 3-vector of a forced case. Returns cudaGetLastError().
int lbm_macro(const float* f, float* rho, float* u, long long n_cells,
              const float* half_force, void* stream) {
  if (n_cells <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_cells + kBlock - 1) / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (half_force) {
    macro_kernel<true><<<(unsigned)blocks, kBlock, 0, s>>>(
        f, rho, u, n_cells, half_force[0], half_force[1], half_force[2]);
  } else {
    macro_kernel<false><<<(unsigned)blocks, kBlock, 0, s>>>(
        f, rho, u, n_cells, 0.0f, 0.0f, 0.0f);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
