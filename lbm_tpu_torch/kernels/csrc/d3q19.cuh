// The D3Q19 device functions and host descriptor parsers that the
// single-step kernels (collide_stream.cuh) and the fused pair
// (collide_stream2.cuh) share: lattice constants, the collision and
// boundary descriptors, the pull with wall and moving-wall
// bounce-back, the NEE rewrite, the collision branches, the fixed-order
// velsum reduction. Each translation unit includes it once, so everything
// here lives in an anonymous namespace of that unit.
//
// The state's storage type S is a template parameter of every load and
// store of populations: float, or __nv_bfloat16 for bf16 storage. Compute
// is fp32 either way: a load widens (exactly), a store narrows with
// round-to-nearest-even (__float2bfloat16_rn, as torch's
// .to(torch.bfloat16) rounds), and a non-fluid cell is never stored.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <type_traits>
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
  int wk;                 // a windkessel outlet's index in the launch's
                          // WKFold (its rho* derived there), or -1
};

struct BCSet {
  int n;
  BCDesc bc[kMaxBCs];
};

// Windkessel (RCR) outlets. Each outlet's flux footprint is a run of
// cells [begin, end) of a host-built list with fp32 weights; its flux Q
// = sign * the sum of weight * u[axis] over the run, summed in a fixed
// order (kWKBlock strided partials, each from 0 in list order, then a
// halving tree), and one backward-Euler step of the RCR model
//   P_c' = (P_c + Q / C) / (1 + 1 / (Rd C)),   P_in = Q Rp + P_c',
// gives the outlet's rho* = rho_fixed + 3 P_in (lbm_tpu/engine/step.py
// apply_bc_fixup, in its fp32 operation order; 1 + 1/(Rd C) comes
// composed in fp32 from the host, as lbm_tpu folds it at trace time).
constexpr int kMaxWK = 12;     // the collide-stream kernel's 4 + 8 planes
constexpr int kWKBlock = 256;
constexpr int kWKInts = 3;     // axis, begin, end
constexpr int kWKFloats = 5;   // sign, Rp, C, 1 + 1/(Rd C), rho_fixed

struct WK {
  int axis;        // the velocity component of the flux
  int begin, end;  // the footprint's rows of the cell and weight lists
  float sign;      // flow_sign = -normal
  float rp, cap, denom;
  float rho_fixed;
};

struct WKSet {
  int n;
  WK wk[kMaxWK];
  float half_force[3];
};

// The fold of the outlets into the collide-stream launch (collide_stream
// .cuh's WK instances): P_c (pc) and the flux Q staged from the state the
// launch reads (q), each (n,) fp32 on the device; the footprint's terms
// weight * u[axis] (terms, one a footprint row) and weights; foot[k] =
// row * 3 + axis of the footprint cell that the launch's k-th listed cell
// is, for k < n_foot.
struct WKFold {
  WKSet set;
  float* pc;
  float* q;
  float* terms;
  const float* weights;
  const int* foot;
  int n_foot;
};

// An outlet's rho* this step, from its committed P_c and staged Q, in the
// operation order above (every thread computes the same value).
__device__ __forceinline__ float wk_rho_star(const WKFold& fold, int b) {
  const WK& d = fold.set.wk[b];
  const float q = fold.q[b];
  const float p_new = (fold.pc[b] + q / d.cap) / d.denom;
  const float p_in = q * d.rp + p_new;
  return d.rho_fixed + 3.0f * p_in;
}

// Fill a WKSet from its host rows: wk_int (axis, begin, end) and wk_float
// (sign, Rp, C, 1 + 1/(Rd C), rho_fixed), one an outlet; half_force: null
// or the host F/2 3-vector. False on a malformed row.
bool parse_wk(int n_wk, const int* wk_int, const float* wk_float,
              const float* half_force, WKSet& set) {
  if (n_wk <= 0 || n_wk > kMaxWK) return false;
  set.n = n_wk;
  for (int b = 0; b < n_wk; ++b) {
    const int* r = wk_int + b * kWKInts;
    const float* f = wk_float + b * kWKFloats;
    WK& d = set.wk[b];
    d.axis = r[0];
    d.begin = r[1];
    d.end = r[2];
    if (d.axis < 0 || d.axis > 2 || d.begin < 0 || d.end < d.begin) {
      return false;
    }
    d.sign = f[0];
    d.rp = f[1];
    d.cap = f[2];
    d.denom = f[3];
    d.rho_fixed = f[4];
  }
  for (int a = 0; a < 3; ++a) {
    set.half_force[a] = half_force ? half_force[a] : 0.0f;
  }
  return true;
}

// A population as fp32, from either storage type.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// An fp32 population in storage type S (round-to-nearest-even for bf16).
template <typename S>
__device__ __forceinline__ S narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

// a / b, correctly rounded (IEEE division), from y = RN(1/b) (__frcp_rn,
// taken once a divisor), without the division's slow path: q = a y and
// two corrections q += (a - q b) y, each residual an FMA. One correction
// is not enough: with y = RN(1/b) it misses at power-of-two dividends
// when b's significand is all ones (0.99999994, 1.9999999, 0.49999997);
// the second makes it exact (chip_smoke.py holds it against a / b over
// all 2^32 dividends for each divisor the bf16 cases use and those).
// The guard keeps the operands where every intermediate is a normal
// number far from overflow, so each residual is exact: b positive in
// [2^-23, 2^24), so y is normal in (2^-24, 2^23]; a zero or |a| in
// [2^-87, 2^88), so |q| lies in (2^-112, 2^112) and the residual's last
// bit, 2^(e_q + e_b - 46) >= 2^(e_a - 47) >= 2^-134, lies above the
// subnormal range. A zero a gives a y, the IEEE signed zero (the
// residuals are +0 and the negated form keeps q's sign). Anything else (a
// subnormal or a larger a, a b out of range or not positive, inf, NaN)
// takes the plain a / b. The IEEE division's own fast path is the same
// sequence from a refined approximate reciprocal; its range check sends
// zero and subnormal dividends to the slow path, 2.7x the cost of a
// normal one on the H100, and at rest 99.6% of the bf16 lid's BGK
// dividends p - feq are zero (probes/div_path.py).
constexpr unsigned kDivALo = 40u << 23;   // 2^-87: exponent field 40
constexpr unsigned kDivAHi = 215u << 23;  // 2^88
constexpr unsigned kDivBLo = 104u << 23;  // 2^-23
constexpr unsigned kDivBHi = 151u << 23;  // 2^24

// div_exact's arithmetic alone, for operands inside its range.
__device__ __forceinline__ float div_core(float a, float b, float y) {
  const float q0 = __fmul_rn(a, y);
  const float r0 = __fmaf_rn(q0, b, -a);
  const float q1 = __fmaf_rn(-r0, y, q0);
  const float r1 = __fmaf_rn(q1, b, -a);
  return __fmaf_rn(-r1, y, q1);
}

// Whether b is a divisor inside div_exact's range.
__host__ __device__ constexpr bool div_b_in_range(unsigned b_bits) {
  return b_bits - kDivBLo < kDivBHi - kDivBLo;
}

__device__ __forceinline__ float div_exact(float a, float b, float y) {
  const unsigned ma = __float_as_uint(a) & 0x7fffffffu;
  if ((ma - kDivALo >= kDivAHi - kDivALo && ma != 0u) ||
      !div_b_in_range(__float_as_uint(b))) {  // a sign bit fails the range
    return a / b;
  }
  return div_core(a, b, y);
}

// The range test of div_exact's dividends, a whole pair's at a time (the
// paired kernel's collision without rewrites): each dividend a adds to two
// accumulators, low = min over a of (bits(a) << 1) - 2 (a zero wraps to
// the top, a subnormal or small normal stays below 2 kDivALo - 2) and
// high = max over a of |a| (inf lands at or above 2^88; a NaN dividend
// gives a NaN quotient either way); in() is true when every dividend was
// zero or inside [2^-87, 2^88).
struct DivRange {
  unsigned low = 0xffffffffu;
  float high = 0.0f;
  __device__ __forceinline__ void add(float a) {
    low = min(low, (__float_as_uint(a) << 1) - 2u);
    high = fmaxf(high, fabsf(a));
  }
  __device__ __forceinline__ bool in() const {
    return low >= 2u * kDivALo - 2u && high < 0x1p88f;
  }
};

// rho and u = (m + F/2) / rho (rho == 0 read as 1; F/2 only with FORCE)
// of 19 populations. DIVX: the paired bf16 kernel's form, whose three
// divisions are div_exact by one reciprocal of rho (the same values).
template <bool FORCE, bool DIVX = false>
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
  if constexpr (DIVX) {
    const float y = __frcp_rn(safe);
    ux = div_exact(mx, safe, y);
    uy = div_exact(my, safe, y);
    uz = div_exact(mz, safe, y);
  } else {
    ux = mx / safe;
    uy = my / safe;
    uz = mz / safe;
  }
}

// The planes a shard of a domain split along x or y receives from its
// ring neighbours each step (K1d): lo holds the five populations that
// stream in across the shard's low face (e_axis = +1, in direction
// order) from the low neighbour's last row, hi the five that stream in
// across its high face (e_axis = -1) from the high neighbour's first row,
// each (5, A, B) fp32 with (A, B) = (ny, nz) for an x shard and (nx, nz)
// for a y shard; mask_lo and mask_hi are those two rows' (A, B) labels.
struct Halo {
  const float* lo;
  const float* hi;
  const int8_t* mask_lo;
  const int8_t* mask_hi;
};

// The component of e_i along the shard axis a (0: x, 1: y).
__host__ __device__ constexpr int e_axis(int a, int i) {
  return a == 0 ? EX(i) : EY(i);
}

// Direction i's row in its halo plane: its rank, in direction order,
// among the five directions with its sign of e_axis (a CPU test derives
// the table from the lattice).
__host__ __device__ constexpr int halo_slot(int a, int i) {
  constexpr int x[Q] = {0, 0, 0, 0, 0, 0, 0, 1, 2, 1, 2,
                        3, 4, 3, 4, 0, 0, 0, 0};
  constexpr int y[Q] = {0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2,
                        0, 0, 0, 0, 3, 3, 4, 4};
  return a == 0 ? x[i] : y[i];
}

// The pulled populations of cell (x, y, z): the value at x - e_i,
// wrapped, or with half-way bounce-back off a wall source the cell's own
// opposite population, plus the Ladd term bb[i] off a MOVING source.
// HALO: -1 for a whole box; 0 or 1 for a shard split along x or y, whose
// sources beyond its own rows on that axis (and their wall tests) come
// from the exchanged planes h (lbm_tpu's halo_axis ring rows).
template <bool MOVING, int HALO = -1, typename S>
__device__ __forceinline__ void pull19(const S* __restrict__ src,
                                       const int8_t* __restrict__ mask,
                                       int x, int y, int z, int nx, int ny,
                                       int nz, long long n_cells, int cell,
                                       const float* bb, float* p,
                                       const Halo& h = Halo{}) {
  p[0] = widen(src[cell]);
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    if constexpr (HALO >= 0) {
      static_assert(std::is_same<S, float>::value, "a shard is fp32");
      const int ea = e_axis(HALO, i);
      if (ea != 0) {
        // the source row on the shard axis lies inside the shard or, for
        // a cell on the face it streams across, in the neighbour's plane:
        // the address is selected, with no branch per direction
        const int c = HALO == 0 ? x : y;
        const bool face = ea > 0 ? c == 0 : c == (HALO == 0 ? nx : ny) - 1;
        const int xs = HALO == 0 ? x - EX(i) : wrap(x - EX(i), nx);
        const int ys = HALO == 1 ? y - EY(i) : wrap(y - EY(i), ny);
        const int zs = wrap(z - EZ(i), nz);
        const int lat = (HALO == 0 ? ys : xs) * nz + zs;
        const int nb = (xs * ny + ys) * nz + zs;
        const long long own = (long long)OPP(i) * n_cells + cell;
        const float* from =
            face ? (ea > 0 ? h.lo : h.hi) +
                       (long long)halo_slot(HALO, i) *
                           (HALO == 0 ? ny : nx) * nz + lat
                 : src + (long long)i * n_cells + nb;
        const int8_t m =
            *(face ? (ea > 0 ? h.mask_lo : h.mask_hi) + lat : mask + nb);
        if constexpr (MOVING) {
          const float v = *(m == kWall || m == kMoving ? src + own : from);
          p[i] = m == kMoving ? v + bb[i] : v;
        } else {
          p[i] = *(m == kWall ? src + own : from);
        }
        continue;
      }
    }
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
      const float v = widen(src[own ? (long long)OPP(i) * n_cells + cell
                                    : (long long)i * n_cells + nb]);
      p[i] = m == kMoving ? v + bb[i] : v;
    } else {
      p[i] = widen(mask[nb] == kWall ? src[(long long)OPP(i) * n_cells + cell]
                                     : src[(long long)i * n_cells + nb]);
    }
  }
}

// Rewrite the pulled populations of one consumer-plane cell with the
// NEE formula: p_i = rho* phi*_i + (f_i(x) - rho_prev phi_i(u_prev)) omega
// for each prescribed direction whose lateral cell is valid (u_prev with
// the F/2 shift under FORCE). WKF: the instance derives a windkessel
// outlet's rho* from the fold (bc.wk, where set); without it the code is
// the static rewrite's alone. DIVX: moments19's exact-division form.
template <bool FORCE, typename S, bool WKF = false, bool DIVX = false>
__device__ __forceinline__ void nee_fix(const BCDesc& bc,
                                        const S* __restrict__ src,
                                        long long n_cells, int cell,
                                        long long lat,
                                        const float* half_force, float* p,
                                        const WKFold* fold = nullptr) {
  float own[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    own[i] = widen(src[(long long)i * n_cells + cell]);
  }
  float rp, uxp, uyp, uzp;
  moments19<FORCE, DIVX>(own, half_force, rp, uxp, uyp, uzp);
  const float usqp = uxp * uxp + uyp * uyp + uzp * uzp;
  float rho_star = bc.rho_is_fixed ? bc.rho_fixed : rp;
  if constexpr (WKF) {
    if (bc.wk >= 0) rho_star = wk_rho_star(*fold, bc.wk);
  }
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
// field_dc is c - c_ref, field_from the force and its half from it.
__device__ __forceinline__ float field_dc(const Collision& c,
                                          long long n_cells, int cell) {
  float cs = c.gfield[cell];
#pragma unroll
  for (int i = 1; i < 7; ++i) cs += c.gfield[(long long)i * n_cells + cell];
  return cs - c.c_ref;
}
__device__ __forceinline__ void field_from(const Collision& c, float dc,
                                           float* F, float* half) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    F[a] = c.buoy[a] * dc;
    half[a] = 0.5f * F[a];
  }
}
__device__ __forceinline__ void field_force(const Collision& c,
                                            long long n_cells, int cell,
                                            float* F, float* half) {
  field_from(c, field_dc(c, n_cells, cell), F, half);
}

// The bf16 bits of v rounded to nearest even.
__device__ __forceinline__ unsigned bf16_bits(float v) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// TRT's relaxation of direction i and its opposite o from their shared
// sum s and difference d (o's d is -d exactly, its s is s), as the
// per-direction form computes each: post[i] = p[i] - s / b - d / bm and
// post[o] = p[o] - s / b - (-d) / bm, with div_exact by (b, y) and (bm,
// ym) once for both.
__device__ __forceinline__ void trt_pair(const float* p, float s, float d,
                                         int i, float b, float y, float bm,
                                         float ym, float* post) {
  const int o = OPP(i);
  const float qs = div_exact(s, b, y);
  const float qd = div_exact(d, bm, ym);
  post[i] = p[i] - qs - qd;
  if (o != i) post[o] = p[o] - qs + qd;
}

// F and half: the cell's force and F/2, read under FORCE (the
// descriptor's constants, or field_force's). DIVX: the paired bf16
// kernel's form: the same arithmetic with every division by tau, 2 tau,
// 2 tau_minus, rho and a closure's tau_eff, 2 tau_eff and 2 tau_minus_eff
// a div_exact (the same values); rcp: RN(1/tau), RN(1/(2 tau)),
// RN(1/(2 tau_minus)).
template <int COLL, bool CLOSURE, int FORCE, typename S, bool DIVX = false>
__device__ __forceinline__ float collide_store(const float* p,
                                               const Collision& c,
                                               const float* F,
                                               const float* half,
                                               S* __restrict__ dst,
                                               long long n_cells, int cell,
                                               const float* rcp = nullptr) {
  static_assert(!DIVX || FORCE != kFieldForce, "bf16 has no force field");
  float rho, ux, uy, uz;
  moments19<FORCE != kNoForce, DIVX>(p, half, rho, ux, uy, uz);
  const float usq = ux * ux + uy * uy + uz * uz;
  if constexpr (COLL == kBGK && !CLOSURE && FORCE == kNoForce) {
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const float feq = rho * phi_i(i, ux, uy, uz, usq);
      if constexpr (DIVX) {
        dst[(long long)i * n_cells + cell] =
            narrow<S>(p[i] - div_exact(p[i] - feq, c.tau, rcp[0]));
      } else {
        dst[(long long)i * n_cells + cell] =
            narrow<S>(p[i] - (p[i] - feq) / c.tau);
      }
    }
  } else if constexpr (COLL == kTRT && FORCE == kFieldForce) {
    // TRT with the field force, a direction at a time: its own and its
    // opposite's feq on the spot (the same value each time), its update,
    // its Guo source, its store, in the operations and order of the
    // branch below. With feq[], post[] and p live at once the instance
    // took 90 registers, two blocks an SM.
    const float uf = ux * F[0] + uy * F[1] + uz * F[2];
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const int o = OPP(i);
      const float fi = rho * phi_i(i, ux, uy, uz, usq);
      const float fo = rho * phi_i(o, ux, uy, uz, usq);
      const float s = (p[i] + p[o]) - (fi + fo);
      const float d = (p[i] - p[o]) - (fi - fo);
      const float post = p[i] - s / c.two_tau - d / c.two_tau_m;
      const float eu = e_dot(i, ux, uy, uz);
      const float e_f = e_dot(i, F[0], F[1], F[2]);
      const float g_even = WGT(i) * (9.0f * eu * e_f - 3.0f * uf);
      const float g_odd = (3.0f * WGT(i)) * e_f;
      dst[(long long)i * n_cells + cell] =
          narrow<S>(post + (c.cp * g_even + c.cm * g_odd));
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
        if constexpr (DIVX) {
          // direction o = OPP(i)'s s is i's and its d is -d: one pair of
          // quotients for both (trt_pair)
          const float b = 2.0f * te, bm = 2.0f * te_m;
          const float y = __frcp_rn(b), ym = __frcp_rn(bm);
#pragma unroll
          for (int i = 0; i < Q; ++i) {
            const int o = OPP(i);
            if (o < i) continue;
            trt_pair(p, fneq[i] + fneq[o], fneq[i] - fneq[o], i, b, y, bm,
                     ym, post);
          }
        } else {
#pragma unroll
          for (int i = 0; i < Q; ++i) {
            const float s = fneq[i] + fneq[OPP(i)];
            const float d = fneq[i] - fneq[OPP(i)];
            post[i] = p[i] - s / (2.0f * te) - d / (2.0f * te_m);
          }
        }
      } else if constexpr (DIVX) {
        const float y = __frcp_rn(te);
#pragma unroll
        for (int i = 0; i < Q; ++i) post[i] = p[i] - div_exact(fneq[i], te, y);
      } else {
#pragma unroll
        for (int i = 0; i < Q; ++i) post[i] = p[i] - fneq[i] / te;
      }
    } else if constexpr (COLL == kBGK) {
      if constexpr (DIVX) {
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          post[i] = p[i] - div_exact(p[i] - feq[i], c.tau, rcp[0]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < Q; ++i) post[i] = p[i] - (p[i] - feq[i]) / c.tau;
      }
    } else if constexpr (COLL == kTRT) {
      if constexpr (DIVX) {
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          const int o = OPP(i);
          if (o < i) continue;
          trt_pair(p, (p[i] + p[o]) - (feq[i] + feq[o]),
                   (p[i] - p[o]) - (feq[i] - feq[o]), i, c.two_tau, rcp[1],
                   c.two_tau_m, rcp[2], post);
        }
      } else {
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          const int o = OPP(i);
          const float s = (p[i] + p[o]) - (feq[i] + feq[o]);
          const float d = (p[i] - p[o]) - (feq[i] - feq[o]);
          post[i] = p[i] - s / c.two_tau - d / c.two_tau_m;
        }
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
    for (int i = 0; i < Q; ++i) {
      dst[(long long)i * n_cells + cell] = narrow<S>(post[i]);
    }
  }
  return usq;
}

// block_sum's sum written to *slot (the paired kernel's blocks are
// numbered over a 3-D grid); block_sum itself keeps its code for the
// instances the paired kernel leaves as they were.
__device__ __forceinline__ void block_sum_to(double v,
                                             double* __restrict__ slot) {
  __shared__ double red[kBlock];
  red[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (unsigned s = kBlock / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) *slot = red[0];
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

// series[t] = (or +=, when accumulate) the sum of the block partials, in
// a fixed order, by one block of kReduceBlock threads.
__device__ __forceinline__ void velsum_reduce(
    const double* __restrict__ partials, int n, double* __restrict__ series,
    int t, int accumulate) {
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

__global__ void __launch_bounds__(kReduceBlock)
velsum_reduce_kernel(const double* __restrict__ partials, int n,
                     double* __restrict__ series, int t, int accumulate) {
  velsum_reduce(partials, n, series, t, accumulate);
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

// Whether storage type S has instance K with halo axis HALO: bf16
// storage has every one but the force field's (lbm_tpu's transports keep
// fp32 state); a shard (HALO 0 or 1) is fp32 and has no force field, as
// lbm_tpu's sharded path takes neither bf16 nor the transports' field.
template <typename S, int K, int HALO = -1>
constexpr bool has_instance() {
  return Inst<K>::kValid &&
         (std::is_same<S, float>::value || Inst<K>::kForce != kFieldForce) &&
         (HALO < 0 ||
          (std::is_same<S, float>::value && Inst<K>::kForce != kFieldForce));
}

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

}  // namespace
