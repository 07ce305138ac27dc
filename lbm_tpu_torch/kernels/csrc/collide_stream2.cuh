// Two fused D3Q19 steps per launch (K2) and the chunked state read (K4)
// for NVIDIA Hopper (sm_90a): the kernels and their host entries,
// templated on the state's storage type. collide_stream2.cu instantiates
// them for float storage and collide_stream2_bf16.cu for bf16 storage,
// each its own translation unit and shared object, compiled side by side.
//
// lbm_collide_stream2 replaces lbm_tpu/kernels/collide_stream.py::_kernel2
// (via ::_pallas_bulk2 and make_pallas_step(fuse=2)): it advances f by two
// steps, t and t + 1, with one read and one write of the state. It takes
// every branch the single-step kernel takes except the force field (BGK,
// TRT, MRT, the closures, the constant Guo force, moving walls; lbm_tpu
// refuses force_field with fuse=2 too), the x/y-plane NEE boundaries with
// a phase table for each of the two steps, and the live-tile list (the
// `tids` of _kernel2). z-plane boundaries are refused by the host: their
// fixup runs after the bulk step and cannot sit between the two.
//
// Layout and semantics are the single-step kernel's (collide_stream.cuh):
// SoA f[19][nx][ny][nz] in fp32 or bf16, z contiguous, modulo wrap on all three axes,
// ping-pong buffers. It does not copy the TPU kernel's ring-2 packed
// layout or its DMA ladder. One block of kBlock threads owns a kT^3
// interior tile (ceil-div over the box, so any extent works):
//   pass 1 computes the (kT + 2)^3 mid tile, the interior plus a one-cell
//     skirt, from device memory with the single-step kernel's per-cell
//     body (pull19 with wall and moving-wall bounce-back, nee_fix with
//     step t's phase, collide_store) into shared memory in fp32; a
//     non-fluid cell's slot gets its source populations and the mid tile
//     keeps each cell's mask byte. Only the cells the tile owns (its
//     interior inside the box) count toward step t's velsum: the skirt is
//     recomputed by the neighbouring tiles that own it (lbm_tpu's
//     `vs_win`/`owned`).
//   pass 2 pulls from the mid tile in local coordinates, applies nee_fix
//     with step t + 1's phase reading each cell's own populations from the
//     mid tile, and writes the interior cells inside the box to dst
//     (non-fluid cells copied through); each counts toward step t + 1's
//     velsum.
// Every global index is wrapped and the mid tile is indexed only locally,
// so a box axis shorter than the tile (pipe n = 36, a 1-cell periodic slab)
// and an extent that is not a multiple of it both work. Arithmetic is the
// shared device functions' (d3q19.cuh), so a pair equals two single-step
// launches bit for bit; the velsums are summed per block in double in a
// fixed order, as there, but over other blocks, so they agree to rounding.
//
// What bounds it: pass 1 recomputes the skirt, (kT + 2)^3 / kT^3 = 1.95x
// the interior's collisions at kT = 8, and the mid tile (76 KB of fp32 plus
// 1 KB of mask) allows two blocks (16 warps) an SM. A pair moves one
// state's bytes against two for two single steps, plus the skirt's
// re-reads, which mostly hit L2.
//
// bf16 storage (S = __nv_bfloat16) widens the global loads of pass 1 and
// narrows pass 2's stores; the mid tile stays fp32 whatever the storage,
// as lbm_tpu's does (collide_stream.py:2084-2086), so a bf16 pair rounds
// once: "widen, two fp32 steps, narrow", bit for bit. That is lbm_tpu's
// bf16 fuse=2 result, and not two bf16 single steps, which narrow in
// between. A non-fluid cell's bf16 words pass through the mid tile exactly.
//
// lbm_extract_rows replaces ::_extract_rows (the HBM-to-HBM DMA of x rows
// behind unpack_state_lowmem): out[c, i, y, z] = f[c, x0 + i, y, z] for the
// 19 channels, a contiguous (19, wx, Y, Z) chunk in the state's own type.
// Each channel's rows are one contiguous span, so it is a copy of 19
// spans, 16 bytes a thread where alignment allows; bound by bytes (each
// read and written once; a bf16 chunk is half the bytes).

#pragma once

#include "d3q19.cuh"

namespace {

constexpr int kT = 8;                  // interior tile edge
constexpr int kM = kT + 2;             // mid tile edge
constexpr int kMid = kM * kM * kM;     // mid tile cells
constexpr int kInterior = kT * kT * kT;
constexpr size_t kSmemBytes = (size_t)Q * kMid * sizeof(float) + kMid;
constexpr int kCopyBlock = 256;

// v in [-1, n + kT] to [0, n)
__device__ __forceinline__ int wrap_far(int v, int n) {
  if (v < 0) v += n;
  return v >= n ? v % n : v;
}

// The pulled populations of mid-tile cell m (interior, so every neighbor
// is inside the tile): the single-step pull19 with the fp32 mid tile as
// source.
template <bool MOVING>
__device__ __forceinline__ void pull_mid(const float* mid,
                                         const int8_t* mmask, int m,
                                         const float* bb, float* p) {
  p[0] = mid[m];
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    const int nb = m - (EX(i) * kM + EY(i)) * kM - EZ(i);
    const int8_t mk = mmask[nb];
    if constexpr (MOVING) {
      const bool own = mk == kWall || mk == kMoving;
      const float v = mid[own ? OPP(i) * kMid + m : i * kMid + nb];
      p[i] = mk == kMoving ? v + bb[i] : v;
    } else {
      p[i] = mk == kWall ? mid[OPP(i) * kMid + m] : mid[i * kMid + nb];
    }
  }
}

// The NEE rewrites of the x/y-plane boundaries of one step at global cell
// (x, y, z), own pre-step populations at own[k * stride + idx] (the
// state in device memory, or the mid tile).
template <bool FORCE, typename S>
__device__ __forceinline__ void nee_all(const BCSet& bcs, const S* own,
                                        long long stride, int idx, int x,
                                        int y, int z, int nz,
                                        const float* half_force, float* p) {
#pragma unroll
  for (int b = 0; b < kMaxBCs; ++b) {
    if (b >= bcs.n) break;
    const BCDesc& bc = bcs.bc[b];
    if ((bc.axis == 0 ? x : y) != bc.coord) continue;
    const long long lat = (long long)(bc.axis == 0 ? y : x) * nz + z;
    nee_fix<FORCE>(bc, own, stride, idx, lat, half_force, p);
  }
}

// Launch block b works on tile tiles[b], or on tile b when `tiles` is
// null; tile ids run over the (gx, gy, gz) tile grid with z fastest.
// partials[b] gets the block's step-t velsum, partials[gridDim.x + b] its
// step t + 1 velsum. Two blocks an SM fit the shared memory; the launch
// bounds hold the registers to that (128 a thread).
template <int COLL, bool CLOSURE, int FORCE, bool MOVING, typename S>
__global__ void __launch_bounds__(kBlock, 2)
collide_stream2_kernel(const S* __restrict__ src, S* __restrict__ dst,
                       const int8_t* __restrict__ mask, int nx, int ny,
                       int nz, int gy, int gz,
                       const __grid_constant__ Collision coll, BCSet bcs_t,
                       BCSet bcs_t1, const int* __restrict__ tiles,
                       double* __restrict__ partials) {
  extern __shared__ float mid[];  // [Q][kMid], then kMid mask bytes
  int8_t* mmask = reinterpret_cast<int8_t*>(mid + Q * kMid);
  const long long n_cells = (long long)nx * ny * nz;  // < 2^31 (host)
  const int tile = tiles ? tiles[blockIdx.x] : (int)blockIdx.x;
  const int x0 = tile / (gy * gz) * kT;
  const int y0 = tile / gz % gy * kT;
  const int z0 = tile % gz * kT;
  constexpr bool kForce = FORCE == kConstForce;

  // pass 1: step t over the mid tile, global (x0 - 1, y0 - 1, z0 - 1) at
  // its local origin
  double vs1 = 0.0;
  for (int m = threadIdx.x; m < kMid; m += kBlock) {
    const int lz = m % kM, ly = m / kM % kM, lx = m / (kM * kM);
    const int x = wrap_far(x0 + lx - 1, nx);
    const int y = wrap_far(y0 + ly - 1, ny);
    const int z = wrap_far(z0 + lz - 1, nz);
    const int cell = (x * ny + y) * nz + z;
    const int8_t mk = mask[cell];
    mmask[m] = mk;
    if (mk != kFluid) {
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        mid[i * kMid + m] = widen(src[(long long)i * n_cells + cell]);
      }
      continue;
    }
    float p[Q];
    pull19<MOVING>(src, mask, x, y, z, nx, ny, nz, n_cells, cell, coll.bb,
                   p);
    nee_all<kForce>(bcs_t, src, n_cells, cell, x, y, z, nz,
                    coll.half_force, p);
    const float usq = collide_store<COLL, CLOSURE, FORCE>(
        p, coll, coll.force, coll.half_force, mid, kMid, m);
    const bool owned = lx >= 1 && lx <= kT && ly >= 1 && ly <= kT &&
                       lz >= 1 && lz <= kT && x0 + lx - 1 < nx &&
                       y0 + ly - 1 < ny && z0 + lz - 1 < nz;
    if (owned) vs1 += (double)sqrtf(usq);
  }
  __syncthreads();

  // pass 2: step t + 1 of the interior cells inside the box
  double vs2 = 0.0;
  for (int k = threadIdx.x; k < kInterior; k += kBlock) {
    const int lz = k % kT, ly = k / kT % kT, lx = k / (kT * kT);
    const int x = x0 + lx, y = y0 + ly, z = z0 + lz;
    if (x >= nx || y >= ny || z >= nz) continue;
    const int cell = (x * ny + y) * nz + z;
    const int m = ((lx + 1) * kM + ly + 1) * kM + lz + 1;
    if (mmask[m] != kFluid) {
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        dst[(long long)i * n_cells + cell] = narrow<S>(mid[i * kMid + m]);
      }
      continue;
    }
    float p[Q];
    pull_mid<MOVING>(mid, mmask, m, coll.bb, p);
    nee_all<kForce>(bcs_t1, mid, kMid, m, x, y, z, nz, coll.half_force, p);
    vs2 += (double)sqrtf(collide_store<COLL, CLOSURE, FORCE>(
        p, coll, coll.force, coll.half_force, dst, n_cells, cell));
  }
  block_sum(vs1, partials);
  block_sum(vs2, partials + gridDim.x);
}

// out[c][k] = f[c * plane + off + k] for k < n, the 19 channels on
// blockIdx.y; T is float4 when every span is 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kCopyBlock)
extract_rows_kernel(const T* __restrict__ f, T* __restrict__ out,
                    long long plane, long long off, long long n) {
  const long long c = blockIdx.y;
  const T* from = f + c * plane + off;
  T* to = out + c * n;
  for (long long k = (long long)blockIdx.x * kCopyBlock + threadIdx.x; k < n;
       k += (long long)gridDim.x * kCopyBlock) {
    to[k] = from[k];
  }
}

template <typename S>
struct PairArgs {
  const S* src;
  S* dst;
  const int8_t* mask;
  int nx, ny, nz, gy, gz;
  const int* tiles;
  double* partials;
  unsigned grid;
  cudaStream_t stream;
};

template <typename S>
using PairLauncher = int (*)(const PairArgs<S>&, const Collision&,
                             const BCSet&, const BCSet&);

template <typename S, int K>
int launch_pair(const PairArgs<S>& a, const Collision& c, const BCSet& bt,
                const BCSet& bt1) {
  using I = Inst<K>;
  cudaError_t err = cudaFuncSetAttribute(
      collide_stream2_kernel<I::kColl, I::kClosure, I::kForce,
                             I::kMovingWall, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  collide_stream2_kernel<I::kColl, I::kClosure, I::kForce, I::kMovingWall, S>
      <<<a.grid, kBlock, kSmemBytes, a.stream>>>(
          a.src, a.dst, a.mask, a.nx, a.ny, a.nz, a.gy, a.gz, c, bt, bt1,
          a.tiles, a.partials);
  return (int)cudaGetLastError();
}

// The pair has every single-step instance but the force field's, in
// either storage.
template <typename S, int K>
constexpr PairLauncher<S> pair_entry() {
  if constexpr (Inst<K>::kValid && Inst<K>::kForce != kFieldForce) {
    return &launch_pair<S, K>;
  } else {
    return nullptr;
  }
}
template <typename S, int... K>
constexpr std::array<PairLauncher<S>, kNumKeys> pair_table(
    std::integer_sequence<int, K...>) {
  return {pair_entry<S, K>()...};
}
template <typename S>
constexpr std::array<PairLauncher<S>, kNumKeys> kPairTable =
    pair_table<S>(std::make_integer_sequence<int, kNumKeys>{});

bool parse_bcs(int n_bc, const int* bc_int, const float* bc_float,
               const void* const* valid_ptrs, const void* const* phi_ptrs,
               int nx, int ny, int nz, BCSet& bcs) {
  bcs.n = n_bc;
  for (int b = 0; b < n_bc; ++b) {
    if (!parse_bc(bc_int + b * kBCInts, bc_float + 2 * b, valid_ptrs[b],
                  phi_ptrs[b], nx, ny, nz, bcs.bc[b]) ||
        bcs.bc[b].axis == 2) {
      return false;
    }
  }
  return true;
}

// The host entries, exported under their C names by collide_stream2.cu
// (S = float) and collide_stream2_bf16.cu (S = __nv_bfloat16, names
// ending in _bf16).

// Two steps from src into dst at absolute steps t and t + 1 with the
// collision branch of coll_int/coll_float (CInt/CFloat; no force field)
// and the x/y-plane boundaries (rows as parse_bc): phi_t[b] and phi_t1[b]
// are boundary b's phase tables of the two steps (null for u_extrap).
// series[slot] and series[slot + 1] = the fluid velsums of the two steps.
// tiles: null (every tile of the ceil-div kT^3 grid) or a device list of
// n_tiles tile ids; the tiles left out must hold only DEAD cells, equal in
// src and dst. partials holds 2 doubles a launched tile (n_partials).
// Returns cudaGetLastError().
template <typename S>
int collide_stream2(const S* src, S* dst, const int8_t* mask, int nx, int ny,
                    int nz, const int* coll_int, const float* coll_float,
                    int n_bc, const int* bc_int, const float* bc_float,
                    const void* const* valid_ptrs, const void* const* phi_t,
                    const void* const* phi_t1, const int* tiles, int n_tiles,
                    double* partials, int n_partials, double* series,
                    int slot, void* stream) {
  const long long n_cells = (long long)nx * ny * nz;
  if (nx <= 0 || ny <= 0 || nz <= 0 || n_cells > 0x7fffffffLL ||
      n_bc < 0 || n_bc > kMaxBCs) {
    return (int)cudaErrorInvalidValue;
  }
  const int gx = (nx + kT - 1) / kT, gy = (ny + kT - 1) / kT,
            gz = (nz + kT - 1) / kT;
  const long long all_tiles = (long long)gx * gy * gz;
  const long long grid = tiles ? n_tiles : all_tiles;
  if (grid <= 0 || grid > all_tiles || 2 * grid != n_partials) {
    return (int)cudaErrorInvalidValue;
  }
  Collision coll = {};
  const int key = parse_collision(coll_int, coll_float, nullptr, coll);
  if (key < 0 || kPairTable<S>[key] == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  BCSet bt = {}, bt1 = {};
  if (!parse_bcs(n_bc, bc_int, bc_float, valid_ptrs, phi_t, nx, ny, nz, bt) ||
      !parse_bcs(n_bc, bc_int, bc_float, valid_ptrs, phi_t1, nx, ny, nz,
                 bt1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PairArgs<S> args = {src, dst, mask, nx, ny, nz, gy, gz, tiles,
                            partials, (unsigned)grid, s};
  int err = kPairTable<S>[key](args, coll, bt, bt1);
  if (err != 0) return err;
  velsum_reduce_kernel<<<1, kReduceBlock, 0, s>>>(partials, (int)grid,
                                                   series, slot, 0);
  velsum_reduce_kernel<<<1, kReduceBlock, 0, s>>>(partials + grid, (int)grid,
                                                   series, slot + 1, 0);
  return (int)cudaGetLastError();
}

// x rows [x0, x0 + wx) of the (19, X, Y, Z) state f into the contiguous
// (19, wx, Y, Z) out, both in storage type S. Returns cudaGetLastError().
template <typename S>
int extract_rows(const S* f, S* out, int X, int Y, int Z, int x0, int wx,
                 void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0 || x0 < 0 || wx <= 0 || x0 + wx > X) {
    return (int)cudaErrorInvalidValue;
  }
  const long long row = (long long)Y * Z;
  long long plane = X * row, off = x0 * row, n = wx * row;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr long long per_vec = 16 / sizeof(S);  // elements in a float4
  const bool vec = row % per_vec == 0 &&
                   reinterpret_cast<uintptr_t>(f) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    plane /= per_vec, off /= per_vec, n /= per_vec;
  }
  const long long blocks = (n + kCopyBlock - 1) / kCopyBlock;
  const dim3 grid((unsigned)(blocks < 8192 ? blocks : 8192), Q);
  if (vec) {
    extract_rows_kernel<float4><<<grid, kCopyBlock, 0, s>>>(
        reinterpret_cast<const float4*>(f), reinterpret_cast<float4*>(out),
        plane, off, n);
  } else {
    extract_rows_kernel<S><<<grid, kCopyBlock, 0, s>>>(f, out, plane, off,
                                                      n);
  }
  return (int)cudaGetLastError();
}

}  // namespace
