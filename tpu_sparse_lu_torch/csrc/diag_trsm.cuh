// The substitution solve of one diagonal tile for up to four columns of
// the carrier, as a device function of one block: the body of
// diag_trsm_kernel (csrc/ldiv.cu), the diagonal step of the level-step
// solve at tri_mode="trsm". Nothing here is a kernel.
//
// What it computes. For one chunk k of a level, D_k y = x_k in place: D_k
// is the factor's (cs, cs) row-major diagonal tile (L: lower, its unit
// diagonal stored; U: upper; padding rows = I), x_k the chunk's (cs, R)
// block of the carrier. Each element is x_i = (r_i - sum_j D_ij x_j) /
// D_ii: the products subtracted one FMA at a time in the order of the
// solve (j ascending for L, descending for U), then the true division
// (lut::div_rn). No inverse of a tile or of a block is formed, and
// everything stays in the carrier's type.
//
// What bounds it. A tile is 2 cs^2 FLOP a column and at most 128 KB
// (float64), nothing for the card's rates; its time is the chain of cs
// dependent steps, each step's division waiting on the FMA of the step
// before. So the design shortens that chain and lays the rest beside it:
//
// * One warp owns one column of x for the whole tile, lane l positions
//   l, l + 32, l + 64 and l + 96 in registers (position u is row u of L
//   and row cs - 1 - u of U, so both solve forwards). Step t: every lane
//   divides its value of slot t / 32 (lane t % 32's numerator is then
//   final), one shuffle hands x_t to the warp, and each lane subtracts
//   D_ut x_t from its later positions. The chain of a step is the
//   division, the shuffle and the next owner's FMA, with no barrier. The
//   columns are independent: a block takes 4, a warp on each SM
//   sub-partition, and the grid is (the level's chunks) x (R / 4), so a
//   level of 23 tiles at R = 16 runs 92 blocks on 92 SMs.
// * The tile waits in shared memory in the order the steps read it:
//   column panel p (the columns of positions 32p .. 32p + 31, every row at
//   a position >= 32p) is one cp.async group, all four issued at the
//   start; the block waits for panel p only when it reaches it, so the
//   later panels' loads hide under the earlier panels' steps. Only the
//   triangle and its diagonal blocks are read (80 KB of a float64 tile).
//   A lane reads D_ut for 16 bytes of steps at once; the row pitch is
//   lut::kPitch (16 bytes past 128 elements), so the 8 lanes of each
//   quarter-warp phase of a 16-byte read hit distinct banks.
//
// Where a tile's rows are not whole 16-byte pieces (cs * sizeof(T) not a
// multiple of 16), Vec = false stages and reads one element at a time.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lu_tile.cuh"

namespace {
namespace dts {

constexpr int kWarps = 4;  // columns of x a block, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCs = lut::kMaxCs;
constexpr int kSlots = kMaxCs / 32;  // positions a lane holds
constexpr unsigned kFull = 0xffffffffu;

// dynamic shared memory of a block: the staged tile
template <typename T>
constexpr size_t smem_bytes(int cs) {
  return lut::tile_bytes<T>(cs);
}

template <bool Lower>
__device__ __forceinline__ int row_of(int u, int cs) {
  return Lower ? u : cs - 1 - u;
}

// cp.async.wait_group with a constant count
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copies of column panel p of the tile d into ds: the columns of
// positions [32p, 32p + 32) of every row at a position >= 32p. A thread
// copies one piece of a row (16 bytes, or one element where not Vec) in
// every kThreads / W-th row.
template <typename T, bool Vec, bool Lower>
__device__ __forceinline__ void stage_panel(T* ds, const T* d, int cs,
                                            int p) {
  const int t0 = 32 * p;
  if (t0 >= cs) return;
  const int t1 = min(t0 + 32, cs);
  constexpr int NV = Vec ? lut::kNV<T> : 1;
  constexpr int W = 32 / NV;  // pieces of a whole panel's row
  const int c = (Lower ? t0 : cs - t1) + (threadIdx.x % W) * NV;
  if ((int)(threadIdx.x % W) * NV >= t1 - t0) return;
  const int r0 = Lower ? t0 : 0;
  for (int i = r0 + threadIdx.x / W; i < r0 + cs - t0; i += kThreads / W)
    __pipeline_memcpy_async(ds + i * lut::kPitch<T> + c, d + i * cs + c,
                            NV * sizeof(T));
}

// a[e] = D[i][row_of(t0 + e)] for the staged row ds_row = ds + i * pitch
template <typename T, bool Vec, bool Lower>
__device__ __forceinline__ void coefs(const T* ds_row, int t0, int cs,
                                      T (&a)[lut::kNV<T>]) {
  constexpr int NV = lut::kNV<T>;
  if constexpr (Vec) {
    const auto v = lut::load16(ds_row + (Lower ? t0 : cs - NV - t0));
#pragma unroll
    for (int e = 0; e < NV; ++e)
      a[e] = lut::Vec16<T>::part(v, Lower ? e : NV - 1 - e);
  } else {
#pragma unroll
    for (int e = 0; e < NV; ++e)
      a[e] = t0 + e < cs ? ds_row[row_of<Lower>(t0 + e, cs)] : T(0);
  }
}

// The lane's positions of one column: r their values (solved ones hold
// x), dg their diagonal entries
template <typename T>
struct Column {
  T r[kSlots], dg[kSlots];
};

template <typename T, bool Lower>
__device__ __forceinline__ void load_column(Column<T>& c, const T* xk,
                                            const T* dk, int cs, int R,
                                            int j, int lane) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int u = lane + 32 * s;
    const bool in = u < cs;
    const int i = in ? row_of<Lower>(u, cs) : 0;
    c.r[s] = in ? xk[(int64_t)i * R + j] : T(0);
    c.dg[s] = in ? dk[i * cs + i] : T(1);
  }
}

// Steps t0 .. t0 + NV - 1 of panel P (all < cs where Whole): lane t - 32P
// owns step t. Branch-free: every lane divides its value of slot P and
// takes the owner's quotient by shuffle; selects keep the solved lanes'
// values and put x_t on its owner, off the chain, whose links are the
// division, the shuffle and the next owner's FMA.
template <typename T, bool Vec, bool Lower, int P, bool Whole>
__device__ __forceinline__ void steps(Column<T>& c, const T* ds, int cs,
                                      int lane, int t0) {
  constexpr int NV = lut::kNV<T>;
  T a[kSlots][NV];
#pragma unroll
  for (int s = P; s < kSlots; ++s) {
    // a position past cs reads a staged row and is never written back
    const int u = min(lane + 32 * s, cs - 1);
    coefs<T, Vec, Lower>(ds + row_of<Lower>(u, cs) * lut::kPitch<T>, t0, cs,
                         a[s]);
  }
  const int d = lane - (t0 - 32 * P);  // step t0 + e is lane d's at d == e
#pragma unroll
  for (int e = 0; e < NV; ++e) {
    if (!Whole && t0 + e >= cs) break;
    const T q = lut::div_rn(c.r[P], c.dg[P]);
    const T xt = __shfl_sync(kFull, q, t0 + e - 32 * P);
    const T next = fma(-a[P][e], xt, c.r[P]);  // right on the lanes d > e
    c.r[P] = d == e ? q : d > e ? next : c.r[P];
#pragma unroll
    for (int s = P + 1; s < kSlots; ++s)
      c.r[s] = fma(-a[s][e], xt, c.r[s]);
  }
}

// The steps of positions [32P, 32P + 32) for this warp's column, once
// the panel's copies are in. A whole panel is unrolled.
template <typename T, bool Vec, bool Lower, int P>
__device__ __forceinline__ void panel(Column<T>& c, const T* ds, int cs,
                                      int lane, bool active) {
  constexpr int NV = lut::kNV<T>;
  wait_groups<kSlots - 1 - P>();  // this thread's copies of panel P
  __syncthreads();                // and every other thread's
  if (!active || 32 * P >= cs) return;
  if (cs >= 32 * P + 32) {
#pragma unroll
    for (int g = 0; g < 32; g += NV)
      steps<T, Vec, Lower, P, true>(c, ds, cs, lane, 32 * P + g);
  } else {
    for (int t0 = 32 * P; t0 < min(32 * P + 32, cs); t0 += NV)
      steps<T, Vec, Lower, P, false>(c, ds, cs, lane, t0);
  }
}

// Solve D y = x in place for columns j0 .. j0 + kWarps - 1 (those < R) of
// the chunk's carrier block xk (cs, R), D = dk (cs, cs) row-major; ds is
// the block's shared memory, smem_bytes<T>(cs). Every thread of the block
// calls it.
template <typename T, bool Vec, bool Lower>
__device__ __forceinline__ void solve_block(T* xk, const T* dk, T* ds,
                                            int cs, int R, int j0) {
#pragma unroll
  for (int p = 0; p < kSlots; ++p) {
    stage_panel<T, Vec, Lower>(ds, dk, cs, p);
    __pipeline_commit();
  }
  const int lane = threadIdx.x & 31;
  const int j = j0 + (threadIdx.x >> 5);
  const bool active = j < R;
  Column<T> c;
  if (active) load_column<T, Lower>(c, xk, dk, cs, R, j, lane);
  static_assert(kSlots == 4, "one panel call a slot");
  panel<T, Vec, Lower, 0>(c, ds, cs, lane, active);
  panel<T, Vec, Lower, 1>(c, ds, cs, lane, active);
  panel<T, Vec, Lower, 2>(c, ds, cs, lane, active);
  panel<T, Vec, Lower, 3>(c, ds, cs, lane, active);
  if (!active) return;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int u = lane + 32 * s;
    if (u < cs) xk[(int64_t)row_of<Lower>(u, cs) * R + j] = c.r[s];
  }
}

}  // namespace dts
}  // namespace
