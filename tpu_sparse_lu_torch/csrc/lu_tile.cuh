// The dense-tile LU with both triangular inverses, as a device function of
// one block: the body of lu_tile_kernel (csrc/lu_tile.cu, whose header
// describes the design) and the diagonal task of elim_fused_kernel
// (csrc/elim_fused.cu). Included by both; nothing here is a kernel.
//
// With L2Only the tile is read from global memory through L2 only
// (ld.global.cg): in the one-launch elimination another SM rewrote it
// during the launch, and an L1 line this SM cached for an earlier task
// would be stale. lu_tile_kernel reads it with plain loads.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {
namespace lut {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCs = 128;
constexpr int kPanel = 32;           // columns per panel, one per lane
constexpr int RA = kMaxCs / kWarps;  // rows per thread (load, write-out)
constexpr int RB = kMaxCs / 32;      // columns per thread (load, write-out)
constexpr int kBlk = 32;             // block of the inverses, one per warp
constexpr int kCols = 8;             // columns (rows) of a block a task
constexpr int kGroups = kBlk / kCols;  // tasks a block
// tasks a warp takes in one step of the inverses: the last step has
// 2 kGroups (nb - 1) tasks
constexpr int kRounds = 2;
static_assert(2 * kGroups * (kMaxCs / kBlk - 1) <= kRounds * kWarps,
              "one step's tasks exceed the warps' rounds");
// the trailing block A22 is at most (kMaxCs - kPanel) square; thread
// (warp w, lane l) updates its rows k1 + w + 16a and columns k1 + l + 32b
constexpr int TA = (kMaxCs - kPanel) / kWarps;
constexpr int TB = (kMaxCs - kPanel) / 32;
constexpr unsigned kFull = 0xffffffffu;

// A diagnostic build (-DLU_TILE_CLOCKS, tools/lu_tile_sweep.py --clocks)
// sums in thread 0 the SM cycles (clock64) of each phase: 0 the load,
// 1 the diagonal blocks, 2 the panel solves, 3 the trailing updates,
// 4 the write-back and the pivot, 5 the inverses' diagonal blocks, 6 their
// off-diagonal fill and the write-out; block 0 writes them over the first
// elements of its uinv.
#ifdef LU_TILE_CLOCKS
constexpr int kClocks = 7;
#define CLOCK_START() \
  long long clk_[kClocks] = {0, 0, 0, 0, 0, 0, 0}, clk_last_ = clock64()
#define CLOCK(phase)                        \
  do {                                      \
    if (tid == 0) {                         \
      const long long t_ = clock64();       \
      clk_[phase] += t_ - clk_last_;        \
      clk_last_ = t_;                       \
    }                                       \
  } while (0)
#define CLOCK_WRITE(out)                                           \
  do {                                                             \
    __syncthreads();                                               \
    if (tid == 0 && blockIdx.x == 0)                               \
      for (int p_ = 0; p_ < kClocks; ++p_) (out)[p_] = (T)clk_[p_]; \
  } while (0)
#else
#define CLOCK_START() (void)0
#define CLOCK(phase) (void)0
#define CLOCK_WRITE(out) (void)0
#endif

// Row pitch of the tile in shared memory, whatever cs: a constant, so the
// unrolled loops address shared memory by immediate offsets, and 16 bytes
// past the widest row, so every row starts 16-byte aligned (the trailing
// update reads L21 16 bytes at a time). By count of shared-memory
// wavefronts: a row read by consecutive lanes, or one address read by a
// whole warp, is conflict-free; a column read with lane = row (loading
// and storing the rows of a diagonal block or of A21, 64 accesses a
// thread per panel) is 4-way in float32 (pitch 132 words: banks 4l mod
// 32) and 2-way in float64 (pitch 130 doubles: bank pairs 2l mod 16 per
// half-warp).
template <typename T>
constexpr int kPitch = kMaxCs + 16 / (int)sizeof(T);

template <typename T>
constexpr size_t tile_bytes(int cs) {
  return (size_t)cs * kPitch<T> * sizeof(T);
}

// 16 bytes of T, and element v of them
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static __device__ __forceinline__ float part(const float4& q, int v) {
    return v == 0 ? q.x : v == 1 ? q.y : v == 2 ? q.z : q.w;
  }
  static __device__ __forceinline__ float4 make(const float (&e)[4]) {
    return make_float4(e[0], e[1], e[2], e[3]);
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static __device__ __forceinline__ double part(const double2& q, int v) {
    return v == 0 ? q.x : q.y;
  }
  static __device__ __forceinline__ double2 make(const double (&e)[2]) {
    return make_double2(e[0], e[1]);
  }
};
template <typename T>
constexpr int kNV = 16 / (int)sizeof(T);  // elements of T in 16 bytes

// a / b rounded to nearest: the true division of the rank-1 loop. The
// division nvcc emits checks its operands' exponent range and leaves the
// fast path when the check fails, which a zero numerator (most
// multipliers of a sparse tile) is expected to do; a warp pays the slow
// path whenever one lane takes it. So 0 / b is taken apart: for b neither
// 0 nor NaN it is the zero of sign sign(a) ^ sign(b), which
// a * copysign(1, b) gives exactly; the division itself sits in volatile
// asm, so the compiler cannot hoist it out of its branch and run it for
// every lane. (On the headline's tiles this cut the diagonal blocks'
// cycles by a third; tools/lu_tile_sweep.py --clocks.)
__device__ __forceinline__ float div_rn(float a, float b) {
  if (a == 0.f && b == b && b != 0.f) return a * copysignf(1.f, b);
  float q;
  asm volatile("div.rn.f32 %0, %1, %2;" : "=f"(q) : "f"(a), "f"(b));
  return q;
}

__device__ __forceinline__ double div_rn(double a, double b) {
  if (a == 0.0 && b == b && b != 0.0) return a * copysign(1.0, b);
  double q;
  asm volatile("div.rn.f64 %0, %1, %2;" : "=d"(q) : "d"(a), "d"(b));
  return q;
}

template <typename T>
__device__ __forceinline__ T nan_min(T x, T y) {
  if (x != x) return x;
  if (y != y) return y;
  return x < y ? x : y;
}

// The diagonal block A11 = A[k0:k0+w, k0:k0+w] by the rank-1 loop, one
// warp: lane i holds row k0 + i in registers; step k takes the pivot and
// row k from lane k by shuffles (the warp's only synchronisation).
template <typename T>
__device__ __forceinline__ void factor_diag(T* A, int k0, int w,
                                            int lane) {
  T* row = A + (k0 + lane) * kPitch<T> + k0;
  const bool mine = lane < w;
  T r[kPanel];
#pragma unroll
  for (int t = 0; t < kPanel; ++t)
    r[t] = (mine && t < w) ? row[t] : T(0);
#pragma unroll
  for (int k = 0; k < kPanel; ++k) {
    if (k >= w) break;  // uniform
    const T p = __shfl_sync(kFull, r[k], k);
    const bool below = lane > k;
    T l = T(0);
    if (below) l = div_rn(r[k], p);
#pragma unroll
    for (int j = k + 1; j < kPanel; ++j) {
      const T u = __shfl_sync(kFull, r[j], k);
      if (below) r[j] -= l * u;
    }
    if (below) r[k] = l;
  }
  if (mine) {
#pragma unroll
    for (int t = 0; t < kPanel; ++t)
      if (t < w) row[t] = r[t];
  }
}

// Row i of A21 against U11: for j = k0.., a_ij -= a_ik u_kj (k = k0..j-1),
// then a_ij /= u_jj. One thread, the row in registers, U11 read from
// shared memory (the same address for every thread: a broadcast).
template <typename T>
__device__ __forceinline__ void solve_row(T* A, int k0, int w, int i) {
  T* row = A + i * kPitch<T> + k0;
  const T* U = A + k0 * kPitch<T> + k0;
  T r[kPanel];
#pragma unroll
  for (int t = 0; t < kPanel; ++t) r[t] = t < w ? row[t] : T(0);
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    if (j >= w) break;  // uniform
#pragma unroll
    for (int k = 0; k < j; ++k) r[j] -= r[k] * U[k * kPitch<T> + j];
    r[j] = div_rn(r[j], U[j * kPitch<T> + j]);
  }
#pragma unroll
  for (int t = 0; t < kPanel; ++t)
    if (t < w) row[t] = r[t];
}

// Column j of A12 against the unit L11: for i = k0.., a_ij -= l_ik a_kj
// (k = k0..i-1). One thread, the column in registers.
template <typename T>
__device__ __forceinline__ void solve_col(T* A, int k0, int w, int j) {
  T* col = A + k0 * kPitch<T> + j;
  const T* L = A + k0 * kPitch<T> + k0;
  T c[kPanel];
#pragma unroll
  for (int t = 0; t < kPanel; ++t)
    c[t] = t < w ? col[t * kPitch<T>] : T(0);
#pragma unroll
  for (int i = 1; i < kPanel; ++i) {
    if (i >= w) break;  // uniform
#pragma unroll
    for (int k = 0; k < i; ++k) c[i] -= L[i * kPitch<T> + k] * c[k];
  }
#pragma unroll
  for (int t = 1; t < kPanel; ++t)
    if (t < w) col[t * kPitch<T>] = c[t];
}

// A22 -= L21 U12 over the panel's kPanel columns k0.. (a panel with rows
// below it is always whole), in ascending order, each product subtracted
// into the element (held in a register). Row i of L21 is read 16 bytes
// (4 floats, 2 doubles) at a time, the same address for the whole warp.
template <typename T>
__device__ __forceinline__ void update_trailing(T* A, int cs, int k0,
                                                int warp, int lane) {
  using V = Vec16<T>;
  constexpr int P = kPitch<T>;
  constexpr int NV = 16 / (int)sizeof(T);
  const int k1 = k0 + kPanel;
  if (k1 + warp >= cs) return;  // no row of this warp
  T acc[TA][TB];
#pragma unroll
  for (int a = 0; a < TA; ++a)
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const int i = k1 + warp + kWarps * a;
      const int j = k1 + lane + 32 * b;
      acc[a][b] = (i < cs && j < cs) ? A[i * P + j] : T(0);
    }
#pragma unroll 2
  for (int kk = 0; kk < kPanel; kk += NV) {
    typename V::type lv[TA];
#pragma unroll
    for (int a = 0; a < TA; ++a) {
      const int i = k1 + warp + kWarps * a;
      if (i < cs)
        lv[a] = *reinterpret_cast<const typename V::type*>(
            &A[i * P + k0 + kk]);
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int k = k0 + kk + v;
      T u[TB];
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        const int j = k1 + lane + 32 * b;
        u[b] = j < cs ? A[k * P + j] : T(0);
      }
#pragma unroll
      for (int a = 0; a < TA; ++a) {
        const bool in = k1 + warp + kWarps * a < cs;
        const T l = in ? V::part(lv[a], v) : T(0);
#pragma unroll
        for (int b = 0; b < TB; ++b) acc[a][b] -= l * u[b];
      }
    }
  }
#pragma unroll
  for (int a = 0; a < TA; ++a)
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const int i = k1 + warp + kWarps * a;
      const int j = k1 + lane + 32 * b;
      if (i < cs && j < cs) A[i * P + j] = acc[a][b];
    }
}

// 16 bytes of T at p (16-byte aligned)
template <typename T>
__device__ __forceinline__ typename Vec16<T>::type load16(const T* p) {
  return *reinterpret_cast<const typename Vec16<T>::type*>(p);
}

// Step 1 of the inverses: the diagonal block b (width w) of the unit lower
// L (lower) or of U, inverted by one warp. Lane c substitutes for column c
// of the inverse in registers, reading the factor's rows 16 bytes at a
// time (one address for the whole warp), then stores the column over its
// own triangle of the block: the strict lower part (L^-1 has a unit
// diagonal) or the upper part with the diagonal.
template <typename T>
__device__ __forceinline__ void invert_diag(T* A, int b, int w, int lane,
                                            bool lower) {
  using V = Vec16<T>;
  constexpr int P = kPitch<T>;
  constexpr int NV = 16 / (int)sizeof(T);
  T* D = A + b * kBlk * (P + 1);
  T x[kBlk];
#pragma unroll
  for (int t = 0; t < kBlk; ++t) x[t] = t == lane ? T(1) : T(0);
  if (lower) {
    // x_m = [m == c] - sum_{q<m} l_mq x_q, m ascending
#pragma unroll
    for (int m = 1; m < kBlk; ++m) {
      if (m >= w) break;  // uniform
      const T* row = D + m * P;
      T s = x[m];
#pragma unroll
      for (int q0 = 0; q0 < m; q0 += NV) {
        const typename V::type v = load16(row + q0);
#pragma unroll
        for (int e = 0; e < NV; ++e)
          if (q0 + e < m) s -= V::part(v, e) * x[q0 + e];
      }
      x[m] = s;
    }
  } else {
    // x_m = ([m == c] - sum_{q>m} u_mq x_q) / u_mm, m descending, the
    // terms summed from q = w-1 down, so that x_{m+1} enters last; times
    // the reciprocal, since most numerators are zero, which the
    // division's slow path would serialise. Lane m forms 1 / u_mm once.
    const T rinv_lane = lane < w ? T(1) / D[lane * (P + 1)] : T(0);
#pragma unroll
    for (int m = kBlk - 1; m >= 0; --m) {
      if (m >= w) continue;  // uniform
      const T* row = D + m * P;
      const T rinv = __shfl_sync(kFull, rinv_lane, m);
      T s = x[m];
#pragma unroll
      for (int q0 = kBlk - NV; q0 > m - NV; q0 -= NV) {
        if (q0 >= w) continue;  // uniform
        const typename V::type v = load16(row + q0);
#pragma unroll
        for (int e = NV - 1; e >= 0; --e)
          if (q0 + e > m && q0 + e < w) s -= V::part(v, e) * x[q0 + e];
      }
      x[m] = s * rinv;
    }
  }
  __syncwarp();
  if (lane < w) {
#pragma unroll
    for (int m = 0; m < kBlk; ++m)
      if (m < w && (lower ? m > lane : m <= lane)) D[m * P + lane] = x[m];
  }
}

// One term of a sum of step 2 of the inverses, for X: acc[t] += L_sk X_kj
// over columns c0 + t. lrow: the lane's row of L_sk; xk: row 0 of X_kj at
// column c0. Diag: k = j, X_jj unit lower, zero in rows above c0.
template <typename T, bool Diag>
__device__ __forceinline__ void x_term(const T* lrow, const T* xk, int c0,
                                       T (&acc)[kCols]) {
  using V = Vec16<T>;
  constexpr int P = kPitch<T>;
  constexpr int NV = 16 / (int)sizeof(T);
#pragma unroll
  for (int kk0 = 0; kk0 < kBlk; kk0 += NV) {
    if (Diag && kk0 + NV <= c0) continue;  // uniform
    const typename V::type lv = load16(lrow + kk0);
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      const int kk = kk0 + e;
      const T l = V::part(lv, e);
      T xv[kCols];
#pragma unroll
      for (int v = 0; v < kCols; v += NV) {
        const typename V::type q = load16(xk + kk * P + v);
#pragma unroll
        for (int f = 0; f < NV; ++f) xv[v + f] = V::part(q, f);
      }
      if (Diag) {
#pragma unroll
        for (int t = 0; t < kCols; ++t) {
          const int c = c0 + t;
          xv[t] = c < kk ? xv[t] : (c == kk ? T(1) : T(0));
        }
      }
#pragma unroll
      for (int t = 0; t < kCols; ++t) acc[t] += l * xv[t];
    }
  }
}

// Step 2 of the inverses, block row s of X = L^-1, the reads: for
// columns c0 .. c0 + kCols - 1 of block column j < s,
//   T = sum_{k=j}^{s-1} L_sk X_kj
// (block row s of L is still the factor's, rows < s of X are final). Lane
// r = row r of block s: its row of L_sk 16 bytes at a time (conflict-free
// at the pitch), the rows of X_kj kCols at once (one address for the whole
// warp). Lanes past a ragged block's last row read row 0; their sums are
// never stored.
template <typename T>
__device__ __forceinline__ void x_sum(const T* A, int cs, int s, int j,
                                      int c0, int lane, T (&acc)[kCols]) {
  constexpr int P = kPitch<T>;
  const int r = lane < cs - kBlk * s ? lane : 0;
  const T* lrow = A + (kBlk * s + r) * P;
#pragma unroll
  for (int t = 0; t < kCols; ++t) acc[t] = T(0);
  x_term<T, true>(lrow + kBlk * j, A + kBlk * j * P + kBlk * j + c0, c0,
                  acc);
  for (int k = j + 1; k < s; ++k)
    x_term<T, false>(lrow + kBlk * k, A + kBlk * k * P + kBlk * j + c0, c0,
                     acc);
}

// The writes, after the block barrier that ends every step's reads:
// X_sj = -X_ss T over columns c0 .. of L_sj's slot, through T stored there
// first (rows of T are other lanes').
template <typename T>
__device__ __forceinline__ void x_finish(T* A, int cs, int s, int j, int c0,
                                         int lane, const T (&acc)[kCols]) {
  using V = Vec16<T>;
  constexpr int P = kPitch<T>;
  constexpr int NV = 16 / (int)sizeof(T);
  const int h = min(kBlk, cs - kBlk * s);  // rows of block s
  const bool mine = lane < h;
  T* out = A + kBlk * s * P + kBlk * j + c0;
  if (mine) {
#pragma unroll
    for (int t = 0; t < kCols; ++t) out[lane * P + t] = acc[t];
  }
  __syncwarp();
  // row r of X_ss T: the unit diagonal, then X_ss's strict lower part
  // against the rows of T
  const T* dr = A + (kBlk * s + (mine ? lane : 0)) * P + kBlk * s;
  T res[kCols];
#pragma unroll
  for (int t = 0; t < kCols; ++t) res[t] = acc[t];
#pragma unroll
  for (int m0 = 0; m0 < kBlk; m0 += NV) {
    if (m0 >= h) break;  // uniform
    const typename V::type dv = load16(dr + m0);
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      const int m = m0 + e;
      if (m >= h) break;  // uniform
      const T dm = (mine && m < lane) ? V::part(dv, e) : T(0);
#pragma unroll
      for (int v = 0; v < kCols; v += NV) {
        const typename V::type q = load16(out + m * P + v);
#pragma unroll
        for (int f = 0; f < NV; ++f) res[v + f] += dm * V::part(q, f);
      }
    }
  }
  __syncwarp();
  if (mine) {
#pragma unroll
    for (int t = 0; t < kCols; ++t) out[lane * P + t] = -res[t];
  }
}

// One term for Y: acc[t] += Y_ik U_ks over rows r0 + t. ucol: the
// lane's column of U_ks at row 0; yrow: row r0 of Y_ik. Diag: k = i, Y_ii
// upper, zero left of column r0.
template <typename T, bool Diag>
__device__ __forceinline__ void y_term(const T* ucol, const T* yrow, int r0,
                                       T (&acc)[kCols]) {
  using V = Vec16<T>;
  constexpr int P = kPitch<T>;
  constexpr int NV = 16 / (int)sizeof(T);
#pragma unroll
  for (int kk0 = 0; kk0 < kBlk; kk0 += NV) {
    if (Diag && kk0 + NV <= r0) continue;  // uniform
    T u[NV];
#pragma unroll
    for (int e = 0; e < NV; ++e) u[e] = ucol[(kk0 + e) * P];
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const typename V::type yv = load16(yrow + t * P + kk0);
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        const T y = (Diag && kk0 + e < r0 + t) ? T(0) : V::part(yv, e);
        acc[t] += y * u[e];
      }
    }
  }
}

// Block column s of Y = U^-1, the reads: for rows r0 .. r0 + kCols - 1 of
// block row i < s,
//   S = sum_{k=i}^{s-1} Y_ik U_ks
// (block column s of U is still the factor's, columns < s of Y are
// final). Lane c = column c of block s: its column of U_ks an element at a
// time (consecutive lanes: conflict-free), the rows of Y_ik 16 bytes at a
// time (one address for the whole warp). Lanes past a ragged block's
// width read the pitch's spare columns; their sums are never stored.
template <typename T>
__device__ __forceinline__ void y_sum(const T* A, int s, int i, int r0,
                                      int lane, T (&acc)[kCols]) {
  constexpr int P = kPitch<T>;
  const T* ucol = A + kBlk * s + lane;
  const T* yrow = A + (kBlk * i + r0) * P;
#pragma unroll
  for (int t = 0; t < kCols; ++t) acc[t] = T(0);
  y_term<T, true>(ucol + kBlk * i * P, yrow + kBlk * i, r0, acc);
  for (int k = i + 1; k < s; ++k)
    y_term<T, false>(ucol + kBlk * k * P, yrow + kBlk * k, r0, acc);
}

// The writes: Y_is = -S Y_ss over rows r0 .. of U_is's slot, through S
// stored there first (columns of S are other lanes').
template <typename T>
__device__ __forceinline__ void y_finish(T* A, int cs, int s, int i, int r0,
                                         int lane, const T (&acc)[kCols]) {
  using V = Vec16<T>;
  constexpr int P = kPitch<T>;
  constexpr int NV = 16 / (int)sizeof(T);
  const int w = min(kBlk, cs - kBlk * s);  // columns of block s
  const bool mine = lane < w;
  T* out = A + (kBlk * i + r0) * P + kBlk * s;
  if (mine) {
#pragma unroll
    for (int t = 0; t < kCols; ++t) out[t * P + lane] = acc[t];
  }
  __syncwarp();
  // column c of S Y_ss: the rows of S against Y_ss's upper part
  const T* ycol = A + kBlk * s * P + kBlk * s + lane;
  T res[kCols];
#pragma unroll
  for (int t = 0; t < kCols; ++t) res[t] = T(0);
#pragma unroll
  for (int m0 = 0; m0 < kBlk; m0 += NV) {
    if (m0 >= w) break;  // uniform
    T y[NV];
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      const int m = m0 + e;
      y[e] = (mine && m < w && m <= lane) ? ycol[m * P] : T(0);
    }
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const typename V::type sv = load16(out + t * P + m0);
#pragma unroll
      for (int e = 0; e < NV; ++e)
        if (m0 + e < w) res[t] += V::part(sv, e) * y[e];
    }
  }
  __syncwarp();
  if (mine) {
#pragma unroll
    for (int t = 0; t < kCols; ++t) out[t * P + lane] = -res[t];
  }
}

// The whole of one tile by the kThreads threads of the block: the tile
// into A (cs rows of kPitch<T> in dynamic shared memory; through L2 only
// when L2Only), the LU blocked in panels, the factor back into `tile`,
// min |pivot| into *piv; then, when lo is not null, both inverses in
// place over A and out into lo (L^-1 with its unit diagonal) and up
// (U^-1). diag: kMaxCs elements of shared memory.
template <typename T, bool L2Only>
__device__ __forceinline__ void lu_tile_block(T* A, T* diag, T* tile,
                                              T* piv, T* lo, T* up,
                                              int cs) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  CLOCK_START();

  // the tile into shared memory: thread (warp w, lane l) moves rows
  // w + 16a, columns l + 32b, every load issued before the first store
  {
    T v[RA][RB];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        const int r = warp + kWarps * a;
        const int c = lane + 32 * b;
        const T* p = tile + r * cs + c;
        v[a][b] = (r < cs && c < cs) ? (L2Only ? __ldcg(p) : *p) : T(0);
      }
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        const int r = warp + kWarps * a;
        const int c = lane + 32 * b;
        if (r < cs && c < cs) A[r * kPitch<T> + c] = v[a][b];
      }
  }
  __syncthreads();
  CLOCK(0);

  // no-pivot LU, blocked in panels of kPanel columns
  for (int k0 = 0; k0 < cs; k0 += kPanel) {
    const int w = min(kPanel, cs - k0);
    const int k1 = k0 + w;
    const int n2 = cs - k1;  // rows of A21 = columns of A12
    if (warp == 0) factor_diag(A, k0, w, lane);
    __syncthreads();
    CLOCK(1);
    if (n2 == 0) break;
    // rows from thread 0, columns from the next whole warp on
    const int c0 = (n2 + 31) & ~31;
    if (tid < n2)
      solve_row(A, k0, w, k1 + tid);
    else if (tid >= c0 && tid < c0 + n2)
      solve_col(A, k0, w, k1 + tid - c0);
    __syncthreads();
    CLOCK(2);
    update_trailing(A, cs, k0, warp, lane);
    __syncthreads();
    CLOCK(3);
  }

  // the factored tile, the diagonal, min |pivot|
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const int r = warp + kWarps * a;
      const int c = lane + 32 * b;
      if (r < cs && c < cs) tile[r * cs + c] = A[r * kPitch<T> + c];
    }
  for (int r = tid; r < cs; r += kThreads) diag[r] = A[r * kPitch<T> + r];
  __syncthreads();
  if (warp == 0) {
    T m = T(INFINITY);
    for (int i = lane; i < cs; i += 32) m = nan_min(m, (T)fabs(diag[i]));
    for (int off = 16; off > 0; off >>= 1)
      m = nan_min(m, __shfl_xor_sync(kFull, m, off));
    if (lane == 0) *piv = m;
  }
  CLOCK(4);
  if (lo == nullptr) return;

  // both triangular inverses in place over the factor, in blocks of kBlk:
  // the diagonal blocks (warps 0 .. nb-1 of L, nb .. 2nb-1 of U), then
  // block row st of X and block column st of Y for st = 1 .. nb-1, the
  // reads of a step, a barrier, its writes, a barrier
  const int nb = (cs + kBlk - 1) / kBlk;
  if (warp < 2 * nb) {
    const int b = warp < nb ? warp : warp - nb;
    invert_diag(A, b, min(kBlk, cs - kBlk * b), lane, warp < nb);
  }
  __syncthreads();
  CLOCK(5);
  for (int st = 1; st < nb; ++st) {
    // 2 kGroups st tasks, the longest sums (nearest block 0) first
    T acc[kRounds][kCols];
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const int t = warp + kWarps * u;
      if (t < 2 * kGroups * st) {
        const int q = t >> 1, b = q / kGroups, g = (q % kGroups) * kCols;
        if (t & 1)
          y_sum(A, st, b, g, lane, acc[u]);
        else
          x_sum(A, cs, st, b, g, lane, acc[u]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const int t = warp + kWarps * u;
      if (t < 2 * kGroups * st) {
        const int q = t >> 1, b = q / kGroups, g = (q % kGroups) * kCols;
        if (t & 1)
          y_finish(A, cs, st, b, g, lane, acc[u]);
        else
          x_finish(A, cs, st, b, g, lane, acc[u]);
      }
    }
    __syncthreads();
  }

  // L^-1 with its unit diagonal, U^-1 with 1/u_ii on its diagonal
  if (cs % kNV<T> == 0) {
    // rows of whole 16-byte chunks: warp w moves rows w + 16a, lane l the
    // chunks at columns (l + 32b) NV
    using V = Vec16<T>;
    constexpr int NV = kNV<T>;
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < kMaxCs / (32 * NV); ++b) {
        const int r = warp + kWarps * a;
        const int c = (lane + 32 * b) * NV;
        if (r >= cs || c >= cs) continue;
        const typename V::type v = load16(A + r * kPitch<T> + c);
        T l[NV], u[NV];
#pragma unroll
        for (int e = 0; e < NV; ++e) {
          const T x = V::part(v, e);
          l[e] = c + e < r ? x : (c + e == r ? T(1) : T(0));
          u[e] = c + e >= r ? x : T(0);
        }
        const int64_t q = (int64_t)r * cs + c;
        *reinterpret_cast<typename V::type*>(lo + q) = V::make(l);
        *reinterpret_cast<typename V::type*>(up + q) = V::make(u);
      }
  } else {
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        const int r = warp + kWarps * a;
        const int c = lane + 32 * b;
        if (r >= cs || c >= cs) continue;
        const int64_t q = (int64_t)r * cs + c;
        const T v = A[r * kPitch<T> + c];
        lo[q] = c < r ? v : (c == r ? T(1) : T(0));
        up[q] = c >= r ? v : T(0);
      }
  }
  CLOCK(6);
  CLOCK_WRITE(up);
}

}  // namespace lut
}  // namespace
