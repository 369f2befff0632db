// Hopper dense-tile LU without pivoting, with the tile's two triangular
// inverses as an option: the diagonal step of the device refactorization.
//
// Replaces the TPU kernel tpu_sparse_lu/ops/pallas_factor.py `_kernel`
// (entry `lu_tile`), which advances a whole batch of VMEM-resident tiles
// one column per loop step with masked full-tile vector passes, and the
// diagonal part of tpu_sparse_lu/ops/pallas_elim.py `_kernel` (LU, then
// both triangular inverses by Neumann squaring on the matrix unit).
//
//   tiles[ids[b]]  <-  merged L\U of itself (strict lower = L with an
//                      implicit unit diagonal, upper incl. diagonal = U)
//   piv[b]         <-  min_i |U[i][i]| (NaN if any pivot is NaN)
//   linv[b]        <-  L^-1 (unit lower), uinv[b] <- U^-1 (upper), when
//                      the caller asks for them
//
// Design. One block of 16 warps per tile. The LU runs on the tile in
// dynamic shared memory, right-looking and blocked in panels of 32
// columns. Per panel k0..k1: one warp factors the diagonal block A11 by
// the rank-1 loop, a row per lane in registers, the pivot row broadcast
// by shuffles (no block barrier); then, with no barrier between them, one
// thread per row of A21 solves it against U11 and one thread per column
// of A12 against the unit L11, each a forward substitution in registers;
// then all 512 threads apply A22 -= L21 U12, each on a register
// micro-tile of at most 6 x 3 elements. Three block barriers a panel, 11
// at cs = 128, where the unblocked loop took 128. Every element sees the
// rank-1 loop's sequence: a_ij -= l_ik u_kj for k ascending, each product
// subtracted into the element itself, then, below the diagonal, one true
// division by u_jj; so the result matches the unblocked loop up to FMA
// contraction.
//
// The inverses then run in registers as before: thread (warp w, lane l)
// holds the elements of rows w + 16a and columns l + 32b, 32 per thread
// (at cs = 128), loaded from the factored tile in shared memory. One pass
// of cs steps, each a block barrier, runs the unit-lower inverse of L
// forwards in the strict lower triangle and the unit-upper inverse of
// D^-1 U backwards in the strict upper triangle (the two never touch the
// same element); U^-1 = (D^-1 U)^-1 D^-1 is a column scaling on the way
// out.
//
// What bounds it on the card: latency, not bytes or FLOP. A tile's time
// is the same for one tile or a batch (blocks of a batch run on different
// SMs), and at cs = 128 more than half of it is the inverse pass's 128
// barrier steps (a few shared-memory reads and at most 32 (64) FMAs per
// thread each). Of the LU, the diagonal blocks' 128 serial steps (a
// shuffle, a division and a row of shuffles and FMAs each, one warp) and
// the panel solves (a chain of 32 divisions a row, 6 busy warps) take the
// most, then the trailing updates (bound by shared-memory wavefronts);
// tools/lu_tile_sweep.py --clocks measures each phase. All arithmetic is
// FP32 or FP64, never TF32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCs = 128;
constexpr int kPanel = 32;           // columns per panel, one per lane
constexpr int RA = kMaxCs / kWarps;  // rows per thread (inverse pass)
constexpr int RB = kMaxCs / 32;      // columns per thread (inverse pass)
// the trailing block A22 is at most (kMaxCs - kPanel) square; thread
// (warp w, lane l) updates its rows k1 + w + 16a and columns k1 + l + 32b
constexpr int TA = (kMaxCs - kPanel) / kWarps;
constexpr int TB = (kMaxCs - kPanel) / 32;
constexpr unsigned kFull = 0xffffffffu;

// A diagnostic build (-DLU_TILE_CLOCKS, tools/lu_tile_sweep.py --clocks)
// sums in thread 0 the SM cycles (clock64) of each phase: 0 the load,
// 1 the diagonal blocks, 2 the panel solves, 3 the trailing updates,
// 4 the write-back and the pivot, 5 the inverse pass; block 0 writes them
// over the first elements of its uinv.
#ifdef LU_TILE_CLOCKS
#define CLOCK_START() \
  long long clk_[6] = {0, 0, 0, 0, 0, 0}, clk_last_ = clock64()
#define CLOCK(phase)                        \
  do {                                      \
    if (tid == 0) {                         \
      const long long t_ = clock64();       \
      clk_[phase] += t_ - clk_last_;        \
      clk_last_ = t_;                       \
    }                                       \
  } while (0)
#define CLOCK_WRITE(out)                                          \
  do {                                                            \
    __syncthreads();                                              \
    if (tid == 0 && blockIdx.x == 0)                              \
      for (int p_ = 0; p_ < 6; ++p_) (out)[p_] = (T)clk_[p_];     \
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
};
template <>
struct Vec16<double> {
  using type = double2;
  static __device__ __forceinline__ double part(const double2& q, int v) {
    return v == 0 ? q.x : q.y;
  }
};

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

// Per step of the inverse pass, the row and column every thread needs,
// double-buffered by step parity so that one barrier per step separates
// writes from reads.
template <typename T>
struct StepBuffers {
  T row_l[2][kMaxCs], col_l[2][kMaxCs];
  T row_u[2][kMaxCs], col_u[2][kMaxCs];
  T diag[kMaxCs];
};

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

// Inverse steps kl = 16 A0 + w0 (strict lower part, forwards) and
// ku = 16 AU + 15 - w0 (strict upper part, backwards; steps past cs
// skipped). Invariant: row kl's strict lower part and row ku's strict
// upper part are final. The two triangles share no element. A0 is a
// template argument, so every register index is a constant (a runtime
// index puts the array in local memory).
template <typename T, int A0>
__device__ __forceinline__ void inv_steps(T (&x)[RA][RB],
                                          StepBuffers<T>& sb, int warp,
                                          int lane, int cs) {
  constexpr int AU = RA - 1 - A0;
  constexpr int BL = A0 >> 1;  // last column block of the L step
  constexpr int BU = AU >> 1;  // first column block of the U step
  for (int w0 = 0; w0 < kWarps; ++w0) {
    const int kl = kWarps * A0 + w0;
    const int ku = kWarps * AU + (kWarps - 1 - w0);
    const bool step_l = kl < cs;
    const bool step_u = ku < cs;
    const int buf = w0 & 1;
    if (step_l && warp == w0) {
#pragma unroll
      for (int b = 0; b < RB; ++b)
        if (lane + 32 * b < cs) sb.row_l[buf][lane + 32 * b] = x[A0][b];
    }
    if (step_l && lane == (kl & 31)) {
#pragma unroll
      for (int a = 0; a < RA; ++a)
        if (warp + kWarps * a < cs)
          sb.col_l[buf][warp + kWarps * a] = x[a][BL];
    }
    if (step_u && warp == kWarps - 1 - w0) {
#pragma unroll
      for (int b = 0; b < RB; ++b)
        if (lane + 32 * b < cs) sb.row_u[buf][lane + 32 * b] = x[AU][b];
    }
    if (step_u && lane == (ku & 31)) {
#pragma unroll
      for (int a = 0; a < RA; ++a)
        if (warp + kWarps * a < cs)
          sb.col_u[buf][warp + kWarps * a] = x[a][BU];
    }
    __syncthreads();
    if (step_l) {
      T rl[BL + 1];
#pragma unroll
      for (int b = 0; b <= BL; ++b) {
        const int c = lane + 32 * b;
        rl[b] = c < kl ? sb.row_l[buf][c] : T(0);
      }
#pragma unroll
      for (int a = A0; a < RA; ++a) {
        const int r = warp + kWarps * a;
        if (r <= kl || r >= cs) continue;
        const T l = sb.col_l[buf][r];
#pragma unroll
        for (int b = 0; b <= BL; ++b) {
          const int c = lane + 32 * b;
          if (c < kl)
            x[a][b] -= l * rl[b];
          else if (c == kl)
            x[a][b] = -l;
        }
      }
    }
    if (step_u) {
      T ru[RB - BU];
#pragma unroll
      for (int b = BU; b < RB; ++b) {
        const int c = lane + 32 * b;
        ru[b - BU] = (c > ku && c < cs) ? sb.row_u[buf][c] : T(0);
      }
#pragma unroll
      for (int a = 0; a <= AU; ++a) {
        const int r = warp + kWarps * a;
        if (r >= ku) continue;
        const T u = sb.col_u[buf][r];
#pragma unroll
        for (int b = BU; b < RB; ++b) {
          const int c = lane + 32 * b;
          if (c > ku && c < cs)
            x[a][b] -= u * ru[b - BU];
          else if (c == ku)
            x[a][b] = -u;
        }
      }
    }
  }
}

template <typename T, int A0>
__device__ __forceinline__ void inv_all(T (&x)[RA][RB], StepBuffers<T>& sb,
                                        int warp, int lane, int cs) {
  if constexpr (A0 < RA) {
    inv_steps<T, A0>(x, sb, warp, lane, cs);
    inv_all<T, A0 + 1>(x, sb, warp, lane, cs);
  }
}

// __launch_bounds__(512, 1): one block per SM, so the compiler may give
// each thread the 128 registers the inverse pass's tile needs (left to
// choose, it took 64 in float32 and spilled)
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
lu_tile_kernel(T* __restrict__ tiles, const int32_t* __restrict__ ids,
               T* __restrict__ piv, T* __restrict__ linv,
               T* __restrict__ uinv, int cs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);  // cs rows of kPitch<T>
  __shared__ StepBuffers<T> sb;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t te = (int64_t)cs * cs;
  const int64_t tile_id = ids != nullptr ? (int64_t)ids[blockIdx.x]
                                         : (int64_t)blockIdx.x;
  T* tile = tiles + tile_id * te;
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
        v[a][b] = (r < cs && c < cs) ? tile[r * cs + c] : T(0);
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
  for (int r = tid; r < cs; r += kThreads)
    sb.diag[r] = A[r * kPitch<T> + r];
  __syncthreads();
  if (warp == 0) {
    T m = T(INFINITY);
    for (int i = lane; i < cs; i += 32) m = nan_min(m, (T)fabs(sb.diag[i]));
    for (int off = 16; off > 0; off >>= 1)
      m = nan_min(m, __shfl_xor_sync(kFull, m, off));
    if (lane == 0) piv[blockIdx.x] = m;
  }
  CLOCK(4);
  if (linv == nullptr) return;

  // both triangular inverses, in place in registers: first D^-1 U (scale
  // the strict upper part of each row by its pivot), then one pass of cs
  // steps
  T x[RA][RB];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int r = warp + kWarps * a;
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const int c = lane + 32 * b;
      x[a][b] = (r < cs && c < cs) ? A[r * kPitch<T> + c] : T(0);
    }
    if (r < cs) {
      const T d = sb.diag[r];
#pragma unroll
      for (int b = 0; b < RB; ++b)
        if (lane + 32 * b > r) x[a][b] /= d;
    }
  }
  inv_all<T, 0>(x, sb, warp, lane, cs);

  // L^-1 (unit lower) and U^-1 = (D^-1 U)^-1 D^-1 (a column scaling)
  T* lo = linv + (int64_t)blockIdx.x * te;
  T* up = uinv + (int64_t)blockIdx.x * te;
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const int r = warp + kWarps * a;
      const int c = lane + 32 * b;
      if (r < cs && c < cs) {
        const int64_t q = (int64_t)r * cs + c;
        lo[q] = c < r ? x[a][b] : (c == r ? T(1) : T(0));
        up[q] = c > r ? x[a][b] / sb.diag[c]
                      : (c == r ? T(1) / sb.diag[r] : T(0));
      }
    }
  CLOCK(5);
  CLOCK_WRITE(up);
}

template <typename T>
int launch_lu_tile(T* tiles, const int32_t* ids, int n, T* piv, T* linv,
                   T* uinv, int cs, cudaStream_t stream) {
  if (cs < 1 || cs > kMaxCs || n < 0) return (int)cudaErrorInvalidValue;
  if ((linv == nullptr) != (uinv == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  // the tile in shared memory: 66 KB (float32) / 130 KB (float64) at
  // cs = 128, above 48 KB only after opting in, once per type
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      lu_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)tile_bytes<T>(kMaxCs));
  if (opt_in != cudaSuccess) return (int)opt_in;
  lu_tile_kernel<T><<<n, kThreads, tile_bytes<T>(cs), stream>>>(
      tiles, ids, piv, linv, uinv, cs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lu_tile_f32(float* tiles, const int32_t* ids, int n, float* piv,
                float* linv, float* uinv, int cs, void* stream) {
  return launch_lu_tile<float>(tiles, ids, n, piv, linv, uinv, cs,
                               (cudaStream_t)stream);
}

int lu_tile_f64(double* tiles, const int32_t* ids, int n, double* piv,
                double* linv, double* uinv, int cs, void* stream) {
  return launch_lu_tile<double>(tiles, ids, n, piv, linv, uinv, cs,
                                (cudaStream_t)stream);
}

}  // extern "C"
