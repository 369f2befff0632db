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
// Design. One block of 16 warps per tile, the tile in registers: thread
// (warp w, lane l) holds the elements of rows w + 16a and columns
// l + 32b, 32 per thread (at cs = 128), so an update is a register FMA.
// Each column step publishes the pivot row and the column through a small
// shared buffer (double-buffered by step parity: one barrier per step),
// each lane of a warp divides one of the warp's multipliers and shuffles
// it to the others. The inverses are computed in place in the same
// registers, in one pass of cs steps that runs the unit-lower inverse of
// L forwards in the strict lower triangle and the unit-upper inverse of
// D^-1 U backwards in the strict upper triangle (the two never touch the
// same element); U^-1 = (D^-1 U)^-1 D^-1 is a column scaling on the way
// out. Shared memory is 5 rows of cs elements, also in float64.
//
// What bounds it on the card: the serial column loop. Each of the 2 cs
// steps (LU, then both inverses) is a barrier, a few shared-memory reads
// and at most 32 (64) FMAs per thread, so a tile takes O(cs) barrier
// rounds of latency whatever the batch; blocks of a batch run on
// different SMs in parallel. All arithmetic is FP32 or FP64, never TF32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCs = 128;
constexpr int RA = kMaxCs / kWarps;  // rows per thread
constexpr int RB = kMaxCs / 32;      // columns per thread

template <typename T>
__device__ __forceinline__ T nan_min(T x, T y) {
  if (x != x) return x;
  if (y != y) return y;
  return x < y ? x : y;
}

// Per step, the row and column every thread needs, double-buffered by
// step parity so that one barrier per step separates writes from reads.
template <typename T>
struct StepBuffers {
  T row_l[2][kMaxCs], col_l[2][kMaxCs];
  T row_u[2][kMaxCs], col_u[2][kMaxCs];
  T diag[kMaxCs];
};

// Thread (warp w, lane l) holds x[a][b] = M[w + 16a][l + 32b]: a warp owns
// rows, its lanes the columns of those rows. Step i = 16 A0 + w0 reads
// row i from x[A0][.] of warp w0 and column i from x[.][A0 / 2] of lane
// i % 32, and can change only rows a >= A0 and columns b >= A0 / 2. A0 is
// a template argument, so every register index is a constant (a runtime
// index puts the array in local memory) and each step's loops start at
// the first block it can change.
template <typename T, int A0>
__device__ __forceinline__ void lu_steps(T (&x)[RA][RB], StepBuffers<T>& sb,
                                         int warp, int lane, int cs) {
  constexpr int B0 = A0 >> 1;
  for (int w0 = 0; w0 < kWarps; ++w0) {
    const int i = kWarps * A0 + w0;
    if (i >= cs) return;  // uniform over the block
    const int buf = i & 1;
    if (warp == w0) {
#pragma unroll
      for (int b = 0; b < RB; ++b)
        if (lane + 32 * b < cs) sb.row_l[buf][lane + 32 * b] = x[A0][b];
    }
    if (lane == (i & 31)) {
#pragma unroll
      for (int a = 0; a < RA; ++a)
        if (warp + kWarps * a < cs)
          sb.col_l[buf][warp + kWarps * a] = x[a][B0];
    }
    __syncthreads();
    const T p = sb.row_l[buf][i];
    // the multipliers of the warp's rows, one division per lane
    T lm = T(0);
    if (lane < RA) {
      const int r = warp + kWarps * lane;
      if (r > i && r < cs) lm = sb.col_l[buf][r] / p;
    }
    T u[RB];
#pragma unroll
    for (int b = B0; b < RB; ++b) {
      const int c = lane + 32 * b;
      u[b] = (c > i && c < cs) ? sb.row_l[buf][c] : T(0);
    }
#pragma unroll
    for (int a = A0; a < RA; ++a) {
      const T l = __shfl_sync(0xffffffffu, lm, a);
      if (warp + kWarps * a > i) {
#pragma unroll
        for (int b = B0; b < RB; ++b) {
          if (lane + 32 * b > i)
            x[a][b] -= l * u[b];
          else if (lane + 32 * b == i)
            x[a][b] = l;
        }
      }
    }
  }
}

// Inverse steps kl = 16 A0 + w0 (strict lower part, forwards) and
// ku = 16 AU + 15 - w0 (strict upper part, backwards; steps past cs
// skipped). Invariant: row kl's strict lower part and row ku's strict
// upper part are final. The two triangles share no element.
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
__device__ __forceinline__ void lu_all(T (&x)[RA][RB], StepBuffers<T>& sb,
                                       int warp, int lane, int cs) {
  if constexpr (A0 < RA) {
    lu_steps<T, A0>(x, sb, warp, lane, cs);
    lu_all<T, A0 + 1>(x, sb, warp, lane, cs);
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
// each thread the 128 registers the tile needs (left to choose, it took
// 64 in float32 and spilled)
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
lu_tile_kernel(T* __restrict__ tiles, const int32_t* __restrict__ ids,
               T* __restrict__ piv, T* __restrict__ linv,
               T* __restrict__ uinv, int cs) {
  __shared__ StepBuffers<T> sb;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t te = (int64_t)cs * cs;
  const int64_t tile_id = ids != nullptr ? (int64_t)ids[blockIdx.x]
                                         : (int64_t)blockIdx.x;
  T* tile = tiles + tile_id * te;

  T x[RA][RB];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const int r = warp + kWarps * a;
      const int c = lane + 32 * b;
      x[a][b] = (r < cs && c < cs) ? tile[(int64_t)r * cs + c] : T(0);
    }

  // no-pivot LU, one column per step
  lu_all<T, 0>(x, sb, warp, lane, cs);

  // the factored tile, the diagonal, min |pivot|
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const int r = warp + kWarps * a;
      const int c = lane + 32 * b;
      if (r < cs && c < cs) {
        tile[(int64_t)r * cs + c] = x[a][b];
        if (r == c) sb.diag[r] = x[a][b];
      }
    }
  __syncthreads();
  if (warp == 0) {
    T m = T(INFINITY);
    for (int i = lane; i < cs; i += 32) m = nan_min(m, (T)fabs(sb.diag[i]));
    for (int off = 16; off > 0; off >>= 1)
      m = nan_min(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) piv[blockIdx.x] = m;
  }
  if (linv == nullptr) return;

  // both triangular inverses, in place: first D^-1 U (scale the strict
  // upper part of each row by its pivot), then one pass of cs steps
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int r = warp + kWarps * a;
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
}

template <typename T>
int launch_lu_tile(T* tiles, const int32_t* ids, int n, T* piv, T* linv,
                   T* uinv, int cs, cudaStream_t stream) {
  if (cs < 1 || cs > kMaxCs || n < 0) return (int)cudaErrorInvalidValue;
  if ((linv == nullptr) != (uinv == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  lu_tile_kernel<T><<<n, kThreads, 0, stream>>>(tiles, ids, piv, linv, uinv,
                                                cs);
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
