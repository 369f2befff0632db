// Hopper bidiagonal ldiv: x = U^-1 L^-1 (Rs .* b) for bidiagonal factors
// (1-D chain matrices) as two affine prefix scans in one launch.
//
// Replaces the TPU kernel tpu_sparse_lu/ops/scan_solve.py `_ldiv_kernel`
// (entry `pallas_bidiag_ldiv`), which holds the whole vector in VMEM as
// (S, 128) planes and runs two Kogge-Stone scans of shifted multiply-adds:
//
//   forward   y_i = aL_i * y_{i-1} + sL_i * b_i    (i = 0 .. n-1)
//   backward  x_i = aU_i * x_{i+1} + sU_i * y_i    (i = n-1 .. 0)
//
// Either sweep may be skipped (a null aL or aU): one sweep alone is the
// chain's lsolve or rsolve. b and x are (n, R) row-major; every column is
// solved on its own.
//
// Design. One block of 1024 threads owns one column and walks it in tiles
// of 8192 elements, forward and then backward, so no grid-wide sync is
// needed between the sweeps. Per tile: the block stages the tile's
// coefficients a_i and c_i = s_i * v_i in shared memory with coalesced
// loads (in processing order, identity maps past the end); each thread
// composes its 8 consecutive maps serially in registers; a warp-shuffle
// scan and a scan over the 32 warp totals give each thread the map of
// everything before it in the tile; applied to the value carried in from
// the previous tile, that is the thread's entry value, from which it walks
// its 8 elements serially again and writes them back coalesced. Maps
// compose as (A, C) after (Ae, Ce) = (A * Ae, A * Ce + C). The serial walk
// inside a thread keeps the substitution's own rounding; only the entry
// values come from the scan.
//
// What bounds it on the card: a sweep reads 3 and writes 1 value per
// element, but one block runs on one SM, so a column is bound by that SM's
// memory latency, its barriers and its instruction issue: ~4.7 us per
// tile of 8192 elements per sweep measured on an H100 at n = 1,048,577,
// not the card's HBM. For R > 1 the columns run on R SMs side by side,
// and their loads are strided by R. A multi-block scan with
// decoupled look-back (each block publishing its tile aggregate) is the
// next step for long vectors.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
// one padding slot per 32 elements: thread t reads slots 8t .. 8t+7, and
// with the padding the 32 lanes of a warp hit 32 distinct banks
constexpr int kPadded = kTile + kTile / 32;

__device__ __forceinline__ int slot(int q) { return q + (q >> 5); }

template <typename T>
__device__ void sweep(T* x, const T* v, const T* __restrict__ a,
                      const T* __restrict__ s, int64_t n, int R, int j,
                      bool backward, T* sa, T* sc, T* wa, T* wc) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned full = 0xffffffffu;
  T carry = T(0);  // the solution just before the current tile
  for (int64_t t0 = 0; t0 < n; t0 += kTile) {
    for (int q = threadIdx.x; q < kTile; q += kThreads) {
      const int64_t p = t0 + q;
      T av = T(1), cv = T(0);
      if (p < n) {
        const int64_t i = backward ? n - 1 - p : p;
        av = a[i];
        cv = s[i] * v[i * R + j];
      }
      sa[slot(q)] = av;
      sc[slot(q)] = cv;
    }
    __syncthreads();

    // this thread's 8 maps, composed
    const int q0 = threadIdx.x * kItems;
    T A = T(1), C = T(0);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const T ak = sa[slot(q0 + k)];
      C = fma(ak, C, sc[slot(q0 + k)]);
      A = ak * A;
    }
    // inclusive scan over the lanes of the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T Ae = __shfl_up_sync(full, A, d);
      const T Ce = __shfl_up_sync(full, C, d);
      if (lane >= d) {
        C = fma(A, Ce, C);
        A = A * Ae;
      }
    }
    if (lane == 31) {
      wa[warp] = A;
      wc[warp] = C;
    }
    __syncthreads();
    if (warp == 0) {  // inclusive scan over the 32 warp totals
      T WA = wa[lane], WC = wc[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const T Ae = __shfl_up_sync(full, WA, d);
        const T Ce = __shfl_up_sync(full, WC, d);
        if (lane >= d) {
          WC = fma(WA, Ce, WC);
          WA = WA * Ae;
        }
      }
      wa[lane] = WA;
      wc[lane] = WC;
    }
    __syncthreads();

    // entry value: the warps before this one, then the lanes before
    T Ax = __shfl_up_sync(full, A, 1);
    T Cx = __shfl_up_sync(full, C, 1);
    T y = carry;
    if (warp > 0) y = fma(wa[warp - 1], y, wc[warp - 1]);
    if (lane > 0) y = fma(Ax, y, Cx);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int qq = slot(q0 + k);
      y = fma(sa[qq], y, sc[qq]);
      sc[qq] = y;
    }
    __syncthreads();
    for (int q = threadIdx.x; q < kTile; q += kThreads) {
      const int64_t p = t0 + q;
      if (p < n) {
        const int64_t i = backward ? n - 1 - p : p;
        x[i * R + j] = sc[slot(q)];
      }
    }
    // past the end the maps are identities, so the last slot holds the
    // solution at the tile's last element
    carry = sc[slot(kTile - 1)];
    __syncthreads();  // before the next tile overwrites sa and sc
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bidiag_kernel(T* x, const T* b, const T* aL, const T* sL, const T* aU,
              const T* sU, int64_t n, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sa = reinterpret_cast<T*>(smem_raw);
  T* sc = sa + kPadded;
  T* wa = sc + kPadded;
  T* wc = wa + kWarps;
  const int j = blockIdx.x;
  const T* v = b;
  if (aL != nullptr) {
    sweep<T>(x, v, aL, sL, n, R, j, false, sa, sc, wa, wc);
    v = x;  // the forward sweep's writes are visible after its last sync
  }
  if (aU != nullptr) sweep<T>(x, v, aU, sU, n, R, j, true, sa, sc, wa, wc);
}

template <typename T>
int launch_bidiag(T* x, const T* b, const T* aL, const T* sL, const T* aU,
                  const T* sU, int64_t n, int R, cudaStream_t stream) {
  if (n < 0 || R < 1 || (aL == nullptr && aU == nullptr) ||
      (aL != nullptr && sL == nullptr) || (aU != nullptr && sU == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const size_t smem = (2 * (size_t)kPadded + 2 * kWarps) * sizeof(T);
  // 68 KB (float32) / 136 KB (float64): above 48 KB only after opting in
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      bidiag_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  bidiag_kernel<T><<<R, kThreads, smem, stream>>>(x, b, aL, sL, aU, sU, n, R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bidiag_ldiv_f32(float* x, const float* b, const float* aL,
                    const float* sL, const float* aU, const float* sU,
                    int64_t n, int R, void* stream) {
  return launch_bidiag<float>(x, b, aL, sL, aU, sU, n, R,
                              (cudaStream_t)stream);
}

int bidiag_ldiv_f64(double* x, const double* b, const double* aL,
                    const double* sL, const double* aU, const double* sU,
                    int64_t n, int R, void* stream) {
  return launch_bidiag<double>(x, b, aL, sL, aU, sU, n, R,
                               (cudaStream_t)stream);
}

}  // extern "C"
