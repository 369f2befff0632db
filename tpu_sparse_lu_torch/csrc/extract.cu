// Hopper extraction of the solve banks at the end of the device
// refactorization: after the elimination, the diagonal tiles, both solve
// banks and the pivot growth, in one launch.
//
// Replaces no TPU kernel: the JAX package extracts with jnp ops
// (tpu_sparse_lu/refactor.py `_extract_solve_tiles` :447-459 and the
// growth and inverse gathers :503-525), and the port ran the same as ~20
// PyTorch ops (ops/extract.py `extract_banks_plain`). From the eliminated
// store, the per-level inverse stacks linv / uinv (NL·BL tiles each) and
// the plan's maps (diag_src, diag_lvlslot: K; l_off_src: TL; u_off_src:
// TU) it writes
//
//   ldiag[k] = tril(store[diag_src[k]], -1) + I,  udiag[k] = triu(...),
//                                                 both I at slot K;
//   lbank[k] = linv[diag_lvlslot[k]]^T for k < K, I at K,
//              -store[l_off_src[j]]^T at K+1+j, 0 in the last slot;
//   ubank    the same from uinv and u_off_src;
//   growth   = max |.| over udiag, the L and the U off-diagonal tiles.
//
// Each block owns kPart rows of one output tile: a diagonal slot (both
// ldiag and udiag from one read of the store tile) or one bank slot. A
// transposed slot goes through shared memory: the block reads columns
// [r0, r0 + kPart) of its source tile, 16 bytes a load, and writes rows
// [r0, r0 + kPart) of its output, 16 bytes a store (32 x 128 values:
// 16.5 KB in float32, 33 KB in float64). Each thread issues all its loads
// before its stores. The growth is folded from what the blocks already
// hold: a block's max of the bits of |.| (|.| >= 0 orders as its bits, and
// a NaN, above +inf, stays a NaN), then one integer atomicMax a block on
// the output, which the entry zeroes on the same stream first. A max is
// exact in any order, so the growth is torch.amax's value.
//
// Every value goes through the operations of the PyTorch route (a copy,
// x + 0 below the diagonal of ldiag as tril(.) + I adds, a negation), so
// the outputs equal it bit for bit.
//
// What bounds it on the card: bytes, each read once and written once.
// At 2D Poisson 100x100 nd, cs = 128, float32 (K = 86, 330 off-diagonal
// tiles): 588 tiles read (38.5 MB), 680 written (44.6 MB), ~25 us of HBM
// on an H100; at block_banded(120, 30) (K = 29, 56 off-diagonal) ~21 MB,
// ~6 us.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCs = 128;
constexpr int kPart = 32;                        // output rows a block
constexpr int kLd = kPart + 1;                   // shared row stride
constexpr int kPer = kPart * kMaxCs / kThreads;  // values a thread moves

template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using type = unsigned int;
};
template <>
struct Bits<double> {
  using type = unsigned long long;
};
template <typename T>
using BitsOf = typename Bits<T>::type;

// the bits of |v|: the sign cleared
__device__ __forceinline__ unsigned int abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}
__device__ __forceinline__ unsigned long long abs_bits(double v) {
  return (unsigned long long)__double_as_longlong(v) &
         0x7fffffffffffffffull;
}

template <typename T>
struct Args {
  T* lbank;
  T* ubank;
  T* ldiag;
  T* udiag;
  BitsOf<T>* growth;
  const T* store;
  const T* linv;
  const T* uinv;
  const int64_t* diag_src;
  const int64_t* l_off_src;
  const int64_t* u_off_src;
  const int64_t* diag_lvlslot;
  int K, TL, TU, cs;
  int64_t n_store, n_inv;  // tiles of the store and of each inverse stack
};

// tile `i` of a stack of n, as the PyTorch gather's bounds check: a map
// that points outside its stack is a fault, not a read of other memory
template <typename T>
__device__ __forceinline__ const T* tile_at(const T* base, int64_t i,
                                            int64_t n, int cs) {
  if ((uint64_t)i >= (uint64_t)n) __trap();
  return base + i * cs * cs;
}

// W values at p, 16 bytes a load or store when W > 1
template <typename T, int W>
__device__ __forceinline__ void load(T* x, const T* p) {
  if constexpr (W == 1) {
    x[0] = *p;
  } else if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    const double2 t = *reinterpret_cast<const double2*>(p);
    x[0] = t.x, x[1] = t.y;
  }
}
template <typename T, int W>
__device__ __forceinline__ void store(T* p, const T* x) {
  if constexpr (W == 1) {
    *p = x[0];
  } else if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<double2*>(p) = make_double2(x[0], x[1]);
  }
}

template <typename U>
__device__ __forceinline__ U umax(U a, U b) {
  return a < b ? b : a;
}

// the block's max of m into *growth (every thread of the block calls it)
template <typename U>
__device__ void fold_growth(U m, U* growth) {
  __shared__ U warp_max[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = umax(m, __shfl_xor_sync(~0u, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = umax(m, warp_max[w]);
    if (m != 0) atomicMax(growth, m);
  }
}

// rows [r0, r0 + h) of the identity (one) or of zero into out
template <typename T, int W>
__device__ void fill_part(T* out, int r0, int h, int cs, bool one) {
  for (int q = threadIdx.x; q * W < h * cs; q += kThreads) {
    const int i = q * W / cs;
    const int c = q * W - i * cs;
    T x[W];
#pragma unroll
    for (int e = 0; e < W; ++e) x[e] = one && c + e == r0 + i ? T(1) : T(0);
    store<T, W>(out + q * W, x);
  }
}

// rows [r0, r0 + h) of a diagonal tile d into ldiag and udiag; returns
// the thread's max of the bits of |udiag|
template <typename T, int W>
__device__ BitsOf<T> diag_part(T* lo, T* up, const T* d, int r0, int h,
                               int cs) {
  constexpr int N = kPer / W;
  T v[kPer];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int q = threadIdx.x + u * kThreads;
    if (q * W < h * cs) load<T, W>(v + u * W, d + q * W);
  }
  BitsOf<T> m = 0;
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int q = threadIdx.x + u * kThreads;
    if (q * W < h * cs) {
      const int i = q * W / cs;
      const int c = q * W - i * cs;
      const int r = r0 + i;
      T l[W], x[W];
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const T a = v[u * W + e];
        // tril(d, -1) + I: the strict lower part plus a zero, 1, 0
        l[e] = c + e < r ? a + T(0) : (c + e == r ? T(1) : T(0));
        x[e] = c + e >= r ? a : T(0);
        m = umax(m, abs_bits(x[e]));
      }
      store<T, W>(lo + q * W, l);
      store<T, W>(up + q * W, x);
    }
  }
  return m;
}

// rows [r0, r0 + h) of src^T (of -src^T when Neg) into out, through sm
// (source row c, output row i); returns the thread's max of the bits of |src| read
template <typename T, int W, bool Neg>
__device__ BitsOf<T> transpose_part(T* out, const T* src, int r0, int h,
                                    int cs, T* sm) {
  constexpr int N = kPer / W;
  T v[kPer];
  // columns [r0, r0 + h) of every source row, W at a time
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int q = threadIdx.x + u * kThreads;
    if (q * W < h * cs) {
      const int c = q * W / h;
      load<T, W>(v + u * W, src + (int64_t)c * cs + r0 + (q * W - c * h));
    }
  }
  BitsOf<T> m = 0;
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int q = threadIdx.x + u * kThreads;
    if (q * W < h * cs) {
      const int c = q * W / h;
      const int j = q * W - c * h;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        sm[c * kLd + j + e] = v[u * W + e];
        if (Neg) m = umax(m, abs_bits(v[u * W + e]));
      }
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q * W < h * cs; q += kThreads) {
    const int i = q * W / cs;
    const int c = q * W - i * cs;
    T x[W];
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const T a = sm[(c + e) * kLd + i];
      x[e] = Neg ? -a : a;
    }
    store<T, W>(out + q * W, x);
  }
  return m;
}

// block (unit, part): rows [r0, r0 + kPart) of one output tile. Units:
// [0, K] the diagonal slots; then lbank's K + TL + 2 slots; then ubank's
// K + TU + 2.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
extract_banks_kernel(const Args<T> a) {
  __shared__ T sm[kMaxCs * kLd];  // a transposed part
  const int cs = a.cs, K = a.K;
  const int r0 = blockIdx.y * kPart;
  const int h = cs - r0 < kPart ? cs - r0 : kPart;
  const int64_t tile = (int64_t)cs * cs;
  const int64_t rows = (int64_t)r0 * cs;
  int s = blockIdx.x;
  if (s <= K) {
    T* lo = a.ldiag + s * tile + rows;
    T* up = a.udiag + s * tile + rows;
    BitsOf<T> m;
    if (s == K) {
      fill_part<T, W>(lo, r0, h, cs, true);
      fill_part<T, W>(up, r0, h, cs, true);
      m = abs_bits(T(1));
    } else {
      const T* d = tile_at(a.store, a.diag_src[s], a.n_store, cs) + rows;
      m = diag_part<T, W>(lo, up, d, r0, h, cs);
    }
    fold_growth(m, a.growth);
    return;
  }
  s -= K + 1;
  const bool upper = s >= K + a.TL + 2;
  if (upper) s -= K + a.TL + 2;
  const int T_off = upper ? a.TU : a.TL;
  T* out = (upper ? a.ubank : a.lbank) + s * tile + rows;
  if (s < K) {
    const T* inv = tile_at(upper ? a.uinv : a.linv, a.diag_lvlslot[s],
                           a.n_inv, cs);
    transpose_part<T, W, false>(out, inv, r0, h, cs, sm);
  } else if (s == K || s == K + T_off + 1) {
    fill_part<T, W>(out, r0, h, cs, s == K);
  } else {
    const int64_t* src = upper ? a.u_off_src : a.l_off_src;
    const T* off = tile_at(a.store, src[s - K - 1], a.n_store, cs);
    fold_growth(transpose_part<T, W, true>(out, off, r0, h, cs, sm),
                a.growth);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch_extract(const Args<T>& a, cudaStream_t stream) {
  if (a.cs < 1 || a.cs > kMaxCs || a.K < 0 || a.TL < 0 || a.TU < 0 ||
      a.n_store < 0 || a.n_inv < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t units =
      (int64_t)(a.K + 1) + (a.K + a.TL + 2) + (a.K + a.TU + 2);
  if (units > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(a.growth, 0, sizeof(T), stream);
  if (e != cudaSuccess) return (int)e;
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = a.cs % kVec == 0 && aligned16(a.lbank) &&
                   aligned16(a.ubank) && aligned16(a.ldiag) &&
                   aligned16(a.udiag) && aligned16(a.store) &&
                   aligned16(a.linv) && aligned16(a.uinv);
  const dim3 grid((unsigned)units, (a.cs + kPart - 1) / kPart);
  if (vec)
    extract_banks_kernel<T, kVec><<<grid, kThreads, 0, stream>>>(a);
  else
    extract_banks_kernel<T, 1><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define EXTRACT_ENTRY(suffix, T)                                            \
  int extract_banks_##suffix(                                               \
      T* lbank, T* ubank, T* ldiag, T* udiag, void* growth, const T* store, \
      const T* linv, const T* uinv, const int64_t* diag_src,                \
      const int64_t* l_off_src, const int64_t* u_off_src,                   \
      const int64_t* diag_lvlslot, int K, int TL, int TU, int64_t n_store,  \
      int64_t n_inv, int cs, void* stream) {                                \
    Args<T> a{lbank,     ubank,     ldiag,        udiag,                    \
              static_cast<BitsOf<T>*>(growth),                              \
              store,     linv,      uinv,         diag_src,                 \
              l_off_src, u_off_src, diag_lvlslot, K,                        \
              TL,        TU,        cs,           n_store,                  \
              n_inv};                                                       \
    return launch_extract<T>(a, (cudaStream_t)stream);                      \
  }

EXTRACT_ENTRY(f32, float)
EXTRACT_ENTRY(f64, double)

}  // extern "C"
