// Hopper tile-store assembly of the device refactorization: the permuted,
// row-equilibrated closure store (Rs A)[p, q] from A's CSC value stream.
//
// Replaces the TPU kernel tpu_sparse_lu/ops/pallas_span.py `_kernel`
// (entry `span_gather`) together with the stages XLA ran around it on the
// TPU (tpu_sparse_lu/assemble.py): leftovers, nd ones, row maxima, the
// reciprocal scaling, the transpose, the row permutation and the identity
// pads. The plan is the one of tpu_sparse_lu_torch/assemble.py; two
// launches on a zeroed (K, cs) array of row maxima:
//
//   assemble_tiles    one block per part of kPart columns of a tile of the
//                     unpermuted store, held in shared memory in its
//                     transposed (col, row) layout: gather its span rows
//                     from the value stream (each a contiguous run:
//                     out[c][k] = a[g + k - cs] for lo <= k < hi), apply
//                     the tile's leftovers, then its nd ones, that fall in
//                     the part, fold each row's max |.| over the part into
//                     the row's max over its block row (an integer
//                     atomicMax on the bits: |.| >= 0 orders as its bits,
//                     and a NaN stays a NaN) and write the part back in
//                     (row, col) order;
//   assemble_closure  one block per part of kPart rows of a closure tile:
//                     row u is the unpermuted store row permrow_src[t cs +
//                     u] times its rs = 1 / max (correctly rounded, as
//                     torch.reciprocal; 1 where the max is not > 0), then
//                     the pads that fall in the part; further blocks write
//                     Rs (n) from the same maxima.
//
// A tile is cut into parts so that the launches have thousands of blocks
// (417 tiles at the headline, 86 for config 2) and each thread issues all
// its loads before its stores: a block then costs about two memory
// latencies, not one per value.
//
// Every value goes through the same operations as the PyTorch route it
// replaces (a copy, |.|, a max, one reciprocal, one multiply), so the
// store and Rs equal it bit for bit; a max is exact in any order, so the
// atomics change no bit either.
//
// What bounds it on the card: bytes. The value stream is read once and
// the closure store written once (27.4 MB in float32 at the headline, 2D
// Poisson 100x100 nd, cs = 128: ~8 us of HBM on an H100); the unpermuted
// store is written and read once in between (17.6 MB, mostly from L2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCs = 128;
constexpr int kPart = 32;                          // columns or rows a block
constexpr int kPer = kPart * kMaxCs / kThreads;    // values a thread moves

// max with NaN kept, as torch.amax
template <typename T>
__device__ __forceinline__ T nan_max(T m, T v) {
  return (v > m || v != v) ? v : m;
}

// 16 bytes of one row into global memory from a column of the transposed
// tile in shared memory (stride ld)
__device__ __forceinline__ void store16(float* dst, const float* col,
                                        int ld) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(col[0], col[ld], col[2 * ld], col[3 * ld]);
}
__device__ __forceinline__ void store16(double* dst, const double* col,
                                        int ld) {
  *reinterpret_cast<double2*>(dst) = make_double2(col[0], col[ld]);
}

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

__device__ __forceinline__ unsigned int bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ unsigned long long bits(double v) {
  return (unsigned long long)__double_as_longlong(v);
}
__device__ __forceinline__ float value(unsigned int b, float) {
  return __uint_as_float(b);
}
__device__ __forceinline__ double value(unsigned long long b, double) {
  return __longlong_as_double((long long)b);
}

// rs of a row from its max over the block row: 1 / max, or 1
template <typename T>
__device__ __forceinline__ T row_scale(const typename Bits<T>::type* rowmax,
                                       int64_t q) {
  const T m = value(rowmax[q], T(0));
  return m > T(0) ? T(1) / m : T(1);
}

// block (t, part): columns [c0, c0 + w) of tile t; rowmax (K, cs) holds
// the bits of each row's max over its block row
template <typename T>
__global__ void __launch_bounds__(kThreads)
tiles_kernel(T* __restrict__ rows2, typename Bits<T>::type* rowmax,
             const int32_t* __restrict__ tile_brow2,
             const T* __restrict__ a, const int32_t* __restrict__ g,
             const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
             const int32_t* __restrict__ left_ptr,
             const int32_t* __restrict__ left_src,
             const int32_t* __restrict__ left_pos,
             const int32_t* __restrict__ ones_ptr,
             const int32_t* __restrict__ ones_pos, int64_t nnz, int cs) {
  __shared__ T sm[kPart * (kMaxCs + 1)];  // (col, row), row stride cs + 1
  __shared__ int sg[kPart], slo[kPart], shi[kPart];
  const int ld = cs + 1;
  const int t = blockIdx.x;
  const int c0 = blockIdx.y * kPart;
  const int w = cs - c0 < kPart ? cs - c0 : kPart;
  const int64_t row0 = (int64_t)t * cs;
  if (threadIdx.x < w) {
    sg[threadIdx.x] = g[row0 + c0 + threadIdx.x];
    slo[threadIdx.x] = lo[row0 + c0 + threadIdx.x];
    shi[threadIdx.x] = hi[row0 + c0 + threadIdx.x];
  }
  __syncthreads();
  // 1. the span rows: consecutive threads on consecutive k of one row
  T v[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int q = threadIdx.x + u * kThreads;
    const int c = q / cs;
    const int k = q - c * cs;
    v[u] = T(0);
    if (c < w && k >= slo[c] && k < shi[c]) {
      const int64_t s = (int64_t)sg[c] + k - cs;
      if (s >= 0 && s < nnz) v[u] = a[s];
    }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int q = threadIdx.x + u * kThreads;
    const int c = q / cs;
    if (c < w) sm[c * ld + q - c * cs] = v[u];
  }
  __syncthreads();
  // 2. the tile's leftovers, then its nd ones, in this part
  // (pos = c * cs + k)
  for (int e = left_ptr[t] + threadIdx.x; e < left_ptr[t + 1];
       e += kThreads) {
    const int c = left_pos[e] / cs - c0;
    if (c >= 0 && c < w) sm[c * ld + left_pos[e] % cs] = a[left_src[e]];
  }
  __syncthreads();
  for (int e = ones_ptr[t] + threadIdx.x; e < ones_ptr[t + 1];
       e += kThreads) {
    const int c = ones_pos[e] / cs - c0;
    if (c >= 0 && c < w) sm[c * ld + ones_pos[e] % cs] = T(1);
  }
  __syncthreads();
  // 3. each row's max |.| over the part's columns, into its block row's
  const int64_t brow = (int64_t)tile_brow2[t] * cs;
  for (int k = threadIdx.x; k < cs; k += kThreads) {
    T m = fabs(sm[k]);
    for (int c = 1; c < w; ++c) m = nan_max(m, fabs(sm[c * ld + k]));
    atomicMax(rowmax + brow + k, bits(m));
  }
  // 4. the part in (row, col) order: consecutive threads on consecutive
  // columns of one row, 16 bytes a store where the rows allow it
  T* out = rows2 + row0 * cs + c0;
  constexpr int kVec = 16 / sizeof(T);
  if (cs % kVec == 0) {
    const int wv = w / kVec;
    for (int q = threadIdx.x; q < cs * wv; q += kThreads) {
      const int k = q / wv;
      const int c = (q - k * wv) * kVec;
      store16(out + (int64_t)k * cs + c, sm + c * ld + k, ld);
    }
  } else {
    for (int q = threadIdx.x; q < cs * w; q += kThreads) {
      const int k = q / w;
      const int c = q - k * w;
      out[(int64_t)k * cs + c] = sm[c * ld + k];
    }
  }
}

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

__device__ __forceinline__ float4 scaled(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}
__device__ __forceinline__ double2 scaled(double2 v, double s) {
  return make_double2(v.x * s, v.y * s);
}

// block (t, part): rows [u0, u0 + h) of closure tile t
template <typename T>
__global__ void __launch_bounds__(kThreads)
closure_kernel(T* __restrict__ out, T* __restrict__ rs,
               const T* __restrict__ rows2,
               const typename Bits<T>::type* __restrict__ rowmax,
               const int32_t* __restrict__ permrow_src,
               const int32_t* __restrict__ tile_brow2,
               const int32_t* __restrict__ pad_ptr,
               const int32_t* __restrict__ pad_pos, int cs, int tiles,
               int n) {
  __shared__ int64_t src[kPart];
  __shared__ T scale[kPart];
  const int t = blockIdx.x;
  if (t >= tiles) {  // Rs, kThreads rows a block
    const int64_t q = (int64_t)(t - tiles) * kThreads + threadIdx.x;
    if (blockIdx.y == 0 && q < n) rs[q] = row_scale<T>(rowmax, q);
    return;
  }
  const int u0 = blockIdx.y * kPart;
  const int h = cs - u0 < kPart ? cs - u0 : kPart;
  if (threadIdx.x < h) {
    const int64_t r = permrow_src[(int64_t)t * cs + u0 + threadIdx.x];
    const int64_t tt = r / cs;
    src[threadIdx.x] = r * cs;
    scale[threadIdx.x] =
        row_scale<T>(rowmax, (int64_t)tile_brow2[tt] * cs + (r - tt * cs));
  }
  __syncthreads();
  T* o = out + ((int64_t)t * cs + u0) * cs;
  constexpr int kVec = 16 / sizeof(T);
  using V = typename Vec16<T>::type;
  if (cs % kVec == 0) {  // rows of whole 16-byte vectors
    const int rv = cs / kVec;
    V v[kPer / kVec];
#pragma unroll
    for (int u = 0; u < kPer / kVec; ++u) {
      const int q = threadIdx.x + u * kThreads;
      const int uu = q / rv;
      if (uu < h)
        v[u] = *reinterpret_cast<const V*>(rows2 + src[uu] +
                                           (q - uu * rv) * kVec);
    }
#pragma unroll
    for (int u = 0; u < kPer / kVec; ++u) {
      const int q = threadIdx.x + u * kThreads;
      const int uu = q / rv;
      if (uu < h)
        *reinterpret_cast<V*>(o + q * kVec) = scaled(v[u], scale[uu]);
    }
  } else {
    T v[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int q = threadIdx.x + u * kThreads;
      const int uu = q / cs;
      v[u] = uu < h ? rows2[src[uu] + q - uu * cs] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int q = threadIdx.x + u * kThreads;
      const int uu = q / cs;
      if (uu < h) o[q] = v[u] * scale[uu];
    }
  }
  __syncthreads();  // the pads land on the scaled values
  for (int e = pad_ptr[t] + threadIdx.x; e < pad_ptr[t + 1]; e += kThreads) {
    const int p = pad_pos[e] - u0 * cs;
    if (p >= 0 && p < h * cs) o[p] = T(1);
  }
}

int parts(int cs) { return (cs + kPart - 1) / kPart; }

template <typename T>
int launch_tiles(T* rows2, void* rowmax, const int32_t* tile_brow2,
                 const T* a, const int32_t* g,
                 const int32_t* lo, const int32_t* hi,
                 const int32_t* left_ptr, const int32_t* left_src,
                 const int32_t* left_pos, const int32_t* ones_ptr,
                 const int32_t* ones_pos, int64_t nnz, int tiles, int cs,
                 cudaStream_t stream) {
  if (cs < 1 || cs > kMaxCs || tiles < 1 || nnz < 0)
    return (int)cudaErrorInvalidValue;
  tiles_kernel<T><<<dim3(tiles, parts(cs)), kThreads, 0, stream>>>(
      rows2, static_cast<typename Bits<T>::type*>(rowmax), tile_brow2, a, g,
      lo, hi, left_ptr, left_src, left_pos, ones_ptr,
      ones_pos, nnz, cs);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_closure(T* out, T* rs, const T* rows2, const void* rowmax,
                   const int32_t* permrow_src, const int32_t* tile_brow2,
                   const int32_t* pad_ptr, const int32_t* pad_pos, int tiles,
                   int cs, int n, cudaStream_t stream) {
  if (cs < 1 || cs > kMaxCs || tiles < 1 || n < 0)
    return (int)cudaErrorInvalidValue;
  const int rs_blocks = (n + kThreads - 1) / kThreads;
  closure_kernel<T><<<dim3(tiles + rs_blocks, parts(cs)), kThreads, 0,
                      stream>>>(
      out, rs, rows2, static_cast<const typename Bits<T>::type*>(rowmax),
      permrow_src, tile_brow2, pad_ptr, pad_pos, cs, tiles, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define ASSEMBLE_ENTRIES(suffix, T)                                          \
  int assemble_tiles_##suffix(                                               \
      T* rows2, void* rowmax, const int32_t* tile_brow2, const T* a,         \
      const int32_t* g, const int32_t* lo, const int32_t* hi,                \
      const int32_t* left_ptr, const int32_t* left_src,                      \
      const int32_t* left_pos, const int32_t* ones_ptr,                      \
      const int32_t* ones_pos, int64_t nnz, int tiles, int cs,               \
      void* stream) {                                                        \
    return launch_tiles<T>(rows2, rowmax, tile_brow2, a, g, lo, hi,          \
                           left_ptr, left_src, left_pos, ones_ptr, ones_pos, \
                           nnz, tiles, cs, (cudaStream_t)stream);            \
  }                                                                          \
  int assemble_closure_##suffix(T* out, T* rs, const T* rows2,               \
                                const void* rowmax,                          \
                                const int32_t* permrow_src,                  \
                                const int32_t* tile_brow2,                   \
                                const int32_t* pad_ptr,                      \
                                const int32_t* pad_pos, int tiles, int cs,   \
                                int n, void* stream) {                       \
    return launch_closure<T>(out, rs, rows2, rowmax, permrow_src,            \
                             tile_brow2, pad_ptr, pad_pos, tiles, cs, n,     \
                             (cudaStream_t)stream);                          \
  }

ASSEMBLE_ENTRIES(f32, float)
ASSEMBLE_ENTRIES(f64, double)

}  // extern "C"
