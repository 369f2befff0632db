// Hopper tile products of the blocked elimination: the panel and Schur
// updates of the device refactorization.
//
// Replaces the panel and Schur part of the TPU kernel
// tpu_sparse_lu/ops/pallas_elim.py `_kernel` (entry `fused_elimination`),
// which keeps the whole merged tile store in VMEM across a sequential
// grid of levels and runs every product on the matrix unit. The store
// (27 MB in float32 at the 2D Poisson 100x100 nd headline) does not fit
// in a block's shared memory, so on the H100 each level is a few launches
// (ops/elimination.py): lu_tile on the level's diagonal tiles (with both
// inverses), then this kernel three times:
//
//   row panels   A_ik <- A_ik . Uinv_kk        (in place on a, overwrite)
//   col panels   A_kj <- Linv_kk . A_kj        (in place on b, overwrite)
//   Schur        A_ij <- A_ij - sum_e L_ik(e) . U_kj(e)   (subtract)
//
// One launch covers groups in CSR form: group d writes tile dst[d] with
// the sum over its entries e of a[a_idx[e]] . b[b_idx[e]]. The host
// schedule gives every destination tile exactly one group, so no two
// blocks write one element, there are no atomics, and each element sums
// its entries, and each product its k, in a fixed order.
//
// What bounds it. One headline elimination is 667 products of 128^3
// (330 panel, 337 Schur): 2.80 GFLOP, 42 us at the card's 67 TFLOP/s of
// FP32 FMAs. The store and the inverses, read and written once, are
// ~66 MB, 20 us at 3.35 TB/s: the work is compute-bound. The tensor cores
// take FP32 only as TF32, which the factorization must not use, so the
// products are FP32 (or FP64) FMAs on the SIMT cores.
//
// Design: a register-tiled SIMT product. A block of 256 threads (a 16 x 16
// grid) computes a BM x BN sub-tile of one destination, at most 64 x 128
// or 128 x 64; each thread holds a (BM/16) x (BN/16) block of it in
// registers (4 x 8 at 64 x 128). (128 x 128, 8 x 8 a thread, took 255
// registers and ran one block per SM: slower at every launch measured.)
// Operands stream through shared memory in k-slices of 64 bytes a row (16
// floats, 8 doubles), a ring of three slices filled with 16-byte cp.async
// copies, so the FMAs of slice s run while slices s+1 and s+2 arrive. The
// ring runs across a group's entries: the next entry's first slice loads
// during this entry's last. Both operands are read from shared memory as
// 16-byte vectors: the b slice along its rows, the a slice along k (its
// 16-byte chunks XOR-swizzled per row, so the two rows a warp reads at
// once fall in different banks); at 4 x 8 a thread does 32 FMAs for 12
// words loaded. Shared memory is at most 36 KB, so no opt-in is needed.
//
// As measured on the H100 (PERF.md): the headline's 667 products take
// ~0.34 ms of device time, ~8 TFLOP/s, 1.6x torch.bmm. Counting shared
// memory wavefronts (16-byte loads are served a quarter-warp at a time,
// so a broadcast saves none): a (BM/16) x (BN/16) micro-tile costs a warp
// BM/16 + BN/16 wavefronts a k for (BM/16)(BN/16) FMAs a thread, so the
// thin ones the narrow launches pick (1 x 8, 2 x 2) are bound by shared
// memory: 7-10 us for a one-product launch, where cuBLAS's 32 x 32
// kernel takes 4.2 us.
//
// The sub-tile shape comes from the wrapper, which picks it from the
// launch's group count so that even a one-product launch spreads over at
// least 8 blocks (ops/elimination.py pick_tile). The in-place rule fixes
// which splits are legal: a row panel overwrites its own a operand, so a
// block there owns whole rows (BN >= cs) and reads only rows it writes;
// a column panel owns whole columns (BM >= cs); a launch whose
// destinations are no operand of it (Schur) may split both ways.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kMaxCs = 128;
constexpr int kStages = 3;     // k-slices in flight

// side codes of the C interface: which operand a destination may be
enum { kOwnRows = 0, kOwnCols = 1, kNoAlias = 2 };

// the a slice keeps row m's four 16-byte chunks in the order c ^ swz(m):
// rows m and m + 1, 2 or 4 (the two a warp reads at once) use different
// banks
__device__ __forceinline__ int swz(int m) { return (m >> 1) & 3; }

// N contiguous elements from shared memory, 16 (or 8) bytes at a time
template <int N>
__device__ __forceinline__ void load_n(float* d, const float* s) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(s)[q];
      d[4 * q] = v.x;
      d[4 * q + 1] = v.y;
      d[4 * q + 2] = v.z;
      d[4 * q + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(s);
    d[0] = v.x;
    d[1] = v.y;
  } else {
    d[0] = s[0];
  }
}

template <int N>
__device__ __forceinline__ void load_n(double* d, const double* s) {
  if constexpr (N >= 2) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const double2 v = reinterpret_cast<const double2*>(s)[q];
      d[2 * q] = v.x;
      d[2 * q + 1] = v.y;
    }
  } else {
    d[0] = s[0];
  }
}

// Issue the copies of k-slice `kk` of one entry: rows [m0, m0 + BM) of
// the a tile and columns [n0, n0 + BN) of the b tile. Out-of-tile
// elements are stored as zeros, so they add nothing.
template <typename T, int BM, int BN>
__device__ __forceinline__ void stage_slice(T* sA, T* sB, const T* at,
                                            const T* bt, int cs, int m0,
                                            int n0, int kk, bool vec) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int BK = 4 * V;          // k per slice: four chunks
  if (vec) {  // cs % V == 0 and 16-byte aligned tiles: whole chunks
    for (int q = threadIdx.x; q < BM * 4; q += kThreads) {
      const int r = q >> 2, c = q & 3;
      T* d = sA + r * BK + ((c ^ swz(r)) * V);
      const int gr = m0 + r, gk = kk + c * V;
      if (gr < cs && gk < cs)
        __pipeline_memcpy_async(d, at + (int64_t)gr * cs + gk, 16);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
    constexpr int CPR = BN / V;  // chunks per b row
    for (int q = threadIdx.x; q < BK * CPR; q += kThreads) {
      const int r = q / CPR, c = q - r * CPR;
      T* d = sB + r * BN + c * V;
      const int gk = kk + r, gc = n0 + c * V;
      if (gk < cs && gc < cs)
        __pipeline_memcpy_async(d, bt + (int64_t)gk * cs + gc, 16);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  } else {  // any cs: one element per copy
    for (int q = threadIdx.x; q < BM * BK; q += kThreads) {
      const int r = q / BK, k = q - r * BK;
      T* d = sA + r * BK + (((k / V) ^ swz(r)) * V) + k % V;
      const int gr = m0 + r, gk = kk + k;
      if (gr < cs && gk < cs)
        __pipeline_memcpy_async(d, at + (int64_t)gr * cs + gk, sizeof(T));
      else
        *d = T(0);
    }
    for (int q = threadIdx.x; q < BK * BN; q += kThreads) {
      const int r = q / BN, c = q - r * BN;
      const int gk = kk + r, gc = n0 + c;
      if (gk < cs && gc < cs)
        __pipeline_memcpy_async(sB + q, bt + (int64_t)gk * cs + gc,
                                sizeof(T));
      else
        sB[q] = T(0);
    }
  }
}

// acc += the product of one k-slice. Thread (ty, tx) owns rows
// (i / VM) * 16 VM + ty VM + i % VM and columns (j / VN) * 16 VN + tx VN
// + j % VN of the sub-tile, so each of its loads is VM or VN contiguous
// elements and a warp's loads are contiguous.
template <typename T, int BM, int BN>
__device__ __forceinline__ void mma_slice(const T* sA, const T* sB,
                                          T (&acc)[BM / 16][BN / 16], int ty,
                                          int tx) {
  constexpr int V = 16 / sizeof(T), BK = 4 * V;
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int VM = TM < 4 ? TM : 4, VN = TN < 4 ? TN : 4;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    T af[TM][V];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = (i / VM) * 16 * VM + ty * VM + i % VM;
      load_n<V>(af[i], sA + m * BK + ((kc ^ swz(m)) * V));
    }
#pragma unroll
    for (int kv = 0; kv < V; ++kv) {
      const T* brow = sB + (kc * V + kv) * BN + tx * VN;
      T bf[TN];
#pragma unroll
      for (int c = 0; c < TN / VN; ++c)
        load_n<VN>(bf + c * VN, brow + c * 16 * VN);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fma(af[i][kv], bf[j], acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
tile_mm_kernel(T* __restrict__ out, const T* a, const T* b,
               const int32_t* __restrict__ dst,
               const int32_t* __restrict__ ptr,
               const int32_t* __restrict__ a_idx,
               const int32_t* __restrict__ b_idx, int cs, int subtract,
               int vec) {
  constexpr int V = 16 / sizeof(T), BK = 4 * V;
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int VM = TM < 4 ? TM : 4, VN = TN < 4 ? TN : 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sA = reinterpret_cast<T*>(smem_raw);  // [kStages][BM][BK]
  T* sB = sA + kStages * BM * BK;          // [kStages][BK][BN]

  const int tiles_n = (cs + BN - 1) / BN;
  const int per = ((cs + BM - 1) / BM) * tiles_n;
  const int d = blockIdx.x / per;
  const int r = blockIdx.x - d * per;
  const int m0 = (r / tiles_n) * BM;
  const int n0 = (r - (r / tiles_n) * tiles_n) * BN;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t te = (int64_t)cs * cs;
  const int e0 = ptr[d];
  const int nk = (cs + BK - 1) / BK;
  const int total = (ptr[d + 1] - e0) * nk;  // slices over all entries

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

  // slice s of the group: entry e0 + s / nk, k from (s % nk) * BK
  auto issue = [&](int s) {
    if (s < total) {
      const int e = e0 + s / nk;
      const int st = s % kStages;
      stage_slice<T, BM, BN>(sA + st * BM * BK, sB + st * BK * BN,
                             a + (int64_t)a_idx[e] * te,
                             b + (int64_t)b_idx[e] * te, cs, m0, n0,
                             (s % nk) * BK, vec != 0);
    }
    __pipeline_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < total; ++s) {
    __pipeline_wait_prior(kStages - 2);  // slice s has landed
    // every thread's copies of slice s are visible, and every thread is
    // done with slice s - 1, whose buffer the next issue refills
    __syncthreads();
    issue(s + kStages - 1);
    const int st = s % kStages;
    mma_slice<T, BM, BN>(sA + st * BM * BK, sB + st * BK * BN, acc, ty, tx);
  }

  T* ot = out + (int64_t)dst[d] * te;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = m0 + (i / VM) * 16 * VM + ty * VM + i % VM;
    if (gr >= cs) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = n0 + (j / VN) * 16 * VN + tx * VN + j % VN;
      if (gc >= cs) continue;
      T* p = ot + (int64_t)gr * cs + gc;
      *p = subtract ? *p - acc[i][j] : acc[i][j];
    }
  }
}

template <typename T, int BM, int BN>
int launch_shape(T* out, const T* a, const T* b, const int32_t* dst,
                 const int32_t* ptr, const int32_t* a_idx,
                 const int32_t* b_idx, int n_groups, int cs, int subtract,
                 int vec, cudaStream_t stream) {
  const int per = ((cs + BM - 1) / BM) * ((cs + BN - 1) / BN);
  const size_t smem = (size_t)kStages * (BM + BN) * 64;  // <= 36 KB
  tile_mm_kernel<T, BM, BN><<<n_groups * per, kThreads, smem, stream>>>(
      out, a, b, dst, ptr, a_idx, b_idx, cs, subtract, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tile_mm(T* out, const T* a, const T* b, const int32_t* dst,
                   const int32_t* ptr, const int32_t* a_idx,
                   const int32_t* b_idx, int n_groups, int cs, int side,
                   int subtract, int bm, int bn, cudaStream_t stream) {
  if (cs < 1 || cs > kMaxCs || n_groups < 0 || side < kOwnRows ||
      side > kNoAlias)
    return (int)cudaErrorInvalidValue;
  // a block reads only what it writes: whole rows when a destination is
  // its own a operand, whole columns when it is its own b
  if ((side == kOwnRows && bn < cs) || (side == kOwnCols && bm < cs))
    return (int)cudaErrorInvalidValue;
  if (n_groups == 0) return 0;
  constexpr int V = 16 / sizeof(T);
  const int vec = cs % V == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(b) % 16 == 0;
#define TILE_MM_SHAPE(BM_, BN_)                                            \
  if (bm == BM_ && bn == BN_)                                              \
    return launch_shape<T, BM_, BN_>(out, a, b, dst, ptr, a_idx, b_idx,    \
                                     n_groups, cs, subtract, vec, stream);
  TILE_MM_SHAPE(64, 128)
  TILE_MM_SHAPE(32, 128)
  TILE_MM_SHAPE(16, 128)
  TILE_MM_SHAPE(128, 64)
  TILE_MM_SHAPE(128, 32)
  TILE_MM_SHAPE(128, 16)
  TILE_MM_SHAPE(64, 64)
  TILE_MM_SHAPE(32, 64)
  TILE_MM_SHAPE(32, 32)
#undef TILE_MM_SHAPE
  return (int)cudaErrorInvalidValue;  // a shape this file does not build
}

}  // namespace

extern "C" {

// side: 0 a destination may be its own a operand, 1 its own b operand,
// 2 no destination is an operand of the launch; (bm, bn) the sub-tile
// one block computes (ops/elimination.py TILE_SHAPES)
int tile_mm_f32(float* out, const float* a, const float* b,
                const int32_t* dst, const int32_t* ptr, const int32_t* a_idx,
                const int32_t* b_idx, int n_groups, int cs, int side,
                int subtract, int bm, int bn, void* stream) {
  return launch_tile_mm<float>(out, a, b, dst, ptr, a_idx, b_idx, n_groups,
                               cs, side, subtract, bm, bn,
                               (cudaStream_t)stream);
}

int tile_mm_f64(double* out, const double* a, const double* b,
                const int32_t* dst, const int32_t* ptr, const int32_t* a_idx,
                const int32_t* b_idx, int n_groups, int cs, int side,
                int subtract, int bm, int bn, void* stream) {
  return launch_tile_mm<double>(out, a, b, dst, ptr, a_idx, b_idx, n_groups,
                                cs, side, subtract, bm, bn,
                                (cudaStream_t)stream);
}

}  // extern "C"
