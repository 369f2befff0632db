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
//   row panels   A_ik <- A_ik . Uinv_kk        (side 0, overwrite)
//   col panels   A_kj <- Linv_kk . A_kj        (side 1, overwrite)
//   Schur        A_ij <- A_ij - sum_e L_ik(e) . U_kj(e)   (side 0, subtract)
//
// One launch covers groups in CSR form: group d writes tile dst[d] with
// the sum over its entries e of a[a_idx[e]] . b[b_idx[e]]. The host
// schedule gives every destination tile exactly one group, so no two
// blocks write one tile, there are no atomics, and each element sums its
// entries, and each product its k, in a fixed order.
//
// Design. A block owns one strip of kStrip rows (side 0) or columns
// (side 1) of one destination tile. Side 0 stages the a strip and the
// whole b tile in shared memory; side 1 the whole a tile and the b
// strip. A panel product overwrites its own input: with side 0 the row
// strip of A_ik a block reads is the strip it writes, with side 1 the
// column strip of A_kj, so blocks never read what another block writes.
// Shared memory is one tile plus one strip: 80 KB in float32 and 160 KB
// in float64 at cs = 128. Each thread keeps a 4x4 (side 0) or 16x1
// (side 1) block of the strip in registers; FP32 or FP64 FMAs, never TF32.
//
// What bounds it on the card: per level the work is small (the widest
// headline level has 51 panel tiles and 337 Schur products) and each
// block re-reads its b (or a) tile from L2, so a level is bound by
// launch latency and per-block shared-memory bandwidth, not by the
// FP32/FP64 rate. The tensor cores take FP32 only as TF32, which the
// factorization must not use; left for later are TMA tile loads, double
// buffering of the next entry, and one persistent launch per level.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCs = 128;
constexpr int kStrip = 32;

// copy an (nrows, ncols) block, row strides src_ld / dst_ld, global ->
// shared, asynchronously; 16-byte copies where alignment allows
template <typename T>
__device__ __forceinline__ void stage(T* dst, int dst_ld, const T* src,
                                      int64_t src_ld, int nrows, int ncols) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = ncols % kVec == 0 && dst_ld % kVec == 0 &&
                   src_ld % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0;
  if (vec) {
    const int per_row = ncols / kVec;
    for (int q = threadIdx.x; q < nrows * per_row; q += kThreads) {
      const int r = q / per_row;
      const int c = (q - r * per_row) * kVec;
      __pipeline_memcpy_async(dst + r * dst_ld + c, src + r * src_ld + c,
                              16);
    }
  } else {
    for (int q = threadIdx.x; q < nrows * ncols; q += kThreads) {
      const int r = q / ncols;
      const int c = q - r * ncols;
      __pipeline_memcpy_async(dst + r * dst_ld + c, src + r * src_ld + c,
                              sizeof(T));
    }
  }
}

template <typename T, int SIDE>
__global__ void __launch_bounds__(kThreads)
tile_mm_kernel(T* __restrict__ out, const T* a, const T* b,
               const int32_t* __restrict__ dst,
               const int32_t* __restrict__ ptr,
               const int32_t* __restrict__ a_idx,
               const int32_t* __restrict__ b_idx, int cs, int subtract) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_strips = (cs + kStrip - 1) / kStrip;
  const int d = blockIdx.x / n_strips;
  const int s0 = (blockIdx.x - d * n_strips) * kStrip;
  const int sw = min(kStrip, cs - s0);  // strip width
  const int64_t te = (int64_t)cs * cs;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  T* big = reinterpret_cast<T*>(smem_raw);  // a whole tile (cs, cs)
  T* strip = big + te;                     // the strip

  // side 0: rows ty + 8 i (i < 4) of the strip, columns tx + 32 j (j < 4)
  // side 1: rows ty + 8 i (i < 16) of the tile, column tx of the strip
  constexpr int RI = SIDE == 0 ? kStrip / kWarps : kMaxCs / kWarps;
  constexpr int RJ = SIDE == 0 ? kMaxCs / 32 : 1;
  T acc[RI][RJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) acc[i][j] = T(0);
  // clamped coordinates: a thread outside the strip computes a duplicate
  // of a valid element and does not write it
  const int nr = SIDE == 0 ? sw : cs;
  const int nc = SIDE == 0 ? cs : sw;
  int rr[RI], cc[RJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) rr[i] = min(ty + kWarps * i, nr - 1);
#pragma unroll
  for (int j = 0; j < RJ; ++j) cc[j] = min(tx + 32 * j, nc - 1);

  const int e_end = ptr[d + 1];
  for (int e = ptr[d]; e < e_end; ++e) {
    const T* at = a + (int64_t)a_idx[e] * te;
    const T* bt = b + (int64_t)b_idx[e] * te;
    __syncthreads();  // the previous entry is done with shared memory
    if (SIDE == 0) {
      stage(strip, cs, at + (int64_t)s0 * cs, cs, sw, cs);  // a rows
      stage(big, cs, bt, cs, cs, cs);                        // b whole
    } else {
      stage(big, cs, at, cs, cs, cs);                        // a whole
      stage(strip, sw, bt + s0, cs, cs, sw);                 // b columns
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int k = 0; k < cs; ++k) {
      T av[RI], bv[RJ];
      if (SIDE == 0) {
#pragma unroll
        for (int i = 0; i < RI; ++i) av[i] = strip[rr[i] * cs + k];
#pragma unroll
        for (int j = 0; j < RJ; ++j) bv[j] = big[k * cs + cc[j]];
      } else {
#pragma unroll
        for (int i = 0; i < RI; ++i) av[i] = big[rr[i] * cs + k];
#pragma unroll
        for (int j = 0; j < RJ; ++j) bv[j] = strip[k * sw + cc[j]];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) acc[i][j] += av[i] * bv[j];
    }
  }

  T* ot = out + (int64_t)dst[d] * te;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + kWarps * i;
    if (r >= nr) continue;
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int c = tx + 32 * j;
      if (c >= nc) continue;
      const int64_t o = SIDE == 0 ? (int64_t)(s0 + r) * cs + c
                                  : (int64_t)r * cs + s0 + c;
      ot[o] = subtract ? ot[o] - acc[i][j] : acc[i][j];
    }
  }
}

template <typename T, int SIDE>
int launch_side(T* out, const T* a, const T* b, const int32_t* dst,
                const int32_t* ptr, const int32_t* a_idx,
                const int32_t* b_idx, int n_groups, int cs, int subtract,
                cudaStream_t stream) {
  // above 48 KB only after opting in, once, for the largest tile + strip
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      tile_mm_kernel<T, SIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)((kMaxCs * kMaxCs + kMaxCs * kStrip) * sizeof(T)));
  if (opt_in != cudaSuccess) return (int)opt_in;
  const int n_strips = (cs + kStrip - 1) / kStrip;
  const size_t smem = ((size_t)cs * cs + (size_t)cs * kStrip) * sizeof(T);
  tile_mm_kernel<T, SIDE><<<n_groups * n_strips, kThreads, smem, stream>>>(
      out, a, b, dst, ptr, a_idx, b_idx, cs, subtract);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tile_mm(T* out, const T* a, const T* b, const int32_t* dst,
                   const int32_t* ptr, const int32_t* a_idx,
                   const int32_t* b_idx, int n_groups, int cs, int side,
                   int subtract, cudaStream_t stream) {
  if (cs < 1 || cs > kMaxCs || n_groups < 0 || (side != 0 && side != 1))
    return (int)cudaErrorInvalidValue;
  if (n_groups == 0) return 0;
  if (side == 0)
    return launch_side<T, 0>(out, a, b, dst, ptr, a_idx, b_idx, n_groups, cs,
                             subtract, stream);
  return launch_side<T, 1>(out, a, b, dst, ptr, a_idx, b_idx, n_groups, cs,
                           subtract, stream);
}

}  // namespace

extern "C" {

int tile_mm_f32(float* out, const float* a, const float* b,
                const int32_t* dst, const int32_t* ptr, const int32_t* a_idx,
                const int32_t* b_idx, int n_groups, int cs, int side,
                int subtract, void* stream) {
  return launch_tile_mm<float>(out, a, b, dst, ptr, a_idx, b_idx, n_groups,
                               cs, side, subtract, (cudaStream_t)stream);
}

int tile_mm_f64(double* out, const double* a, const double* b,
                const int32_t* dst, const int32_t* ptr, const int32_t* a_idx,
                const int32_t* b_idx, int n_groups, int cs, int side,
                int subtract, void* stream) {
  return launch_tile_mm<double>(out, a, b, dst, ptr, a_idx, b_idx, n_groups,
                                cs, side, subtract, (cudaStream_t)stream);
}

}  // extern "C"
