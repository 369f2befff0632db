// Hopper tile products of the blocked elimination: the panel and Schur
// updates of the device refactorization, as the per-level yardstick.
//
// The TPU kernel tpu_sparse_lu/ops/pallas_elim.py `_kernel` (entry
// `fused_elimination`) keeps the whole merged tile store in VMEM across a
// sequential grid of levels and runs every product on the matrix unit.
// Its port is csrc/elim_fused.cu: the whole elimination in one persistent
// launch, whose panel and Schur tasks run this file's product body
// (tmm::product, csrc/tile_mm.cuh) on sub-tiles. This kernel launches that
// body per level, three times after lu_tile on the level's diagonal tiles
// (ops/elimination.py, route="levels"), which no entry point takes: it is
// the yardstick the one launch is held to bit for bit and timed against.
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mm.cuh"

namespace {

using tmm::kMaxCs;
using tmm::kThreads;

// side codes of the C interface: which operand a destination may be
enum { kOwnRows = 0, kOwnCols = 1, kNoAlias = 2 };

// block b: sub-tile b % per of group b / per
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
tile_mm_kernel(T* __restrict__ out, const T* a, const T* b,
               const int32_t* __restrict__ dst,
               const int32_t* __restrict__ ptr,
               const int32_t* __restrict__ a_idx,
               const int32_t* __restrict__ b_idx, int cs, int subtract,
               int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tiles_n = (cs + BN - 1) / BN;
  const int per = ((cs + BM - 1) / BM) * tiles_n;
  const int d = blockIdx.x / per;
  const int r = blockIdx.x - d * per;
  tmm::product<T, BM, BN, false>(
      out + (int64_t)dst[d] * cs * cs, a, b, a_idx, b_idx, ptr[d],
      ptr[d + 1], cs, (r / tiles_n) * BM, (r - (r / tiles_n) * tiles_n) * BN,
      subtract != 0, vec != 0, smem_raw, threadIdx.x, tmm::BlockSync{});
}

template <typename T, int BM, int BN>
int launch_shape(T* out, const T* a, const T* b, const int32_t* dst,
                 const int32_t* ptr, const int32_t* a_idx,
                 const int32_t* b_idx, int n_groups, int cs, int subtract,
                 int vec, cudaStream_t stream) {
  const int per = ((cs + BM - 1) / BM) * ((cs + BN - 1) / BN);
  const size_t smem = tmm::smem_bytes(BM, BN);  // <= 36 KB
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
