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
// Design (the body is lut::lu_tile_block in csrc/lu_tile.cuh, shared
// with the one-launch elimination, csrc/elim_fused.cu). One block of 16
// warps per tile. The LU runs on the tile in
// dynamic shared memory, right-looking and blocked in panels of 32
// columns. Per panel k0..k1: one warp factors the diagonal block A11 by
// the rank-1 loop, a row per lane in registers, each step's pivot by a
// shuffle and its pivot row through shared memory (the lane that owns it
// stores it, final, over its own row of the tile; every lane reads it
// back 16 bytes at a time), column k + 1 and the next division ahead of
// the other columns (no block barrier); then, with no barrier between
// them, one thread per row of A21 solves it against U11 (by columns, each
// finished entry subtracted from the next column first) and one thread
// per column of A12 against the unit L11, each a forward substitution in
// registers; then all 512 threads apply A22 -= L21 U12, each on a register
// micro-tile of at most 6 x 3 elements. Three block barriers a panel, 11
// at cs = 128, where the unblocked loop took 128. Every element sees the
// rank-1 loop's sequence: a_ij -= l_ik u_kj for k ascending, each product
// subtracted into the element itself, then, below the diagonal, one true
// division by u_jj; so the result matches the unblocked loop up to FMA
// contraction. Every true division is lut::div_rn: no branch, so no lane
// of a warp waits on another's zero numerator, and the bits of a / b.
//
// The inverses then run in 32 x 32 blocks (nb = ceil(cs / 32), the last
// one ragged), in place over the factor in shared memory, as LAPACK's
// in-place trtri does. X = L^-1, Y = U^-1. Step 1, no block barrier
// inside: warp b inverts the diagonal block L_bb, warp nb + b the block
// U_bb, a column of the inverse per lane by substitution in registers,
// the factor's rows read as broadcasts; each stores its inverse over its
// own triangle of the block (the strict lower part of X_bb, the upper part
// of Y_bb with the diagonal 1/u_ii). Step 2, for s = 1 .. nb-1, block row
// s of X and block column s of Y:
//   X_sj = -X_ss T,  T = sum_{k=j}^{s-1} L_sk X_kj   (j < s)
//   Y_is = -S Y_ss,  S = sum_{k=i}^{s-1} Y_ik U_ks   (i < s)
// Row s of X reads the factor only in L's block row s (its own slots) and
// X only in rows < s (final); column s of Y likewise. So every sum of a
// step is taken into registers, a block barrier, each result goes over its
// own slot, a block barrier: 2 a step, 1 + 2 (nb - 1) in all (7 at
// cs = 128, where the old pass took 128). A task is 8 columns of an X
// block (lane = row, L's row read 16 bytes at a time) or 8 rows of a Y
// block (lane = column, U's column an element at a time), the longest
// sums first, at most 2 tasks a warp a step. The write-out then copies
// both triangles to linv (unit diagonal) and uinv.
//
// Shared memory: the tile alone, cs rows of kPitch (66 KB float32, 130 KB
// float64 at cs = 128) and the pivots. A second copy for the inverses
// would fit in float32 but not in float64 (2 x 130 KB > 227 KB), and
// reading the overwritten factor back from global memory costs a
// wavefront per lane (a row each); the sweep by block rows and columns
// needs neither. One code path serves both types.
//
// What bounds it on the card: latency, not bytes or FLOP. A tile's time
// is the same for one tile or a batch (blocks of a batch run on different
// SMs). Of the LU (~45 us of a 128 x 128 float32 tile on an H100), the
// diagonal blocks' 124 serial steps take the most, ~215 SM cycles each
// with one warp busy: a division (~65 cycles), the next pivot's shuffle
// and the pivot row's trip through shared memory lie on the chain; then
// the trailing updates (bound by shared-memory wavefronts) and the panel
// solves (a chain of 32 divisions a row, 6 busy warps). Of the
// inverses, the block products of step 2 take the most: every FMA of a
// task takes one element read by the whole warp at once (a row of X_kj or
// of Y_ik), so by count they are bound by shared-memory wavefronts, not
// FMAs, the last step (s terms at step s) the longest; then the diagonal
// blocks' substitution (8 warps busy). tools/lu_tile_sweep.py --clocks
// measures each phase. All arithmetic is
// FP32 or FP64, never TF32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lu_tile.cuh"

namespace {

using namespace lut;

// __launch_bounds__(512, 1): one block per SM, so the compiler may give
// each thread up to 128 registers: the load keeps 32 elements a thread in
// flight, the trailing update an 18-element micro-tile and the diagonal
// inverses a 32-element column (left to choose, ptxas took 64 in float32
// and spilled)
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
lu_tile_kernel(T* __restrict__ tiles, const int32_t* __restrict__ ids,
               T* __restrict__ piv, T* __restrict__ linv,
               T* __restrict__ uinv, int cs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T diag[kMaxCs];  // the pivots u_ii
  const int64_t te = (int64_t)cs * cs;
  const int64_t tile_id = ids != nullptr ? (int64_t)ids[blockIdx.x]
                                         : (int64_t)blockIdx.x;
  lu_tile_block<T, false>(reinterpret_cast<T*>(smem_raw), diag,
                          tiles + tile_id * te,
                   piv + blockIdx.x,
                   linv == nullptr ? nullptr : linv + blockIdx.x * te,
                   uinv == nullptr ? nullptr : uinv + blockIdx.x * te, cs);
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
