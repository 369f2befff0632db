// Hopper ldiv kernels: the sparse LU solve x = A \ b as a few dozen
// launches of simple kernels.
//
// Replaces the TPU kernel tpu_sparse_lu/ops/pallas_ldiv.py `_kernel`
// (entry `pallas_fused_ldiv`), which runs the whole ldiv as one serial
// op stream on one TensorCore. Here the same work is split at the
// dependency boundaries the host schedule keeps (ops/fused_ldiv.py):
//
//   perm_gather   y[i, :] = scale[s] * v[s, :],  s = idx[i]
//                 (0 where s lies outside [0, n_v), -1 by convention)
//                 perm-in with the row scaling folded in, and perm-out.
//   wave_apply    for every destination block d of one wave:
//                 x[d] = acc * x[d] + sum_e tile[e] @ x[src[e]]
//                 the diagonal wave (acc = 0, src == dst, tile = Dinv_k)
//                 and the off-diagonal wave (acc = 1, tiles pre-negated)
//                 of one level of the L or U solve.
//   diag_trsm     for every chunk k of one level: x[k] = D_k \ x[k] by
//                 substitution in place, D_k the factor's diagonal tile
//                 itself (tri_mode="trsm"; the body and its design
//                 are diag_trsm.cuh). It replaces no Pallas kernel: the
//                 JAX package's step is lax.linalg.triangular_solve
//                 (tpu_sparse_lu/solve.py:136-141), a library call.
//
// Layouts. The solution carrier x is (blocks, cs, R) row-major. Tiles are
// passed TRANSPOSED, tiles_t[t][k][i] = tile[t][i][k], so the 32 lanes of
// a warp read 32 consecutive i of one k as one coalesced line. Every
// offset into x and into the tile bank is computed in 64 bits.
//
// wave_apply design. One block owns one destination block and one strip
// of RB columns of R, and writes it exactly once. For each entry it
// stages the whole tile and the x[src] strip in shared memory with
// asynchronous copies, all in flight at once (a block that waited on each
// k step's loads in turn ran a 64 KB tile at ~3 GB/s on an H100). Its 8
// warps split the k range of the tile, each lane keeps rows lane,
// lane+32, lane+64, lane+96 of the strip in registers (so cs <= 128), and
// the warps' partial sums meet in shared memory, where each output
// element adds them in warp order. So there are no atomics and the result does not
// depend on scheduling. All reads of x[src] end before the block's first
// write, which makes the in-place diagonal wave (src == dst) safe; an
// off-diagonal wave never reads a block it writes (sources lie in the
// current level, destinations in later ones). Shared memory: the tile (or
// the partials, whichever is larger) plus the strip, up to 145 KB for
// float64 at cs = 128.
//
// bfloat16 tiles (SolverConfig.stream_dtype="bfloat16"): the tile bank is
// read as bf16 and the carrier stays float32, as the TPU kernel widens its
// bf16 L/U pages after the DMA (pallas_ldiv.py:663). The tile is staged in
// shared memory at half the width and each element widens to float32 as it
// is read from there, so all arithmetic is the same float32 FMAs; only the
// bytes per tile halve.
//
// What bounds it on the card: one solve reads every L and U tile once
// (about 33 MB at the 2D Poisson 100x100, cs = 128, nd headline), so it is
// bound by bytes plus the launch latency of ~30 dependent waves. This
// simple design leaves for later: capturing the waves in a CUDA graph or
// one persistent kernel with per-chunk ready flags, TMA tile loads, and
// filling more of the 132 SMs than the 23 chunks of the widest diagonal
// wave do (splitting a destination's k range over several blocks).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "diag_trsm.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerLane = 4;
constexpr int kMaxCs = 32 * kRowsPerLane;

// bytes of the shared tile region: the tile (of the tile type TT), or the
// warps' partials (of the carrier type T), rounded up to 16 bytes
template <typename T, typename TT, int RB>
__host__ __device__ inline int tile_region(int cs) {
  const int partials = kWarps * RB * (cs + 1) * (int)sizeof(T);
  const int tile = cs * cs * (int)sizeof(TT);
  return ((tile > partials ? tile : partials) + 15) / 16 * 16;
}

// a staged tile element in the carrier's type
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T widen(T v) { return v; }

template <typename T>
__global__ void __launch_bounds__(256)
perm_gather_kernel(T* __restrict__ y, const T* __restrict__ v,
                   const int32_t* __restrict__ idx,
                   const T* __restrict__ scale, int64_t n_v, int64_t n_out,
                   int R) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_out * R) return;
  const int64_t i = q / R;
  const int64_t j = q - i * R;
  const int32_t s = idx[i];
  T val = T(0);
  if (s >= 0 && s < n_v) {
    val = v[(int64_t)s * R + j];
    if (scale != nullptr) val = val * scale[s];
  }
  y[q] = val;
}

template <typename T, typename TT, int RB>
__global__ void __launch_bounds__(kThreads)
wave_apply_kernel(T* __restrict__ x, const TT* __restrict__ tiles_t,
                  const int32_t* __restrict__ dst,
                  const int32_t* __restrict__ ptr,
                  const int32_t* __restrict__ ent_tile,
                  const int32_t* __restrict__ ent_src,
                  int cs, int R, int accumulate) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // (cs, cs) staged tile; after the last entry the same space holds the
  // warps' partial sums, (kWarps, RB, cs + 1): lanes (rows) of a warp hit
  // consecutive banks, and the padded column keeps the columns of the
  // final sum apart too
  TT* ts = reinterpret_cast<TT*>(smem_raw);
  T* ps = reinterpret_cast<T*>(smem_raw);  // the partials, in ts's place
  // (cs, RB) staged x[src] strip
  T* xs = reinterpret_cast<T*>(smem_raw + tile_region<T, TT, RB>(cs));
  const int ldp = cs + 1;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j0 = blockIdx.y * RB;
  const int64_t blk = (int64_t)cs * R;  // elements per carrier block
  const int tile_elems = cs * cs;
  constexpr int kVec = 16 / sizeof(TT);  // tile elements per 16-byte copy

  // each thread owns the strip entries q = threadIdx.x + u * kThreads;
  // an accumulating wave loads their old values before anything else, so
  // those loads overlap the tile copies instead of stalling the write-back
  constexpr int kPer = (kMaxCs * RB + kThreads - 1) / kThreads;
  T* xd = x + (int64_t)dst[blockIdx.x] * blk;
  T old[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int q = threadIdx.x + u * kThreads;
    const int i = q / RB;
    const int j = q - i * RB;
    old[u] = (accumulate && i < cs && j0 + j < R)
                 ? xd[(int64_t)i * R + j0 + j] : T(0);
  }

  T acc[kRowsPerLane][RB];
#pragma unroll
  for (int r = 0; r < kRowsPerLane; ++r)
#pragma unroll
    for (int j = 0; j < RB; ++j) acc[r][j] = T(0);

  const int e_end = ptr[blockIdx.x + 1];
  for (int e = ptr[blockIdx.x]; e < e_end; ++e) {
    const TT* tile = tiles_t + (int64_t)ent_tile[e] * tile_elems;
    const T* xsrc = x + (int64_t)ent_src[e] * blk;
    __syncthreads();  // the previous entry is done with ts and xs
    // the whole tile in flight at once: asynchronous copies into shared
    // memory, 16 bytes each where the tile allows it
    if (tile_elems % kVec == 0 &&
        reinterpret_cast<uintptr_t>(tile) % 16 == 0) {
      for (int q = threadIdx.x; q < tile_elems / kVec; q += kThreads)
        __pipeline_memcpy_async(ts + q * kVec, tile + q * kVec, 16);
    } else if constexpr (sizeof(TT) >= 4) {
      for (int q = threadIdx.x; q < tile_elems; q += kThreads)
        __pipeline_memcpy_async(ts + q, tile + q, sizeof(TT));
    } else {  // no asynchronous copy of fewer than 4 bytes
      for (int q = threadIdx.x; q < tile_elems; q += kThreads)
        ts[q] = tile[q];
    }
    for (int q = threadIdx.x; q < cs * RB; q += kThreads) {
      const int k = q / RB;
      const int j = q - k * RB;
      if (j0 + j < R)
        __pipeline_memcpy_async(xs + q, xsrc + (int64_t)k * R + j0 + j,
                                sizeof(T));
      else
        xs[q] = T(0);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int k = warp; k < cs; k += kWarps) {
      const TT* trow = ts + k * cs;
      T t[kRowsPerLane];
#pragma unroll
      for (int r = 0; r < kRowsPerLane; ++r) {
        const int i = lane + 32 * r;
        t[r] = (i < cs) ? widen(trow[i]) : T(0);
      }
      const T* xk = xs + k * RB;
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        const T xv = xk[j];
#pragma unroll
        for (int r = 0; r < kRowsPerLane; ++r) acc[r][j] += t[r] * xv;
      }
    }
  }

  // deterministic cross-warp reduction: every warp stores its partials,
  // then each output element sums them in warp order (all warps at once;
  // adding them one warp after another cost ~9 us a launch at RB = 16 on
  // an H100)
  __syncthreads();  // every warp is done reading the staged tile
#pragma unroll
  for (int r = 0; r < kRowsPerLane; ++r) {
    const int i = lane + 32 * r;
    if (i < cs) {
#pragma unroll
      for (int j = 0; j < RB; ++j) ps[(warp * RB + j) * ldp + i] = acc[r][j];
    }
  }
  __syncthreads();

#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int q = threadIdx.x + u * kThreads;
    const int i = q / RB;
    const int j = q - i * RB;
    if (i < cs && j0 + j < R) {
      T sum = ps[j * ldp + i];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += ps[(w * RB + j) * ldp + i];
      xd[(int64_t)i * R + j0 + j] = old[u] + sum;
    }
  }
}

template <typename T>
int launch_perm_gather(T* y, const T* v, const int32_t* idx, const T* scale,
                       int64_t n_v, int64_t n_out, int R,
                       cudaStream_t stream) {
  const int64_t total = n_out * R;
  if (total == 0) return 0;
  const int64_t blocks = (total + 255) / 256;
  perm_gather_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      y, v, idx, scale, n_v, n_out, R);
  return (int)cudaGetLastError();
}

template <typename T, typename TT, int RB>
int launch_wave_rb(T* x, const TT* tiles_t, const int32_t* dst,
                   const int32_t* ptr, const int32_t* ent_tile,
                   const int32_t* ent_src, int n_dst, int cs, int R,
                   int accumulate, cudaStream_t stream) {
  // above 48 KB only after opting in, once per instantiation, for the
  // largest tile (145 KB for float64 at cs = 128, RB = 16)
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      wave_apply_kernel<T, TT, RB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(tile_region<T, TT, RB>(kMaxCs) + kMaxCs * RB * sizeof(T)));
  if (opt_in != cudaSuccess) return (int)opt_in;
  const dim3 grid(n_dst, (R + RB - 1) / RB);
  const size_t smem = (size_t)tile_region<T, TT, RB>(cs) +
                      (size_t)cs * RB * sizeof(T);
  wave_apply_kernel<T, TT, RB><<<grid, kThreads, smem, stream>>>(
      x, tiles_t, dst, ptr, ent_tile, ent_src, cs, R, accumulate);
  return (int)cudaGetLastError();
}

template <typename T, typename TT>
int launch_wave(T* x, const TT* tiles_t, const int32_t* dst,
                const int32_t* ptr, const int32_t* ent_tile,
                const int32_t* ent_src, int n_dst, int cs, int R,
                int accumulate, cudaStream_t stream) {
  if (cs < 1 || cs > kMaxCs || R < 1) return (int)cudaErrorInvalidValue;
  if (n_dst == 0) return 0;
  // column strip: as wide as R up to 16, so a single RHS wastes no lanes
  if (R == 1)
    return launch_wave_rb<T, TT, 1>(x, tiles_t, dst, ptr, ent_tile, ent_src,
                                    n_dst, cs, R, accumulate, stream);
  if (R <= 4)
    return launch_wave_rb<T, TT, 4>(x, tiles_t, dst, ptr, ent_tile, ent_src,
                                    n_dst, cs, R, accumulate, stream);
  return launch_wave_rb<T, TT, 16>(x, tiles_t, dst, ptr, ent_tile, ent_src,
                                   n_dst, cs, R, accumulate, stream);
}

// One block a (chunk of the level, strip of dts::kWarps columns).
template <typename T, bool Vec, bool Lower>
__global__ void __launch_bounds__(dts::kThreads)
diag_trsm_kernel(T* __restrict__ x, const T* __restrict__ diag,
                 const int32_t* __restrict__ dst, int cs, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t k = dst[blockIdx.x];
  dts::solve_block<T, Vec, Lower>(x + k * cs * R, diag + k * cs * cs,
                                  reinterpret_cast<T*>(smem_raw), cs, R,
                                  blockIdx.y * dts::kWarps);
}

template <typename T, bool Vec, bool Lower>
int launch_diag_trsm_as(T* x, const T* diag, const int32_t* dst, int n_dst,
                        int cs, int R, cudaStream_t stream) {
  // above 48 KB only after opting in, once per instantiation, for the
  // largest tile (133 KB for float64 at cs = 128)
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      diag_trsm_kernel<T, Vec, Lower>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dts::smem_bytes<T>(dts::kMaxCs));
  if (opt_in != cudaSuccess) return (int)opt_in;
  const dim3 grid(n_dst, (R + dts::kWarps - 1) / dts::kWarps);
  diag_trsm_kernel<T, Vec, Lower>
      <<<grid, dts::kThreads, dts::smem_bytes<T>(cs), stream>>>(x, diag, dst,
                                                                 cs, R);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_diag_trsm(T* x, const T* diag, const int32_t* dst, int n_dst,
                     int cs, int R, int lower, cudaStream_t stream) {
  if (cs < 1 || cs > dts::kMaxCs || R < 1) return (int)cudaErrorInvalidValue;
  if (n_dst == 0) return 0;
  // whole 16-byte pieces: every row of every tile starts 16-byte aligned
  const bool vec = (cs * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(diag) % 16 == 0;
  auto go = vec ? (lower ? launch_diag_trsm_as<T, true, true>
                         : launch_diag_trsm_as<T, true, false>)
                : (lower ? launch_diag_trsm_as<T, false, true>
                         : launch_diag_trsm_as<T, false, false>);
  return go(x, diag, dst, n_dst, cs, R, stream);
}

}  // namespace

extern "C" {

int ldiv_max_chunk() { return kMaxCs; }

const char* ldiv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int ldiv_perm_gather_f32(float* y, const float* v, const int32_t* idx,
                         const float* scale, int64_t n_v, int64_t n_out,
                         int R, void* stream) {
  return launch_perm_gather<float>(y, v, idx, scale, n_v, n_out, R,
                                   (cudaStream_t)stream);
}

int ldiv_perm_gather_f64(double* y, const double* v, const int32_t* idx,
                         const double* scale, int64_t n_v, int64_t n_out,
                         int R, void* stream) {
  return launch_perm_gather<double>(y, v, idx, scale, n_v, n_out, R,
                                    (cudaStream_t)stream);
}

int ldiv_wave_apply_f32(float* x, const float* tiles_t, const int32_t* dst,
                        const int32_t* ptr, const int32_t* ent_tile,
                        const int32_t* ent_src, int n_dst, int cs, int R,
                        int accumulate, void* stream) {
  return launch_wave<float, float>(x, tiles_t, dst, ptr, ent_tile, ent_src,
                                   n_dst, cs, R, accumulate,
                                   (cudaStream_t)stream);
}

int ldiv_wave_apply_f64(double* x, const double* tiles_t, const int32_t* dst,
                        const int32_t* ptr, const int32_t* ent_tile,
                        const int32_t* ent_src, int n_dst, int cs, int R,
                        int accumulate, void* stream) {
  return launch_wave<double, double>(x, tiles_t, dst, ptr, ent_tile, ent_src,
                                     n_dst, cs, R, accumulate,
                                     (cudaStream_t)stream);
}

int ldiv_wave_apply_bf16(float* x, const void* tiles_t, const int32_t* dst,
                         const int32_t* ptr, const int32_t* ent_tile,
                         const int32_t* ent_src, int n_dst, int cs, int R,
                         int accumulate, void* stream) {
  return launch_wave<float, __nv_bfloat16>(
      x, static_cast<const __nv_bfloat16*>(tiles_t), dst, ptr, ent_tile,
      ent_src, n_dst, cs, R, accumulate, (cudaStream_t)stream);
}

int ldiv_diag_trsm_f32(float* x, const float* diag, const int32_t* dst,
                       int n_dst, int cs, int R, int lower, void* stream) {
  return launch_diag_trsm<float>(x, diag, dst, n_dst, cs, R, lower,
                                 (cudaStream_t)stream);
}

int ldiv_diag_trsm_f64(double* x, const double* diag, const int32_t* dst,
                       int n_dst, int cs, int R, int lower, void* stream) {
  return launch_diag_trsm<double>(x, diag, dst, n_dst, cs, R, lower,
                                  (cudaStream_t)stream);
}

}  // extern "C"
