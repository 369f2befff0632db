// Hopper ldiv kernel: the whole sparse LU solve x = A \ b in one launch.
//
// Replaces the TPU kernel tpu_sparse_lu/ops/pallas_ldiv.py `_kernel`
// (entry `pallas_fused_ldiv`), which runs perm-in, the L levels, the U
// levels and perm-out as one serial op stream on one TensorCore and DMAs
// the next page of tiles while it computes the current one. Here the same
// stream is a list of tasks the host builds once per plan
// (ops/fused_ldiv.py `build_ldiv_schedule`), in the order of the waves:
//
//   perm-in    carrier block k:  x[k*cs + i, :] = rs[s] * b[s, :],
//              s = pidx[k*cs + i] (0 where s = -1);
//   wave       one destination block d of one wave of the L or U factor:
//              x[d] = acc * x[d] + sum_e tile[e] @ x[src[e]];
//   perm-out   rows m*cs.. of y:  y[r, :] = x[qidx[r], :].
//
// Each task runs once per strip of RB columns of R (a ticket is task *
// strips + strip; RB is 1, 4, 8 or 16, chosen by the wrapper), and waits
// only for the tickets of the same strip that it depends on: the last
// writer of every carrier block it reads or writes, and every earlier
// reader of a block it writes. RB only groups columns: every output
// element gets the same arithmetic at every RB.
//
// The launch has as many blocks as the card holds at once (or fewer).
// Each block loops: take the next ticket with atomicAdd (tickets, not
// blockIdx, because blocks do not start in index order; a block waits only
// on tickets that running blocks already hold, so the launch cannot
// deadlock at any grid size, down to one block); start the copy of the
// task's first tile, and of its second where shared memory holds two
// (tiles of 4 bytes or fewer), into shared memory (tiles never change
// within a solve); wait on the ready flags of its dependencies; compute
// exactly as wave_apply_kernel or perm_gather_kernel of csrc/ldiv.cu do
// (the same entry order, the same 8-warp split of k, the same warp-order
// reduction, so the result equals the 32-launch route bit for bit);
// publish its flag. Later entries' tiles load into the buffer the entry
// before last freed, while the last one computes.
//
// Ready flags and graphs. `state` holds the ticket counter, the exit
// counter, the generation, and one flag per ticket. A flag is ready when
// it equals the generation the block read at entry; flags start at 0 and
// the generation at 1. The last block to leave resets both counters and
// advances the generation, so nothing is reset from the host and the
// launch may be captured in a CUDA graph and replayed. One launch may run
// on a `state` at a time: the wrapper keeps one per stream.
//
// Memory ordering. A task publishes with: all threads' stores,
// __syncthreads(), and thread 0's gpu-scope release store of its flag
// (cumulative: it carries the stores the barrier ordered before it). A
// waiting warp reads each flag with a gpu-scope acquire load, a lane per
// dependency, then __syncthreads(). The carrier x is written by other SMs
// during the launch, so it is read only through L2 (cp.async.cg 16 bytes
// at a time, or ld.global.cg): never __ldg or an L1-allocating copy,
// which could return a line this SM cached for an earlier task. Tiles and
// b never change in a launch and take any path.
// A wait that never ends (a schedule fault) traps after 2^26 polls, so it
// shows as a launch error and not as a hang.
//
// What bounds it on the card: not the bytes (every L and U tile once, 33
// MB at the headline, 2D Poisson 100x100, cs = 128, nd: ~10 us of HBM),
// but the critical path, a chain of dependent tasks, each ticket on one
// SM: 32 tasks at the headline (perm-in, 15 L and 15 U waves, perm-out),
// 116 on config 2's block-banded plan and 3,200 on config 5's one-device
// half, two a level (the diagonal wave, then the off-diagonal wave into
// the next chunk; LdivSchedule.critical_path). One chain step at a strip
// of 16 columns: the flag seen ~0.55 us after its release, the strip from
// L2 ~0.65 us, the 128 x 128 x 16 product ~1.95 us, the reduction and
// stores ~1.05 us, the release ~0.4 us; at a strip of 1 column 0.5, 0.4,
// 0.64, 0.2 and 0.45 us (an H100, tools/ldiv_sweep.py --clocks on config
// 2's plan, R = 16). So the wrapper picks the strip width per launch from
// the schedule (ops/fused_ldiv.py strip_width): a deep chain runs R
// chains of 1 column side by side on R SMs, while a plan of wide levels
// keeps wider strips, since every ticket stages its task's tiles again
// (the headline at 1 column: 0.397 ms against 0.167 at 16). The rule's
// time of one chain task at RB = 1, 4, 8, 16 (TASK_US): 2.287, 2.899,
// 3.572, 4.691 us, config 5's launch (7.31, 9.27, 11.42, 15.00 ms) over
// its 3,200 tasks, R = 16, float32 (tools/ldiv_sweep.py --strip). The
// tile loads are off the chain's path. Left for later: keeping the carrier in shared memory
// across a run of one-tile levels, folding the diagonal wave into the
// off-diagonal gather, splitting a task's rows or k range over blocks,
// and TMA loads.

#include <cuda/atomic>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerLane = 4;
constexpr int kMaxCs = 32 * kRowsPerLane;
constexpr long long kSpinLimit = 1LL << 26;

// task flags (ops/fused_ldiv.py)
constexpr int kKindMask = 3;
constexpr int kPermIn = 0;
constexpr int kWave = 1;
constexpr int kBankU = 4;
constexpr int kAccumulate = 8;

// state words
constexpr int kTicket = 0;
constexpr int kExit = 1;
constexpr int kGeneration = 2;
constexpr int kFlags = 3;

using flag_ref = cuda::atomic_ref<int, cuda::thread_scope_device>;

// bytes of the shared tile region: the tile (of the tile type TT), or the
// warps' partials (of the carrier type T), rounded up to 16 bytes
template <typename T, typename TT, int RB>
__host__ __device__ constexpr int tile_region(int cs) {
  const int partials = kWarps * RB * (cs + 1) * (int)sizeof(T);
  const int tile = cs * cs * (int)sizeof(TT);
  return ((tile > partials ? tile : partials) + 15) / 16 * 16;
}

constexpr int kMaxSmem = 232448;  // a block's shared memory on Hopper

__host__ __device__ constexpr int tile_bytes16(int cs, int size) {
  return (cs * cs * size + 15) / 16 * 16;
}

// a second tile buffer where the largest tile leaves room for it (tiles
// of 4 bytes or fewer): the next entry's tile loads during this one
template <typename T, typename TT, int RB>
__host__ __device__ constexpr bool two_tiles() {
  return (size_t)tile_region<T, TT, RB>(kMaxCs) +
             tile_bytes16(kMaxCs, sizeof(TT)) + kMaxCs * RB * sizeof(T) <=
         (size_t)kMaxSmem;
}

// bytes of the second tile buffer (0 without one)
template <typename T, typename TT, int RB>
__host__ __device__ constexpr int second_tile(int cs) {
  return two_tiles<T, TT, RB>() ? tile_bytes16(cs, sizeof(TT)) : 0;
}

template <typename T, typename TT, int RB>
inline size_t smem_bytes(int cs) {
  return (size_t)tile_region<T, TT, RB>(cs) + second_tile<T, TT, RB>(cs) +
         (size_t)cs * RB * sizeof(T);
}

// one row k of the staged strip into registers, 16 bytes at a time where
// the row allows it (vector members, so xv never needs an address)
template <typename T, int RB>
__device__ __forceinline__ void strip_row(T (&xv)[RB], const T* xk) {
  if constexpr (std::is_same_v<T, float> && RB % 4 == 0) {
#pragma unroll
    for (int j = 0; j < RB; j += 4) {
      const float4 u = *reinterpret_cast<const float4*>(xk + j);
      xv[j] = u.x;
      xv[j + 1] = u.y;
      xv[j + 2] = u.z;
      xv[j + 3] = u.w;
    }
  } else if constexpr (std::is_same_v<T, double> && RB % 2 == 0) {
#pragma unroll
    for (int j = 0; j < RB; j += 2) {
      const double2 u = *reinterpret_cast<const double2*>(xk + j);
      xv[j] = u.x;
      xv[j + 1] = u.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < RB; ++j) xv[j] = xk[j];
  }
}

__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T widen(T v) { return v; }

// the whole tile in flight at once: asynchronous copies into shared
// memory, 16 bytes each where the tile allows it; committed by the caller
template <typename TT>
__device__ __forceinline__ void stage_tile(TT* ts, const TT* tile,
                                           int tile_elems) {
  constexpr int kVec = 16 / sizeof(TT);
  if (tile_elems % kVec == 0 && reinterpret_cast<uintptr_t>(tile) % 16 == 0) {
    for (int q = threadIdx.x; q < tile_elems / kVec; q += kThreads)
      __pipeline_memcpy_async(ts + q * kVec, tile + q * kVec, 16);
  } else if constexpr (sizeof(TT) >= 4) {
    for (int q = threadIdx.x; q < tile_elems; q += kThreads)
      __pipeline_memcpy_async(ts + q, tile + q, sizeof(TT));
  } else {  // no asynchronous copy of fewer than 4 bytes
    for (int q = threadIdx.x; q < tile_elems; q += kThreads) ts[q] = tile[q];
  }
}

__device__ __forceinline__ void cp_async_cg16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// the x[src] strip of one entry into xs, read through L2: 16-byte
// asynchronous copies (cp.async.cg) where the rows allow it, else scalar
// loads all in flight before the stores
template <typename T, int RB>
__device__ __forceinline__ void stage_strip(T* xs, const T* xsrc, int cs,
                                            int R, int j0) {
  constexpr int kXVec = 16 / sizeof(T);
  if constexpr (RB % kXVec == 0) {
    if (R % kXVec == 0 && reinterpret_cast<uintptr_t>(xsrc) % 16 == 0) {
      constexpr int kRowVecs = RB / kXVec;
      for (int q = threadIdx.x; q < cs * kRowVecs; q += kThreads) {
        const int k = q / kRowVecs;
        const int c = (q - k * kRowVecs) * kXVec;
        T* d = xs + k * RB + c;
        if (j0 + c < R)
          cp_async_cg16(d, xsrc + (int64_t)k * R + j0 + c);
        else
          *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      }
      return;
    }
  }
  constexpr int kPer = (kMaxCs * RB + kThreads - 1) / kThreads;
  T v[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int q = threadIdx.x + u * kThreads;
    const int k = q / RB;
    const int j = q - k * RB;
    v[u] = (k < cs && j0 + j < R) ? __ldcg(xsrc + (int64_t)k * R + j0 + j)
                                  : T(0);
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int q = threadIdx.x + u * kThreads;
    if (q < cs * RB) xs[q] = v[u];
  }
}

// one destination block of one wave, one strip: wave_apply_kernel's body
// (csrc/ldiv.cu), with the first tile already in flight and x read
// through L2
template <typename T, typename TT, int RB>
__device__ __forceinline__ void wave_task(
    T* x, const TT* bank, const int32_t* ent_tile, const int32_t* ent_src,
    int e0, int e1, int dst, bool accumulate, int cs, int R, int j0,
    unsigned char* smem) {
  // tile buffers: entry i of the task reads buf0 for even i, buf1 for odd
  // i (buf0 alone without a second buffer); the partials go in buf0's
  // place
  constexpr bool kTwo = two_tiles<T, TT, RB>();
  TT* const buf0 = reinterpret_cast<TT*>(smem);
  TT* const buf1 =
      reinterpret_cast<TT*>(smem + (kTwo ? tile_region<T, TT, RB>(cs) : 0));
  T* ps = reinterpret_cast<T*>(smem);
  T* xs = reinterpret_cast<T*>(smem + tile_region<T, TT, RB>(cs) +
                               second_tile<T, TT, RB>(cs));
  const int ldp = cs + 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t blk = (int64_t)cs * R;
  const int tile_elems = cs * cs;

  constexpr int kPer = (kMaxCs * RB + kThreads - 1) / kThreads;
  T* xd = x + (int64_t)dst * blk;
  T old[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int q = threadIdx.x + u * kThreads;
    const int i = q / RB;
    const int j = q - i * RB;
    old[u] = (accumulate && i < cs && j0 + j < R)
                 ? __ldcg(xd + (int64_t)i * R + j0 + j) : T(0);
  }

  T acc[kRowsPerLane][RB];
#pragma unroll
  for (int r = 0; r < kRowsPerLane; ++r)
#pragma unroll
    for (int j = 0; j < RB; ++j) acc[r][j] = T(0);

  for (int e = e0; e < e1; ++e) {
    const int i = e - e0;
    const T* xsrc = x + (int64_t)ent_src[e] * blk;
    TT* ts = (kTwo && (i & 1)) ? buf1 : buf0;
    if (i > 0) {
      __syncthreads();  // the previous entry is done with its tile and xs
      if (!kTwo)
        stage_tile(ts, bank + (int64_t)ent_tile[e] * tile_elems, tile_elems);
    }
    stage_strip<T, RB>(xs, xsrc, cs, R, j0);
    __pipeline_commit();
    if (kTwo && i > 0 && e + 1 < e1) {
      // the next entry's tile into the buffer the previous entry freed;
      // it may stay in flight while this entry computes
      stage_tile((i & 1) ? buf0 : buf1,
                 bank + (int64_t)ent_tile[e + 1] * tile_elems, tile_elems);
      __pipeline_commit();
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
#pragma unroll 2
    for (int k = warp; k < cs; k += kWarps) {
      const TT* trow = ts + k * cs;
      T t[kRowsPerLane];
#pragma unroll
      for (int r = 0; r < kRowsPerLane; ++r) {
        const int i = lane + 32 * r;
        t[r] = (i < cs) ? widen(trow[i]) : T(0);
      }
      T xv[RB];
      strip_row<T, RB>(xv, xs + k * RB);
#pragma unroll
      for (int j = 0; j < RB; ++j) {
#pragma unroll
        for (int r = 0; r < kRowsPerLane; ++r) acc[r][j] += t[r] * xv[j];
      }
    }
  }

  // deterministic cross-warp reduction, as wave_apply_kernel: every warp
  // stores its partials, then each output element sums them in warp order
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

// a minimum of one block per SM: without it ptxas held the bf16 instance at
// 128 registers (two blocks per SM) and spilled its strip row; the solve is
// bound by its chain of dependent steps, not by resident blocks
template <typename T, typename TT, int RB>
__global__ void __launch_bounds__(kThreads, 1)
ldiv_fused_kernel(T* y, T* x, const T* b, const T* rs, const TT* lbank,
                  const TT* ubank, const int32_t* task,
                  const int32_t* dep_ptr, const int32_t* dep,
                  const int32_t* ent_tile, const int32_t* ent_src,
                  const int32_t* pidx, const int32_t* qidx, int32_t* state,
                  int n_tickets, int strips, int64_t n, int cs, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_ticket;
  __shared__ int s_gen;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile_elems = cs * cs;
  int32_t* done = state + kFlags;

  if (threadIdx.x == 0)
    s_gen = flag_ref(state[kGeneration]).load(cuda::memory_order_relaxed);
  int gen = 0;
  for (;;) {
    if (threadIdx.x == 0) s_ticket = atomicAdd(&state[kTicket], 1);
    __syncthreads();
    const int ticket = s_ticket;
    gen = s_gen;
    if (ticket >= n_tickets) break;
    const int t = ticket / strips;
    const int strip = ticket - t * strips;
    const int j0 = strip * RB;
    const int flags = task[4 * t];
    const int dst = task[4 * t + 1];
    const int e0 = task[4 * t + 2];
    const int e1 = task[4 * t + 3];
    const int kind = flags & kKindMask;
    const TT* bank = (flags & kBankU) ? ubank : lbank;

    // 1. the first tile (and the second, where there is room) in flight
    // before the wait
    if (kind == kWave && e0 < e1) {
      stage_tile(reinterpret_cast<TT*>(smem_raw),
                 bank + (int64_t)ent_tile[e0] * tile_elems, tile_elems);
      __pipeline_commit();
      if (two_tiles<T, TT, RB>() && e1 - e0 > 1) {
        stage_tile(reinterpret_cast<TT*>(smem_raw +
                                         tile_region<T, TT, RB>(cs)),
                   bank + (int64_t)ent_tile[e0 + 1] * tile_elems, tile_elems);
        __pipeline_commit();
      }
    }
    // 2. the ready flags of the same strip of every dependency, a lane
    // each
    if (warp == 0) {
      const int q1 = dep_ptr[t + 1];
      for (int q = dep_ptr[t] + lane; q < q1; q += 32) {
        flag_ref f(done[dep[q] * strips + strip]);
        long long polls = 0;
        while (f.load(cuda::memory_order_acquire) != gen) {
          if (++polls > kSpinLimit) __trap();
        }
      }
    }
    __syncthreads();
    // 3. the task
    if (kind == kWave) {
      wave_task<T, TT, RB>(x, bank, ent_tile, ent_src, e0, e1, dst,
                           (flags & kAccumulate) != 0, cs, R, j0, smem_raw);
    } else {
      // a perm task: perm_gather_kernel's arithmetic on cs rows x RB
      const bool in = kind == kPermIn;
      for (int q = threadIdx.x; q < cs * RB; q += kThreads) {
        const int i = q / RB;
        const int j = q - i * RB;
        const int64_t row = (int64_t)dst * cs + i;
        if (j0 + j >= R || (!in && row >= n)) continue;
        T val = T(0);
        if (in) {
          const int32_t s = pidx[row];
          if (s >= 0 && s < n) {
            val = b[(int64_t)s * R + j0 + j];
            val = val * rs[s];
          }
          x[row * R + j0 + j] = val;
        } else {
          const int32_t s = qidx[row];
          if (s >= 0) val = __ldcg(x + (int64_t)s * R + j0 + j);
          y[row * R + j0 + j] = val;
        }
      }
    }
    // 4. publish: the barrier orders every thread's stores before thread
    // 0's release, which makes them visible at gpu scope with the flag
    __syncthreads();
    if (threadIdx.x == 0)
      flag_ref(done[ticket]).store(gen, cuda::memory_order_release);
  }
  // the last block out resets the counters and advances the generation
  if (threadIdx.x == 0 &&
      atomicAdd(&state[kExit], 1) == (int)gridDim.x - 1) {
    state[kTicket] = 0;
    state[kExit] = 0;
    state[kGeneration] = gen == INT_MAX ? 1 : gen + 1;
    __threadfence();
  }
}

template <typename T, typename TT, int RB>
cudaError_t opt_in() {
  // above 48 KB only after opting in, once per instantiation, for the
  // largest tile (145 KB for float64 at cs = 128, RB = 16)
  static const cudaError_t rc = cudaFuncSetAttribute(
      ldiv_fused_kernel<T, TT, RB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<T, TT, RB>(kMaxCs));
  return rc;
}

template <typename T, typename TT, int RB>
int capacity_rb(int cs) {
  cudaError_t rc = opt_in<T, TT, RB>();
  if (rc != cudaSuccess) return -(int)rc;
  int dev = 0, sms = 0, per_sm = 0;
  if ((rc = cudaGetDevice(&dev)) != cudaSuccess) return -(int)rc;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return -(int)rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ldiv_fused_kernel<T, TT, RB>, kThreads,
      smem_bytes<T, TT, RB>(cs));
  if (rc != cudaSuccess) return -(int)rc;
  return per_sm * sms;
}

template <typename T, typename TT>
int capacity(int cs, int RB) {
  if (cs < 1 || cs > kMaxCs) return -(int)cudaErrorInvalidValue;
  switch (RB) {
    case 1: return capacity_rb<T, TT, 1>(cs);
    case 4: return capacity_rb<T, TT, 4>(cs);
    case 8: return capacity_rb<T, TT, 8>(cs);
    case 16: return capacity_rb<T, TT, 16>(cs);
  }
  return -(int)cudaErrorInvalidValue;
}

template <typename T, typename TT, int RB>
int launch_rb(T* y, T* x, const T* b, const T* rs, const TT* lbank,
              const TT* ubank, const int32_t* task, const int32_t* dep_ptr,
              const int32_t* dep, const int32_t* ent_tile,
              const int32_t* ent_src, const int32_t* pidx,
              const int32_t* qidx, int32_t* state, int n_tasks, int64_t n,
              int cs, int R, int grid, cudaStream_t stream) {
  const cudaError_t rc = opt_in<T, TT, RB>();
  if (rc != cudaSuccess) return (int)rc;
  const int strips = (R + RB - 1) / RB;
  ldiv_fused_kernel<T, TT, RB><<<grid, kThreads, smem_bytes<T, TT, RB>(cs),
                                 stream>>>(
      y, x, b, rs, lbank, ubank, task, dep_ptr, dep, ent_tile, ent_src, pidx,
      qidx, state, n_tasks * strips, strips, n, cs, R);
  return (int)cudaGetLastError();
}

template <typename T, typename TT>
int launch(T* y, T* x, const T* b, const T* rs, const TT* lbank,
           const TT* ubank, const int32_t* task, const int32_t* dep_ptr,
           const int32_t* dep, const int32_t* ent_tile,
           const int32_t* ent_src, const int32_t* pidx, const int32_t* qidx,
           int32_t* state, int n_tasks, int64_t n, int cs, int R, int RB,
           int grid, cudaStream_t stream) {
  if (cs < 1 || cs > kMaxCs || R < 1 || grid < 1 || n_tasks < 1)
    return (int)cudaErrorInvalidValue;
  // column strip: the width the wrapper chose (ops/fused_ldiv.py
  // strip_width); any width gives the same bits
#define LDIV_FUSED_RB(W)                                                     \
  case W:                                                                    \
    return launch_rb<T, TT, W>(y, x, b, rs, lbank, ubank, task, dep_ptr,     \
                               dep, ent_tile, ent_src, pidx, qidx, state,    \
                               n_tasks, n, cs, R, grid, stream);
  switch (RB) {
    LDIV_FUSED_RB(1)
    LDIV_FUSED_RB(4)
    LDIV_FUSED_RB(8)
    LDIV_FUSED_RB(16)
  }
#undef LDIV_FUSED_RB
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

#define LDIV_FUSED_ENTRY(suffix, T, TT, TTARG)                               \
  int ldiv_fused_##suffix(T* y, T* x, const T* b, const T* rs,               \
                          const TTARG* lbank, const TTARG* ubank,            \
                          const int32_t* task, const int32_t* dep_ptr,       \
                          const int32_t* dep, const int32_t* ent_tile,       \
                          const int32_t* ent_src, const int32_t* pidx,       \
                          const int32_t* qidx, int32_t* state, int n_tasks,  \
                          int64_t n, int cs, int R, int RB, int grid,        \
                          void* stream) {                                    \
    return launch<T, TT>(y, x, b, rs, reinterpret_cast<const TT*>(lbank),   \
                         reinterpret_cast<const TT*>(ubank), task, dep_ptr,  \
                         dep, ent_tile, ent_src, pidx, qidx, state, n_tasks, \
                         n, cs, R, RB, grid, (cudaStream_t)stream);          \
  }                                                                          \
  int ldiv_fused_##suffix##_capacity(int cs, int RB) {                       \
    return capacity<T, TT>(cs, RB);                                          \
  }

LDIV_FUSED_ENTRY(f32, float, float, float)
LDIV_FUSED_ENTRY(f64, double, double, double)
LDIV_FUSED_ENTRY(bf16, float, __nv_bfloat16, void)

}  // extern "C"
