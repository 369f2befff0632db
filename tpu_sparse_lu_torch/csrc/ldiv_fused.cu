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
// Each task runs once per strip of RB columns of R (RB is 1, 4, 8 or 16,
// chosen by the wrapper), and waits only for the same strip of the tasks
// it depends on: the last writer of every carrier block it reads or
// writes, and every earlier reader of a block it writes. RB only groups
// columns: every output element gets the same arithmetic at every RB.
//
// Runs. A ticket is a unit of the task list and a strip (unit * strips +
// strip): a single task, or a run, a chain of one-tile wave tasks t0..t1
// where each depends on the one before it and on nothing else at or after
// t0 (ops/fused_ldiv.py find_runs). One block walks a run in order: the
// block each task writes stays in shared memory as the next task's x[src]
// strip (the carrier), the next tasks' tiles stream into a ring of
// buffers while the current one computes, and no flag passes between two
// tasks of the run. Each task still writes its block to x and has its own
// ready flag, for the tasks outside the run; the flags go out a batch of
// kRunBatch tasks at a time behind one fence, and the flags a batch's
// tasks wait on outside the run (all earlier than t0) are read during the
// batch before and seen before the batch starts. A kernel whose ring
// cannot hold two tiles at every strip width (float64) takes no run, nor
// does a tile the bulk copy cannot take (not whole 16-byte pieces): the
// wrapper then gives one task a ticket (ops/fused_ldiv.py _takes_runs,
// which asks ldiv_fused_*_takes_runs).
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
// counter, the generation, and one flag per task and strip (task * strips
// + strip). A flag is ready when
// it equals the generation the block read at entry; flags start at 0 and
// the generation at 1. The last block to leave resets both counters and
// advances the generation, so nothing is reset from the host and the
// launch may be captured in a CUDA graph and replayed. One launch may run
// on a `state` at a time: the wrapper keeps one per stream.
//
// Memory ordering. A task publishes with: all threads' stores,
// __syncthreads(), and thread 0's gpu-scope release store of its flag
// (cumulative: it carries the stores the barrier ordered before it); a
// run's batch with a barrier, warp 0's gpu-scope acq_rel fence and relaxed
// stores of its flags (that fence also makes acquires of the relaxed reads
// of the flags the next batch waits on). A
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
// tile loads are off the chain's path. A run takes the flag, the restaged
// strip and the release off each step of such a chain: a step at RB = 1,
// 4, 8, 16 takes 1.149, 1.710, 2.432, 3.570 us (RUN_TASK_US, the same
// launch: 3.68 ms at RB = 1). Of a step at one column (--clocks, config
// 2's plan, ~1.0 us) ~0.48 us are the products, which read the 64 KB tile
// from shared memory while the bulk copy of a later tile writes there,
// ~0.17 the reduction and stores, ~0.28 the loads' issue, the ring's wait
// and a barrier, ~0.08 the batch's fence a step.
// Left for later: folding the diagonal wave into the off-diagonal gather,
// splitting a task's rows or k range over blocks.

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
constexpr int kRing = 3;       // most tile buffers of a run
constexpr int kRunBatch = 64;  // a run's tasks per fence

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

// a run's layout: a ring of tile buffers, the warps' partials and the
// carrier strip
template <typename T, int RB>
__host__ __device__ constexpr int partials_bytes(int cs) {
  return (kWarps * RB * (cs + 1) * (int)sizeof(T) + 15) / 16 * 16;
}

// the tiles a run's layout has room for at width RB
template <typename T, typename TT, int RB>
__host__ __device__ constexpr int ring_room() {
  return (kMaxSmem - partials_bytes<T, RB>(kMaxCs) -
          kMaxCs * RB * (int)sizeof(T)) /
         tile_bytes16(kMaxCs, sizeof(TT));
}

// whether the kernel takes runs: its ring holds two tiles at every width
// (the widest leaves the least room). Not float64: a 128 KB tile leaves
// room for one, so a run would load each tile on its path, where a single
// task loads its tile before its wait (a run step 2.90 us against a task's
// 2.57 at config 5's plan, 1 column, R = 16, an H100)
template <typename T, typename TT>
__host__ __device__ constexpr bool takes_runs() {
  return ring_room<T, TT, 16>() >= 2;
}

// the ring's buffers (0: the kernel takes no run)
template <typename T, typename TT, int RB>
__host__ __device__ constexpr int ring_tiles() {
  if (!takes_runs<T, TT>()) return 0;
  return ring_room<T, TT, RB>() >= kRing ? kRing : 2;
}

// bytes before the carrier strip in a run's layout
template <typename T, typename TT, int RB>
__host__ __device__ constexpr int run_strip_at(int cs) {
  return ring_tiles<T, TT, RB>() * tile_bytes16(cs, sizeof(TT)) +
         partials_bytes<T, RB>(cs);
}

template <typename T, typename TT, int RB>
inline size_t smem_bytes(int cs) {
  const size_t task = (size_t)tile_region<T, TT, RB>(cs) +
                      second_tile<T, TT, RB>(cs);
  const size_t run = ring_tiles<T, TT, RB>() ? run_strip_at<T, TT, RB>(cs) : 0;
  return (task > run ? task : run) + (size_t)cs * RB * sizeof(T);
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

// a run's tile ring: one bulk copy (TMA) a tile, completing on the
// buffer's mbarrier
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_tile(uint32_t bar, void* dst,
                                          const void* src, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wait_bar(uint32_t bar, uint32_t parity) {
  uint32_t ok = 0;
  long long polls = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
    if (ok) return;
    if (++polls > kSpinLimit) __trap();
  }
}

// a flag read without ordering; a later fence makes it an acquire
__device__ __forceinline__ int load_relaxed(const int32_t* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

// the x[src] strip into xs through L2 with loads, all in flight before the
// stores (0 past R)
template <typename T, int RB>
__device__ __forceinline__ void load_strip(T* xs, const T* xsrc, int cs,
                                           int R, int j0) {
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
  load_strip<T, RB>(xs, xsrc, cs, R, j0);
}

// the products of one staged tile with the staged strip, added to the
// lane's rows: warp w takes k = w, w + 8, ... (wave_apply_kernel's split);
// at one column eight k a warp in flight at once (the unrolling leaves
// each row's sum in the same order)
template <typename T, typename TT, int RB>
__device__ __forceinline__ void tile_product(T (&acc)[kRowsPerLane][RB],
                                             const TT* ts, const T* xs,
                                             int cs) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  auto step = [&](int k) {
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
  };
  if constexpr (RB == 1) {
#pragma unroll 8
    for (int k = warp; k < cs; k += kWarps) step(k);
  } else {
#pragma unroll 2
    for (int k = warp; k < cs; k += kWarps) step(k);
  }
}

// every warp's partials into ps, for the warp-order sum
template <typename T, int RB>
__device__ __forceinline__ void store_partials(
    T* ps, const T (&acc)[kRowsPerLane][RB], int cs) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRowsPerLane; ++r) {
    const int i = lane + 32 * r;
    if (i < cs) {
#pragma unroll
      for (int j = 0; j < RB; ++j)
        ps[(warp * RB + j) * (cs + 1) + i] = acc[r][j];
    }
  }
}

// output element (i, j): the partials summed in warp order
template <typename T, int RB>
__device__ __forceinline__ T warp_sum(const T* ps, int i, int j, int cs) {
  const int ldp = cs + 1;
  T sum = ps[j * ldp + i];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) sum += ps[(w * RB + j) * ldp + i];
  return sum;
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
    tile_product<T, TT, RB>(acc, ts, xs, cs);
  }

  // deterministic cross-warp reduction, as wave_apply_kernel: every warp
  // stores its partials, then each output element sums them in warp order
  __syncthreads();  // every warp is done reading the staged tile
  store_partials<T, RB>(ps, acc, cs);
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int q = threadIdx.x + u * kThreads;
    const int i = q / RB;
    const int j = q - i * RB;
    if (i < cs && j0 + j < R)
      xd[(int64_t)i * R + j0 + j] = old[u] + warp_sum<T, RB>(ps, i, j, cs);
  }
}

// warp 0 polls the ready flags wait[q0:q1] (tasks) of strip `strip`, a
// lane each; the caller's barrier then holds the block
__device__ __forceinline__ void wait_flags(const int32_t* wait, int q0,
                                           int q1, int32_t* done,
                                           int strips, int strip, int gen) {
  if (threadIdx.x >= 32) return;
  for (int q = q0 + (int)threadIdx.x; q < q1; q += 32) {
    flag_ref f(done[wait[q] * strips + strip]);
    long long polls = 0;
    while (f.load(cuda::memory_order_acquire) != gen) {
      if (++polls > kSpinLimit) __trap();
    }
  }
}

// one run, one strip: tasks t0 .. t1 - 1, each one entry (meta[t] = flags,
// dst, tile, src), walked in order by this block. The block a task writes
// stays in xs (the carrier) as the next task's source (find_runs: each
// task after the first reads the block the one before it wrote, and
// accumulates into another, written before the run); only the first task
// stages its strip from L2. Once task i's products are done, the tile of
// task i + NB streams into the buffer it freed (NB = ring_tiles, 2 or 3),
// one bulk copy on the buffer's mbarrier (`phase`: each buffer's next
// parity, kept by the block across its runs), issued by thread kThreads /
// 2, which the reduction leaves idle at one column (an issue costs its
// thread ~0.1-0.2 us). The wrapper gives runs only where the bulk copy
// takes the tiles (whole 16-byte pieces, banks on 16 bytes). Every task's
// arithmetic is wave_task's for one entry.
//
// Flags by batch of kRunBatch tasks: at a batch's first task warp 0 reads
// (relaxed) the flags the next batch waits on outside the run; at its
// end, after a barrier over the batch's stores, warp 0 waits for any of
// those not yet seen, fences once (release of this batch's blocks,
// acquire of the next batch's dependencies) and stores this batch's
// flags.
template <typename T, typename TT, int RB>
__device__ __forceinline__ void run_tasks(
    T* x, const TT* lbank, const TT* ubank, const int4* meta,
    const int32_t* wait_ptr, const int32_t* wait, int32_t* done, int gen,
    int t0, int t1, int strips, int strip, int cs, int R,
    unsigned char* smem, const uint64_t* ring, uint32_t& phase) {
  constexpr int NB = ring_tiles<T, TT, RB>();
  constexpr int kPer = (kMaxCs * RB + kThreads - 1) / kThreads;
  const int n = t1 - t0;
  const int j0 = strip * RB;
  const int lane = threadIdx.x & 31;
  const int tile_elems = cs * cs;
  const int tile_bytes = tile_bytes16(cs, sizeof(TT));
  const uint32_t tile_exact = (uint32_t)tile_elems * sizeof(TT);
  if (tile_exact % 16 != 0 || reinterpret_cast<uintptr_t>(lbank) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ubank) % 16 != 0)
    __trap();  // a run the bulk copy cannot load
  const int64_t blk = (int64_t)cs * R;
  T* const ps = reinterpret_cast<T*>(smem + NB * tile_bytes);
  T* const xs = reinterpret_cast<T*>(smem + run_strip_at<T, TT, RB>(cs));
  auto buf = [&](int i) {
    return reinterpret_cast<TT*>(smem + (i % NB) * tile_bytes);
  };
  auto tile_of = [&](const int4& m) {
    return ((m.x & kBankU) ? ubank : lbank) + (int64_t)m.z * tile_elems;
  };
  // task i's tile into its buffer: one thread issues the bulk copy
  auto load = [&](int i, const int4& m) {
    if (threadIdx.x == kThreads / 2)
      bulk_tile(smem_u32(ring + i % NB), buf(i), tile_of(m), tile_exact);
  };
  // q[k]: meta of task i + k; q[NB + 1] loads during task i
  int4 q[NB + 2];
#pragma unroll
  for (int k = 0; k < NB + 1; ++k)
    q[k] = k < n ? __ldg(meta + t0 + k) : make_int4(0, 0, 0, 0);

  // 1. the first tiles in flight before the wait (after a proxy fence:
  // the buffers held other data, written by the threads, before)
  if (threadIdx.x == kThreads / 2)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < NB; ++k)
    if (k < n) load(k, q[k]);
  // 2. the flags of the first batch's tasks outside the run; the next
  // batch's flag indices
  wait_flags(wait, wait_ptr[t0], wait_ptr[t0 + min(n, kRunBatch)], done,
             strips, strip, gen);
  int ahead_idx[4] = {-1, -1, -1, -1};  // warp 0: flags of the next batch
  int ahead_val[4] = {0, 0, 0, 0};
  int ahead_q0 = 0, ahead_q1 = 0;  // and their range of wait[]
  __syncthreads();
  load_strip<T, RB>(xs, x + (int64_t)q[0].w * blk, cs, R, j0);
  int out = 0;  // tasks whose flags are out
  for (int i = 0; i < n; ++i) {
    const int4 m = q[0];
    q[NB + 1] = i + NB + 1 < n ? __ldg(meta + t0 + i + NB + 1)
                               : make_int4(0, 0, 0, 0);
    if (i % kRunBatch == 0 && threadIdx.x < 32) {
      // the next batch's flags outside the run, read now, checked at the
      // end of this batch
      const int a = min(n, i + kRunBatch);
      ahead_q0 = wait_ptr[t0 + a];
      ahead_q1 = wait_ptr[t0 + min(n, a + kRunBatch)];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int qq = ahead_q0 + lane + 32 * k;
        ahead_idx[k] = qq < ahead_q1 ? wait[qq] : -1;
        ahead_val[k] = ahead_idx[k] >= 0
                           ? load_relaxed(done + ahead_idx[k] * strips + strip)
                           : gen;
      }
    }
    const bool accumulate = (m.x & kAccumulate) != 0;
    T* const xd = x + (int64_t)m.y * blk;
    T old[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int qq = threadIdx.x + u * kThreads;
      const int r = qq / RB;
      const int j = qq - r * RB;
      old[u] = (accumulate && r < cs && j0 + j < R)
                   ? __ldcg(xd + (int64_t)r * R + j0 + j) : T(0);
    }
    wait_bar(smem_u32(ring + i % NB), (phase >> (i % NB)) & 1);
    phase ^= 1u << (i % NB);
    __syncthreads();  // the tile and the strip are in
    T acc[kRowsPerLane][RB];
#pragma unroll
    for (int r = 0; r < kRowsPerLane; ++r)
#pragma unroll
      for (int j = 0; j < RB; ++j) acc[r][j] = T(0);
    tile_product<T, TT, RB>(acc, buf(i), xs, cs);
    store_partials<T, RB>(ps, acc, cs);
    __syncthreads();  // every warp is done with the tile and the strip
    // the tile NB tasks on into the buffer this task freed, issued by a
    // thread the reduction below leaves idle at one column
    if (i + NB < n) load(i + NB, q[NB]);
    // the block into x and into the carrier (0 past R)
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int qq = threadIdx.x + u * kThreads;
      const int r = qq / RB;
      const int j = qq - r * RB;
      if (r < cs && j0 + j < R) {
        const T v = old[u] + warp_sum<T, RB>(ps, r, j, cs);
        xd[(int64_t)r * R + j0 + j] = v;
        xs[qq] = v;
      } else if (qq < cs * RB) {
        xs[qq] = T(0);
      }
    }
    if (i + 1 == n || (i + 1) % kRunBatch == 0) {
      // end of a batch: its stores, then one fence
      __syncthreads();
      if (threadIdx.x < 32) {
        if (i + 1 < n) {
          // the next batch's flags outside the run, seen (relaxed)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            long long polls = 0;
            while (ahead_val[k] != gen) {
              if (++polls > kSpinLimit) __trap();
              ahead_val[k] = load_relaxed(done + ahead_idx[k] * strips + strip);
            }
          }
          for (int qq = ahead_q0 + 128 + lane; qq < ahead_q1; qq += 32) {
            const int32_t* f = done + wait[qq] * strips + strip;
            long long polls = 0;
            while (load_relaxed(f) != gen) {
              if (++polls > kSpinLimit) __trap();
            }
          }
        }
        // release of this batch's blocks, acquire of those flags
        cuda::atomic_thread_fence(cuda::memory_order_acq_rel,
                                  cuda::thread_scope_device);
        for (int k = out + lane; k <= i; k += 32)
          flag_ref(done[(t0 + k) * strips + strip])
              .store(gen, cuda::memory_order_relaxed);
      }
      out = i + 1;
      if (i + 1 < n) __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < NB + 1; ++k) q[k] = q[k + 1];
  }
}

// a minimum of one block per SM: without it ptxas held the bf16 instance at
// 128 registers (two blocks per SM) and spilled its strip row; the solve is
// bound by its chain of dependent steps, not by resident blocks
template <typename T, typename TT, int RB>
__global__ void __launch_bounds__(kThreads, 1)
ldiv_fused_kernel(T* y, T* x, const T* b, const T* rs, const TT* lbank,
                  const TT* ubank, const int32_t* task, const int4* meta,
                  const int32_t* unit_ptr, const int32_t* wait_ptr,
                  const int32_t* wait, const int32_t* ent_tile,
                  const int32_t* ent_src, const int32_t* pidx,
                  const int32_t* qidx, int32_t* state, int n_tickets,
                  int strips, int64_t n, int cs, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_ticket;
  __shared__ int s_gen;
  __shared__ uint64_t s_ring[kRing];  // a run's tile buffers' mbarriers
  const int tile_elems = cs * cs;
  int32_t* done = state + kFlags;

  if (threadIdx.x == 0) {
    s_gen = flag_ref(state[kGeneration]).load(cuda::memory_order_relaxed);
    for (int k = 0; k < kRing; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   ::"r"(smem_u32(s_ring + k))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  uint32_t phase = 0;  // the parity each ring buffer's mbarrier waits for
  int gen = 0;
  for (;;) {
    if (threadIdx.x == 0) s_ticket = atomicAdd(&state[kTicket], 1);
    __syncthreads();
    const int ticket = s_ticket;
    gen = s_gen;
    if (ticket >= n_tickets) break;
    const int unit = ticket / strips;
    const int strip = ticket - unit * strips;
    const int t = unit_ptr[unit];
    const int t_end = unit_ptr[unit + 1];
    if (t_end - t > 1) {
      if constexpr (ring_tiles<T, TT, RB>() > 0)
        run_tasks<T, TT, RB>(x, lbank, ubank, meta, wait_ptr, wait, done,
                             gen, t, t_end, strips, strip, cs, R, smem_raw,
                             s_ring, phase);
      else
        __trap();  // a run given to a kernel that takes none
      continue;
    }
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
    wait_flags(wait, wait_ptr[t], wait_ptr[t + 1], done, strips, strip, gen);
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
      flag_ref(done[t * strips + strip]).store(gen,
                                               cuda::memory_order_release);
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
              const TT* ubank, const int32_t* task, const int32_t* meta,
              const int32_t* unit_ptr, const int32_t* wait_ptr,
              const int32_t* wait, const int32_t* ent_tile,
              const int32_t* ent_src, const int32_t* pidx,
              const int32_t* qidx, int32_t* state, int n_units, int64_t n,
              int cs, int R, int grid, cudaStream_t stream) {
  const cudaError_t rc = opt_in<T, TT, RB>();
  if (rc != cudaSuccess) return (int)rc;
  const int strips = (R + RB - 1) / RB;
  ldiv_fused_kernel<T, TT, RB><<<grid, kThreads, smem_bytes<T, TT, RB>(cs),
                                 stream>>>(
      y, x, b, rs, lbank, ubank, task, reinterpret_cast<const int4*>(meta),
      unit_ptr, wait_ptr, wait, ent_tile, ent_src, pidx, qidx, state,
      n_units * strips, strips, n, cs, R);
  return (int)cudaGetLastError();
}

template <typename T, typename TT>
int launch(T* y, T* x, const T* b, const T* rs, const TT* lbank,
           const TT* ubank, const int32_t* task, const int32_t* meta,
           const int32_t* unit_ptr, const int32_t* wait_ptr,
           const int32_t* wait, const int32_t* ent_tile,
           const int32_t* ent_src, const int32_t* pidx, const int32_t* qidx,
           int32_t* state, int n_units, int64_t n, int cs, int R, int RB,
           int grid, cudaStream_t stream) {
  if (cs < 1 || cs > kMaxCs || R < 1 || grid < 1 || n_units < 1 ||
      reinterpret_cast<uintptr_t>(meta) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // column strip: the width the wrapper chose (ops/fused_ldiv.py
  // strip_width); any width gives the same bits
#define LDIV_FUSED_RB(W)                                                     \
  case W:                                                                    \
    return launch_rb<T, TT, W>(y, x, b, rs, lbank, ubank, task, meta,        \
                               unit_ptr, wait_ptr, wait, ent_tile, ent_src,  \
                               pidx, qidx, state, n_units, n, cs, R, grid,   \
                               stream);
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
                          const int32_t* task, const int32_t* meta,          \
                          const int32_t* unit_ptr, const int32_t* wait_ptr,  \
                          const int32_t* wait, const int32_t* ent_tile,      \
                          const int32_t* ent_src, const int32_t* pidx,       \
                          const int32_t* qidx, int32_t* state, int n_units,  \
                          int64_t n, int cs, int R, int RB, int grid,        \
                          void* stream) {                                    \
    return launch<T, TT>(y, x, b, rs, reinterpret_cast<const TT*>(lbank),   \
                         reinterpret_cast<const TT*>(ubank), task, meta,     \
                         unit_ptr, wait_ptr, wait, ent_tile, ent_src, pidx,  \
                         qidx, state, n_units, n, cs, R, RB, grid,           \
                         (cudaStream_t)stream);                              \
  }                                                                          \
  int ldiv_fused_##suffix##_capacity(int cs, int RB) {                       \
    return capacity<T, TT>(cs, RB);                                          \
  }                                                                          \
  int ldiv_fused_##suffix##_takes_runs() { return takes_runs<T, TT>(); }

LDIV_FUSED_ENTRY(f32, float, float, float)
LDIV_FUSED_ENTRY(f64, double, double, double)
LDIV_FUSED_ENTRY(bf16, float, __nv_bfloat16, void)

}  // extern "C"
