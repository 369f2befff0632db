// Hopper blocked elimination: the whole device LU of the merged tile store
// in one persistent launch.
//
// Replaces the TPU kernel tpu_sparse_lu/ops/pallas_elim.py `_kernel`
// (entry `fused_elimination`), one program whose sequential grid runs a
// level a step with the store resident in VMEM: the level's diagonal LUs
// and both inverses, its row and column panels, its Schur updates. Here
// the same work is a list of tasks the host builds once per plan
// (ops/elim_fused.py `build_elim_tasks`), in level order:
//
//   LU      one real diagonal tile d of a level: merged L\U in place,
//           min |pivot| into piv[p], L^-1 and U^-1 into linv[s], uinv[s]
//           (csrc/lu_tile.cuh, lu_tile_kernel's body, all 512 threads);
//   rows    A_ik <- A_ik . uinv[s]    (one destination tile a task)
//   cols    A_kj <- linv[s] . A_kj    (one destination tile a task)
//   Schur   A_ij <- A_ij - sum_e L_ik(e) . U_kj(e), one destination a task
//           (RefactorPlan.schur_groups), the entries in the plan's order.
//
// A product task is split into sub-tiles of the shape its flags name
// (whole rows for a row panel, whole columns for a column panel, so an
// in-place sub-tile reads only what it writes; any split for Schur), and
// a ticket is task x sub-tile: the block's first 256 threads run
// csrc/tile_mm.cuh's product body (tile_mm_kernel's) on it, with a named
// barrier of their own, while the other 256 wait. The thin shapes are
// bound by the SM's shared-memory bandwidth, so two sub-tiles on one SM
// took twice as long as one (tools/elim_sweep.py --clocks, PERF.md): one
// a ticket does the same work a second sooner on the chain of diagonal
// tiles. An element is one FMA chain over the
// task's entries and k ascending, as in tile_mm, and the LU is lu_tile's
// code, so the launch equals the per-level route (lu_tile, then tile_mm
// three times a level) bit for bit, at any grid and any sub-tile shape.
//
// Each task waits for every ticket of the earlier tasks it conflicts with
// over store tiles and inverse slots (read after write, write after write,
// write after read). The launch has as many blocks as the card holds at
// once (one a SM), or the grid the caller asks for. Each block loops:
// take the next ticket with atomicAdd (tickets, not blockIdx: blocks do
// not start in order; a block waits only on tickets that running blocks
// already hold, so the launch cannot deadlock at any grid, down to one
// block); wait on its dependencies' ready flags, a lane a flag; run the
// task; publish its flag.
//
// Ready flags and graphs, as csrc/ldiv_fused.cu: `state` holds the ticket
// counter, the exit counter, the generation, and one flag per ticket. A
// flag is ready when it equals the generation the block read at entry;
// the last block to leave resets both counters and advances the
// generation, so nothing is reset from the host and the launch may be
// captured in a CUDA graph and replayed. One launch at a time on a
// `state`: the wrapper keeps one per stream.
//
// Memory ordering. A task publishes with: all threads' stores,
// __syncthreads(), thread 0's gpu-scope release store of its flag. A
// waiting warp reads each flag with a gpu-scope acquire load, then
// __syncthreads(). The store and the inverse stacks are rewritten by other
// SMs during the launch, so every read of them goes through L2 only
// (ld.global.cg, cp.async.cg), never through L1, which could return a line
// this SM cached for an earlier task. The index arrays never change.
// A waiting lane sleeps ~256 ns between polls. A wait that never ends (a
// schedule fault) traps after 2^26 polls (~20-40 s), so it shows as a
// launch error and not as a hang.
//
// What bounds it on the card: the chain of diagonal tiles. Each level's LU
// runs on one SM (~74 us a 128 x 128 tile in float32, as lu_tile; the
// first of a launch ~115 us), and the next level's LU waits for it, a
// panel sub-tile and the Schur sub-tile into its own tile (~22 us of
// products a level: the thin shapes are bound by the SM's shared-memory
// wavefronts): 8 LUs in a row at the 2D Poisson 100x100 nd headline, 29
// in BASELINE config 2, 69% and 76% of the critical path (an H100,
// tools/elim_sweep.py --clocks, PERF.md). The FLOP and bytes (~45 us at
// the headline) hide under that chain. The ticket order is a list
// schedule of the task graph on the card's SMs (ops/elim_fused.py), so a
// block seldom holds a ticket whose dependencies are far from done while
// ready work waits behind it. A diagnostic build (-DELIM_FUSED_CLOCKS,
// tools/elim_sweep.py --clocks) records per ticket when it was taken,
// when its dependencies were ready and when it was done (%globaltimer),
// its wait and run in SM cycles, and its SM.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "lu_tile.cuh"
#include "tile_mm.cuh"

namespace {

constexpr int kThreads = lut::kThreads;  // the LU's 512; a product 256
static_assert(kThreads >= tmm::kThreads, "a product's threads a block");
constexpr int kMaxCs = lut::kMaxCs;
constexpr long long kSpinLimit = 1LL << 26;
// the pause between two polls of a flag: the waiting blocks (most of the
// grid, while a diagonal LU runs) would otherwise keep the flag's L2
// slice busy under the running tasks' loads and stores
constexpr unsigned kPollNs = 256;

// task words (ops/elim_fused.py): flags (kind | shape << kShapeShift),
// destination tile, entries e0:e1 (products), inverse slot and pivot
// index (LU)
constexpr int kTaskWords = 6;
constexpr int kKindMask = 15;
constexpr int kShapeShift = 4;
enum { kLu = 0, kRows = 1, kCols = 2, kSchur = 3 };

// state words
constexpr int kTicket = 0;
constexpr int kExit = 1;
constexpr int kGeneration = 2;
constexpr int kFlags = 3;

// words a ticket of the clock build records
constexpr int kClockWords = 6;

using flag_ref = cuda::atomic_ref<int, cuda::thread_scope_device>;

// product sub-tile shapes (BM, BN) by code (ops/elim_fused.py
// FUSED_SHAPES): rows, columns, Schur. At most 16 elements a thread (2 x 8,
// 8 x 2, 4 x 4), so no shape needs more registers than the LU's 128.
constexpr int kNumShapes = 7;
constexpr int kShapeBM[kNumShapes] = {32, 16, 128, 128, 64, 32, 32};
constexpr int kShapeBN[kNumShapes] = {128, 128, 32, 16, 64, 64, 32};

// shared memory of a product's ring, the largest shape's
constexpr int product_smem() {
  int m = 0;
  for (int s = 0; s < kNumShapes; ++s) {
    const int b = tmm::smem_bytes(kShapeBM[s], kShapeBN[s]);
    m = b > m ? b : m;
  }
  return m;
}
constexpr int kProductSmem = product_smem();

template <typename T>
size_t smem_bytes(int cs) {
  const size_t lu = lut::tile_bytes<T>(cs);
  return lu > (size_t)kProductSmem ? lu : (size_t)kProductSmem;
}

#ifdef ELIM_FUSED_CLOCKS
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

// The task bodies are called, not inlined: each then gets the registers
// it would have as a kernel of its own (128 a thread), where inlined into
// the ticket loop the LU spilled in its inner loops. Each declares the
// shared memory it uses itself, so its loads and stores stay shared-space
// ones and not generic.

// one diagonal tile: lu_tile_kernel's body
template <typename T>
__device__ __noinline__ void lu_task(T* tile, T* piv, T* lo, T* up,
                                     int cs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T diag[kMaxCs];  // the pivots u_ii
  lut::lu_tile_block<T, true>(reinterpret_cast<T*>(smem_raw), diag, tile,
                              piv, lo, up, cs);
}

// sub-tile q of a task's BM x BN split, by the block's first
// tmm::kThreads threads (named barrier 1)
template <typename T, int BM, int BN>
__device__ __noinline__ void product_task(T* ot, const T* a, const T* b,
                                          const int32_t* ent_a,
                                          const int32_t* ent_b, int e0,
                                          int e1, int cs, int q,
                                          bool subtract, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tiles_n = (cs + BN - 1) / BN;
  tmm::product<T, BM, BN, true>(ot, a, b, ent_a, ent_b, e0, e1, cs,
                                (q / tiles_n) * BM, (q % tiles_n) * BN,
                                subtract, vec, smem_raw, threadIdx.x,
                                tmm::NamedSync{1});
}

template <typename T>
__device__ __forceinline__ void run_product(int shape, T* ot, const T* a,
                                            const T* b, const int32_t* ent_a,
                                            const int32_t* ent_b, int e0,
                                            int e1, int cs, int q,
                                            bool subtract, bool vec) {
#define ELIM_FUSED_SHAPE(S)                                                   \
  case S:                                                                     \
    product_task<T, kShapeBM[S], kShapeBN[S]>(ot, a, b, ent_a, ent_b, e0, e1, \
                                              cs, q, subtract, vec);          \
    break;
  switch (shape) {
    ELIM_FUSED_SHAPE(0)
    ELIM_FUSED_SHAPE(1)
    ELIM_FUSED_SHAPE(2)
    ELIM_FUSED_SHAPE(3)
    ELIM_FUSED_SHAPE(4)
    ELIM_FUSED_SHAPE(5)
    ELIM_FUSED_SHAPE(6)
    default:
      __trap();  // a shape code this file does not build
  }
#undef ELIM_FUSED_SHAPE
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
elim_fused_kernel(T* store, T* linv, T* uinv, T* piv,
                  const int32_t* __restrict__ task,
                  const int32_t* __restrict__ tick0,
                  const int32_t* __restrict__ ticket_task,
                  const int32_t* __restrict__ dep_ptr,
                  const int32_t* __restrict__ dep,
                  const int32_t* __restrict__ ent_a,
                  const int32_t* __restrict__ ent_b, int32_t* state,
                  long long* clocks, int n_tickets, int cs, int vec) {
  __shared__ int s_ticket;
  __shared__ int s_gen;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t te = (int64_t)cs * cs;
  int32_t* done = state + kFlags;
  (void)clocks;

  if (threadIdx.x == 0)
    s_gen = flag_ref(state[kGeneration]).load(cuda::memory_order_relaxed);
  int gen = 0;
  for (;;) {
    if (threadIdx.x == 0) s_ticket = atomicAdd(&state[kTicket], 1);
    __syncthreads();
    const int ticket = s_ticket;
    gen = s_gen;
    if (ticket >= n_tickets) break;
#ifdef ELIM_FUSED_CLOCKS
    const long long t_take = global_ns(), c_take = clock64();
#endif
    const int t = ticket_task[ticket];
    const int32_t* w = task + kTaskWords * t;
    const int flags = w[0];
    const int64_t dst = w[1];

    // 1. the ready flags of every ticket it waits for, a lane each
    if (warp == 0) {
      const int q1 = dep_ptr[t + 1];
      for (int q = dep_ptr[t] + lane; q < q1; q += 32) {
        flag_ref f(done[dep[q]]);
        long long polls = 0;
        while (f.load(cuda::memory_order_acquire) != gen) {
          if (++polls > kSpinLimit) __trap();
          __nanosleep(kPollNs);
        }
      }
    }
    __syncthreads();
#ifdef ELIM_FUSED_CLOCKS
    const long long t_ready = global_ns(), c_ready = clock64();
#endif
    // 2. the task
    const int kind = flags & kKindMask;
    if (kind == kLu) {
      const int64_t slot = w[4];
      lu_task<T>(store + dst * te, piv + w[5], linv + slot * te,
                 uinv + slot * te, cs);
    } else if (threadIdx.x < tmm::kThreads) {
      run_product<T>(flags >> kShapeShift, store + dst * te,
                     kind == kCols ? linv : store,
                     kind == kRows ? uinv : store, ent_a, ent_b, w[2], w[3],
                     cs, ticket - tick0[t], kind == kSchur, vec != 0);
    }
    // 3. publish: the barrier orders every thread's stores before thread
    // 0's release, which makes them visible at gpu scope with the flag
    __syncthreads();
    if (threadIdx.x == 0) {
      flag_ref(done[ticket]).store(gen, cuda::memory_order_release);
#ifdef ELIM_FUSED_CLOCKS
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      long long* c = clocks + (int64_t)kClockWords * ticket;
      c[0] = t_take;
      c[1] = t_ready;
      c[2] = global_ns();
      c[3] = c_ready - c_take;
      c[4] = clock64() - c_ready;
      c[5] = sm;
#endif
    }
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

template <typename T>
cudaError_t opt_in() {
  // above 48 KB only after opting in, once per type, for the largest tile
  // (66 KB float32, 130 KB float64 at cs = 128)
  static const cudaError_t rc = cudaFuncSetAttribute(
      elim_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<T>(kMaxCs));
  return rc;
}

template <typename T>
int capacity(int cs) {
  if (cs < 1 || cs > kMaxCs) return -(int)cudaErrorInvalidValue;
  cudaError_t rc = opt_in<T>();
  if (rc != cudaSuccess) return -(int)rc;
  int dev = 0, sms = 0, per_sm = 0;
  if ((rc = cudaGetDevice(&dev)) != cudaSuccess) return -(int)rc;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return -(int)rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, elim_fused_kernel<T>, kThreads, smem_bytes<T>(cs));
  if (rc != cudaSuccess) return -(int)rc;
  return per_sm * sms;
}

template <typename T>
int launch(T* store, T* linv, T* uinv, T* piv, const int32_t* task,
           const int32_t* tick0, const int32_t* ticket_task,
           const int32_t* dep_ptr, const int32_t* dep, const int32_t* ent_a,
           const int32_t* ent_b, int32_t* state, long long* clocks,
           int n_tickets, int cs, int grid, cudaStream_t stream) {
  if (cs < 1 || cs > kMaxCs || grid < 1 || n_tickets < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t rc = opt_in<T>();
  if (rc != cudaSuccess) return (int)rc;
  constexpr int V = 16 / sizeof(T);
  const int vec = cs % V == 0 &&
                  reinterpret_cast<uintptr_t>(store) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(linv) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(uinv) % 16 == 0;
  elim_fused_kernel<T><<<grid, kThreads, smem_bytes<T>(cs), stream>>>(
      store, linv, uinv, piv, task, tick0, ticket_task, dep_ptr, dep, ent_a,
      ent_b, state, clocks, n_tickets, cs, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// clocks: kClockWords int64 a ticket, written only by the
// -DELIM_FUSED_CLOCKS build (may be null otherwise)
#define ELIM_FUSED_ENTRY(suffix, T)                                          \
  int elim_fused_##suffix(T* store, T* linv, T* uinv, T* piv,               \
                          const int32_t* task, const int32_t* tick0,         \
                          const int32_t* ticket_task,                        \
                          const int32_t* dep_ptr, const int32_t* dep,        \
                          const int32_t* ent_a, const int32_t* ent_b,        \
                          int32_t* state, long long* clocks, int n_tickets,  \
                          int cs, int grid, void* stream) {                  \
    return launch<T>(store, linv, uinv, piv, task, tick0, ticket_task,       \
                     dep_ptr, dep, ent_a, ent_b, state, clocks, n_tickets,   \
                     cs, grid, (cudaStream_t)stream);                        \
  }                                                                          \
  int elim_fused_##suffix##_capacity(int cs) { return capacity<T>(cs); }

ELIM_FUSED_ENTRY(f32, float)
ELIM_FUSED_ENTRY(f64, double)

int elim_fused_clock_words(void) {
#ifdef ELIM_FUSED_CLOCKS
  return kClockWords;
#else
  return 0;
#endif
}

}  // extern "C"
