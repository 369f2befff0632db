// Hopper bidiagonal ldiv: x = U^-1 L^-1 (Rs .* b) for bidiagonal factors
// (1-D chain matrices) as two affine prefix scans in one launch.
//
// Replaces the TPU kernel tpu_sparse_lu/ops/scan_solve.py `_ldiv_kernel`
// (entry `pallas_bidiag_ldiv`), which holds the whole vector in VMEM as
// (S, 128) planes and runs two Kogge-Stone scans of shifted multiply-adds:
//
//   forward   y_i = aL_i * y_{i-1} + sL_i * b_i    (i = 0 .. n-1)
//   backward  x_i = aU_i * x_{i+1} + sU_i * y_i    (i = n-1 .. 0)
//
// Either sweep may be skipped (a null aL or aU): one sweep alone is the
// chain's lsolve or rsolve. b and x are (n, R) row-major; every column is
// solved on its own. Maps compose as (A, C) after (Ae, Ce) =
// (A * Ae, fma(A, Ce, C)).
//
// Design. The rows are cut into T tiles of `rows` rows (the wrapper picks
// `rows`, ops/bidiag_ldiv.py `tile_rows`); a tile's rows x R values are
// contiguous in b and x. The blocks of the launch take tickets: the T
// forward tiles first, then the T backward tiles from the last rows up.
// A block, for its tile:
//   1. (backward after a forward sweep) waits for the forward tile with
//      the same rows to be written, since its c_i = sU_i * y_i;
//   2. computes the tile's aggregate map (A, C[R]) and publishes it: the
//      tile is staged in chunks of at most kChunk values in shared memory
//      (coalesced, in processing order, identity maps past the end); in a
//      chunk each thread composes up to kItems consecutive maps of one
//      column serially, a warp-shuffle scan and a scan over the column's
//      warp totals combine the threads' maps, and the chunks fold in order;
//   3. waits for the aggregates of every earlier tile of its sweep and
//      composes them in a fixed order (lanes of a warp over fixed groups of
//      predecessors, then a fixed shuffle tree) into its entry value: the
//      classic decoupled look-back would take whichever prefix had been
//      published and round differently from run to run, this does not;
//   4. walks each chunk from the entry value: each thread applies its
//      segment's exclusive map and then steps its items serially (the
//      substitution's own rounding), writes the chunk back coalesced, and
//      publishes that its rows are written.
// The result depends on the tiling only, never on the grid or the timing:
// any grid from one block gives the same bits.
//
// Ready words and graphs, as csrc/ldiv_fused.cu: `state` holds the ticket
// counter, the exit counter, the generation, then two flags per ticket
// (aggregate published, rows written), ready when equal to the generation
// read at entry. The last block out resets the counters and advances the
// generation, so the launch can be captured in a CUDA graph and replayed;
// one launch may run on a `state` at a time (the wrapper keeps one per
// stream). A block publishes with its stores, __syncthreads() and thread
// 0's gpu-scope release store; a waiting warp reads each flag with a
// gpu-scope acquire load, then __syncthreads(). Aggregates and y are
// written during the launch by other SMs, so they are read through L2
// only (ld.global.cg). A wait that never ends traps after 2^26 polls.
//
// What bounds it on the card: the bytes (four planes, b and x, and y
// written and read: about 10 us at n = 1,048,577, R = 1 on an H100) for
// long vectors; for short ones (config 1, n = 20,000) the latency of the
// chain load -> aggregate -> composition -> walk -> store, twice.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                  // most maps a thread composes
constexpr int kChunk = kThreads * kItems;   // most values of a chunk
// one padding slot per 32 values: strided reads of consecutive threads
// spread over the banks
constexpr int kPadded = kChunk + kChunk / 32;
constexpr int kLoads = kChunk / kThreads;  // values a thread stages
constexpr long long kSpinLimit = 1LL << 26;

// state words
constexpr int kTicket = 0;
constexpr int kExit = 1;
constexpr int kGeneration = 2;
constexpr int kFlags = 3;

using flag_ref = cuda::atomic_ref<int, cuda::thread_scope_device>;

__device__ __forceinline__ int slot(int q) { return q + (q >> 5); }

// threads (segments) per column for a group of g <= kThreads columns: the
// largest power of two with segments * g <= kThreads
__host__ __device__ __forceinline__ int segments(int g) {
  int s = 1;
  while (2 * s * g <= kThreads) s *= 2;
  return s;
}

template <typename T>
__device__ __forceinline__ T load_v(const T* p, bool through_l2) {
  return through_l2 ? __ldcg(p) : __ldg(p);
}

__device__ __forceinline__ void spin(int32_t* word, int gen) {
  flag_ref f(*word);
  long long polls = 0;
  while (f.load(cuda::memory_order_acquire) != gen) {
    if (++polls > kSpinLimit) __trap();
  }
}

// one thread's map within a chunk, after the scans
template <typename T>
struct Scan {
  T A, C;      // the column's maps up to and including this thread's
  T Ash, Csh;  // the warp-local inclusive map of the lane before
  T PA, PC;    // the column's earlier warps, composed
  bool lead;   // first lane of its column within the warp
  bool has_p;  // earlier warps exist
};

// stage chunk positions [0, S * Kc) x g columns of the tile in
// processing order: sa[p] = a_i, sc[p * g + j] = s_i * v[i, jg + j]. Each
// thread issues all its loads before its first store, so a chunk costs
// about one memory latency, not one per value.
template <typename T>
__device__ __forceinline__ void load_chunk(
    T* sa, T* sc, const T* a, const T* s, const T* v, bool v_l2,
    int64_t r0, int64_t r1, bool back, int64_t p0, int rc, int npos, int g,
    int jg, int R) {
  T av[kLoads], sv[kLoads], vv[kLoads];
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int p = threadIdx.x + u * kThreads;
    av[u] = T(1);
    if (p < rc) av[u] = a[back ? r1 - 1 - (p0 + p) : r0 + p0 + p];
  }
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int q = threadIdx.x + u * kThreads;
    const int p = q / g;
    sv[u] = T(0);
    vv[u] = T(0);
    if (q < npos * g && p < rc) {
      const int64_t i = back ? r1 - 1 - (p0 + p) : r0 + p0 + p;
      sv[u] = s[i];
      vv[u] = load_v(v + i * R + jg + (q - p * g), v_l2);
    }
  }
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int p = threadIdx.x + u * kThreads;
    if (p < npos) sa[slot(p)] = av[u];
  }
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int q = threadIdx.x + u * kThreads;
    if (q < npos * g) sc[slot(q)] = sv[u] * vv[u];
  }
}

// compose and scan a staged chunk: thread (j, seg) = (tid / S, tid % S)
// takes positions seg*Kc .. seg*Kc+Kc-1 of column j
template <typename T>
__device__ __forceinline__ Scan<T> scan_chunk(const T* sa, const T* sc,
                                              T* wa, T* wc, int S, int Kc,
                                              int g) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = threadIdx.x / S;
  const int seg = threadIdx.x - j * S;
  Scan<T> r;
  T A = T(1), C = T(0);
  if (j < g) {
    for (int k = 0; k < Kc; ++k) {
      const int p = seg * Kc + k;
      const T ak = sa[slot(p)];
      C = fma(ak, C, sc[slot(p * g + j)]);
      A = ak * A;
    }
  }
  const int W = S < 32 ? S : 32;
  const int wl = lane & (W - 1);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (d >= W) break;
    const T Ae = __shfl_up_sync(full, A, d, W);
    const T Ce = __shfl_up_sync(full, C, d, W);
    if (wl >= d) {
      C = fma(A, Ce, C);
      A = A * Ae;
    }
  }
  r.Ash = __shfl_up_sync(full, A, 1, W);
  r.Csh = __shfl_up_sync(full, C, 1, W);
  r.lead = wl == 0;
  r.PA = T(1);
  r.PC = T(0);
  r.has_p = false;
  if (S > 32) {  // a column spans S / 32 warps: compose the earlier ones
    if (lane == 31) {
      wa[warp] = A;
      wc[warp] = C;
    }
    __syncthreads();
    const int w0 = warp - (warp % (S / 32));
    for (int w = w0; w < warp; ++w) {
      r.PC = fma(wa[w], r.PC, wc[w]);
      r.PA = wa[w] * r.PA;
      r.has_p = true;
    }
  }
  r.A = A;
  r.C = C;
  if (r.has_p) {  // this thread's inclusive map over the whole column
    r.C = fma(A, r.PC, C);
    r.A = A * r.PA;
  }
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bidiag_kernel(T* x, const T* b, const T* aL, const T* sL, const T* aU,
              const T* sU, T* agg, int32_t* state, int64_t n, int R,
              int64_t rows, int tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sa = reinterpret_cast<T*>(smem_raw);
  T* sc = sa + kPadded;
  T* wa = sc + kPadded;
  T* wc = wa + kWarps;
  T* carry = wc + kWarps;  // two buffers of kThreads
  __shared__ int s_ticket;
  __shared__ int s_gen;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned full = 0xffffffffu;
  const bool fwd = aL != nullptr;
  const bool bwd = aU != nullptr;
  const int n_tickets = (fwd + bwd) * tiles;
  const int first_bwd = fwd ? tiles : 0;
  int32_t* done = state + kFlags;
  const int64_t stride = (int64_t)R + 1;

  if (threadIdx.x == 0)
    s_gen = flag_ref(state[kGeneration]).load(cuda::memory_order_relaxed);
  int gen = 0;
  for (;;) {
    if (threadIdx.x == 0) s_ticket = atomicAdd(&state[kTicket], 1);
    __syncthreads();
    const int ticket = s_ticket;
    gen = s_gen;
    if (ticket >= n_tickets) break;
    const bool back = bwd && ticket >= first_bwd;
    const int k = back ? ticket - first_bwd : ticket;  // place in its sweep
    const int m = back ? tiles - 1 - k : k;            // tile
    const int64_t r0 = (int64_t)m * rows;
    const int64_t r1 = r0 + rows < n ? r0 + rows : n;
    const int64_t len = r1 - r0;
    const T* a = back ? aU : aL;
    const T* s = back ? sU : sL;
    const bool after_fwd = back && fwd;
    const T* v = after_fwd ? x : b;
    T* aggs = agg + (after_fwd ? (int64_t)tiles * stride : 0);

    // 1. y of these rows, from the forward tile
    if (after_fwd) {
      if (threadIdx.x == 0) spin(&done[2 * m + 1], gen);
      __syncthreads();
    }
    // 2. the tile's aggregate, column group by column group
    const int groups = (R + kThreads - 1) / kThreads;
    bool cached = false;  // pass 1 left the one chunk and its scan in place
    Scan<T> sv;
    for (int jg = 0; jg < R; jg += kThreads) {
      const int g = R - jg < kThreads ? R - jg : kThreads;
      const int S = segments(g);
      const int64_t CR = (int64_t)S * kItems;
      const int nch = (int)((len + CR - 1) / CR);
      const int j = threadIdx.x / S;
      const bool last_seg = threadIdx.x - j * S == S - 1 && j < g;
      T tA = T(1), tC = T(0);
      for (int c = 0; c < nch; ++c) {
        const int64_t p0 = (int64_t)c * CR;
        const int rc = (int)(len - p0 < CR ? len - p0 : CR);
        const int Kc = (rc + S - 1) / S;
        load_chunk<T>(sa, sc, a, s, v, after_fwd, r0, r1, back, p0, rc,
                      S * Kc, g, jg, R);
        __syncthreads();
        sv = scan_chunk<T>(sa, sc, wa, wc, S, Kc, g);
        if (last_seg) {
          tC = fma(sv.A, tC, sv.C);
          tA = sv.A * tA;
        }
        cached = groups == 1 && nch == 1;
        if (!cached) __syncthreads();  // before the next chunk's loads
      }
      if (last_seg) {
        aggs[(int64_t)k * stride + 1 + jg + j] = tC;
        if (jg == 0 && j == 0) aggs[(int64_t)k * stride] = tA;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0)
      flag_ref(done[2 * ticket]).store(gen, cuda::memory_order_release);

    // 3. every earlier tile's aggregate of this sweep, a lane per flag
    if (warp == 0) {
      for (int q = lane; q < k; q += 32) spin(&done[2 * (ticket - k + q)],
                                                gen);
    }
    __syncthreads();

    // 4. per column group: the entry values, then the walk
    for (int jg = 0; jg < R; jg += kThreads) {
      const int g = R - jg < kThreads ? R - jg : kThreads;
      const int S = segments(g);
      const int64_t CR = (int64_t)S * kItems;
      const int nch = (int)((len + CR - 1) / CR);
      const int j = threadIdx.x / S;
      const int seg = threadIdx.x - j * S;
      // composed in a fixed order: lane l takes predecessors
      // [l * per, (l + 1) * per), then a shuffle tree in lane order
      const int per = (k + 31) / 32;
      for (int jj = warp; jj < g; jj += kWarps) {
        const int q1 = (lane + 1) * per < k ? (lane + 1) * per : k;
        T MA = T(1), MC = T(0);
#pragma unroll 4
        for (int q = lane * per; q < q1; ++q) {
          const T* ag = aggs + (int64_t)q * stride;
          const T Aq = __ldcg(ag);
          MC = fma(Aq, MC, __ldcg(ag + 1 + jg + jj));
          MA = Aq * MA;
        }
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const T RA = __shfl_down_sync(full, MA, d);
          const T RC = __shfl_down_sync(full, MC, d);
          if ((lane & (2 * d - 1)) == 0) {
            MC = fma(RA, MC, RC);
            MA = RA * MA;
          }
        }
        if (lane == 0) carry[jj] = MC;  // the map applied to 0
      }
      __syncthreads();
      for (int c = 0; c < nch; ++c) {
        const int64_t p0 = (int64_t)c * CR;
        const int rc = (int)(len - p0 < CR ? len - p0 : CR);
        const int Kc = (rc + S - 1) / S;
        if (!cached) {
          load_chunk<T>(sa, sc, a, s, v, after_fwd, r0, r1, back, p0, rc,
                        S * Kc, g, jg, R);
          __syncthreads();
          sv = scan_chunk<T>(sa, sc, wa, wc, S, Kc, g);
        }
        const T* cin = carry + (c & 1) * kThreads;
        T* cout = carry + ((c + 1) & 1) * kThreads;
        if (j < g) {
          T y = cin[j];
          if (sv.has_p) y = fma(sv.PA, y, sv.PC);
          if (!sv.lead) y = fma(sv.Ash, y, sv.Csh);
          for (int kk = 0; kk < Kc; ++kk) {
            const int p = seg * Kc + kk;
            const int qq = slot(p * g + j);
            y = fma(sa[slot(p)], y, sc[qq]);
            sc[qq] = y;
          }
          // past the end the maps are identities: the last segment ends on
          // the value of the chunk's last row
          if (seg == S - 1) cout[j] = y;
        }
        __syncthreads();
        for (int q = threadIdx.x; q < rc * g; q += kThreads) {
          const int p = q / g;
          const int jj = q - p * g;
          const int64_t i = back ? r1 - 1 - (p0 + p) : r0 + p0 + p;
          x[i * R + jg + jj] = sc[slot(q)];
        }
        __syncthreads();  // before the next chunk overwrites sa, sc, carry
      }
    }
    if (threadIdx.x == 0)
      flag_ref(done[2 * ticket + 1]).store(gen, cuda::memory_order_release);
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
constexpr size_t smem_bytes() {
  return (2 * (size_t)kPadded + 2 * kWarps + 2 * kThreads) * sizeof(T);
}

template <typename T>
cudaError_t opt_in() {
  // 36 KB (float32) / 72 KB (float64): above 48 KB only after opting in
  static const cudaError_t rc = cudaFuncSetAttribute(
      bidiag_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<T>());
  return rc;
}

template <typename T>
int capacity() {
  cudaError_t rc = opt_in<T>();
  if (rc != cudaSuccess) return -(int)rc;
  int dev = 0, sms = 0, per_sm = 0;
  if ((rc = cudaGetDevice(&dev)) != cudaSuccess) return -(int)rc;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return -(int)rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bidiag_kernel<T>, kThreads, smem_bytes<T>());
  if (rc != cudaSuccess) return -(int)rc;
  return per_sm * sms;
}

template <typename T>
int launch_bidiag(T* x, const T* b, const T* aL, const T* sL, const T* aU,
                  const T* sU, T* agg, int32_t* state, int64_t n, int R,
                  int64_t rows, int grid, cudaStream_t stream) {
  if (n < 0 || R < 1 || rows < 1 || grid < 1 ||
      (aL == nullptr && aU == nullptr) ||
      (aL != nullptr && sL == nullptr) || (aU != nullptr && sU == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int64_t tiles = (n + rows - 1) / rows;
  const int64_t tickets = ((aL != nullptr) + (aU != nullptr)) * tiles;
  if (tickets > INT_MAX / 2) return (int)cudaErrorInvalidValue;
  const cudaError_t rc = opt_in<T>();
  if (rc != cudaSuccess) return (int)rc;
  const int blocks = grid < tickets ? grid : (int)tickets;
  bidiag_kernel<T><<<blocks, kThreads, smem_bytes<T>(), stream>>>(
      x, b, aL, sL, aU, sU, agg, state, n, R, rows, (int)tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bidiag_ldiv_f32(float* x, const float* b, const float* aL,
                    const float* sL, const float* aU, const float* sU,
                    float* agg, int32_t* state, int64_t n, int R,
                    int64_t rows, int grid, void* stream) {
  return launch_bidiag<float>(x, b, aL, sL, aU, sU, agg, state, n, R, rows,
                              grid, (cudaStream_t)stream);
}

int bidiag_ldiv_f64(double* x, const double* b, const double* aL,
                    const double* sL, const double* aU, const double* sU,
                    double* agg, int32_t* state, int64_t n, int R,
                    int64_t rows, int grid, void* stream) {
  return launch_bidiag<double>(x, b, aL, sL, aU, sU, agg, state, n, R, rows,
                               grid, (cudaStream_t)stream);
}

int bidiag_ldiv_f32_capacity(void) { return capacity<float>(); }
int bidiag_ldiv_f64_capacity(void) { return capacity<double>(); }

}  // extern "C"
