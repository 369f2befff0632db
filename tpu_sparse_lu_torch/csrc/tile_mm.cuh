// The register-tiled SIMT tile product of the blocked elimination, as a
// device function of 256 threads: the body of tile_mm_kernel (csrc/elim.cu,
// whose header describes the design) and the panel and Schur tasks of
// elim_fused_kernel (csrc/elim_fused.cu), where each half of a 512-thread
// block runs it on its own sub-tile. Included by both; nothing here is a
// kernel.
//
// With L2Only every read of the operands and of the destination goes
// through L2 only (cp.async.cg, ld.global.cg): in the one-launch
// elimination other SMs rewrite tiles during the launch, and an L1 line
// this SM cached for an earlier task would be stale. tile_mm_kernel
// copies with cp.async.ca and reads with plain loads. An element of the
// result is one FMA chain
// over the group's entries in order and, within an entry, over k
// ascending, whatever the sub-tile shape, so every shape and both kernels
// give the same bits.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tmm {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kMaxCs = 128;
constexpr int kStages = 3;     // k-slices in flight

// bytes of shared memory of a BM x BN sub-tile's ring of k-slices: 64
// bytes a row of either operand a stage
__host__ __device__ constexpr int smem_bytes(int bm, int bn) {
  return kStages * (bm + bn) * 64;
}

// The group's barrier: the whole block (the standalone kernel), or named
// barrier `id` over the kThreads threads of one half of a larger block
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
struct NamedSync {
  int id;
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
  }
};

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

// 16 bytes from global into shared memory, asynchronously: through L2
// only (cp.async.cg) or also through L1 (cp.async.ca)
template <bool L2Only>
__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  if constexpr (L2Only) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  } else {
    __pipeline_memcpy_async(smem, gmem, 16);
  }
}

// one element: a load through L2 only and a store (cp.async.cg takes 16
// bytes alone), or an asynchronous copy through L1
template <bool L2Only, typename T>
__device__ __forceinline__ void copy1(T* smem, const T* gmem) {
  if constexpr (L2Only)
    *smem = __ldcg(gmem);
  else
    __pipeline_memcpy_async(smem, gmem, sizeof(T));
}

// Issue the copies of k-slice `kk` of one entry: rows [m0, m0 + BM) of
// the a tile and columns [n0, n0 + BN) of the b tile. Out-of-tile
// elements are stored as zeros, so they add nothing. tid: the thread's
// index in the group of kThreads.
template <typename T, int BM, int BN, bool L2Only>
__device__ __forceinline__ void stage_slice(T* sA, T* sB, const T* at,
                                            const T* bt, int cs, int m0,
                                            int n0, int kk, bool vec,
                                            int tid) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int BK = 4 * V;          // k per slice: four chunks
  if (vec) {  // cs % V == 0 and 16-byte aligned tiles: whole chunks
    for (int q = tid; q < BM * 4; q += kThreads) {
      const int r = q >> 2, c = q & 3;
      T* d = sA + r * BK + ((c ^ swz(r)) * V);
      const int gr = m0 + r, gk = kk + c * V;
      if (gr < cs && gk < cs)
        copy16<L2Only>(d, at + (int64_t)gr * cs + gk);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
    constexpr int CPR = BN / V;  // chunks per b row
    for (int q = tid; q < BK * CPR; q += kThreads) {
      const int r = q / CPR, c = q - r * CPR;
      T* d = sB + r * BN + c * V;
      const int gk = kk + r, gc = n0 + c * V;
      if (gk < cs && gc < cs)
        copy16<L2Only>(d, bt + (int64_t)gk * cs + gc);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  } else {  // any cs: one element per copy
    for (int q = tid; q < BM * BK; q += kThreads) {
      const int r = q / BK, k = q - r * BK;
      T* d = sA + r * BK + (((k / V) ^ swz(r)) * V) + k % V;
      const int gr = m0 + r, gk = kk + k;
      if (gr < cs && gk < cs)
        copy1<L2Only>(d, at + (int64_t)gr * cs + gk);
      else
        *d = T(0);
    }
    for (int q = tid; q < BK * BN; q += kThreads) {
      const int r = q / BN, c = q - r * BN;
      const int gk = kk + r, gc = n0 + c;
      if (gk < cs && gc < cs)
        copy1<L2Only>(sB + q, bt + (int64_t)gk * cs + gc);
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

// The BM x BN sub-tile at (m0, n0) of one group by kThreads threads (tid
// 0 .. kThreads-1, barrier `sync`):
//   ot = (ot -)? sum_{e = e0}^{e1-1} a[a_idx[e]] . b[b_idx[e]]
// te = cs * cs; smem: smem_bytes(BM, BN) bytes, 16-byte aligned. The ring
// of k-slices runs across the entries: the next entry's first slice loads
// during this entry's last.
template <typename T, int BM, int BN, bool L2Only, typename Sync>
__device__ __forceinline__ void product(T* ot, const T* a, const T* b,
                                        const int32_t* a_idx,
                                        const int32_t* b_idx, int e0, int e1,
                                        int cs, int m0, int n0, bool subtract,
                                        bool vec, unsigned char* smem,
                                        int tid, Sync sync) {
  constexpr int V = 16 / sizeof(T), BK = 4 * V;
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int VM = TM < 4 ? TM : 4, VN = TN < 4 ? TN : 4;
  T* sA = reinterpret_cast<T*>(smem);  // [kStages][BM][BK]
  T* sB = sA + kStages * BM * BK;      // [kStages][BK][BN]
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t te = (int64_t)cs * cs;
  const int nk = (cs + BK - 1) / BK;
  const int total = (e1 - e0) * nk;  // slices over all entries

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
      stage_slice<T, BM, BN, L2Only>(sA + st * BM * BK, sB + st * BK * BN,
                             a + (int64_t)a_idx[e] * te,
                             b + (int64_t)b_idx[e] * te, cs, m0, n0,
                             (s % nk) * BK, vec, tid);
    }
    __pipeline_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < total; ++s) {
    __pipeline_wait_prior(kStages - 2);  // slice s has landed
    // every thread's copies of slice s are visible, and every thread is
    // done with slice s - 1, whose buffer the next issue refills
    sync();
    issue(s + kStages - 1);
    const int st = s % kStages;
    mma_slice<T, BM, BN>(sA + st * BM * BK, sB + st * BK * BN, acc, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = m0 + (i / VM) * 16 * VM + ty * VM + i % VM;
    if (gr >= cs) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = n0 + (j / VN) * 16 * VN + tx * VN + j % VN;
      if (gc >= cs) continue;
      T* p = ot + (int64_t)gr * cs + gc;
      *p = subtract ? (L2Only ? __ldcg(p) : *p) - acc[i][j] : acc[i][j];
    }
  }
}

}  // namespace tmm
}  // namespace
