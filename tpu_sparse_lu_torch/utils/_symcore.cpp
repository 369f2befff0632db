// _symcore — native core of the host planner: counterpart of
// tpu_sparse_lu/utils/_symcore.cpp with a plain C interface.
//
// The arithmetic and the output order are the JAX package's, so the plans
// are bit-identical to its native core and to the NumPy planner
// (symbolic.py, refactor.py), which stays the plain version. The entries
// are loaded with ctypes (utils/_symcore_build.py) instead of being a
// CPython extension: no Python.h and no NumPy headers are needed to build
// them. Arrays are caller-allocated; where a size is known only inside,
// the entry returns a handle holding the result and its size, and a
// second entry copies it into the caller's arrays and frees it.
//
//   symcore_level_schedule(brow, bcol, T, K, lower, level[K])
//       Longest-path level of each chunk in the tile DAG. `brow` must be
//       sorted ascending (tiles keyed brow*K+bcol, as symbolic.py emits).
//
//   symcore_blocked_fill(brow, bcol, m, K, &count) -> handle
//   symcore_take_pairs(handle, rows[count], cols[count])
//       Closure of a tile pattern under blocked elimination:
//       (i,k),(k,j) present with i,j>k  =>  (i,j) present; all diagonal
//       tiles included. Sorted-unique tile coordinates.
//
//   symcore_plan_keys(indptr, indices, idx64, n, cs, K, lower, extra,
//                     n_extra, &T, &bad) -> handle
//   symcore_plan_fill(handle, indptr, indices, idx64, n, cs, K,
//                     keys[T], diag_dest[nnz], offdiag_dest[nnz])
//       The O(nnz) middle of plan_triangular in two passes: the sorted
//       unique off-diagonal tile keys (brow*K + bcol, merged with
//       `extra`), then the per-nonzero pack scatter destinations (exactly
//       one of diag/offdiag is real; the other holds the one-past-the-end
//       drop sentinel). `idx64` says whether indptr/indices are int64
//       (else int32); they are read in place. `bad` counts entries on the
//       wrong side of the diagonal (the handle is then null).
//
//   symcore_free(handle, kind)
//       Frees a handle that was not taken (kind 0: blocked_fill's,
//       1: plan_keys').

#include <algorithm>
#include <cstdint>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Pairs {
  std::vector<int64_t> keys;
  int64_t K;
};

struct Keys {
  std::vector<int64_t> uniq;
};

// int32 or int64 index array read in place
struct Idx {
  const int32_t* d32;
  const int64_t* d64;
  Idx(const void* p, int is64)
      : d32(is64 ? nullptr : static_cast<const int32_t*>(p)),
        d64(is64 ? static_cast<const int64_t*>(p) : nullptr) {}
  inline int64_t operator[](int64_t i) const {
    return d64 ? d64[i] : static_cast<int64_t>(d32[i]);
  }
};

// runtime 64-bit idiv costs ~20-40 cycles and runs 3-4x per nonzero: use
// shift/mask for the (usual) power-of-two chunk sizes
struct ChunkDiv {
  int64_t cs, mask;
  int shift;
  bool pow2;
  explicit ChunkDiv(int64_t c)
      : cs(c), mask(c - 1),
        shift(c > 0 ? __builtin_ctzll(static_cast<unsigned long long>(c)) : 0),
        pow2(c > 0 && (c & (c - 1)) == 0) {}
  inline int64_t div(int64_t v) const { return pow2 ? (v >> shift) : (v / cs); }
  inline int64_t mod(int64_t v) const { return pow2 ? (v & mask) : (v % cs); }
};

}  // namespace

extern "C" {

int symcore_level_schedule(const int64_t* ub, const int64_t* uc, int64_t T,
                           int64_t K, int lower, int64_t* level) {
  std::fill(level, level + K, 0);
  // per-chunk dependency runs: ub sorted ascending
  std::vector<int64_t> start(static_cast<size_t>(K) + 1, 0);
  {
    int64_t p = 0;
    for (int64_t k = 0; k <= K; ++k) {
      while (p < T && ub[p] < k) ++p;
      start[static_cast<size_t>(k)] = p;
    }
  }
  auto relax = [&](int64_t k) {
    int64_t lk = 0;
    for (int64_t p = start[static_cast<size_t>(k)];
         p < start[static_cast<size_t>(k) + 1]; ++p) {
      const int64_t d = level[uc[p]] + 1;
      if (d > lk) lk = d;
    }
    level[k] = lk;
  };
  if (lower) {
    for (int64_t k = 0; k < K; ++k) relax(k);
  } else {
    for (int64_t k = K - 1; k >= 0; --k) relax(k);
  }
  return 0;
}

void* symcore_blocked_fill(const int64_t* br, const int64_t* bc, int64_t m,
                           int64_t K, int64_t* count) {
  std::unordered_set<int64_t> seen;
  seen.reserve(static_cast<size_t>(m) * 2 + static_cast<size_t>(K));
  std::vector<std::vector<int64_t>> col_of(static_cast<size_t>(K));  // rows i>j per col j
  std::vector<std::vector<int64_t>> row_of(static_cast<size_t>(K));  // cols j>i per row i
  auto insert = [&](int64_t i, int64_t j) {
    if (!seen.insert(i * K + j).second) return;
    if (i > j)
      col_of[static_cast<size_t>(j)].push_back(i);
    else if (i < j)
      row_of[static_cast<size_t>(i)].push_back(j);
  };
  for (int64_t k = 0; k < K; ++k) insert(k, k);
  for (int64_t t = 0; t < m; ++t) insert(br[t], bc[t]);

  for (int64_t k = 0; k < K; ++k) {
    // copy: insert() may grow these vectors for later k only, but the
    // current k's lists must be snapshotted against reallocation
    const std::vector<int64_t> rows = col_of[static_cast<size_t>(k)];
    const std::vector<int64_t> cols = row_of[static_cast<size_t>(k)];
    for (int64_t i : rows)
      for (int64_t j : cols) insert(i, j);
  }
  Pairs* out = new Pairs{std::vector<int64_t>(seen.begin(), seen.end()), K};
  std::sort(out->keys.begin(), out->keys.end());
  *count = static_cast<int64_t>(out->keys.size());
  return out;
}

void symcore_take_pairs(void* handle, int64_t* rows, int64_t* cols) {
  Pairs* h = static_cast<Pairs*>(handle);
  const size_t n = h->keys.size();
  for (size_t t = 0; t < n; ++t) {
    rows[t] = h->keys[t] / h->K;
    cols[t] = h->keys[t] % h->K;
  }
  delete h;
}

void* symcore_plan_keys(const void* indptr_p, const void* indices_p,
                        int idx64, int64_t n, int64_t cs, int64_t K,
                        int lower, const int64_t* extra, int64_t n_extra,
                        int64_t* T_out, int64_t* bad_out) {
  const Idx indptr(indptr_p, idx64), rows(indices_p, idx64);
  const ChunkDiv c(cs);
  // CSC row indices are sorted within a column, so consecutive nonzeros
  // usually share a tile: a last-key cache skips most hash inserts
  std::unordered_set<int64_t> tiles;
  tiles.reserve(4096);
  for (int64_t t = 0; t < n_extra; ++t) tiles.insert(extra[t]);
  int64_t bad = 0;
  for (int64_t j = 0; j < n; ++j) {
    const int64_t bcol = c.div(j);
    int64_t last_key = -1;
    for (int64_t p = indptr[j]; p < indptr[j + 1]; ++p) {
      const int64_t brow = c.div(rows[p]);
      if (brow == bcol) continue;
      if (lower ? (brow > bcol) : (brow < bcol)) {
        const int64_t key = brow * K + bcol;
        if (key != last_key) {
          tiles.insert(key);
          last_key = key;
        }
      } else {
        ++bad;
      }
    }
  }
  *bad_out = bad;
  if (bad) {
    *T_out = 0;
    return nullptr;
  }
  Keys* out = new Keys{std::vector<int64_t>(tiles.begin(), tiles.end())};
  std::sort(out->uniq.begin(), out->uniq.end());
  *T_out = static_cast<int64_t>(out->uniq.size());
  return out;
}

void symcore_plan_fill(void* handle, const void* indptr_p,
                       const void* indices_p, int idx64, int64_t n,
                       int64_t cs, int64_t K, int64_t* keys, int64_t* dd,
                       int64_t* od) {
  Keys* h = static_cast<Keys*>(handle);
  const Idx indptr(indptr_p, idx64), rows(indices_p, idx64);
  const ChunkDiv c(cs);
  const int64_t T = static_cast<int64_t>(h->uniq.size());
  std::unordered_map<int64_t, int64_t> tid;
  tid.reserve(h->uniq.size() * 2);
  for (int64_t t = 0; t < T; ++t) {
    keys[t] = h->uniq[static_cast<size_t>(t)];
    tid.emplace(keys[t], t);
  }
  delete h;
  // pack scatter destinations (drop sentinel = one-past-the-end)
  const int64_t diag_sent = (K + 1) * cs * cs;
  const int64_t off_sent = (T + 1) * cs * cs;
  for (int64_t j = 0; j < n; ++j) {
    const int64_t bcol = c.div(j);
    const int64_t lc = c.mod(j);
    int64_t last_key = -1, last_tid = 0;
    for (int64_t p = indptr[j]; p < indptr[j + 1]; ++p) {
      const int64_t r = rows[p];
      const int64_t brow = c.div(r);
      const int64_t lr = c.mod(r);
      if (brow == bcol) {
        dd[p] = (brow * cs + lr) * cs + lc;
        od[p] = off_sent;
      } else {
        const int64_t key = brow * K + bcol;
        if (key != last_key) {
          last_tid = tid[key];
          last_key = key;
        }
        dd[p] = diag_sent;
        od[p] = (last_tid * cs + lr) * cs + lc;
      }
    }
  }
}

void symcore_free(void* handle, int kind) {
  if (kind == 0)
    delete static_cast<Pairs*>(handle);
  else
    delete static_cast<Keys*>(handle);
}

}  // extern "C"
