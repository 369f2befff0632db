// Hopper span gather: the first stage of the device refactorization's
// tile-store assembly.
//
// Replaces the TPU kernel tpu_sparse_lu/ops/pallas_span.py `_kernel`
// (entry `span_gather`), which builds each store row from a dynamic
// two-row read of a VMEM-resident value stream plus a lane roll. Here it
// is a plain gather:
//
//   out[i, k] = a[g[i] + k]   for lo[i] <= k < hi[i], else 0
//
// with i < n_rows store rows of width cs (one tile column of the
// transposed store each) and `a` the value stream front-padded by cs
// zeros. A source index outside [0, n_a) reads 0, so a bad plan cannot
// read past the stream.
//
// What bounds it on the card: it is a pure copy, bound by bytes: it
// reads the value stream once and writes n_rows * cs elements (about
// 18 MB in float32 for the 2D Poisson 100x100 nd headline store). One
// thread per output element, a warp on 32 neighbouring lanes of one row,
// so both the reads of a contiguous span and the writes of the row are
// coalesced; every offset is 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
span_gather_kernel(T* __restrict__ out, const T* __restrict__ a,
                   const int32_t* __restrict__ g,
                   const int32_t* __restrict__ lo,
                   const int32_t* __restrict__ hi, int64_t n_a,
                   int64_t n_rows, int cs) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_rows * cs) return;
  const int64_t i = q / cs;
  const int k = (int)(q - i * cs);
  T v = T(0);
  if (k >= lo[i] && k < hi[i]) {
    const int64_t s = (int64_t)g[i] + k;
    if (s >= 0 && s < n_a) v = a[s];
  }
  out[q] = v;
}

template <typename T>
int launch_span_gather(T* out, const T* a, const int32_t* g,
                       const int32_t* lo, const int32_t* hi, int64_t n_a,
                       int64_t n_rows, int cs, cudaStream_t stream) {
  if (cs < 1 || n_rows < 0) return (int)cudaErrorInvalidValue;
  const int64_t total = n_rows * cs;
  if (total == 0) return 0;
  const int64_t blocks = (total + 255) / 256;
  span_gather_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      out, a, g, lo, hi, n_a, n_rows, cs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int span_gather_f32(float* out, const float* a, const int32_t* g,
                    const int32_t* lo, const int32_t* hi, int64_t n_a,
                    int64_t n_rows, int cs, void* stream) {
  return launch_span_gather<float>(out, a, g, lo, hi, n_a, n_rows, cs,
                                   (cudaStream_t)stream);
}

int span_gather_f64(double* out, const double* a, const int32_t* g,
                    const int32_t* lo, const int32_t* hi, int64_t n_a,
                    int64_t n_rows, int cs, void* stream) {
  return launch_span_gather<double>(out, a, g, lo, hi, n_a, n_rows, cs,
                                    (cudaStream_t)stream);
}

}  // extern "C"
