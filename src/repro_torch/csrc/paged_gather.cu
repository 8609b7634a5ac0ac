// Paged gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged.py::paged_gather
// (body _gather_kernel): copy logical pages table[i] of a (P, ps, dim)
// buffer into contiguous (n * ps, dim) rows, writing rows at or past
// valid_len as zeros (recycled pages are not scrubbed, so a page can
// still hold rows of its previous owner).
//
// What bounds it on the H100: memory, a pure copy.  The least time is
// n * ps * dim * 4 bytes read plus the same written.  Blocks of the
// grid's x axis walk logical pages (each reads its own table entry);
// the y axis splits a large page across blocks; every thread moves
// 16-byte vectors (when dim is a multiple of 4) with neighbouring threads
// on neighbouring addresses, and rows past valid_len are written as zeros
// without being read.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) paged_gather_kernel(
    const float* __restrict__ pages, const int* __restrict__ table,
    float* __restrict__ out, int ps, int dim, int valid_len, int vec4) {
  const int i = blockIdx.x;
  const size_t n = (size_t)ps * dim;
  const float* src = pages + (size_t)table[i] * n;
  float* dst = out + (size_t)i * n;
  const long row0 = (long)i * ps;
  const size_t start = (size_t)blockIdx.y * blockDim.x + threadIdx.x;
  const size_t step = (size_t)gridDim.y * blockDim.x;
  if (vec4) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (size_t e = start; e < n / 4; e += step) {
      const long row = row0 + (long)((e * 4) / dim);
      d4[e] = row < valid_len ? s4[e] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (size_t e = start; e < n; e += step) {
      const long row = row0 + (long)(e / dim);
      dst[e] = row < valid_len ? src[e] : 0.f;
    }
  }
}

}  // namespace

// pages (P, ps, dim) f32; table (n,) i32; out (n * ps, dim) f32.
// Returns cudaGetLastError().
extern "C" int repro_paged_gather(const float* pages, const int* table,
                                  float* out, int n, int ps, int dim,
                                  int valid_len, void* stream) {
  const int vec4 = dim % 4 == 0;
  const size_t per_page = (size_t)ps * dim / (vec4 ? 4 : 1);
  size_t split = (per_page + kThreads * 8 - 1) / (kThreads * 8);
  if (split < 1) split = 1;
  if (split > 1024) split = 1024;
  const dim3 grid(n, (unsigned)split);
  paged_gather_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      pages, table, out, ps, dim, valid_len, vec4);
  return (int)cudaGetLastError();
}
