// Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py::ssm_scan
// (body _kernel):
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
//   y_t = <h_t, C_t> + D * x_t                        (all in float32)
// x, dt (B, T, E); Bm, Cm (B, T, N); A (E, N); D (E,); h0 (B, E, N).
// Outputs y (B, T, E), hT (B, E, N) and, when asked for, hs (B, T, E, N):
// the post-step carry at every position, which the serving layer's
// checkpoint ring stores.
//
// What bounds it on the H100: bytes.  Per (b, t, e, n) the recurrence
// costs one exp and ~6 flops, while x, dt, y and above all hs (N floats
// per (b, t, e)) cross device memory; at the full-width verify call
// (B=8, T=8, E=8192, N=16) hs is ~70% of the bytes.
//
// Design.  The TPU kernel carries a (bE, N) state tile in VMEM across a
// sequential T grid axis.  Here the recurrence is sequential in T and
// independent per (b, e) channel, so ONE THREAD OWNS ONE CHANNEL: it keeps
// its N states and A[e, :] in registers and walks T with no barrier on the
// recurrence.  A block covers 128 consecutive channels of one row (grid
// (ceil(E/128), B)), so x / dt / y accesses coalesce across e.  B_t and C_t
// are the same for the whole block: the block stages a chunk of kTc
// timesteps of them in shared memory (one barrier pair per chunk) and
// every thread reads them as broadcasts.  With N = 16 a thread's hs row is
// 64 contiguous bytes, written as float4 stores by neighbouring threads on
// neighbouring rows.  N is a template parameter over {4, 8, 16}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // channels per block
constexpr int kTc = 32;         // timesteps of B/C staged per chunk

__device__ __forceinline__ float load_x(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load_x(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

template <int N, typename XT, bool STATES>
__global__ void __launch_bounds__(kThreads) ssm_scan_kernel(
    const XT* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ A, const float* __restrict__ Dv,
    const float* __restrict__ h0, float* __restrict__ y,
    float* __restrict__ hT, float* __restrict__ hs, int T, int E) {
  __shared__ float sB[kTc * N];
  __shared__ float sC[kTc * N];
  const int b = blockIdx.y;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const bool live = e < E;

  float a[N], h[N];
  float d = 0.f;
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      a[n] = A[(size_t)e * N + n];
      h[n] = h0[((size_t)b * E + e) * N + n];
    }
    d = Dv[e];
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) a[n] = h[n] = 0.f;
  }

  const size_t row = (size_t)b * T;   // (b, t) row index base
  for (int t0 = 0; t0 < T; t0 += kTc) {
    const int tc = min(kTc, T - t0);
    __syncthreads();   // the previous chunk's reads are done
    for (int i = threadIdx.x; i < tc * N; i += kThreads) {
      sB[i] = Bm[(row + t0) * N + i];
      sC[i] = Cm[(row + t0) * N + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < tc; ++j) {
      const size_t bt = row + t0 + j;
      const size_t xe = bt * E + e;
      const float xv = load_x(x, xe);
      const float dv = dt[xe];
      const float u = dv * xv;
      const float* bj = sB + j * N;
      const float* cj = sC + j * N;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dv * a[n]) * h[n] + u * bj[n];
        acc += h[n] * cj[n];
      }
      y[xe] = acc + d * xv;
      if (STATES) {
        float4* dst = reinterpret_cast<float4*>(hs + xe * N);
#pragma unroll
        for (int n = 0; n < N; n += 4)
          dst[n / 4] = make_float4(h[n], h[n + 1], h[n + 2], h[n + 3]);
      }
    }
  }
  if (live) {
    float4* dst = reinterpret_cast<float4*>(hT + ((size_t)b * E + e) * N);
#pragma unroll
    for (int n = 0; n < N; n += 4)
      dst[n / 4] = make_float4(h[n], h[n + 1], h[n + 2], h[n + 3]);
  }
}

template <int N, typename XT>
void launch(const void* x, const float* dt, const float* Bm, const float* Cm,
            const float* A, const float* D, const float* h0, float* y,
            float* hT, float* hs, int B, int T, int E, cudaStream_t s) {
  const dim3 grid((E + kThreads - 1) / kThreads, B);
  const XT* xp = static_cast<const XT*>(x);
  if (hs != nullptr)
    ssm_scan_kernel<N, XT, true><<<grid, kThreads, 0, s>>>(
        xp, dt, Bm, Cm, A, D, h0, y, hT, hs, T, E);
  else
    ssm_scan_kernel<N, XT, false><<<grid, kThreads, 0, s>>>(
        xp, dt, Bm, Cm, A, D, h0, y, hT, hs, T, E);
}

template <typename XT>
int dispatch_n(int N, const void* x, const float* dt, const float* Bm,
               const float* Cm, const float* A, const float* D,
               const float* h0, float* y, float* hT, float* hs, int B, int T,
               int E, cudaStream_t s) {
  switch (N) {
    case 4: launch<4, XT>(x, dt, Bm, Cm, A, D, h0, y, hT, hs, B, T, E, s);
      return 0;
    case 8: launch<8, XT>(x, dt, Bm, Cm, A, D, h0, y, hT, hs, B, T, E, s);
      return 0;
    case 16: launch<16, XT>(x, dt, Bm, Cm, A, D, h0, y, hT, hs, B, T, E, s);
      return 0;
    default:
      return -1;
  }
}

}  // namespace

// x (B, T, E) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); dt (B, T, E), Bm / Cm
// (B, T, N), A (E, N), D (E,), h0 (B, E, N) f32; y (B, T, E), hT (B, E, N)
// and hs (B, T, E, N) or null, f32.  N in {4, 8, 16}; T >= 1.
// Returns cudaGetLastError(), or -1 for an N it does not take.
extern "C" int repro_ssm_scan(const void* x, const float* dt, const float* Bm,
                              const float* Cm, const float* A, const float* D,
                              const float* h0, float* y, float* hT, float* hs,
                              int B, int T, int E, int N, int x_bf16,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      x_bf16 ? dispatch_n<__nv_bfloat16>(N, x, dt, Bm, Cm, A, D, h0, y, hT,
                                         hs, B, T, E, s)
             : dispatch_n<float>(N, x, dt, Bm, Cm, A, D, h0, y, hT, hs, B, T,
                                 E, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
