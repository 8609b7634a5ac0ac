// Backward of the Mamba-1 selective scan (carry mode) for Hopper (sm_90a).
//
// The gradient of src/repro/kernels/ssm_scan.py::ssm_scan (the TPU kernel
// has no backward: the reference's training path differentiates the
// chunked lax.scan of src/repro/models/layers.py::mamba with
// jax.value_and_grad).  The port runs its forward kernel (ssm_scan.cu)
// under every cache-less Mamba layer, so training on the card needs this
// kernel behind it (kernels/ssm_scan.py::SsmScanFn).
//
// Forward, all in f32:  a_t = exp(dt_t * A),  h_t = a_t * h_{t-1} +
// (dt_t * x_t) * B_t,  y_t = <h_t, C_t> + D * x_t, with x, dt (B, T, E),
// Bm, Cm (B, T, N), A (E, N), D (E,), h0 (B, E, N).  The reverse
// recurrence, with g_t the total gradient reaching h_t
// (g_{T-1} = dhT + dy_{T-1} C_{T-1}; g_t = a_{t+1} g_{t+1} + dy_t C_t):
//   dx_t   = dy_t D + dt_t <g_t, B_t>
//   ddt_t  = x_t <g_t, B_t> + <g_t, h_{t-1} a_t A>
//   dB_t   = sum_e g_t (dt_t x_t)            dC_t = sum_e dy_t h_t
//   dA     = sum_{b,t} g_t h_{t-1} a_t dt_t  dD   = sum_{b,t} dy_t x_t
//   dh0    = a_0 g_0
// The states h_t come from the forward's states mode (hs (B, T, E, N),
// which the autograd function saves), so nothing is recomputed.
//
// Design: the forward's layout, run backwards in T.  A channel (b, e) is
// a group of N/4 lanes, four states each; a block covers 128 / (N/4)
// channels of one row and stages kTc timesteps of x, dt, dy, B and C in
// shared memory (newest first), reading h_{t-1} from hs one float4 a
// lane a step (a warp's read is one contiguous run, as the forward's
// store was).  The dot products over N reduce inside the group by
// shuffles.  dB and dC sum over the channels: a warp first reduces over
// its channels by shuffles, the block over its four warps in shared
// memory, and each block writes its partial per (b, t) to scratch; dA and
// dD sum over B and T: each channel keeps its sum over T in registers and
// writes one partial per row b.  A second kernel sums the block partials
// (dB, dC) and the row partials (dA, dD) in a fixed order, so the result
// is deterministic (no atomics).
//
// What bounds it on the H100: bytes.  It reads x, dt, dy (B, T, E), B and
// C, and the hs states once (4 bytes x B x T x E x N: 134 MB at
// falcon-mamba-7b's E = 8192, N = 16 and T = 256), and writes dx and ddt;
// the recurrence is ~20 flops and one exp per state and step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTc = 16;         // timesteps staged per chunk
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_x(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load_x(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_x(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_x(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

struct Grads {
  void* dx;            // (B, T, E) in x's dtype
  float* ddt;          // (B, T, E)
  float* dh0;          // (B, E, N)
  float* part_bc;      // (B, T, n_blocks, 2N): dB then dC partials
  float* part_a;       // (B, E, N)
  float* part_d;       // (B, E)
};

template <int N, typename XT>
__global__ void __launch_bounds__(kThreads) ssm_scan_bwd_kernel(
    const XT* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ A, const float* __restrict__ Dv,
    const float* __restrict__ h0, const float* __restrict__ hs,
    const float* __restrict__ dy, const float* __restrict__ dhT, Grads gr,
    int T, int E) {
  constexpr int G = N / 4;              // lanes of one channel
  constexpr int C = kThreads / G;       // channels of one block
  __shared__ float sx[kTc * C];
  __shared__ float sdt[kTc * C];
  __shared__ float sdy[kTc * C];
  __shared__ __align__(16) float sB[kTc * N];
  __shared__ __align__(16) float sC[kTc * N];
  __shared__ __align__(16) float sPB[kTc * kWarps * N];
  __shared__ __align__(16) float sPC[kTc * kWarps * N];
  const int b = blockIdx.y;
  const int nblk = gridDim.x;
  const int g = threadIdx.x % G;        // states 4g .. 4g+3
  const int c = threadIdx.x / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e0 = blockIdx.x * C;
  const int e = e0 + c;
  const bool live = e < E;
  const size_t ch = (size_t)e * N + 4 * g;     // (e, 4g) in an (E, N) slab
  const size_t EN = (size_t)E * N;
  const size_t bt0 = (size_t)b * T;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 a = zero, adj = zero, hcur = zero, dacc = zero;
  float d = 0.f, dd = 0.f;
  if (live) {
    a = ld4(A + ch);
    d = Dv[e];
    if (dhT != nullptr) adj = ld4(dhT + b * EN + ch);
    hcur = ld4(hs + (bt0 + T - 1) * EN + ch);
  }

  for (int t1 = T; t1 > 0; t1 -= kTc) {
    const int t0 = t1 > kTc ? t1 - kTc : 0, tc = t1 - t0;
    __syncthreads();   // the previous chunk's reads are done
    for (int i = threadIdx.x; i < tc * N; i += kThreads) {
      sB[i] = Bm[(bt0 + t0) * N + i];
      sC[i] = Cm[(bt0 + t0) * N + i];
    }
    for (int i = threadIdx.x; i < tc * C; i += kThreads) {
      const int j = i / C, ee = e0 + i - j * C;
      const size_t xe = (bt0 + t0 + j) * E + ee;
      const bool ok = ee < E;
      sx[i] = ok ? load_x(x, xe) : 0.f;
      sdt[i] = ok ? dt[xe] : 0.f;
      sdy[i] = ok ? dy[xe] : 0.f;
    }
    __syncthreads();
    for (int j = tc - 1; j >= 0; --j) {
      const int t = t0 + j;
      const float xv = sx[j * C + c];
      const float dv = sdt[j * C + c];
      const float dyv = sdy[j * C + c];
      const float4 bj = ld4(sB + j * N + 4 * g);
      const float4 cj = ld4(sC + j * N + 4 * g);
      // the total gradient reaching h_t
      adj.x += dyv * cj.x;
      adj.y += dyv * cj.y;
      adj.z += dyv * cj.z;
      adj.w += dyv * cj.w;
      float4 pc = make_float4(dyv * hcur.x, dyv * hcur.y, dyv * hcur.z,
                              dyv * hcur.w);
      float4 hp = zero;
      if (live)
        hp = t > 0 ? ld4(hs + (bt0 + t - 1) * EN + ch)
                   : ld4(h0 + b * EN + ch);
      const float4 dec = make_float4(expf(dv * a.x), expf(dv * a.y),
                                     expf(dv * a.z), expf(dv * a.w));
      float gB = adj.x * bj.x + adj.y * bj.y + adj.z * bj.z + adj.w * bj.w;
      float gha = adj.x * hp.x * dec.x * a.x + adj.y * hp.y * dec.y * a.y +
                  adj.z * hp.z * dec.z * a.z + adj.w * hp.w * dec.w * a.w;
#pragma unroll
      for (int off = 1; off < G; off <<= 1) {
        gB += __shfl_xor_sync(kFull, gB, off);
        gha += __shfl_xor_sync(kFull, gha, off);
      }
      const float u = dv * xv;
      float4 pb = make_float4(adj.x * u, adj.y * u, adj.z * u, adj.w * u);
      dacc.x += adj.x * hp.x * dec.x * dv;
      dacc.y += adj.y * hp.y * dec.y * dv;
      dacc.z += adj.z * hp.z * dec.z * dv;
      dacc.w += adj.w * hp.w * dec.w * dv;
      dd += dyv * xv;
      if (live && g == 0) {
        const size_t xe = (bt0 + t) * E + e;
        store_x(static_cast<XT*>(gr.dx), xe, dyv * d + dv * gB);
        gr.ddt[xe] = xv * gB + gha;
      }
      adj.x *= dec.x;
      adj.y *= dec.y;
      adj.z *= dec.z;
      adj.w *= dec.w;
      hcur = hp;
      // sum dB and dC over the warp's channels (lanes of equal g)
#pragma unroll
      for (int off = G; off < 32; off <<= 1) {
        pb.x += __shfl_xor_sync(kFull, pb.x, off);
        pb.y += __shfl_xor_sync(kFull, pb.y, off);
        pb.z += __shfl_xor_sync(kFull, pb.z, off);
        pb.w += __shfl_xor_sync(kFull, pb.w, off);
        pc.x += __shfl_xor_sync(kFull, pc.x, off);
        pc.y += __shfl_xor_sync(kFull, pc.y, off);
        pc.z += __shfl_xor_sync(kFull, pc.z, off);
        pc.w += __shfl_xor_sync(kFull, pc.w, off);
      }
      if (lane < G) {
        st4(sPB + (j * kWarps + warp) * N + 4 * lane, pb);
        st4(sPC + (j * kWarps + warp) * N + 4 * lane, pc);
      }
    }
    __syncthreads();
    // the block's partials of this chunk, summed over its warps in order
    for (int i = threadIdx.x; i < tc * N; i += kThreads) {
      const int j = i / N, n = i - j * N;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sb += sPB[(j * kWarps + w) * N + n];
        sc += sPC[(j * kWarps + w) * N + n];
      }
      float* dst = gr.part_bc + ((bt0 + t0 + j) * nblk + blockIdx.x) * 2 * N;
      dst[n] = sb;
      dst[N + n] = sc;
    }
  }
  if (live) {
    st4(gr.dh0 + b * EN + ch, adj);
    st4(gr.part_a + b * EN + ch, dacc);
    if (g == 0) gr.part_d[(size_t)b * E + e] = dd;
  }
}

// dB, dC: the sum over the n_blocks partials of each (b, t, n); dA, dD:
// the sum over the B row partials of each (e, n) and e; fixed order.
__global__ void ssm_scan_bwd_reduce(const float* __restrict__ part_bc,
                                    const float* __restrict__ part_a,
                                    const float* __restrict__ part_d,
                                    float* dBm, float* dCm, float* dA,
                                    float* dD, int B, int T, int E, int N,
                                    int nblk) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t nbc = (size_t)B * T * 2 * N;
  if (i < nbc) {
    const size_t bt = i / (2 * N);
    const int r = (int)(i - bt * 2 * N);
    float s = 0.f;
    for (int k = 0; k < nblk; ++k) s += part_bc[(bt * nblk + k) * 2 * N + r];
    if (r < N)
      dBm[bt * N + r] = s;
    else
      dCm[bt * N + r - N] = s;
    return;
  }
  i -= nbc;
  const size_t EN = (size_t)E * N;
  if (i < EN) {
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += part_a[b * EN + i];
    dA[i] = s;
    return;
  }
  i -= EN;
  if (i < (size_t)E) {
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += part_d[(size_t)b * E + i];
    dD[i] = s;
  }
}

template <int N, typename XT>
int launch(const void* x, const float* dt, const float* Bm, const float* Cm,
           const float* A, const float* D, const float* h0, const float* hs,
           const float* dy, const float* dhT, Grads gr, int B, int T, int E,
           cudaStream_t s) {
  constexpr int C = kThreads / (N / 4);
  const dim3 grid((E + C - 1) / C, B);
  ssm_scan_bwd_kernel<N, XT><<<grid, kThreads, 0, s>>>(
      static_cast<const XT*>(x), dt, Bm, Cm, A, D, h0, hs, dy, dhT, gr, T,
      E);
  return (int)cudaGetLastError();
}

template <typename XT>
int dispatch_n(int N, const void* x, const float* dt, const float* Bm,
               const float* Cm, const float* A, const float* D,
               const float* h0, const float* hs, const float* dy,
               const float* dhT, Grads gr, int B, int T, int E,
               cudaStream_t s) {
  switch (N) {
    case 4:
      return launch<4, XT>(x, dt, Bm, Cm, A, D, h0, hs, dy, dhT, gr, B, T,
                           E, s);
    case 8:
      return launch<8, XT>(x, dt, Bm, Cm, A, D, h0, hs, dy, dhT, gr, B, T,
                           E, s);
    case 16:
      return launch<16, XT>(x, dt, Bm, Cm, A, D, h0, hs, dy, dhT, gr, B, T,
                            E, s);
    default:
      return -1;
  }
}

}  // namespace

// n_blocks of the backward kernel's grid for (E, N): the wrapper sizes
// part_bc (B, T, n_blocks, 2N) with it.
extern "C" int repro_ssm_scan_bwd_blocks(int E, int N) {
  const int C = kThreads / (N / 4);
  return (E + C - 1) / C;
}

// x (B, T, E) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); dt (B, T, E), Bm /
// Cm (B, T, N), A (E, N), D (E,), h0 (B, E, N), hs (B, T, E, N) the
// forward's post-step states, dy (B, T, E), dhT (B, E, N) or null, all
// f32.  Out: dx (B, T, E) in x's dtype; ddt (B, T, E), dBm / dCm (B, T,
// N), dA (E, N), dD (E,), dh0 (B, E, N) f32.  Scratch: part_bc (B, T,
// n_blocks, 2N), part_a (B, E, N), part_d (B, E) f32.  N in {4, 8, 16};
// T >= 1.  Two kernels on the stream, in order.  Returns
// cudaGetLastError(), or -1 for an N it does not take.
extern "C" int repro_ssm_scan_bwd(
    const void* x, const float* dt, const float* Bm, const float* Cm,
    const float* A, const float* D, const float* h0, const float* hs,
    const float* dy, const float* dhT, void* dx, float* ddt, float* dBm,
    float* dCm, float* dA, float* dD, float* dh0, float* part_bc,
    float* part_a, float* part_d, int B, int T, int E, int N, int x_bf16,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grads gr{dx, ddt, dh0, part_bc, part_a, part_d};
  const int rc =
      x_bf16 ? dispatch_n<__nv_bfloat16>(N, x, dt, Bm, Cm, A, D, h0, hs, dy,
                                         dhT, gr, B, T, E, s)
             : dispatch_n<float>(N, x, dt, Bm, Cm, A, D, h0, hs, dy, dhT,
                                 gr, B, T, E, s);
  if (rc != 0) return rc;
  const size_t total = (size_t)B * T * 2 * N + (size_t)E * N + E;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  ssm_scan_bwd_reduce<<<blocks, threads, 0, s>>>(
      part_bc, part_a, part_d, dBm, dCm, dA, dD, B, T, E, N,
      repro_ssm_scan_bwd_blocks(E, N));
  return (int)cudaGetLastError();
}
