// Fused speculative verification for Hopper (sm_90a), two entry points
// over one per-row body:
//
// - repro_verify_accept_batched replaces the Pallas TPU kernel
//   src/repro/kernels/verify_accept.py::verify_accept_batched (body
//   _batched_kernel): (B, R, V) f32 logits with ragged lens;
// - repro_verify_accept replaces the single-request Pallas TPU kernel
//   src/repro/kernels/verify_accept.py::verify_accept (body _kernel):
//   (R, V) logits, f32 or bf16 (read as f32), every row valid.
//
// For each (row b, draft position r < lens[b]):
// softmax of the target logits p and draft logits q over V; accept =
// u <= p[t] / max(q[t], 1e-30); p_tok = p[t], q_tok = q[t]; residual token
// = inverse CDF of norm(max(p - q, 0)) (p itself when that mass is
// <= 1e-12) with the cdf renormalised by its last entry: the count of
// entries with cdf <= w, clamped to V - 1.  Rows r >= lens[b] return
// zeros and read nothing.
//
// What bounds it on the H100: memory.  Each (b, r) needs its two f32
// logit rows read once (2 * 4 * V bytes) for a handful of flops per
// element.  One block per (b, r) makes strided, coalesced passes over V
// for the max and the exp-sums of p and q and for the residual mass; the
// rows are small enough (128 KB each at V = 32000) that the later passes
// hit the 50 MB L2.  The inverse-CDF draw never materialises the cdf:
// every thread owns one contiguous chunk of V, a block-wide exclusive scan
// of the chunk sums gives each chunk its starting cdf value and the total
// (the cdf's last entry), and each thread then counts cdf / total <= w
// within its own chunk.  Split-V across blocks is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Block-wide max or sum; every thread gets the result.  red holds >= 33
// floats.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(kFull, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  __syncthreads();  // red is free: every thread read the previous result
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nw ? red[lane] : (kMax ? -INFINITY : 0.f);
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(kFull, v, off);
      v = kMax ? fmaxf(v, o) : v + o;
    }
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// Block-wide exclusive scan of one float per thread; also returns the
// total.  tot holds >= 33 floats.
__device__ void block_exclusive_scan(float v, float* tot, float* excl,
                                     float* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += n;
  }
  __syncthreads();
  if (lane == 31) tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const float wt = lane < nw ? tot[lane] : 0.f;
    float wi = wt;
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(kFull, wi, off);
      if (lane >= off) wi += n;
    }
    if (lane < nw) tot[lane] = wi - wt;  // exclusive prefix of the warps
    if (lane == nw - 1) tot[32] = wi;
  }
  __syncthreads();
  *excl = tot[warp] + incl - v;
  *total = tot[32];
}

__device__ __forceinline__ float ld(const float* x, int i) { return x[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* x, int i) {
  return __bfloat162float(x[i]);
}

// The verdict of one draft position: p, q its target and draft logit rows
// (V,), t the drafted token, uv the accept uniform, wv the residual
// uniform; the four outputs go to index `at`.  Every thread of the block
// calls it (it has block-wide barriers).
template <typename T>
__device__ void verify_row(const T* __restrict__ p, const T* __restrict__ q,
                           int t, float uv, float wv, int V, int at,
                           int* __restrict__ acc, int* __restrict__ res,
                           float* __restrict__ ptok,
                           float* __restrict__ qtok) {
  __shared__ float red[33];
  __shared__ float tot[33];
  const int tid = threadIdx.x;

  float pm = -INFINITY, qm = -INFINITY;
  for (int v = tid; v < V; v += blockDim.x) {
    pm = fmaxf(pm, ld(p, v));
    qm = fmaxf(qm, ld(q, v));
  }
  pm = block_reduce<true>(pm, red);
  qm = block_reduce<true>(qm, red);
  float ps = 0.f, qs = 0.f;
  for (int v = tid; v < V; v += blockDim.x) {
    ps += expf(ld(p, v) - pm);
    qs += expf(ld(q, v) - qm);
  }
  ps = block_reduce<false>(ps, red);
  qs = block_reduce<false>(qs, red);

  float z = 0.f;
  for (int v = tid; v < V; v += blockDim.x) {
    z += fmaxf(expf(ld(p, v) - pm) / ps - expf(ld(q, v) - qm) / qs, 0.f);
  }
  z = block_reduce<false>(z, red);
  const bool residual = z > 1e-12f;
  const float zden = fmaxf(z, 1e-30f);

  // contiguous per-thread chunk of V for the inverse-CDF count
  const int chunk = (V + blockDim.x - 1) / blockDim.x;
  const int v0 = min(V, tid * chunk), v1 = min(V, v0 + chunk);
  float csum = 0.f;
  for (int v = v0; v < v1; ++v) {
    const float pv = expf(ld(p, v) - pm) / ps;
    csum += residual ? fmaxf(pv - expf(ld(q, v) - qm) / qs, 0.f) / zden : pv;
  }
  float excl, total;
  block_exclusive_scan(csum, tot, &excl, &total);
  const float den = fmaxf(total, 1e-30f);  // the cdf's last entry
  float run = excl, cnt = 0.f;
  for (int v = v0; v < v1; ++v) {
    const float pv = expf(ld(p, v) - pm) / ps;
    run += residual ? fmaxf(pv - expf(ld(q, v) - qm) / qs, 0.f) / zden : pv;
    if (run / den <= wv) cnt += 1.f;
  }
  cnt = block_reduce<false>(cnt, red);
  if (tid == 0) {
    const float p_t = expf(ld(p, t) - pm) / ps;
    const float q_t = expf(ld(q, t) - qm) / qs;
    acc[at] = uv <= p_t / fmaxf(q_t, 1e-30f) ? 1 : 0;
    res[at] = min((int)cnt, V - 1);
    ptok[at] = p_t;
    qtok[at] = q_t;
  }
}

__global__ void __launch_bounds__(kThreads) verify_accept_batched_kernel(
    const float* __restrict__ p_logits, const float* __restrict__ q_logits,
    const int* __restrict__ tokens, const int* __restrict__ lens,
    const float* __restrict__ u, const float* __restrict__ w,
    int* __restrict__ acc, int* __restrict__ res, float* __restrict__ ptok,
    float* __restrict__ qtok, int R, int V) {
  const int br = blockIdx.x;
  const int b = br / R, r = br - b * R;
  if (r >= lens[b]) {  // uniform over the block: no barrier is skipped
    if (threadIdx.x == 0) {
      acc[br] = 0;
      res[br] = 0;
      ptok[br] = 0.f;
      qtok[br] = 0.f;
    }
    return;
  }
  verify_row(p_logits + (size_t)br * V, q_logits + (size_t)br * V,
             tokens[br], u[br], w[br], V, br, acc, res, ptok, qtok);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) verify_accept_kernel(
    const T* __restrict__ p_logits, const T* __restrict__ q_logits,
    const int* __restrict__ tokens, const float* __restrict__ u,
    const float* __restrict__ w, int* __restrict__ acc,
    int* __restrict__ res, float* __restrict__ ptok,
    float* __restrict__ qtok, int V) {
  const int r = blockIdx.x;
  verify_row(p_logits + (size_t)r * V, q_logits + (size_t)r * V, tokens[r],
             u[r], w[r], V, r, acc, res, ptok, qtok);
}

}  // namespace

// p_logits, q_logits (B,R,V) f32; tokens (B,R) i32; lens (B,) i32;
// u, w (B,R) f32; outputs acc, res (B,R) i32 and ptok, qtok (B,R) f32.
// Returns cudaGetLastError().
extern "C" int repro_verify_accept_batched(
    const float* p_logits, const float* q_logits, const int* tokens,
    const int* lens, const float* u, const float* w, int* acc, int* res,
    float* ptok, float* qtok, int B, int R, int V, void* stream) {
  verify_accept_batched_kernel<<<B * R, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      p_logits, q_logits, tokens, lens, u, w, acc, res, ptok, qtok, R, V);
  return (int)cudaGetLastError();
}

// p_logits, q_logits (R,V), f32 or bf16 (is_bf16); tokens (R,) i32; u, w
// (R,) f32; outputs acc, res (R,) i32 and ptok, qtok (R,) f32.  Returns
// cudaGetLastError().
extern "C" int repro_verify_accept(const void* p_logits, const void* q_logits,
                                   const int* tokens, const float* u,
                                   const float* w, int* acc, int* res,
                                   float* ptok, float* qtok, int R, int V,
                                   int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    verify_accept_kernel<<<R, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(p_logits),
        static_cast<const __nv_bfloat16*>(q_logits), tokens, u, w, acc, res,
        ptok, qtok, V);
  } else {
    verify_accept_kernel<<<R, kThreads, 0, s>>>(
        static_cast<const float*>(p_logits),
        static_cast<const float*>(q_logits), tokens, u, w, acc, res, ptok,
        qtok, V);
  }
  return (int)cudaGetLastError();
}
