// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention.py::paged_decode_attention (body
// _kernel): online-softmax GQA attention read straight through a page
// table.  Key position = j * ps + o for slot o of logical page j; a key is
// visible to query token t of row b when kpos < lens[b] and
// kpos <= q_start[b] + t (plus the optional sliding window and tanh
// softcap); the scale is 1/sqrt(hd).  Fully masked keys add zero mass and
// a zero-length row writes zeros, as the TPU kernel does.
//
// What bounds it on the H100: memory.  Decode and verify chunks do
// O(T * G) multiply-adds per key byte read, far below the card's
// operations-per-byte balance, so the least time is the row's K/V pages
// read once.  The design spends one block per (row, kv head, T tile):
// the block reads each of its row's pages ONCE into shared memory as a
// (ps, hd) K tile and V tile and serves every query of the head group
// (G heads x T_tile tokens) from them, so K/V traffic is one read per
// (row, kv head, T tile).  The block walks its row's pages itself (it
// reads table[b, j]) and stops at ceil(lens[b] / ps): short rows cost
// nothing past their length.  T is tiled because bucketed prefill sends
// whole prompt rungs through this kernel, not only verify chunks.
// Logits, the running max/mass and the accumulator stay in f32 in shared
// memory.  This first version runs on the CUDA cores; tensor cores
// (wgmma) and TMA page loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename scalar_t>
__device__ __forceinline__ scalar_t from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory layout, in floats.  Q and K tiles use a row stride of
// hd + 1 so the logit loop (threads spread over key slots) does not hit
// one bank with every thread.
__host__ __device__ inline size_t smem_floats(int rows, int hd, int ps) {
  return (size_t)rows * (hd + 1)   // Qs, pre-scaled queries
         + (size_t)rows * hd       // Acc
         + (size_t)ps * (hd + 1)   // Ks
         + (size_t)ps * hd         // Vs
         + 2 * (size_t)rows * ps   // Sc (logits -> probabilities), Mk (mask)
         + 3 * (size_t)rows;       // running max, running mass, correction
}

template <typename scalar_t>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const scalar_t* __restrict__ q, const scalar_t* __restrict__ k_pages,
    const scalar_t* __restrict__ v_pages, const int* __restrict__ table,
    const int* __restrict__ lens, const int* __restrict__ q_start,
    scalar_t* __restrict__ out, int T, int H, int KV, int hd, int ps,
    int n_max, int t_tile, int window, float cap, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, t0 = blockIdx.z * t_tile;
  const int G = H / KV;
  const int rows = G * t_tile;  // row r = g * t_tile + tl
  const int hq = hd + 1;
  float* Qs = smem;
  float* Acc = Qs + (size_t)rows * hq;
  float* Ks = Acc + (size_t)rows * hd;
  float* Vs = Ks + (size_t)ps * hq;
  float* Sc = Vs + (size_t)ps * hd;
  float* Mk = Sc + (size_t)rows * ps;
  float* Mrow = Mk + (size_t)rows * ps;
  float* Lrow = Mrow + rows;
  float* Crow = Lrow + rows;

  const int tid = threadIdx.x;
  const int len = lens[b];
  const int qs = q_start[b];

  for (int e = tid; e < rows * hd; e += blockDim.x) {
    const int r = e / hd, d = e - r * hd;
    const int g = r / t_tile, t = t0 + (r - g * t_tile);
    float x = 0.f;
    if (t < T) {
      x = to_f(q[(((size_t)b * T + t) * H + kvh * G + g) * hd + d]) * scale;
    }
    Qs[r * hq + d] = x;
    Acc[e] = 0.f;
  }
  for (int r = tid; r < rows; r += blockDim.x) {
    Mrow[r] = kNegInf;
    Lrow[r] = 0.f;
  }

  const int n_pages = min(n_max, (max(len, 0) + ps - 1) / ps);
  for (int j = 0; j < n_pages; ++j) {
    const int page = table[(size_t)b * n_max + j];
    __syncthreads();  // the previous page's tiles are no longer read
    for (int e = tid; e < ps * hd; e += blockDim.x) {
      const int o = e / hd, d = e - o * hd;
      const size_t off = (((size_t)page * ps + o) * KV + kvh) * hd + d;
      Ks[o * hq + d] = to_f(k_pages[off]);
      Vs[e] = to_f(v_pages[off]);
    }
    __syncthreads();
    for (int e = tid; e < rows * ps; e += blockDim.x) {
      const int r = e / ps, o = e - r * ps;
      const int g = r / t_tile;
      const int qpos = qs + t0 + (r - g * t_tile);
      const int kpos = j * ps + o;
      bool ok = kpos < len && kpos <= qpos;
      if (window > 0) ok = ok && (qpos - kpos) < window;
      const float* qr = Qs + r * hq;
      const float* kr = Ks + o * hq;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
      if (cap > 0.f) s = cap * tanhf(s / cap);
      Sc[e] = ok ? s : kNegInf;
      Mk[e] = ok ? 1.f : 0.f;
    }
    __syncthreads();
    for (int r = tid; r < rows; r += blockDim.x) {
      float* sr = Sc + r * ps;
      const float* mr = Mk + r * ps;
      const float m_prev = Mrow[r];
      float m_new = m_prev;
      for (int o = 0; o < ps; ++o) m_new = fmaxf(m_new, sr[o]);
      float lsum = 0.f;
      for (int o = 0; o < ps; ++o) {
        // a masked slot adds zero mass even when the whole page is masked
        const float p = mr[o] != 0.f ? expf(sr[o] - m_new) : 0.f;
        sr[o] = p;
        lsum += p;
      }
      const float corr = expf(m_prev - m_new);
      Lrow[r] = Lrow[r] * corr + lsum;
      Mrow[r] = m_new;
      Crow[r] = corr;
    }
    __syncthreads();
    for (int e = tid; e < rows * hd; e += blockDim.x) {
      const int r = e / hd, d = e - r * hd;
      const float* pr = Sc + r * ps;
      float a = Acc[e] * Crow[r];
      for (int o = 0; o < ps; ++o) a = fmaf(pr[o], Vs[o * hd + d], a);
      Acc[e] = a;
    }
  }
  __syncthreads();
  for (int e = tid; e < rows * hd; e += blockDim.x) {
    const int r = e / hd, d = e - r * hd;
    const int g = r / t_tile, t = t0 + (r - g * t_tile);
    if (t < T) {
      out[(((size_t)b * T + t) * H + kvh * G + g) * hd + d] =
          from_f<scalar_t>(Acc[e] / fmaxf(Lrow[r], 1e-20f));
    }
  }
}

template <typename scalar_t>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* table, const int* lens, const int* q_start, void* out,
           int B, int T, int H, int KV, int hd, int ps, int n_max,
           int t_tile, int window, float cap, float scale,
           cudaStream_t stream) {
  const int rows = (H / KV) * t_tile;
  const size_t smem = smem_floats(rows, hd, ps) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<scalar_t>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, KV, (T + t_tile - 1) / t_tile);
  paged_attention_kernel<scalar_t><<<grid, kThreads, smem, stream>>>(
      static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k_pages),
      static_cast<const scalar_t*>(v_pages), table, lens, q_start,
      static_cast<scalar_t*>(out), T, H, KV, hd, ps, n_max, t_tile, window,
      cap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" size_t repro_paged_attention_smem(int rows, int hd, int ps) {
  return smem_floats(rows, hd, ps) * sizeof(float);
}

// q (B,T,H,hd); k/v pages (P,ps,KV,hd); table (B,n_max); lens, q_start
// (B,); out (B,T,H,hd).  is_bf16 selects bf16 storage, else f32.  cap <= 0
// means no softcap, window <= 0 no window.  Returns cudaGetLastError().
extern "C" int repro_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const int* table, const int* lens, const int* q_start, void* out,
    int B, int T, int H, int KV, int hd, int ps, int n_max, int t_tile,
    int window, float cap, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(q, k_pages, v_pages, table, lens, q_start,
                                 out, B, T, H, KV, hd, ps, n_max, t_tile,
                                 window, cap, scale, s);
  }
  return launch<float>(q, k_pages, v_pages, table, lens, q_start, out, B, T,
                       H, KV, hd, ps, n_max, t_tile, window, cap, scale, s);
}
