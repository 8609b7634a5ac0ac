// Backward of flash attention over position-masked dense KV, for Hopper
// (sm_90a).
//
// The gradient of src/repro/kernels/flash_attention.py::flash_attention,
// the function src/repro/models/layers.py::attend computes (the TPU
// kernel has no backward: the reference's training path differentiates
// the plain jnp attend with jax.value_and_grad).  The port runs its
// forward kernel (flash_attention.cu) under every cache-less attention
// call, so training on the card needs this kernel behind it
// (kernels/flash_attention.py::FlashAttentionFn).
//
// The forward's contract, whole: q (B, T, H, hd); k, v (B, S, KV, hd),
// GQA with G = H / KV query heads per kv head; key s is visible to query
// t when k_pos[s] >= 0, k_pos[s] <= q_ctx[t] (causal; q_ctx may lie below
// q_pos: parallel-draft slot queries) and q_pos[t] - k_pos[s] < window
// (window > 0); z = cap * tanh(scale * q.k / cap) with a softcap, else
// scale * q.k; p = softmax over the visible keys; o = p v.  With
// dO the output gradient:
//   D_t      = sum_d dO_t * O_t                  (O: the forward's output)
//   dp_ts    = dO_t . v_s
//   dz_ts    = p_ts * (dp_ts - D_t)
//   ds_ts    = dz_ts * (1 - (z_ts / cap)^2)      (1 without a softcap)
//   dq_t     = scale * sum_s ds_ts k_s
//   dk_s     = scale * sum_{t, g} ds_ts q_t      (summed over the G heads)
//   dv_s     = sum_{t, g} p_ts dO_t
// A query that sees no key has o = 0 in the forward kernel, so every
// gradient through it is 0.  f32 and bf16 storage; all arithmetic in f32.
//
// Design: two kernels in one launch entry, no atomics, deterministic.
// 1. dq (grid: 16-row blocks of the T x G rows of one kv head, kv heads,
//    batch).  Each warp owns 4 query rows; q and dO rows sit in shared
//    memory as f32.  D comes from a prologue over O.  Pass 1 walks 32-key
//    tiles (one key a lane) and keeps each lane's running max and sum,
//    merged across the warp at the end: the row's log-sum-exp, which the
//    forward kernel does not write.  Pass 2 walks the tiles again with V
//    beside K: each lane computes p, dp and ds for its key, then the warp
//    accumulates dq over the tile's 32 keys, lane l holding elements
//    l, l + 32, ... of each row (ds broadcast by shuffle).  The kernel
//    writes dq and the rows' lse and D (B, H, T) for kernel 2.
// 2. dk/dv (grid: 16-key blocks, kv heads, batch).  Each warp owns 4 keys
//    (K and V in shared memory); the block walks every row of its kv head
//    (all G heads) in 32-row tiles (one row a lane) and accumulates dk and
//    dv in registers, lane l holding elements l, l + 32, ....
// Both kernels read the positions of a tile first and skip a tile that no
// (row, key) pair of the block sees (about half the tiles of a causal
// frame).  Key rows in shared memory are padded to hd + 1 floats so that
// the lane-per-key dot products do not collide on one bank.
//
// What bounds it on the H100: operations, on CUDA cores.  The backward
// does about 2.5x the forward's products (q.k twice, dO.v twice, and the
// three accumulations), here in f32 FMAs fed from shared memory, without
// the tensor cores; at gemma3-4b's training shape (T = S = 1280, 8 heads
// of 256, bf16) the bound in the tensor-core rate is ~10 us and this
// kernel is well above it.  It is the simple correct version; tensor-core
// tiles (mma.sync / wgmma over 64-row blocks) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 4;                    // dq kernel
constexpr int kRowBlock = kWarps * kRowsPerWarp;   // 16 query rows
constexpr int kKeyTile = 32;                       // one key a lane
constexpr int kKeysPerWarp = 4;                    // dk/dv kernel
constexpr int kKeyBlock = kWarps * kKeysPerWarp;   // 16 keys
constexpr int kRowTile = 32;                       // one row a lane
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const int *q_pos, *q_ctx, *k_pos;
  void *dq, *dk, *dv;
  float *lse, *delta;  // (B, H, T)
  int T, S, H, KV, G, causal, window;
  float cap, scale;
};

__device__ __forceinline__ bool visible(const Args& a, int qp, int qc,
                                        int kp) {
  return kp >= 0 && (!a.causal || kp <= qc) &&
         (a.window <= 0 || qp - kp < a.window);
}

__device__ __forceinline__ float logit(const Args& a, float dot) {
  const float s = dot * a.scale;
  return a.cap > 0.f ? a.cap * tanhf(s / a.cap) : s;
}

// d logit / d (scale * q.k), times the scale: the chain factor of ds
__device__ __forceinline__ float dlogit(const Args& a, float z) {
  if (a.cap <= 0.f) return a.scale;
  const float t = z / a.cap;
  return (1.f - t * t) * a.scale;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// q / dO element offset of row r = t * G + g of kv head kvh, batch b
__device__ __forceinline__ size_t row_off(const Args& a, int b, int kvh,
                                          int r, int HD) {
  const int t = r / a.G, h = kvh * a.G + (r - t * a.G);
  return (((size_t)b * a.T + t) * a.H + h) * HD;
}

__device__ __forceinline__ size_t stat_off(const Args& a, int b, int kvh,
                                           int r) {
  const int t = r / a.G, h = kvh * a.G + (r - t * a.G);
  return ((size_t)b * a.H + h) * a.T + t;
}

template <int HD, typename TT>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Args a) {
  constexpr int NI = (HD + 31) / 32;
  constexpr int KS = HD + 1;
  extern __shared__ float smem[];
  float* sQ = smem;                   // [kRowBlock][HD]
  float* sO = sQ + kRowBlock * HD;    // dO [kRowBlock][HD]
  float* sK = sO + kRowBlock * HD;    // [kKeyTile][KS]
  float* sV = sK + kKeyTile * KS;     // [kKeyTile][KS]
  __shared__ int sKp[kKeyTile];
  __shared__ int sQp[kRowBlock], sQc[kRowBlock];
  const TT* q = static_cast<const TT*>(a.q);
  const TT* k = static_cast<const TT*>(a.k);
  const TT* v = static_cast<const TT*>(a.v);
  const TT* o = static_cast<const TT*>(a.o);
  const TT* dout = static_cast<const TT*>(a.dout);
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int r0 = blockIdx.x * kRowBlock;
  const int nrows = a.T * a.G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kRowBlock * HD; i += kThreads) {
    const int rr = i / HD, d = i - rr * HD;
    float qv = 0.f, dv = 0.f;
    if (r0 + rr < nrows) {
      const size_t idx = row_off(a, b, kvh, r0 + rr, HD) + d;
      qv = ld(q, idx);
      dv = ld(dout, idx);
    }
    sQ[i] = qv;
    sO[i] = dv;
  }
  if (threadIdx.x < kRowBlock) {
    const int r = r0 + threadIdx.x;
    int qp = 0, qc = 0;
    if (r < nrows) {
      const size_t bt = (size_t)b * a.T + r / a.G;
      qp = a.q_pos[bt];
      qc = a.q_ctx[bt];
    }
    sQp[threadIdx.x] = qp;
    sQc[threadIdx.x] = qc;
  }
  __syncthreads();

  // D = rowsum(dO * O), one warp reduction per row
  float delta[kRowsPerWarp], lse[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    lse[i] = 0.f;
    const int rr = warp * kRowsPerWarp + i;
    float acc = 0.f;
    if (r0 + rr < nrows) {
      const size_t base = row_off(a, b, kvh, r0 + rr, HD);
      for (int d = lane; d < HD; d += 32) acc += sO[rr * HD + d] * ld(o, base + d);
    }
    delta[i] = warp_sum(acc);
  }

  // pass 1: each lane's running max and sum over its keys, then merged
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int pass = 0; pass < 2; ++pass) {
    float acc[kRowsPerWarp][NI];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int n = 0; n < NI; ++n) acc[i][n] = 0.f;
    for (int s0 = 0; s0 < a.S; s0 += kKeyTile) {
      __syncthreads();  // the previous tile's reads are done
      if (threadIdx.x < kKeyTile) {
        const int s = s0 + threadIdx.x;
        sKp[threadIdx.x] = s < a.S ? a.k_pos[(size_t)b * a.S + s] : -1;
      }
      __syncthreads();
      int any = 0;
      for (int p = threadIdx.x; p < kRowBlock * kKeyTile; p += kThreads) {
        const int rr = p / kKeyTile, j = p - rr * kKeyTile;
        any |= (r0 + rr < nrows) && visible(a, sQp[rr], sQc[rr], sKp[j]);
      }
      if (!__syncthreads_or(any)) continue;
      for (int i = threadIdx.x; i < kKeyTile * HD; i += kThreads) {
        const int j = i / HD, d = i - j * HD;
        const int s = s0 + j;
        const size_t idx = (((size_t)b * a.S + s) * a.KV + kvh) * HD + d;
        sK[j * KS + d] = s < a.S ? ld(k, idx) : 0.f;
        if (pass == 1) sV[j * KS + d] = s < a.S ? ld(v, idx) : 0.f;
      }
      __syncthreads();
      const int kp = sKp[lane];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int rr = warp * kRowsPerWarp + i;
        const bool see = (r0 + rr < nrows) && visible(a, sQp[rr], sQc[rr], kp);
        float ds = 0.f;
        if (see) {
          float dot = 0.f;
#pragma unroll 8
          for (int d = 0; d < HD; ++d) dot += sQ[rr * HD + d] * sK[lane * KS + d];
          const float z = logit(a, dot);
          if (pass == 0) {
            if (z > m[i]) {
              l[i] = l[i] * expf(m[i] - z) + 1.f;
              m[i] = z;
            } else {
              l[i] += expf(z - m[i]);
            }
          } else {
            const float p = expf(z - lse[i]);
            float dp = 0.f;
#pragma unroll 8
            for (int d = 0; d < HD; ++d) dp += sO[rr * HD + d] * sV[lane * KS + d];
            ds = p * (dp - delta[i]) * dlogit(a, z);
          }
        }
        if (pass == 0 || !__any_sync(kFull, ds != 0.f)) continue;
        for (int j = 0; j < kKeyTile; ++j) {
          const float dsj = __shfl_sync(kFull, ds, j);
#pragma unroll
          for (int n = 0; n < NI; ++n) {
            const int d = lane + 32 * n;
            if (d < HD) acc[i][n] += dsj * sK[j * KS + d];
          }
        }
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float mm = warp_max(m[i]);
        const float ll = warp_sum(m[i] > kNegInf ? l[i] * expf(m[i] - mm) : 0.f);
        lse[i] = ll > 0.f ? mm + logf(ll) : 0.f;
      }
      continue;
    }
    TT* dq = static_cast<TT*>(a.dq);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = r0 + warp * kRowsPerWarp + i;
      if (r >= nrows) continue;
      const size_t base = row_off(a, b, kvh, r, HD);
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        const int d = lane + 32 * n;
        if (d < HD) st(dq, base + d, acc[i][n]);
      }
      if (lane == 0) {
        a.lse[stat_off(a, b, kvh, r)] = lse[i];
        a.delta[stat_off(a, b, kvh, r)] = delta[i];
      }
    }
  }
}

template <int HD, typename TT>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const Args a) {
  constexpr int NI = (HD + 31) / 32;
  constexpr int RS = HD + 1;
  extern __shared__ float smem[];
  float* sK = smem;                    // [kKeyBlock][HD]
  float* sV = sK + kKeyBlock * HD;     // [kKeyBlock][HD]
  float* sQ = sV + kKeyBlock * HD;     // [kRowTile][RS]
  float* sO = sQ + kRowTile * RS;      // dO [kRowTile][RS]
  __shared__ int sKp[kKeyBlock];
  __shared__ int sQp[kRowTile], sQc[kRowTile];
  __shared__ float sL[kRowTile], sD[kRowTile];
  const TT* q = static_cast<const TT*>(a.q);
  const TT* k = static_cast<const TT*>(a.k);
  const TT* v = static_cast<const TT*>(a.v);
  const TT* dout = static_cast<const TT*>(a.dout);
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int s0 = blockIdx.x * kKeyBlock;
  const int nrows = a.T * a.G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kKeyBlock * HD; i += kThreads) {
    const int j = i / HD, d = i - j * HD;
    const int s = s0 + j;
    const size_t idx = (((size_t)b * a.S + s) * a.KV + kvh) * HD + d;
    sK[i] = s < a.S ? ld(k, idx) : 0.f;
    sV[i] = s < a.S ? ld(v, idx) : 0.f;
  }
  if (threadIdx.x < kKeyBlock) {
    const int s = s0 + threadIdx.x;
    sKp[threadIdx.x] = s < a.S ? a.k_pos[(size_t)b * a.S + s] : -1;
  }
  float dk[kKeysPerWarp][NI], dv[kKeysPerWarp][NI];
#pragma unroll
  for (int kk = 0; kk < kKeysPerWarp; ++kk)
#pragma unroll
    for (int n = 0; n < NI; ++n) dk[kk][n] = dv[kk][n] = 0.f;

  for (int r0 = 0; r0 < nrows; r0 += kRowTile) {
    __syncthreads();  // the previous tile's reads are done
    if (threadIdx.x < kRowTile) {
      const int r = r0 + threadIdx.x;
      int qp = 0, qc = 0;
      float lse = 0.f, dl = 0.f;
      if (r < nrows) {
        const size_t bt = (size_t)b * a.T + r / a.G;
        qp = a.q_pos[bt];
        qc = a.q_ctx[bt];
        lse = a.lse[stat_off(a, b, kvh, r)];
        dl = a.delta[stat_off(a, b, kvh, r)];
      }
      sQp[threadIdx.x] = qp;
      sQc[threadIdx.x] = qc;
      sL[threadIdx.x] = lse;
      sD[threadIdx.x] = dl;
    }
    __syncthreads();
    int any = 0;
    for (int p = threadIdx.x; p < kRowTile * kKeyBlock; p += kThreads) {
      const int j = p / kRowTile, row = p - j * kRowTile;
      any |= (r0 + row < nrows) && visible(a, sQp[row], sQc[row], sKp[j]);
    }
    if (!__syncthreads_or(any)) continue;
    for (int i = threadIdx.x; i < kRowTile * HD; i += kThreads) {
      const int row = i / HD, d = i - row * HD;
      float qv = 0.f, ov = 0.f;
      if (r0 + row < nrows) {
        const size_t idx = row_off(a, b, kvh, r0 + row, HD) + d;
        qv = ld(q, idx);
        ov = ld(dout, idx);
      }
      sQ[row * RS + d] = qv;
      sO[row * RS + d] = ov;
    }
    __syncthreads();
    const bool rlive = r0 + lane < nrows;
#pragma unroll
    for (int kk = 0; kk < kKeysPerWarp; ++kk) {
      const int j = warp * kKeysPerWarp + kk;
      float p = 0.f, ds = 0.f;
      if (rlive && visible(a, sQp[lane], sQc[lane], sKp[j])) {
        float dot = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
          dot += sQ[lane * RS + d] * sK[j * HD + d];
          dp += sO[lane * RS + d] * sV[j * HD + d];
        }
        const float z = logit(a, dot);
        p = expf(z - sL[lane]);
        ds = p * (dp - sD[lane]) * dlogit(a, z);
      }
      if (!__any_sync(kFull, p != 0.f || ds != 0.f)) continue;
      for (int i = 0; i < kRowTile; ++i) {
        const float pi = __shfl_sync(kFull, p, i);
        const float dsi = __shfl_sync(kFull, ds, i);
#pragma unroll
        for (int n = 0; n < NI; ++n) {
          const int d = lane + 32 * n;
          if (d < HD) {
            dv[kk][n] += pi * sO[i * RS + d];
            dk[kk][n] += dsi * sQ[i * RS + d];
          }
        }
      }
    }
  }
  TT* dkp = static_cast<TT*>(a.dk);
  TT* dvp = static_cast<TT*>(a.dv);
#pragma unroll
  for (int kk = 0; kk < kKeysPerWarp; ++kk) {
    const int s = s0 + warp * kKeysPerWarp + kk;
    if (s >= a.S) continue;
    const size_t base = (((size_t)b * a.S + s) * a.KV + kvh) * HD;
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const int d = lane + 32 * n;
      if (d < HD) {
        st(dkp, base + d, dk[kk][n]);
        st(dvp, base + d, dv[kk][n]);
      }
    }
  }
}

template <int HD, typename TT>
int launch(const Args& a, int B, cudaStream_t s) {
  const size_t smem_q =
      (2 * kRowBlock * HD + 2 * kKeyTile * (HD + 1)) * sizeof(float);
  const size_t smem_k =
      (2 * kKeyBlock * HD + 2 * kRowTile * (HD + 1)) * sizeof(float);
  int rc = (int)cudaFuncSetAttribute(
      flash_bwd_dq_kernel<HD, TT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (rc != 0) return rc;
  rc = (int)cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<HD, TT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_k);
  if (rc != 0) return rc;
  const dim3 gq((a.T * a.G + kRowBlock - 1) / kRowBlock, a.KV, B);
  flash_bwd_dq_kernel<HD, TT><<<gq, kThreads, smem_q, s>>>(a);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const dim3 gk((a.S + kKeyBlock - 1) / kKeyBlock, a.KV, B);
  flash_bwd_dkdv_kernel<HD, TT><<<gk, kThreads, smem_k, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename TT>
int dispatch(const Args& a, int B, int hd, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<16, TT>(a, B, s);
    case 32: return launch<32, TT>(a, B, s);
    case 64: return launch<64, TT>(a, B, s);
    case 80: return launch<80, TT>(a, B, s);
    case 128: return launch<128, TT>(a, B, s);
    case 144: return launch<144, TT>(a, B, s);
    case 160: return launch<160, TT>(a, B, s);
    case 256: return launch<256, TT>(a, B, s);
    default: return -1;
  }
}

}  // namespace

// q, o, dout, dq (B,T,H,hd); k, v, dk, dv (B,S,KV,hd); q_pos, q_ctx (B,T)
// and k_pos (B,S) int32; lse, delta (B,H,T) f32 scratch written by the
// dq kernel and read by the dk/dv kernel.  is_bf16 selects bf16 storage,
// else f32.  causal 0 drops the horizon; cap <= 0 means no softcap,
// window <= 0 no window.  Two kernels on the stream, in order.  Returns
// cudaGetLastError(), or -1 for a head dim it does not take.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const int* q_pos, const int* q_ctx, const int* k_pos,
    void* dq, void* dk, void* dv, float* lse, float* delta, int B, int T,
    int S, int H, int KV, int hd, int causal, int window, float cap,
    float scale, int is_bf16, void* stream) {
  const Args a{q,  k,  v, o,  dout, q_pos,  q_ctx,  k_pos,
               dq, dk, dv, lse, delta, T,   S,      H,
               KV, H / KV, causal, window, cap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(a, B, hd, s)
                 : dispatch<float>(a, B, hd, s);
}
