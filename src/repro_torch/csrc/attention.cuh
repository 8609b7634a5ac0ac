// The tile loop of the flash-attention kernel for Hopper (sm_90a),
// flash_attention.cu (dense KV with per-key positions); it serves that
// kernel alone (the paged and branch-decode kernels run the decode loop
// of decode_attention.cuh).  Where key s of row b lives and what its
// position is comes from a small addressing struct `Keys`:
//
//   int n_keys(b)      keys of row b the block walks (s in [0, n_keys))
//   int k_pos(b, s)    position of key s, -1 for an invalid slot
//   int kv_row(b, s)   its row in (k, v), which hold (rows, KV, hd)
//   int q_pos(b, t)    position of query token t (window reference)
//   int q_ctx(b, t)    causal horizon of query token t
//
// Key s is visible to query t when k_pos >= 0, k_pos <= q_ctx (causal)
// and q_pos - k_pos < window (window > 0); logits get an optional tanh
// softcap, and the scale multiplies q in f32 before the product.  A
// query that sees no key writes zeros.
//
// What bounds it on the H100: memory.  Decode and verify chunks do
// O(T * G) multiply-adds per K/V byte, far below the card's
// operations-per-byte balance, so the least time is the visible K/V read
// once.  The design: one block per (row, kv head, T tile) walks the key
// axis in 64-key tiles.  It reads each tile's positions first and skips
// the tile, before loading any K/V, when no key in it is visible to any
// query of the block (most slots of an early dense ring are -1; a window
// leaves early pages dead).  A loaded tile is read ONCE into shared
// memory with 16-byte loads (every K/V row spans a multiple of 16 bytes
// and starts 16-byte aligned; the wrappers check this) and serves all G
// query heads of the kv head and the T tile's tokens.  Logits, the
// running max/mass and the accumulator stay in f32 in shared memory; each
// warp reduces whole query rows with shuffles, and the dot products keep
// four independent sums to shorten their dependency chains.  This
// version runs on the CUDA cores; the decode loop's cp.async ring, tensor
// cores and split-KV (decode_attention.cuh) are later work here.
#pragma once

// REPRO_ATTN_STOP (a -D flag; 0 by default) cuts every tile short for
// `chip_smoke.py --probe`: 1 after the K/V loads, 2 after the logits.
#ifndef REPRO_ATTN_STOP
#define REPRO_ATTN_STOP 0
#endif

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {  // each kernel source gets its own copy

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kTile = 64;             // keys per shared-memory tile
constexpr int kScStride = kTile + 1;  // logit row stride (no bank clash)
static_assert(kTile == 64, "the row reduction gives each lane two keys");

// 16 bytes of K or V as floats: 4 f32 or 8 bf16 values
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x, out[2 * i + 1] = f.y;
  }
}

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// Shared-memory layout: floats, then ints.  Q and K tiles use a row
// stride of hd + 1 so the logit loop (threads spread over keys) does not
// hit one bank with every thread.
__host__ __device__ inline size_t smem_bytes(int rows, int t_tile, int hd) {
  const size_t floats = (size_t)rows * (hd + 1)     // Qs, pre-scaled queries
                        + (size_t)rows * hd         // Acc
                        + (size_t)kTile * (hd + 1)  // Ks
                        + (size_t)kTile * hd        // Vs
                        + (size_t)rows * kScStride  // logits -> probs
                        + 3 * (size_t)rows;         // max, mass, correction
  const size_t ints = 2 * (size_t)t_tile + kTile;  // q_pos, q_ctx, k_pos
  return floats * sizeof(float) + ints * sizeof(int);
}

template <typename scalar_t, typename Keys>
__global__ void __launch_bounds__(kThreads) attention_kernel(
    const scalar_t* __restrict__ q, const scalar_t* __restrict__ k,
    const scalar_t* __restrict__ v, scalar_t* __restrict__ out,
    const Keys keys, int T, int H, int KV, int hd, int t_tile, int causal,
    int window, float cap, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, t0 = blockIdx.z * t_tile;
  const int G = H / KV;
  const int rows = G * t_tile;  // row r = g * t_tile + tl
  const int hq = hd + 1;
  const float masked = -__int_as_float(0x7f800000);  // -inf marks masked
  float* Qs = smem;
  float* Acc = Qs + (size_t)rows * hq;
  float* Ks = Acc + (size_t)rows * hd;
  float* Vs = Ks + (size_t)kTile * hq;
  float* Sc = Vs + (size_t)kTile * hd;
  float* Mrow = Sc + (size_t)rows * kScStride;
  float* Lrow = Mrow + rows;
  float* Crow = Lrow + rows;
  int* Qp = reinterpret_cast<int*>(Crow + rows);
  int* Qc = Qp + t_tile;
  int* Kp = Qc + t_tile;

  const int tid = threadIdx.x;
  const int n_t = min(t_tile, T - t0);  // real tokens of this T tile

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
  for (int tl = tid; tl < t_tile; tl += blockDim.x) {
    const bool real = tl < n_t;
    // a pad token sees nothing (q_ctx -1) and is never written
    Qp[tl] = real ? keys.q_pos(b, t0 + tl) : 0;
    Qc[tl] = real ? keys.q_ctx(b, t0 + tl) : -1;
  }
  __syncthreads();
  // the block's widest horizon and earliest window start: a key outside
  // both is visible to none of its queries
  int ctx_max = -1, qp_min = 0x7fffffff;
  for (int tl = 0; tl < n_t; ++tl) {
    ctx_max = max(ctx_max, Qc[tl]);
    qp_min = min(qp_min, Qp[tl]);
  }

  const int S = keys.n_keys(b);
  constexpr int kVec = 16 / sizeof(scalar_t);
  const int nv = hd / kVec;
  for (int s0 = 0; s0 < S; s0 += kTile) {
    const int n = min(kTile, S - s0);
    int vis = 0;
    for (int o = tid; o < n; o += blockDim.x) {
      const int kp = keys.k_pos(b, s0 + o);
      bool ok = kp >= 0;
      if (causal) ok = ok && kp <= ctx_max;
      if (window > 0) ok = ok && (long long)qp_min - kp < window;
      vis |= ok;
    }
    // also the barrier after the previous tile's last read of Ks/Vs/Sc
    if (!__syncthreads_or(vis)) continue;
#pragma unroll 4
    for (int e = tid; e < kTile * nv; e += blockDim.x) {
      const int o = e / nv, d = (e - o * nv) * kVec;
      float kx[kVec], vx[kVec];
      if (o < n) {
        const size_t off =
            ((size_t)keys.kv_row(b, s0 + o) * KV + kvh) * hd + d;
        load16(k + off, kx);
        load16(v + off, vx);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kx[i] = vx[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        Ks[o * hq + d + i] = kx[i];
        Vs[o * hd + d + i] = vx[i];
      }
    }
    for (int o = tid; o < kTile; o += blockDim.x) {
      Kp[o] = o < n ? keys.k_pos(b, s0 + o) : -1;
    }
    __syncthreads();
#if REPRO_ATTN_STOP == 1
    continue;
#endif
    for (int e = tid; e < rows * kTile; e += blockDim.x) {
      const int r = e / kTile, o = e - r * kTile;
      const int tl = r % t_tile;
      const int kp = Kp[o];
      bool ok = kp >= 0;
      if (causal) ok = ok && kp <= Qc[tl];
      if (window > 0) ok = ok && (long long)Qp[tl] - kp < window;
      float s = masked;
      if (ok) {
        const float* qr = Qs + r * hq;
        const float* kr = Ks + o * hq;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int d = 0;
        for (; d + 4 <= hd; d += 4) {
          a0 = fmaf(qr[d], kr[d], a0);
          a1 = fmaf(qr[d + 1], kr[d + 1], a1);
          a2 = fmaf(qr[d + 2], kr[d + 2], a2);
          a3 = fmaf(qr[d + 3], kr[d + 3], a3);
        }
        for (; d < hd; ++d) a0 = fmaf(qr[d], kr[d], a0);
        const float acc = (a0 + a1) + (a2 + a3);
        s = cap > 0.f ? cap * tanhf(acc / cap) : acc;
      }
      Sc[r * kScStride + o] = s;
    }
    __syncthreads();
#if REPRO_ATTN_STOP == 2
    continue;
#endif
    // one warp per query row: lane l owns keys l and l + 32 of the tile
    const int lane = tid & 31;
    for (int r = tid >> 5; r < rows; r += blockDim.x >> 5) {
      float* sr = Sc + r * kScStride;
      const float m_prev = Mrow[r];
      const float x0 = sr[lane], x1 = sr[lane + 32];
      const float m_new = warp_max(fmaxf(m_prev, fmaxf(x0, x1)));
      const float p0 = x0 == masked ? 0.f : expf(x0 - m_new);
      const float p1 = x1 == masked ? 0.f : expf(x1 - m_new);
      sr[lane] = p0;
      sr[lane + 32] = p1;
      const float lsum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        Lrow[r] = Lrow[r] * corr + lsum;
        Mrow[r] = m_new;
        Crow[r] = corr;
      }
    }
    __syncthreads();
    for (int e = tid; e < rows * hd; e += blockDim.x) {
      const int r = e / hd, d = e - r * hd;
      const float* pr = Sc + r * kScStride;
      const float* vc = Vs + d;
      float a0 = Acc[e] * Crow[r], a1 = 0.f, a2 = 0.f, a3 = 0.f;
      int o = 0;
      for (; o + 4 <= n; o += 4) {
        a0 = fmaf(pr[o], vc[o * hd], a0);
        a1 = fmaf(pr[o + 1], vc[(o + 1) * hd], a1);
        a2 = fmaf(pr[o + 2], vc[(o + 2) * hd], a2);
        a3 = fmaf(pr[o + 3], vc[(o + 3) * hd], a3);
      }
      for (; o < n; ++o) a0 = fmaf(pr[o], vc[o * hd], a0);
      Acc[e] = (a0 + a1) + (a2 + a3);
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

template <typename scalar_t, typename Keys>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 const Keys& keys, int B, int T, int H, int KV, int hd,
                 int t_tile, int causal, int window, float cap, float scale,
                 cudaStream_t stream) {
  const size_t smem = smem_bytes((H / KV) * t_tile, t_tile, hd);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<scalar_t, Keys>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, KV, (T + t_tile - 1) / t_tile);
  attention_kernel<scalar_t, Keys><<<grid, kThreads, smem, stream>>>(
      static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k),
      static_cast<const scalar_t*>(v), static_cast<scalar_t*>(out), keys, T,
      H, KV, hd, t_tile, causal, window, cap, scale);
  return (int)cudaGetLastError();
}

// Launches the kernel on bf16 (is_bf16) or f32 storage; q, out (B, T, H,
// hd).  cap <= 0 means no softcap, window <= 0 no window.  Returns
// cudaGetLastError().
template <typename Keys>
int launch_attention(const void* q, const void* k, const void* v, void* out,
                     const Keys& keys, int B, int T, int H, int KV, int hd,
                     int t_tile, int causal, int window, float cap,
                     float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_typed<__nv_bfloat16>(q, k, v, out, keys, B, T, H, KV, hd,
                                       t_tile, causal, window, cap, scale, s);
  }
  return launch_typed<float>(q, k, v, out, keys, B, T, H, KV, hd, t_tile,
                             causal, window, cap, scale, s);
}

}  // namespace
