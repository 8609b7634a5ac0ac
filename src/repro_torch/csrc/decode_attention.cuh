// The decode tile loop of the paged and branch-decode attention kernels
// for Hopper (sm_90a): paged_attention.cu (KV pages read through a page
// table) and branch_attention.cu (one shared prefix plus a suffix per
// branch).  They differ only in where a key lives, what its position is
// and which query rows may see it; each source gives that as a small
// addressing struct `Keys`:
//
//   Tok token(item, tl)       query token tl of an item: its causal
//                             horizon (ctx), window reference (qp) and
//                             owner (the branch it belongs to)
//   Blk block(item, tl0, tl1) per-block constants for tokens tl0..tl1
//   int bound(blk)            keys the block's range may hold, known
//                             without reading device memory
//   int limit(blk)            keys it holds (<= bound; may come from a
//                             read, e.g. the row's length)
//   Key key(blk, s)           key s: position (-1 for an invalid slot or
//                             past the row's length), owner (-1 when every
//                             row may see it), K/V pair (0 or 1) and its
//                             row in that pair, which holds (rows, KV, hd)
//
// Key s is visible to a query row when its position is >= 0, <= the
// row's ctx (causal), qp - position < window (window > 0), and its owner
// is -1 or the row's own.  Logits are scaled by 1/sqrt(hd) in f32 after
// the product, then get the optional tanh softcap; sums are f32 and the
// output is q's dtype.  A query that sees no key writes zeros.
//
// What bounds it on the H100: memory, and at decode sizes the latency
// of the first bytes.  A decode block has 1-16 query rows per kv head,
// far below the tensor cores' operations-per-byte balance, so the least
// time reads the visible K/V once.  The design:
//
//  * One block per (item, 16-row tile, kv head, key split).  A row tile
//    holds G heads x T tokens of one item; in branch decode it holds the
//    rows of every branch of the tile, so each prefix tile is read once
//    per kv head for all of them, and a branch's suffix keys (walked after
//    the prefix) are masked to its own rows.
//  * Each of the four warps owns every fourth 16-key tile of the block's
//    range and keeps its own ring of K/V tiles in shared memory, in the
//    storage dtype, filled by 16-byte cp.async copies (zero-filled past
//    the valid keys).  A key's position and page-table entry are read one
//    ring step before its copies are issued, so no copy waits on a
//    dependent read; the loop has no block barrier, only the warp's own
//    cp.async groups.  A tile that no row of the block can see is
//    neither copied nor computed.
//  * bf16: mma.sync m16n8k16 with f32 accumulators.  The Q fragments stay
//    in registers for the whole loop; K comes through ldmatrix, V through
//    ldmatrix.trans.  P goes to bf16 for the PV product as two terms, hi
//    = bf16(p) and lo = bf16(p - hi), so the product keeps ~16 bits of p:
//    one bf16 rounding of p (2^-9) would sit above the 1e-3 rms floor of
//    the bf16 tolerance at near-zero outputs.  f32 runs the same ring and
//    fragment layout on the CUDA cores (no TF32).
//  * Each warp keeps its own online softmax (m, l, O) in registers, in
//    base 2 (logits times log2 e, exp2); the warps merge once, through
//    shared memory, at the end.
//  * Split-KV: when the grid would leave SMs idle, the host splits the
//    key axis (from shapes it knows, never from lens) into at most 8
//    splits.  The splits of one (row tile, kv head) run as one
//    thread-block cluster: each keeps its f32 part (m, l, O) in shared
//    memory, and after a cluster barrier the first block reads the
//    others' parts through distributed shared memory, merges them by
//    (m, l) and writes the output.  A call stays one launch, with no
//    scratch in device memory and no state between calls.  A split that
//    sees no key has l = 0 and weight 0.
#pragma once

// REPRO_ATTN_STOP (a -D flag; 0 by default) cuts every tile short for
// `chip_smoke.py --probe`: 1 after the K/V loads, 2 after the logits.
#ifndef REPRO_ATTN_STOP
#define REPRO_ATTN_STOP 0
#endif

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {  // each kernel source gets its own copy

namespace cg = cooperative_groups;

constexpr int kDecThreads = 128;
constexpr int kWarps = kDecThreads / 32;
constexpr int kRows = 16;  // query rows per block: one m16 tile
constexpr int kKeys = 16;  // keys per warp tile
constexpr int kPad = 16;   // bytes after every shared row (no bank clash)
constexpr float kNegBig = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Tok {
  int ctx, qp, owner;
};
struct Key {
  int pos, owner, buf, row;
};

struct DecodeArgs {
  const void* q;
  const void* k0;
  const void* v0;
  const void* k1;
  const void* v1;
  void* out;
  int T;            // tokens per item
  int H, KV, G;
  int row_tiles;    // 16-row tiles per item: ceil(T * G / 16)
  int n_split, split_len;  // n_split <= 8: one cluster per split set
  int window;
  float cap, scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// p as bf16 hi + lo terms, packed in pairs (lower k index in the low half)
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(p0 - hf.x, p1 - hf.y);
}

template <typename scalar_t>
__device__ __forceinline__ scalar_t from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD, int ES, int STAGES>
struct DecodeSmem {
  static constexpr int RB = HD * ES;     // bytes of a K/V or q row
  static constexpr int RS = RB + kPad;   // their shared-memory stride
  static constexpr int CPR = RB / 16;    // 16-byte chunks per row
  static constexpr int kQ = kRows * RS;
  static constexpr int kTileBytes = kKeys * RS;                 // K or V
  static constexpr int kRing = kWarps * STAGES * 2 * kTileBytes;
  // the warps' (m, l, O), then the block's: f32
  static constexpr int kMerge = (kWarps + 1) * kRows * (HD + 2) * 4;
  static constexpr int kMeta = kWarps * STAGES * kKeys * 8;     // int2
  static constexpr int kRowInfo = 3 * kRows * 4;
  static constexpr int kBytes =
      kQ + (kRing > kMerge ? kRing : kMerge) + kMeta + kRowInfo;
};

template <typename scalar_t, int HD, int STAGES, typename Keys>
__global__ void __launch_bounds__(kDecThreads)
    decode_attention_kernel(const Keys keys, const DecodeArgs a) {
  using L = DecodeSmem<HD, (int)sizeof(scalar_t), STAGES>;
  constexpr bool kMma = sizeof(scalar_t) == 2;
  constexpr int RS = L::RS, CPR = L::CPR, NT = HD / 8;
  static_assert(HD % 16 == 0 && CPR % 2 == 0, "head dim: 16, 32, 64, 128");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* Qs = smem;
  unsigned char* ring = Qs + L::kQ;
  const int ring_span = L::kRing > L::kMerge ? L::kRing : L::kMerge;
  int2* kmeta = reinterpret_cast<int2*>(ring + ring_span);
  int* rctx = reinterpret_cast<int*>(kmeta + kWarps * STAGES * kKeys);
  int* rqp = rctx + kRows;
  int* rown = rqp + kRows;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int item = blockIdx.x / a.row_tiles;
  const int r0 = (blockIdx.x - item * a.row_tiles) * kRows;
  const int kvh = blockIdx.y, split = blockIdx.z;
  const int G = a.G;
  const int nrows = min(kRows, a.T * G - r0);
  const int tl0 = r0 / G, tl1 = (r0 + nrows - 1) / G;
  const size_t tok0 = (size_t)item * a.T;

  // query rows: row r of the tile is token (r0 + r) / G, head (r0 + r) % G
  for (int r = tid; r < kRows; r += kDecThreads) {
    Tok t{-1, 0, -2};  // a pad row sees nothing
    if (r < nrows) t = keys.token(item, (r0 + r) / G);
    rctx[r] = t.ctx;
    rqp[r] = t.qp;
    rown[r] = t.owner;
  }
  for (int c = tid; c < kRows * CPR; c += kDecThreads) {
    const int r = c / CPR, part = c - r * CPR;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows) {
      const int rr = r0 + r;
      const size_t off =
          ((tok0 + rr / G) * a.H + (size_t)kvh * G + rr % G) * HD;
      x = reinterpret_cast<const uint4*>(
          static_cast<const scalar_t*>(a.q) + off)[part];
    }
    *reinterpret_cast<uint4*>(Qs + r * RS + part * 16) = x;
  }
  const auto blk = keys.block(item, tl0, tl1);
  // the split's keys: addresses are read up to the host-known bound, the
  // loop walks only up to the row's own length (device-known)
  const int s_beg = split * a.split_len;
  const int s_end = min(keys.bound(blk), s_beg + a.split_len);
  const int s_lim = min(s_end, keys.limit(blk));
  const int n_tiles = s_lim > s_beg ? (s_lim - s_beg + kKeys - 1) / kKeys : 0;
  const int nw = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;

  const scalar_t* k0 = static_cast<const scalar_t*>(a.k0);
  const scalar_t* v0 = static_cast<const scalar_t*>(a.v0);
  const scalar_t* k1 = static_cast<const scalar_t*>(a.k1);
  const scalar_t* v1 = static_cast<const scalar_t*>(a.v1);
  unsigned char* my_ring = ring + warp * STAGES * 2 * L::kTileBytes;
  int2* my_meta = kmeta + warp * STAGES * kKeys;

  // key lane (< 16) of warp tile j
  auto load_key = [&](int j) -> Key {
    const int s = s_beg + (warp + j * kWarps) * kKeys + lane;
    Key k{-1, -1, 0, 0};
    if (lane < kKeys && s < s_end) k = keys.key(blk, s);
    return k;
  };
  // the keys of the first STAGES tiles, read while q and the row
  // information are in flight
  Key pre[STAGES];
#pragma unroll
  for (int st = 0; st < STAGES; ++st) pre[st] = load_key(st);
  __syncthreads();

  // the block's widest horizon and earliest window reference: a key
  // outside both is visible to none of its rows
  int ctx_max = -1, qp_min = 0x7fffffff;
  for (int r = 0; r < nrows; ++r) {
    ctx_max = max(ctx_max, rctx[r]);
    qp_min = min(qp_min, rqp[r]);
  }
  const int ra = lane >> 2, rb = ra + 8, quad = lane & 3;
  const int ctx_a = rctx[ra], qp_a = rqp[ra], own_a = rown[ra];
  const int ctx_b = rctx[rb], qp_b = rqp[rb], own_b = rown[rb];
  // issue the copies of warp tile j into its ring stage; false when no
  // row of the block can see a key of it (then nothing is copied)
  auto issue = [&](const Key& k, int stage) -> bool {
    const bool ok = k.pos >= 0;
    const bool vis = ok && k.pos <= ctx_max &&
                     (a.window <= 0 || (long long)qp_min - k.pos < a.window);
    const bool live = __any_sync(0xffffffffu, vis);
    if (live) {
      if (lane < kKeys) my_meta[stage * kKeys + lane] = make_int2(k.pos, k.owner);
      // consecutive lanes copy consecutive 16-byte chunks of a row, so a
      // warp's copy covers whole rows (32 / CPR of them per step)
      unsigned char* kd = my_ring + stage * 2 * L::kTileBytes;
      unsigned char* vd = kd + L::kTileBytes;
      constexpr int kVec = 16 / (int)sizeof(scalar_t);
#pragma unroll
      for (int i = 0; i < CPR / 2; ++i) {
        const int c = i * 32 + lane;
        const int key = c / CPR, part = c - key * CPR;
        const int row = __shfl_sync(0xffffffffu, k.row, key);
        const int buf = __shfl_sync(0xffffffffu, k.buf, key);
        const bool kok = __shfl_sync(0xffffffffu, ok, key);
        const size_t off = ((size_t)row * a.KV + kvh) * HD + part * kVec;
        cp_async16(kd + key * RS + part * 16, (buf ? k1 : k0) + off, kok);
        cp_async16(vd + key * RS + part * 16, (buf ? v1 : v0) + off, kok);
      }
    }
    cp_async_commit();
    return live;
  };

  uint32_t qf[kMma ? HD / 16 : 1][4];
  if constexpr (kMma) {
    const int qrow = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int qcol = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldsm_x4(qf[kk], Qs + qrow * RS + (kk * 16 + qcol) * 2);
  }

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = kNegBig, m_b = kNegBig, l_a = 0.f, l_b = 0.f;
  unsigned live_bits = 0;

  // prologue: copies of the first STAGES - 1 tiles
  Key nxt;
  {
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < nw) {
        if (issue(pre[st], st)) live_bits |= 1u << st;
      } else {
        cp_async_commit();
      }
    }
    nxt = pre[STAGES - 1];
  }

  const float masked = -__int_as_float(0x7f800000);  // -inf
  for (int j = 0; j < nw; ++j) {
    const int stage = j % STAGES;
    __syncwarp();  // every lane is done with the stage refilled below
    {
      const int jn = j + STAGES - 1, sn = jn % STAGES;
      if (jn < nw) {
        const bool live = issue(nxt, sn);
        live_bits = (live_bits & ~(1u << sn)) | ((unsigned)live << sn);
      } else {
        cp_async_commit();
      }
      if (j + STAGES < nw) nxt = load_key(j + STAGES);
    }
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    if (!((live_bits >> stage) & 1u)) continue;
#if REPRO_ATTN_STOP == 1
    continue;
#endif
    const unsigned char* Kt = my_ring + stage * 2 * L::kTileBytes;
    const unsigned char* Vt = Kt + L::kTileBytes;
    const int2* km = my_meta + stage * kKeys;

    // logits of rows ra, rb at keys nt * 8 + 2 * quad + {0, 1}
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    if constexpr (kMma) {
      const int krow = (lane & 7) + ((lane >> 4) << 3);
      const int kcol = ((lane >> 3) & 1) * 8;
      // even and odd k-steps in two accumulators: half the dependent chain
      float s2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, Kt + krow * RS + (kk * 16 + kcol) * 2);
        float (&acc)[2][4] = (kk & 1) ? s2 : s;
        mma_bf16(acc[0], qf[kk], b[0], b[1]);
        mma_bf16(acc[1], qf[kk], b[2], b[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] += s2[nt][i];
    } else {
      const float* qa = reinterpret_cast<const float*>(Qs + ra * RS);
      const float* qb = reinterpret_cast<const float*>(Qs + rb * RS);
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        const float4 xa = *reinterpret_cast<const float4*>(qa + d);
        const float4 xb = *reinterpret_cast<const float4*>(qb + d);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 kx = *reinterpret_cast<const float4*>(
                Kt + (nt * 8 + 2 * quad + e) * RS + d * 4);
            s[nt][e] += xa.x * kx.x + xa.y * kx.y + xa.z * kx.z + xa.w * kx.w;
            s[nt][2 + e] +=
                xb.x * kx.x + xb.y * kx.y + xb.z * kx.z + xb.w * kx.w;
          }
        }
      }
    }
#if REPRO_ATTN_STOP == 2
    o[0][0] += s[0][0] + s[0][1] + s[0][2] + s[0][3] + s[1][0] + s[1][1] +
               s[1][2] + s[1][3];
    continue;
#endif
    // scale, softcap, mask; the tile's row maxima
    float mx_a = masked, mx_b = masked;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int2 k = km[nt * 8 + 2 * quad + e];
        const bool okk = k.x >= 0;
        const bool va = okk && k.x <= ctx_a &&
                        (a.window <= 0 || (long long)qp_a - k.x < a.window) &&
                        (k.y < 0 || k.y == own_a);
        const bool vb2 = okk && k.x <= ctx_b &&
                         (a.window <= 0 || (long long)qp_b - k.x < a.window) &&
                         (k.y < 0 || k.y == own_b);
        float xa = s[nt][e] * a.scale, xb = s[nt][2 + e] * a.scale;
        if (a.cap > 0.f) {  // only where seen: pad rows are most rows
          if (va) xa = a.cap * tanhf(xa / a.cap);
          if (vb2) xb = a.cap * tanhf(xb / a.cap);
        }
        xa *= kLog2e;  // the softmax runs in base 2
        xb *= kLog2e;
        s[nt][e] = va ? xa : masked;
        s[nt][2 + e] = vb2 ? xb : masked;
        mx_a = fmaxf(mx_a, s[nt][e]);
        mx_b = fmaxf(mx_b, s[nt][2 + e]);
      }
    }
#pragma unroll
    for (int msk = 1; msk <= 2; msk <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, msk));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, msk));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float cr_a = exp2f(m_a - mn_a), cr_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = s[nt][e] == masked ? 0.f : exp2f(s[nt][e] - mn_a);
        s[nt][2 + e] = s[nt][2 + e] == masked ? 0.f : exp2f(s[nt][2 + e] - mn_b);
        ps_a += s[nt][e];
        ps_b += s[nt][2 + e];
      }
    }
    l_a = l_a * cr_a + ps_a;  // this lane's keys; the quad sums at the end
    l_b = l_b * cr_b + ps_b;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= cr_a;
      o[n][1] *= cr_a;
      o[n][2] *= cr_b;
      o[n][3] *= cr_b;
    }
    if constexpr (kMma) {
      uint32_t ph[4], pl[4];
      split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
      split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
      split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
      split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
      const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
      const int vcol = (lane >> 4) * 8;
#pragma unroll
      for (int dd = 0; dd < HD / 16; ++dd) {
        uint32_t b[4];
        ldsm_x4_t(b, Vt + vrow * RS + (dd * 16 + vcol) * 2);
        mma_bf16(o[2 * dd], ph, b[0], b[1]);
        mma_bf16(o[2 * dd], pl, b[0], b[1]);
        mma_bf16(o[2 * dd + 1], ph, b[2], b[3]);
        mma_bf16(o[2 * dd + 1], pl, b[2], b[3]);
      }
    } else {
      const int qbase = lane & ~3;
#pragma unroll
      for (int key = 0; key < kKeys; ++key) {
        const int nt = key >> 3, e = key & 1, src = qbase | ((key & 7) >> 1);
        const float pa = __shfl_sync(0xffffffffu, s[nt][e], src);
        const float pb = __shfl_sync(0xffffffffu, s[nt][2 + e], src);
        const float* vr = reinterpret_cast<const float*>(Vt + key * RS);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 v = *reinterpret_cast<const float2*>(vr + n * 8 + 2 * quad);
          o[n][0] = fmaf(pa, v.x, o[n][0]);
          o[n][1] = fmaf(pa, v.y, o[n][1]);
          o[n][2] = fmaf(pb, v.x, o[n][2]);
          o[n][3] = fmaf(pb, v.y, o[n][3]);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int msk = 1; msk <= 2; msk <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, msk);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, msk);
  }

  // merge the warps' (m, l, O) through shared memory (the ring's space)
  __syncthreads();
  float* Mw = reinterpret_cast<float*>(ring);
  float* Lw = Mw + kWarps * kRows;
  float* Ow = Lw + kWarps * kRows;
  if (quad == 0) {
    Mw[warp * kRows + ra] = m_a;
    Mw[warp * kRows + rb] = m_b;
    Lw[warp * kRows + ra] = l_a;
    Lw[warp * kRows + rb] = l_b;
  }
  if (ra < nrows) {  // pad rows are never read back
    float* wa = Ow + ((size_t)warp * kRows + ra) * HD + 2 * quad;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(wa + n * 8) = make_float2(o[n][0], o[n][1]);
  }
  if (rb < nrows) {
    float* wb = Ow + ((size_t)warp * kRows + rb) * HD + 2 * quad;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(wb + n * 8) = make_float2(o[n][2], o[n][3]);
  }
  __syncthreads();

  scalar_t* out = static_cast<scalar_t*>(a.out);
  auto out_off = [&](int r, int d) -> size_t {
    const int rr = r0 + r;
    return ((tok0 + rr / G) * a.H + (size_t)kvh * G + rr % G) * HD + d;
  };
  // the block's (m, l, O): the output itself, or this split's part
  float* Bo = Ow + (size_t)kWarps * kRows * HD;  // (kRows, HD) unnormalised
  float2* Bml = reinterpret_cast<float2*>(Bo + kRows * HD);  // (m, l)
  for (int e = tid; e < nrows * HD; e += kDecThreads) {
    const int r = e / HD, d = e - r * HD;
    float M = kNegBig;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, Mw[w * kRows + r]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(Mw[w * kRows + r] - M);
      l += Lw[w * kRows + r] * c;
      acc += Ow[((size_t)w * kRows + r) * HD + d] * c;
    }
    if (a.n_split == 1) {
      out[out_off(r, d)] = from_f<scalar_t>(acc / fmaxf(l, 1e-20f));
    } else {
      Bo[e] = acc;
      if (d == 0) Bml[r] = make_float2(M, l);
    }
  }
  if (a.n_split == 1) return;

  // split-KV: the n_split blocks of this (row tile, kv head) form one
  // thread-block cluster; the first reads the others' parts from their
  // shared memory and writes the output, then all leave together
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    for (int e = tid; e < nrows * HD; e += kDecThreads) {
      const int r = e / HD;
      float M = kNegBig;
      for (int z = 0; z < a.n_split; ++z)
        M = fmaxf(M, cluster.map_shared_rank(Bml, z)[r].x);
      float l = 0.f, acc = 0.f;
      for (int z = 0; z < a.n_split; ++z) {
        const float2 x = cluster.map_shared_rank(Bml, z)[r];
        const float c = exp2f(x.x - M);
        l += x.y * c;
        acc += cluster.map_shared_rank(Bo, z)[e] * c;
      }
      out[out_off(r, e - r * HD)] = from_f<scalar_t>(acc / fmaxf(l, 1e-20f));
    }
  }
  cluster.sync();  // no block leaves while its shared memory is read
}

template <typename scalar_t, int HD>
constexpr int decode_stages() {
  return HD * (int)sizeof(scalar_t) <= 256 ? 3 : 2;
}

template <typename scalar_t, int HD>
constexpr size_t decode_smem_typed() {
  return DecodeSmem<HD, (int)sizeof(scalar_t),
                    decode_stages<scalar_t, HD>()>::kBytes;
}

template <typename scalar_t, int HD, typename Keys>
int decode_launch_typed(const Keys& keys, const DecodeArgs& a, int n_items,
                        cudaStream_t stream) {
  constexpr int S = decode_stages<scalar_t, HD>();
  auto kern = decode_attention_kernel<scalar_t, HD, S, Keys>;
  constexpr int smem = (int)decode_smem_typed<scalar_t, HD>();
  static_assert(smem <= 232448, "a block's shared memory on sm_90");
  // per call: the attribute belongs to the current device
  const cudaError_t set = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid(n_items * a.row_tiles, a.KV, a.n_split);
  if (a.n_split == 1) {
    kern<<<grid, kDecThreads, smem, stream>>>(keys, a);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = a.n_split;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, keys, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launches the kernel over n_items items on bf16 (is_bf16) or f32 storage
// with head dim hd (16, 32, 64 or 128).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another head dim.
template <typename Keys>
int decode_launch(const Keys& keys, const DecodeArgs& a, int n_items, int hd,
                  int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE_CASE(HD_)                                              \
  case HD_:                                                                 \
    return is_bf16 ? decode_launch_typed<__nv_bfloat16, HD_>(keys, a,       \
                                                             n_items, s)    \
                   : decode_launch_typed<float, HD_>(keys, a, n_items, s);
  switch (hd) {
    REPRO_DECODE_CASE(16)
    REPRO_DECODE_CASE(32)
    REPRO_DECODE_CASE(64)
    REPRO_DECODE_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_CASE
}

}  // namespace
