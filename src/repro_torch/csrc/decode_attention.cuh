// The decode tile loop of the three attention kernels for Hopper
// (sm_90a): paged_attention.cu (KV pages read through a page table),
// branch_attention.cu (one shared prefix plus a suffix per branch) and
// flash_attention.cu (the dense ring cache and the cache-less forward:
// key s of row b is K/V row b * S + s).  They differ only in where a key
// lives, what its position is and which query rows may see it; each
// source gives that as a small addressing struct `Keys`:
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
//   kAhead                    tiles whose keys a warp reads before it
//                             issues their copies: 1 where nearly every
//                             tile is live, more where runs of tiles no
//                             row sees are common (a dense ring's -1 slots)
//
// Key s is visible to a query row when its position is >= 0, <= the
// row's ctx (causal), qp - position < window (window > 0), and its owner
// is -1 or the row's own.  Positions may come in any order (a dense ring
// wraps, a rollback leaves stale slots).  Logits are scaled by 1/sqrt(hd)
// in f32 after the product, then get the optional tanh softcap; sums are
// f32 and the output is q's dtype.  A query that sees no key writes zeros.
// Head dims 1-256, on two load paths.  Aligned (kRag false): the compiled
// width HD is the head dim, one of 16, 32, 64, 80, 128, 144, 160 and 256
// (every head dim of the repo's configurations and of their draft()
// variants but granite-moe's 85), and rows are whole 16-byte chunks from
// 16-byte aligned starts.  At 144 (HD / 16 = 9 k-steps, 18 chunks of a
// bf16 row) nothing steps over k in pairs: the logits' even/odd
// accumulators alternate per k-step, the PV product and ldmatrix walk one
// 16-column step at a time, and the copy loops need only an even chunk
// count per row (18, 20; 36, 40 at f32).  Ragged (kRag true): any head
// dim hd <= HD (a.hd, the rows' stride in device memory) at a compiled
// width HD of 16, 32, 64, 96, 128, 160 or 256, or an aligned head dim
// whose storage is not 16-byte aligned.  The tiles keep HD columns, those
// past hd zero: zeroed once per block before the first copy, and never
// left otherwise.  Tiles fill by 4-byte cp.async copies, still one tile
// group ahead of the products: f32 an element a copy; bf16 a word a copy,
// and a bf16 row of odd hd (or of a view at an odd element offset) that
// starts 2 bytes past a word is copied from that word, so it lands one
// column late ("led"), its last word cut at its end; once it has landed
// the warp moves it left by one column in place and zeroes its columns
// from hd on (ragged_row, ragged_shift).  q fills every column (zeros
// past hd); stores write only columns < hd, element by element.  The
// scale is the host's 1/sqrt(hd).
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
//    the prefix) are masked to its own rows.  Prefill and cache-less rows
//    (T x G > 16) take one block per 16-row tile, each reading the K/V
//    its rows see; a causal tile skips the keys past its last row.  The
//    flash kernel gives an item with 64 or more rows per kv head to the
//    wide block (wide_attention_kernel below): 64 rows, a 16-row tile per
//    warp, share each K/V tile it reads.
//  * Each of the four warps owns every fourth 16-key tile of the block's
//    range and keeps its own ring of K/V tiles in shared memory, in the
//    storage dtype, filled by 16-byte cp.async copies (zero-filled past
//    the valid keys): 3 stages for rows of up to 256 bytes, 2 up to 512
//    and 1 above (f32 at hd 144, 160 and 256: two stages at 256 would
//    need 266 KB).  A key's
//    position and page-table entry are read Keys::kAhead tiles before its
//    copies are issued, so no copy waits on a dependent read, and with a
//    deeper queue a run of tiles that no row sees (an early ring is mostly
//    -1) costs a fraction of a memory round trip each; the loop has no
//    block barrier, only the warp's own cp.async groups.  A tile that no row of the block can see
//    is neither copied nor computed.
//  * bf16: mma.sync m16n8k16 with f32 accumulators.  Up to hd 128 the Q
//    fragments stay in registers for the whole loop; above (144, 160,
//    256) they are read from shared memory (ldmatrix) at every tile: at
//    256, 64 more registers beside the 128 of a warp's f32 O would not
//    fit under 255.
//    K comes through ldmatrix, V through ldmatrix.trans.  P goes to bf16
//    for the PV product as two terms, hi = bf16(p) and lo = bf16(p - hi),
//    so the product keeps ~16 bits of p: one bf16 rounding of p (2^-9)
//    would sit above the 1e-3 rms floor of the bf16 tolerance at
//    near-zero outputs.  f32 runs the same ring and fragment layout on
//    the CUDA cores (no TF32).
//  * Each warp keeps its own online softmax (m, l, O) in registers, in
//    base 2 (logits times log2 e, exp2); the warps merge once, through
//    shared memory, at the end.
//  * Split-KV: when the grid would leave SMs idle, the host splits the
//    key axis (from shapes it knows, never from lens or positions) into
//    at most 8 splits.  The splits of one (row tile, kv head) run as one
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
constexpr int kMaxSplits = 8;  // a cluster's portable size
constexpr int kWideRows = kWarps * kRows;  // query rows of a wide block
constexpr int kWideKeys = 64;              // keys of a wide block's tile
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
  int row_tiles;    // row blocks per item: ceil(T * G / 16), or / 64 wide
  int n_split, split_len;  // n_split <= 8: one cluster per split set
  int window;
  float cap, scale;
  int hd;           // the head dim: the rows' stride (<= the compiled width)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
// a 4-byte copy of n (0, 2 or 4) bytes from src, zero-filled after
// them: the ragged path's words
__device__ __forceinline__ void cp_async4n(void* dst, const void* src,
                                           int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
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

// The ragged path's loader: one K row and one V row of hs (<= HD) values
// into shared rows kd, vd, by one warp, 4-byte cp.async copies in the
// caller's group (zeros when !ok), a word a lane.  f32: element c into
// column c.  bf16: a row of odd hd (or of a view at an odd element
// offset) may start on a 2-byte boundary, below cp.async's 4-byte
// copies, so its words are copied from the boundary at or below its
// start (then its element c lands in column c + 1: the row is "led", and
// ragged_shift moves it once it has landed; the element before a led
// row's start is read and dropped), the last word cut at the row's end
// (zero-filled).  Columns past hs + 1, and the pad past the HD columns
// by more than one word, are never written.  Returns the rows that are
// led: bit 0 K, bit 1 V.
template <typename scalar_t, int HD>
__device__ __forceinline__ unsigned ragged_row(unsigned char* kd,
                                               unsigned char* vd,
                                               const scalar_t* ks,
                                               const scalar_t* vs, bool ok,
                                               int hs, int lane) {
  if constexpr (sizeof(scalar_t) == 4) {
    constexpr int NI = (HD + 31) / 32;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < hs) {
        cp_async4n(kd + d * 4, ks + d, ok ? 4 : 0);
        cp_async4n(vd + d * 4, vs + d, ok ? 4 : 0);
      }
    }
    return 0u;
  } else {
    constexpr int NI = (HD / 2 + 1 + 31) / 32;  // HD / 2 words, one more led
    const int lk = ok ? (int)((reinterpret_cast<uintptr_t>(ks) >> 1) & 1) : 0;
    const int lv = ok ? (int)((reinterpret_cast<uintptr_t>(vs) >> 1) & 1) : 0;
    const int bk = 2 * (lk + hs), bv = 2 * (lv + hs);  // bytes to copy
    const char* gk = reinterpret_cast<const char*>(ks - lk);
    const char* gv = reinterpret_cast<const char*>(vs - lv);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int b = 4 * (lane + 32 * i);
      if (b < bk) cp_async4n(kd + b, gk + b, ok ? min(4, bk - b) : 0);
      if (b < bv) cp_async4n(vd + b, gv + b, ok ? min(4, bv - b) : 0);
    }
    return (unsigned)(lk | (lv << 1));
  }
}

// Moves a led bf16 row (ragged_row) left by one column in place, once its
// copies have landed, by one warp, and zeroes its columns from hs on.
// Word i takes the high half of word i + 1 (the word past the HD columns,
// in the row's pad, when hs == HD).
template <int HD>
__device__ __forceinline__ void ragged_shift(unsigned char* row, int hs,
                                             int lane) {
  constexpr int NW = HD / 2, NK = (NW + 31) / 32;
  unsigned* w = reinterpret_cast<unsigned*>(row);
  unsigned out[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int i = lane + 32 * k;
    unsigned v = 0u;
    if (i < NW && 2 * i < hs) {
      v = __funnelshift_r(w[i], 2 * i + 1 < hs ? w[i + 1] : 0u, 16);
      if (2 * i + 1 >= hs) v &= 0xffffu;
    }
    out[k] = v;
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int i = lane + 32 * k;
    if (i < NW) w[i] = out[k];
  }
}

// Zeros the 16-byte chunks from the one holding column hs to the row's
// end (HD columns of ES bytes) in n shared rows of stride RS at p, one
// chunk a thread of nthr; the ragged loader's copies follow a barrier.
template <int HD, int ES, int RS>
__device__ __forceinline__ void zero_tails(unsigned char* p, int n, int hs,
                                           int tid, int nthr) {
  constexpr int CPR = HD * ES / 16;
  const int c0 = hs * ES / 16, per = CPR - c0;
  for (int i = tid; i < n * per; i += nthr) {
    const int r = i / per;
    *reinterpret_cast<uint4*>(p + r * RS + (c0 + i - r * per) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// the Q fragments (mma A operand, m16 x k16 per k-step) of the 16 rows at
// Qt, whose shared-memory stride is RS bytes
template <int HD, int RS>
__device__ __forceinline__ void load_qfrags(uint32_t (&qf)[HD / 16][4],
                                            const unsigned char* Qt,
                                            int lane) {
  const unsigned char* p =
      Qt + ((lane & 7) + ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 16;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) ldsm_x4(qf[kk], p + kk * 32);
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

// The wide block: kWideRows query rows (a 16-row tile per warp) over a
// block-wide ring of kWideKeys-key K/V tiles; the keys' (position, owner)
// and (row, pair); the split merge's (O, (m, l), weights) in the ring's
// space.
template <int HD, int ES, int STAGES>
struct WideSmem {
  static constexpr int RB = HD * ES;
  static constexpr int RS = RB + kPad;
  static constexpr int CPR = RB / 16;
  static constexpr int kQ = kWideRows * RS;
  static constexpr int kTileBytes = kWideKeys * RS;             // K or V
  static constexpr int kRing = STAGES * 2 * kTileBytes;
  static constexpr int kMerge = kWideRows * (HD + 2 + kMaxSplits) * 4;
  static constexpr int kMeta = STAGES * kWideKeys * 16;         // 2 x int2
  static constexpr int kRowInfo = 3 * kWideRows * 4;
  static constexpr int kBytes =
      kQ + (kRing > kMerge ? kRing : kMerge) + kMeta + kRowInfo;
};

// A warp's online softmax (base 2) over its 16 query rows: lane holds rows
// ra = lane / 4 and rb = ra + 8, columns n * 8 + 2 * (lane % 4) + {0, 1}
// of O; l is this lane's share until the quad sums it.
template <int HD>
struct WarpSoftmax {
  float o[HD / 8][4];
  float m_a, m_b, l_a, l_b;
  __device__ void init() {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    m_a = m_b = kNegBig;
    l_a = l_b = 0.f;
  }
  __device__ void sum_l() {
#pragma unroll
    for (int msk = 1; msk <= 2; msk <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, msk);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, msk);
    }
  }
};
// what a lane's two rows may see: causal horizon, window reference, owner
struct RowPair {
  int ctx_a, qp_a, own_a, ctx_b, qp_b, own_b;
};

// One 16-key tile for a warp's 16 query rows: logits (mma.sync at bf16,
// CUDA cores at f32), scale, softcap on the entries a row sees, mask, the
// online-softmax update and the PV product.  Qt: the rows' Q in shared
// memory (qf: their fragments, when held in registers); Kt, Vt: the
// tile's K and V rows; km: its keys' (position, owner).
template <typename scalar_t, int HD, int RS, bool kQRegs>
__device__ __forceinline__ void attend_tile(
    WarpSoftmax<HD>& w, const uint32_t (&qf)[kQRegs ? HD / 16 : 1][4],
    const unsigned char* Qt, const unsigned char* Kt,
    const unsigned char* Vt, const int2* km, const RowPair& rp,
    const DecodeArgs& a, int lane) {
#if REPRO_ATTN_STOP == 1
  return;
#endif
  constexpr bool kMma = sizeof(scalar_t) == 2;
  constexpr int NT = HD / 8;
  const int ra = lane >> 2, rb = ra + 8, quad = lane & 3;
  const float masked = -__int_as_float(0x7f800000);  // -inf

  // logits of rows ra, rb at keys nt * 8 + 2 * quad + {0, 1}
  float s[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  if constexpr (kMma) {
    const unsigned char* qfrag =
        Qt + ((lane & 7) + ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 16;
    const int krow = (lane & 7) + ((lane >> 4) << 3);
    const int kcol = ((lane >> 3) & 1) * 8;
    // even and odd k-steps in two accumulators: half the dependent chain
    float s2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t b[4];
      ldsm_x4(b, Kt + krow * RS + (kk * 16 + kcol) * 2);
      float (&acc)[2][4] = (kk & 1) ? s2 : s;
      if constexpr (kQRegs) {
        mma_bf16(acc[0], qf[kk], b[0], b[1]);
        mma_bf16(acc[1], qf[kk], b[2], b[3]);
      } else {
        uint32_t qa[4];
        ldsm_x4(qa, qfrag + kk * 32);
        mma_bf16(acc[0], qa, b[0], b[1]);
        mma_bf16(acc[1], qa, b[2], b[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] += s2[nt][i];
  } else {
    const float* qa = reinterpret_cast<const float*>(Qt + ra * RS);
    const float* qb = reinterpret_cast<const float*>(Qt + rb * RS);
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
  w.o[0][0] += s[0][0] + s[0][1] + s[0][2] + s[0][3] + s[1][0] + s[1][1] +
               s[1][2] + s[1][3];
  return;
#endif
  // scale, softcap, mask; the tile's row maxima
  float mx_a = masked, mx_b = masked;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int2 k = km[nt * 8 + 2 * quad + e];
      const bool okk = k.x >= 0;
      const bool va = okk && k.x <= rp.ctx_a &&
                      (a.window <= 0 || (long long)rp.qp_a - k.x < a.window) &&
                      (k.y < 0 || k.y == rp.own_a);
      const bool vb = okk && k.x <= rp.ctx_b &&
                      (a.window <= 0 || (long long)rp.qp_b - k.x < a.window) &&
                      (k.y < 0 || k.y == rp.own_b);
      float xa = s[nt][e] * a.scale, xb = s[nt][2 + e] * a.scale;
      if (a.cap > 0.f) {  // only where seen: pad rows are most rows
        if (va) xa = a.cap * tanhf(xa / a.cap);
        if (vb) xb = a.cap * tanhf(xb / a.cap);
      }
      xa *= kLog2e;  // the softmax runs in base 2
      xb *= kLog2e;
      s[nt][e] = va ? xa : masked;
      s[nt][2 + e] = vb ? xb : masked;
      mx_a = fmaxf(mx_a, s[nt][e]);
      mx_b = fmaxf(mx_b, s[nt][2 + e]);
    }
  }
#pragma unroll
  for (int msk = 1; msk <= 2; msk <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, msk));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, msk));
  }
  const float mn_a = fmaxf(w.m_a, mx_a), mn_b = fmaxf(w.m_b, mx_b);
  const float cr_a = exp2f(w.m_a - mn_a), cr_b = exp2f(w.m_b - mn_b);
  w.m_a = mn_a;
  w.m_b = mn_b;
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
  w.l_a = w.l_a * cr_a + ps_a;  // this lane's keys; the quad sums at the end
  w.l_b = w.l_b * cr_b + ps_b;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    w.o[n][0] *= cr_a;
    w.o[n][1] *= cr_a;
    w.o[n][2] *= cr_b;
    w.o[n][3] *= cr_b;
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
      mma_bf16(w.o[2 * dd], ph, b[0], b[1]);
      mma_bf16(w.o[2 * dd], pl, b[0], b[1]);
      mma_bf16(w.o[2 * dd + 1], ph, b[2], b[3]);
      mma_bf16(w.o[2 * dd + 1], pl, b[2], b[3]);
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
        w.o[n][0] = fmaf(pa, v.x, w.o[n][0]);
        w.o[n][1] = fmaf(pa, v.y, w.o[n][1]);
        w.o[n][2] = fmaf(pb, v.x, w.o[n][2]);
        w.o[n][3] = fmaf(pb, v.y, w.o[n][3]);
      }
    }
  }
}

// Split-KV merge.  The n_split blocks of one (row tile, kv head) run as
// one thread-block cluster; each holds its split's part of the tile's
// nrows rows in shared memory, O unnormalised (Bo, nrows x HD f32) and
// (m, l) (Bml).  After a cluster barrier every block merges a 1/n_split
// share of the outputs: threads r < nrows turn the splits' (m, l) into
// weights (Wz, kMaxSplits a row; a split that saw no key has l = 0 and
// weight 0), then each thread reads its 4 outputs' parts from every
// split's shared memory (16-byte reads, all in flight together), so the
// merge costs about two round trips, not one per row.  All leave together.
// kRag: only the columns below hs are stored, element by element.
template <int HD, bool kRag, typename scalar_t, typename OutOff>
__device__ __forceinline__ void cluster_merge(float* Bo, float2* Bml,
                                              float* Wz, int nrows,
                                              int n_split, scalar_t* out,
                                              OutOff out_off, int hs) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int tid = threadIdx.x, rank = (int)cluster.block_rank();
  for (int r = tid; r < nrows; r += kDecThreads) {
    float2 ml[kMaxSplits];
    float M = kNegBig;
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z) {
      ml[z] = z < n_split ? cluster.map_shared_rank(Bml, z)[r]
                          : make_float2(kNegBig, 0.f);
      M = fmaxf(M, ml[z].x);
    }
    float l = 0.f;
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z) {
      ml[z].x = exp2f(ml[z].x - M);
      l += ml[z].y * ml[z].x;
    }
    const float inv = 1.f / fmaxf(l, 1e-20f);
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z)
      Wz[r * kMaxSplits + z] = ml[z].x * inv;
  }
  __syncthreads();
  const int n4 = nrows * HD / 4;
  for (int e4 = rank * kDecThreads + tid; e4 < n4;
       e4 += n_split * kDecThreads) {
    float4 part[kMaxSplits];
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z)
      if (z < n_split)
        part[z] = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(Bo, z))[e4];
    const int r = e4 * 4 / HD, d = e4 * 4 - r * HD;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z) {
      if (z < n_split) {
        const float c = Wz[r * kMaxSplits + z];
        acc.x = fmaf(c, part[z].x, acc.x);
        acc.y = fmaf(c, part[z].y, acc.y);
        acc.z = fmaf(c, part[z].z, acc.z);
        acc.w = fmaf(c, part[z].w, acc.w);
      }
    }
    if constexpr (kRag) {
      if (d >= hs) continue;
      scalar_t* o4 = out + out_off(r, d);
      const float v[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (d + i < hs) o4[i] = from_f<scalar_t>(v[i]);
    } else {
      scalar_t* o4 = out + out_off(r, d);
      o4[0] = from_f<scalar_t>(acc.x);
      o4[1] = from_f<scalar_t>(acc.y);
      o4[2] = from_f<scalar_t>(acc.z);
      o4[3] = from_f<scalar_t>(acc.w);
    }
  }
  cluster.sync();  // no block leaves while its shared memory is read
}

template <typename scalar_t, int HD, int STAGES, typename Keys, bool kRag>
__global__ void __launch_bounds__(kDecThreads)
    decode_attention_kernel(const Keys keys, const DecodeArgs a) {
  using L = DecodeSmem<HD, (int)sizeof(scalar_t), STAGES>;
  constexpr int ES = (int)sizeof(scalar_t);
  constexpr bool kMma = sizeof(scalar_t) == 2;
  constexpr bool kQRegs = kMma && HD <= 128;  // else Q is read per tile
  constexpr int RS = L::RS, CPR = L::CPR, NT = HD / 8;
  static_assert(HD % 16 == 0 && CPR % 2 == 0,
                "compiled width: 16, 32, 64, 80, 96, 128, 144, 160 or 256");
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
  const int hs = kRag ? a.hd : HD;  // the rows' stride in device memory

  // query rows: row r of the tile is token (r0 + r) / G, head (r0 + r) % G
  for (int r = tid; r < kRows; r += kDecThreads) {
    Tok t{-1, 0, -2};  // a pad row sees nothing
    if (r < nrows) t = keys.token(item, (r0 + r) / G);
    rctx[r] = t.ctx;
    rqp[r] = t.qp;
    rown[r] = t.owner;
  }
  if constexpr (kRag) {
    // every column of the q tile (zeros past hs), and the ring's columns
    // past hs zeroed once (the barrier below orders them before the copies)
    for (int e = tid; e < kRows * HD; e += kDecThreads) {
      const int r = e / HD, d = e - r * HD;
      scalar_t x = from_f<scalar_t>(0.f);
      if (r < nrows && d < hs) {
        const int rr = r0 + r;
        x = static_cast<const scalar_t*>(a.q)
            [((tok0 + rr / G) * a.H + (size_t)kvh * G + rr % G) * hs + d];
      }
      *reinterpret_cast<scalar_t*>(Qs + r * RS + d * ES) = x;
    }
    zero_tails<HD, ES, RS>(ring, kWarps * STAGES * 2 * kKeys, hs, tid,
                           kDecThreads);
  } else {
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
  // information are in flight (pre[] for the prologue's copies, ahead[0]
  // for warp tile STAGES - 1), then those of the next KA - 1 tiles the
  // warp walks: ahead[i] is warp tile STAGES - 1 + i
  constexpr int KA = Keys::kAhead;
  Key pre[STAGES > 1 ? STAGES - 1 : 1];
  Key ahead[KA];
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) pre[st] = load_key(st);
  ahead[0] = load_key(STAGES - 1);
#pragma unroll
  for (int i = 1; i < KA; ++i)
    ahead[i] = STAGES - 1 + i < nw ? load_key(STAGES - 1 + i)
                                   : Key{-1, -1, 0, 0};
  __syncthreads();

  // the block's widest horizon and earliest window reference: a key
  // outside both is visible to none of its rows
  int ctx_max = -1, qp_min = 0x7fffffff;
  for (int r = 0; r < nrows; ++r) {
    ctx_max = max(ctx_max, rctx[r]);
    qp_min = min(qp_min, rqp[r]);
  }
  const int ra = lane >> 2, rb = ra + 8, quad = lane & 3;
  const RowPair rp{rctx[ra], rqp[ra], rown[ra], rctx[rb], rqp[rb], rown[rb]};
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
      if constexpr (kRag) {  // a key's row at a time, a word a lane
        unsigned led = 0;  // bit key: K row led, bit 16 + key: V row
#pragma unroll 2
        for (int key = 0; key < kKeys; ++key) {
          const int row = __shfl_sync(0xffffffffu, k.row, key);
          const int buf = __shfl_sync(0xffffffffu, k.buf, key);
          const bool kok = __shfl_sync(0xffffffffu, ok, key);
          const size_t off = ((size_t)row * a.KV + kvh) * hs;
          const unsigned l = ragged_row<scalar_t, HD>(
              kd + key * RS, vd + key * RS, (buf ? k1 : k0) + off,
              (buf ? v1 : v0) + off, kok, hs, lane);
          led |= ((l & 1u) << key) | ((l >> 1) << (16 + key));
        }
        // kept in the last word of the stage's first K row's pad (a led
        // copy overruns the HD columns by one word at most)
        if (lane == 0) *reinterpret_cast<unsigned*>(kd + L::RB + 12) = led;
      } else {
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
    }
    cp_async_commit();
    return live;
  };

  // Q fragments (A operand, m16 x k16 per k-step): held in registers up
  // to hd 128, else read from shared memory where they are used
  uint32_t qf[kQRegs ? HD / 16 : 1][4];
  if constexpr (kQRegs) load_qfrags<HD, RS>(qf, Qs, lane);

  WarpSoftmax<HD> w;
  w.init();
  unsigned live_bits = 0;

  // prologue: copies of the first STAGES - 1 tiles
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nw) {
      if (issue(pre[st], st)) live_bits |= 1u << st;
    } else {
      cp_async_commit();
    }
  }

  for (int j = 0; j < nw; ++j) {
    const int stage = j % STAGES;
    __syncwarp();  // every lane is done with the stage refilled below
    {
      const int jn = j + STAGES - 1, sn = jn % STAGES;
      if (jn < nw) {
        const bool live = issue(ahead[0], sn);
        live_bits = (live_bits & ~(1u << sn)) | ((unsigned)live << sn);
      } else {
        cp_async_commit();
      }
      // the key queue moves one tile on (registers: indices are static)
#pragma unroll
      for (int i = 0; i + 1 < KA; ++i) ahead[i] = ahead[i + 1];
      if (jn + KA < nw) ahead[KA - 1] = load_key(jn + KA);
    }
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    if (!((live_bits >> stage) & 1u)) continue;
    if constexpr (kRag && kMma) {  // move the led bf16 rows into place
      unsigned char* st = my_ring + stage * 2 * L::kTileBytes;
      for (unsigned led = *reinterpret_cast<const unsigned*>(st + L::RB + 12);
           led; led &= led - 1) {
        const int b = __ffs(led) - 1;
        ragged_shift<HD>(st + (b < 16 ? b * RS : L::kTileBytes +
                                                     (b - 16) * RS),
                         hs, lane);
      }
      __syncwarp();
    }
    attend_tile<scalar_t, HD, RS, kQRegs>(
        w, qf, Qs, my_ring + stage * 2 * L::kTileBytes,
        my_ring + stage * 2 * L::kTileBytes + L::kTileBytes,
        my_meta + stage * kKeys, rp, a, lane);
  }
  cp_async_wait<0>();
  w.sum_l();

  // merge the warps' (m, l, O) through shared memory (the ring's space)
  __syncthreads();
  float* Mw = reinterpret_cast<float*>(ring);
  float* Lw = Mw + kWarps * kRows;
  float* Ow = Lw + kWarps * kRows;
  if (quad == 0) {
    Mw[warp * kRows + ra] = w.m_a;
    Mw[warp * kRows + rb] = w.m_b;
    Lw[warp * kRows + ra] = w.l_a;
    Lw[warp * kRows + rb] = w.l_b;
  }
  if (ra < nrows) {  // pad rows are never read back
    float* wa = Ow + ((size_t)warp * kRows + ra) * HD + 2 * quad;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(wa + n * 8) =
          make_float2(w.o[n][0], w.o[n][1]);
  }
  if (rb < nrows) {
    float* wb = Ow + ((size_t)warp * kRows + rb) * HD + 2 * quad;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(wb + n * 8) =
          make_float2(w.o[n][2], w.o[n][3]);
  }
  __syncthreads();

  scalar_t* out = static_cast<scalar_t*>(a.out);
  auto out_off = [&](int r, int d) -> size_t {
    const int rr = r0 + r;
    return ((tok0 + rr / G) * a.H + (size_t)kvh * G + rr % G) * hs + d;
  };
  // the block's (m, l, O): the output itself, or this split's part
  float* Bo = Ow + (size_t)kWarps * kRows * HD;  // (kRows, HD) unnormalised
  float2* Bml = reinterpret_cast<float2*>(Bo + kRows * HD);  // (m, l)
  for (int e = tid; e < nrows * HD; e += kDecThreads) {
    const int r = e / HD, d = e - r * HD;
    float M = kNegBig;
#pragma unroll
    for (int u = 0; u < kWarps; ++u) M = fmaxf(M, Mw[u * kRows + r]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int u = 0; u < kWarps; ++u) {
      const float c = exp2f(Mw[u * kRows + r] - M);
      l += Lw[u * kRows + r] * c;
      acc += Ow[((size_t)u * kRows + r) * HD + d] * c;
    }
    if (a.n_split == 1) {
      if (!kRag || d < hs)
        out[out_off(r, d)] = from_f<scalar_t>(acc / fmaxf(l, 1e-20f));
    } else {
      Bo[e] = acc;
      if (d == 0) Bml[r] = make_float2(M, l);
    }
  }
  if (a.n_split == 1) return;
  cluster_merge<HD, kRag>(Bo, Bml, Ow, nrows, a.n_split, out, out_off, hs);
}

// The wide block, for rows that need more than a few 16-row tiles
// (prefill, the cache-less forward, an encoder's bidirectional rows): 64
// query rows of one kv head, a 16-row tile per warp, over a block-wide
// ring of 64-key K/V tiles, so each K/V tile is read once for 64 rows
// instead of once per 16.  Every thread copies (consecutive threads on
// consecutive 16-byte chunks of a row); the first 64 threads hold one key
// each of the tiles ahead, read Keys::kAhead tiles before their copies.  A
// tile no row of the block sees is neither copied nor computed, and a
// warp skips each 16-key part of a tile that none of its rows sees (the
// keys past a causal tile's last row).  Per tile: one barrier for the
// landed copies (and the stage freed for the next copies) and one that
// votes whether the next tile is live.  Each warp keeps its rows' online
// softmax to the end; split-KV merges as the decode kernel does.
template <typename scalar_t, int HD, int STAGES, typename Keys, bool kRag>
__global__ void __launch_bounds__(kDecThreads)
    wide_attention_kernel(const Keys keys, const DecodeArgs a) {
  using L = WideSmem<HD, (int)sizeof(scalar_t), STAGES>;
  constexpr int ES = (int)sizeof(scalar_t);
  constexpr bool kMma = sizeof(scalar_t) == 2;
  constexpr bool kQRegs = kMma && HD <= 128;  // else Q is read per tile
  constexpr int RS = L::RS, CPR = L::CPR, NT = HD / 8;
  static_assert(HD % 16 == 0 && (kWideKeys * CPR) % kDecThreads == 0,
                "compiled width: 16, 32, 64, 80, 96, 128, 144, 160 or 256");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* Qs = smem;
  unsigned char* ring = Qs + L::kQ;
  constexpr int ring_span = L::kRing > L::kMerge ? L::kRing : L::kMerge;
  int2* kmeta = reinterpret_cast<int2*>(ring + ring_span);  // (pos, owner)
  int2* kaddr = kmeta + STAGES * kWideKeys;                 // (row, pair)
  int* rctx = reinterpret_cast<int*>(kaddr + STAGES * kWideKeys);
  int* rqp = rctx + kWideRows;
  int* rown = rqp + kWideRows;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int item = blockIdx.x / a.row_tiles;
  const int r0 = (blockIdx.x - item * a.row_tiles) * kWideRows;
  const int kvh = blockIdx.y, split = blockIdx.z;
  const int G = a.G;
  const int nrows = min(kWideRows, a.T * G - r0);
  const int tl0 = r0 / G, tl1 = (r0 + nrows - 1) / G;
  const size_t tok0 = (size_t)item * a.T;
  const int hs = kRag ? a.hd : HD;  // the rows' stride in device memory

  for (int r = tid; r < kWideRows; r += kDecThreads) {
    Tok t{-1, 0, -2};  // a pad row sees nothing
    if (r < nrows) t = keys.token(item, (r0 + r) / G);
    rctx[r] = t.ctx;
    rqp[r] = t.qp;
    rown[r] = t.owner;
  }
  if constexpr (kRag) {  // as the decode kernel's
    for (int e = tid; e < kWideRows * HD; e += kDecThreads) {
      const int r = e / HD, d = e - r * HD;
      scalar_t x = from_f<scalar_t>(0.f);
      if (r < nrows && d < hs) {
        const int rr = r0 + r;
        x = static_cast<const scalar_t*>(a.q)
            [((tok0 + rr / G) * a.H + (size_t)kvh * G + rr % G) * hs + d];
      }
      *reinterpret_cast<scalar_t*>(Qs + r * RS + d * ES) = x;
    }
    zero_tails<HD, ES, RS>(ring, STAGES * 2 * kWideKeys, hs, tid,
                           kDecThreads);
  } else {
    for (int c = tid; c < kWideRows * CPR; c += kDecThreads) {
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
  }
  const auto blk = keys.block(item, tl0, tl1);
  const int s_beg = split * a.split_len;
  const int s_end = min(keys.bound(blk), s_beg + a.split_len);
  const int s_lim = min(s_end, keys.limit(blk));
  const int nt = s_lim > s_beg ? (s_lim - s_beg + kWideKeys - 1) / kWideKeys
                               : 0;

  const scalar_t* k0 = static_cast<const scalar_t*>(a.k0);
  const scalar_t* v0 = static_cast<const scalar_t*>(a.v0);
  const scalar_t* k1 = static_cast<const scalar_t*>(a.k1);
  const scalar_t* v1 = static_cast<const scalar_t*>(a.v1);

  // key tid (< kWideKeys) of block tile j
  auto load_key = [&](int j) -> Key {
    const int s = s_beg + j * kWideKeys + tid;
    Key k{-1, -1, 0, 0};
    if (tid < kWideKeys && s < s_end) k = keys.key(blk, s);
    return k;
  };
  // the key queue as in the decode kernel; f32 at hd 256 keeps one tile
  // ahead: its 128 O accumulators leave no registers for more
  constexpr int KA = (kMma || HD <= 128) ? Keys::kAhead : 1;
  Key pre[STAGES > 1 ? STAGES - 1 : 1];
  Key ahead[KA];
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) pre[st] = load_key(st);
  ahead[0] = load_key(STAGES - 1);
#pragma unroll
  for (int i = 1; i < KA; ++i)
    ahead[i] = STAGES - 1 + i < nt ? load_key(STAGES - 1 + i)
                                   : Key{-1, -1, 0, 0};
  __syncthreads();

  // the block's and this warp's widest horizon and earliest window
  // reference
  const int wr0 = warp * kRows;
  int ctx_max = -1, qp_min = 0x7fffffff, wctx = -1, wqp = 0x7fffffff;
  for (int r = 0; r < nrows; ++r) {
    ctx_max = max(ctx_max, rctx[r]);
    qp_min = min(qp_min, rqp[r]);
    if (r >= wr0 && r < wr0 + kRows) {
      wctx = max(wctx, rctx[r]);
      wqp = min(wqp, rqp[r]);
    }
  }
  const int ra = lane >> 2, rb = ra + 8, quad = lane & 3;
  const RowPair rp{rctx[wr0 + ra], rqp[wr0 + ra], rown[wr0 + ra],
                   rctx[wr0 + rb], rqp[wr0 + rb], rown[wr0 + rb]};
  const unsigned char* Qt = Qs + wr0 * RS;

  // issue the copies of block tile j into its ring stage (every thread
  // calls it: it holds a barrier); false when no row sees a key of it
  auto issue = [&](const Key& k, int stage) -> bool {
    const bool vis = k.pos >= 0 && k.pos <= ctx_max &&
                     (a.window <= 0 || (long long)qp_min - k.pos < a.window);
    if (tid < kWideKeys) {
      kmeta[stage * kWideKeys + tid] = make_int2(k.pos, k.owner);
      kaddr[stage * kWideKeys + tid] = make_int2(k.row, k.buf);
    }
    const bool live = __syncthreads_or(vis);
    if (live) {
      unsigned char* kd = ring + stage * 2 * L::kTileBytes;
      unsigned char* vd = kd + L::kTileBytes;
      if constexpr (kRag) {  // warp w fills keys w, w + 4, ..., a word a lane
#pragma unroll 2
        for (int key = warp; key < kWideKeys; key += kWarps) {
          const int2 ad = kaddr[stage * kWideKeys + key];
          const bool ok = kmeta[stage * kWideKeys + key].x >= 0;
          const size_t off = ((size_t)ad.x * a.KV + kvh) * hs;
          ragged_row<scalar_t, HD>(kd + key * RS, vd + key * RS,
                                   (ad.y ? k1 : k0) + off,
                                   (ad.y ? v1 : v0) + off, ok, hs, lane);
        }
      } else {
        constexpr int kVec = 16 / (int)sizeof(scalar_t);
#pragma unroll
        for (int i = 0; i < kWideKeys * CPR / kDecThreads; ++i) {
          const int c = i * kDecThreads + tid;
          const int key = c / CPR, part = c - key * CPR;
          const int2 ad = kaddr[stage * kWideKeys + key];
          const bool ok = kmeta[stage * kWideKeys + key].x >= 0;
          const size_t off = ((size_t)ad.x * a.KV + kvh) * HD + part * kVec;
          cp_async16(kd + key * RS + part * 16, (ad.y ? k1 : k0) + off, ok);
          cp_async16(vd + key * RS + part * 16, (ad.y ? v1 : v0) + off, ok);
        }
      }
    }
    cp_async_commit();
    return live;
  };

  uint32_t qf[kQRegs ? HD / 16 : 1][4];
  if constexpr (kQRegs) load_qfrags<HD, RS>(qf, Qt, lane);
  WarpSoftmax<HD> w;
  w.init();
  unsigned live_bits = 0;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nt) {
      if (issue(pre[st], st)) live_bits |= 1u << st;
    } else {
      cp_async_commit();
    }
  }

  for (int j = 0; j < nt; ++j) {
    const int stage = j % STAGES;
    if constexpr (STAGES > 1) cp_async_wait<STAGES - 2>();
    // tile j has landed for every thread (STAGES > 1), and every warp is
    // done with the stage the next copies fill
    __syncthreads();
    {
      const int jn = j + STAGES - 1, sn = jn % STAGES;
      if (jn < nt) {
        const bool live = issue(ahead[0], sn);
        live_bits = (live_bits & ~(1u << sn)) | ((unsigned)live << sn);
      } else {
        cp_async_commit();
      }
#pragma unroll
      for (int i = 0; i + 1 < KA; ++i) ahead[i] = ahead[i + 1];
      if (jn + KA < nt) ahead[KA - 1] = load_key(jn + KA);
    }
    if constexpr (STAGES == 1) {
      cp_async_wait<0>();
      __syncthreads();
    }
    if (!((live_bits >> stage) & 1u)) continue;
    if constexpr (kRag && kMma) {
      // warp w moves its keys' led bf16 rows into place (ragged_row: a
      // row is led when its start is 2 bytes past a word), then all wait
      unsigned char* st = ring + stage * 2 * L::kTileBytes;
      for (int key = warp; key < kWideKeys; key += kWarps) {
        const int2 ad = kaddr[stage * kWideKeys + key];
        if (kmeta[stage * kWideKeys + key].x < 0) continue;
        const size_t off = ((size_t)ad.x * a.KV + kvh) * hs;
        if ((reinterpret_cast<uintptr_t>((ad.y ? k1 : k0) + off) >> 1) & 1)
          ragged_shift<HD>(st + key * RS, hs, lane);
        if ((reinterpret_cast<uintptr_t>((ad.y ? v1 : v0) + off) >> 1) & 1)
          ragged_shift<HD>(st + L::kTileBytes + key * RS, hs, lane);
      }
      __syncthreads();
    }
    const unsigned char* Kt = ring + stage * 2 * L::kTileBytes;
    const int2* km = kmeta + stage * kWideKeys;
#pragma unroll 1
    for (int u = 0; u < kWideKeys / kKeys; ++u) {
      const int2 k = lane < kKeys ? km[u * kKeys + lane] : make_int2(-1, -1);
      const bool v = k.x >= 0 && k.x <= wctx &&
                     (a.window <= 0 || (long long)wqp - k.x < a.window);
      if (!__any_sync(0xffffffffu, v)) continue;
      attend_tile<scalar_t, HD, RS, kQRegs>(
          w, qf, Qt, Kt + u * kKeys * RS, Kt + L::kTileBytes + u * kKeys * RS,
          km + u * kKeys, rp, a, lane);
    }
  }
  cp_async_wait<0>();
  w.sum_l();

  scalar_t* out = static_cast<scalar_t*>(a.out);
  auto out_off = [&](int r, int d) -> size_t {
    const int rr = r0 + r;
    return ((tok0 + rr / G) * a.H + (size_t)kvh * G + rr % G) * hs + d;
  };
  const int row_a = wr0 + ra, row_b = wr0 + rb;
  if (a.n_split == 1) {
    const float ia = 1.f / fmaxf(w.l_a, 1e-20f);
    const float ib = 1.f / fmaxf(w.l_b, 1e-20f);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if constexpr (kRag) {  // each of a pair's columns below hs
        const int d = n * 8 + 2 * quad;
        if (row_a < nrows && d < hs) {
          scalar_t* oa = out + out_off(row_a, d);
          oa[0] = from_f<scalar_t>(w.o[n][0] * ia);
          if (d + 1 < hs) oa[1] = from_f<scalar_t>(w.o[n][1] * ia);
        }
        if (row_b < nrows && d < hs) {
          scalar_t* ob = out + out_off(row_b, d);
          ob[0] = from_f<scalar_t>(w.o[n][2] * ib);
          if (d + 1 < hs) ob[1] = from_f<scalar_t>(w.o[n][3] * ib);
        }
      } else {
        if (row_a < nrows) {
          scalar_t* oa = out + out_off(row_a, n * 8 + 2 * quad);
          oa[0] = from_f<scalar_t>(w.o[n][0] * ia);
          oa[1] = from_f<scalar_t>(w.o[n][1] * ia);
        }
        if (row_b < nrows) {
          scalar_t* ob = out + out_off(row_b, n * 8 + 2 * quad);
          ob[0] = from_f<scalar_t>(w.o[n][2] * ib);
          ob[1] = from_f<scalar_t>(w.o[n][3] * ib);
        }
      }
    }
    return;
  }
  // this split's part, in the ring's space: every warp is done with it
  __syncthreads();
  float* Bo = reinterpret_cast<float*>(ring);      // (kWideRows, HD)
  float2* Bml = reinterpret_cast<float2*>(Bo + kWideRows * HD);
  float* Wz = reinterpret_cast<float*>(Bml + kWideRows);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (row_a < nrows)
      *reinterpret_cast<float2*>(Bo + row_a * HD + n * 8 + 2 * quad) =
          make_float2(w.o[n][0], w.o[n][1]);
    if (row_b < nrows)
      *reinterpret_cast<float2*>(Bo + row_b * HD + n * 8 + 2 * quad) =
          make_float2(w.o[n][2], w.o[n][3]);
  }
  if (quad == 0) {
    if (row_a < nrows) Bml[row_a] = make_float2(w.m_a, w.l_a);
    if (row_b < nrows) Bml[row_b] = make_float2(w.m_b, w.l_b);
  }
  cluster_merge<HD, kRag>(Bo, Bml, Wz, nrows, a.n_split, out, out_off, hs);
}

// ring stages: 3 for rows of up to 256 bytes, 2 up to 512, else 1 (f32
// at hd 144, 160 and 256: two stages of four warps' K/V tiles would need
// 266 KB at 256); the wide block's 64-key tiles: 2 up to 512 bytes, else 1
template <bool kWide, typename scalar_t, int HD>
constexpr int decode_stages() {
  constexpr int rb = HD * (int)sizeof(scalar_t);
  if (kWide) return rb <= 512 ? 2 : 1;
  return rb <= 256 ? 3 : rb <= 512 ? 2 : 1;
}

template <bool kWide, typename scalar_t, int HD, bool kRag, typename Keys>
int decode_launch_typed(const Keys& keys, const DecodeArgs& a, int n_items,
                        cudaStream_t stream) {
  constexpr int S = decode_stages<kWide, scalar_t, HD>();
  constexpr int ES = (int)sizeof(scalar_t);
  auto kern = [] {  // only the kernel asked for is instantiated
    if constexpr (kWide)
      return wide_attention_kernel<scalar_t, HD, S, Keys, kRag>;
    else
      return decode_attention_kernel<scalar_t, HD, S, Keys, kRag>;
  }();
  constexpr int smem = kWide ? WideSmem<HD, ES, S>::kBytes
                             : DecodeSmem<HD, ES, S>::kBytes;
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

// Launches the decode kernel (kWide: the wide block; a.row_tiles counts
// blocks of 16 or 64 rows to match) over n_items items on bf16 (is_bf16)
// or f32 storage at compiled width `width`: on the aligned path (kRag
// false) the head dim a.hd itself, one of 16, 32, 64, 80, 128, 144, 160
// and 256; on the ragged path one of 16, 32, 64, 96, 128, 160 and 256,
// with 1 <= a.hd <= width (kernels/decode_attention.py::head_dim_path).
// Only the path asked for is instantiated.  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for another width or head dim.
template <bool kWide, bool kRag, typename Keys>
int decode_launch(const Keys& keys, const DecodeArgs& a, int n_items,
                  int width, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kRag ? (a.hd < 1 || a.hd > width) : a.hd != width)
    return (int)cudaErrorInvalidValue;
#define REPRO_DECODE_CASE(HD_)                                              \
  case HD_:                                                                 \
    return is_bf16 ? decode_launch_typed<kWide, __nv_bfloat16, HD_, kRag>(  \
                         keys, a, n_items, s)                               \
                   : decode_launch_typed<kWide, float, HD_, kRag>(          \
                         keys, a, n_items, s);
  if constexpr (kRag) {
    switch (width) {
      REPRO_DECODE_CASE(16)
      REPRO_DECODE_CASE(32)
      REPRO_DECODE_CASE(64)
      REPRO_DECODE_CASE(96)
      REPRO_DECODE_CASE(128)
      REPRO_DECODE_CASE(160)
      REPRO_DECODE_CASE(256)
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (width) {
      REPRO_DECODE_CASE(16)
      REPRO_DECODE_CASE(32)
      REPRO_DECODE_CASE(64)
      REPRO_DECODE_CASE(80)
      REPRO_DECODE_CASE(128)
      REPRO_DECODE_CASE(144)
      REPRO_DECODE_CASE(160)
      REPRO_DECODE_CASE(256)
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
#undef REPRO_DECODE_CASE
}

}  // namespace
