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
// scale * q.k; p = softmax over the visible keys; o = p v.  Positions may
// come in any order.  With dO the output gradient:
//   D_t      = sum_d dO_t * O_t                  (O: the forward's output)
//   dp_ts    = dO_t . v_s
//   dz_ts    = p_ts * (dp_ts - D_t)
//   ds_ts    = dz_ts * (1 - (z_ts / cap)^2)      (1 without a softcap)
//   dq_t     = scale * sum_s ds_ts k_s
//   dk_s     = scale * sum_{t, g} ds_ts q_t      (summed over the G heads)
//   dv_s     = sum_{t, g} p_ts dO_t
// A query that sees no key has o = 0 in the forward kernel, so every
// gradient through it is 0.  Head dims 1-256 and T and S of any length:
// a head dim of 16, 32, 64, 80, 128, 144, 160 or 256 over 16-byte aligned
// storage runs at its own width (the aligned path); any other, or storage
// off a 16-byte boundary, runs at a compiled width HD of 16, 32, 64, 96,
// 128, 160 or 256 above it with the head dim hd the rows' stride (the
// ragged path, kRag; kernels/decode_attention.py::head_dim_path): the
// tiles' columns past hd are zeroed once per block and never written,
// rows load by decode_attention.cuh's ragged_row (4-byte copies; an f32
// row never starts inside a word, so only bf16 rows are shifted), and
// every store to dq, dk and dv is an element's.  The scratch (the chunks'
// dq, dk, dv sums) has rows of HD columns.
//
// What bounds it on the H100: operations, on the tensor cores.  Every
// visible (row, key) pair costs hd-long products: q.k and dO.v in both
// main kernels below (the recomputation), dS k in the dq kernel, P^T dO
// and dS^T q in the dk/dv kernel; at gemma3-4b's training frame (T = S =
// 1280, 8 heads of 256, window 1024) that is ~23 GFLOP, 23 us at the
// card's 989 bf16 TFLOP/s, while the bytes in and out (q, k, v, o, dO,
// dq, dk, dv) take 5 us at 3.35 TB/s.  What holds it back in practice is
// latency: mma.sync tiles fed from shared memory, at most two 4-warp
// blocks an SM at hd 256 (registers and shared memory), and causal walks
// of unequal length.  The design answers with shared-memory tiles read
// by ldmatrix, copies one tile ahead, walks split into chunks so that
// every SM has blocks to run, and address arithmetic kept off the loop.
// At f32 the products run as 3xTF32 (below): three TF32 products each at
// 495 TFLOP/s, 165 TFLOP/s of f32 work against the CUDA cores' 67.  The
// f32 frames the repo trains (the tiny pairs, the draft-head loss,
// granite-moe's draft, the reduced configs) are small: there a kernel's
// time is the latency of one warp's walk, and launches count.
//
// bf16 storage: six kernels on the stream, on 4-warp blocks, with
// mma.sync m16n8k16 (bf16 operands, f32 sums) and ldmatrix operands from
// decode_attention.cuh (.trans for the products whose B operand is stored
// row-major along k: dS K, P^T dO, dS^T Q); every tile lives in shared
// memory as bf16 rows padded by 16 bytes (the stride is an odd multiple
// of 16 bytes, so the eight rows of an ldmatrix hit eight bank groups),
// filled by 16-byte cp.async copies (zeros past the last row or key) in a
// two-stage ring: the next live tile copies while the current one
// computes.  A lane computes one row's address and the copy loop takes
// it by shuffle (a division by G per row and lane cost more than the
// products).
//  1. spans: a {min, max} summary of the positions of every 16 query rows
//     (q_pos, q_ctx) and every 16 keys (k_pos, and whether every / some
//     key is valid).  From two summaries a tile is classed without
//     touching its pairs: skipped when no pair can see (about half the
//     tiles of a causal frame), "full" when every pair sees (no
//     per-element mask), else an edge tile, masked per element (causal,
//     window, q_ctx, k_pos -1, pad rows and keys).  The test is exact for
//     "full" and conservative for "skip": positions out of order may
//     leave a tile that no pair sees on the edge path, which adds zeros.
//     A walk reads the classes of 32 tiles with one ballot pair and steps
//     through the bits; every warp gets the same bits, so no barrier
//     decides.
//  2. rows: per query row (one a warp) D = rowsum(dO * O) and its
//     positions, into a row record {lse, D, q_pos, q_ctx}.
//  3. dq, row-block-outer (grid: 64-row blocks of the T x G rows of one
//     kv head, the last rows first, x chunks; kv heads; batch).  Each warp
//     owns 16 rows; Q and dO stay in shared memory; K/V tiles of 32 keys
//     (16 above hd 128, for registers and two blocks an SM).  One pass:
//     S = Q K^T and dP = dO V^T, then the forward's online softmax carried
//     over to the gradient: dS~ = p~ (dP - D) z' with p~ = 2^(z log2 e -
//     m) for the running max m, rounded to bf16 as the A operand of acc
//     += dS~ K, acc and l rescaled when m moves.  The forward kernel
//     writes no statistics; this pass yields lse without an extra one.
//     A chunk writes its unnormalised acc and (m, l) per row in f32.
//  4. dq merge: per row, M = max m_k, dq = sum_k 2^(m_k - M) acc_k / sum_k
//     2^(m_k - M) l_k in chunk order; lse (base 2) into the row record.
//  5. dk/dv, key-block-outer (grid: 32-key blocks x chunks, kv heads,
//     batch).  K and V stay in shared memory; the block walks the live
//     32-row tiles of its kv head's T x G rows (all G heads: that is the
//     GQA sum) through the ring of Q, dO and row records.  Per tile, (A)
//     each warp computes S^T = K Q^T and dP^T = V dO^T for 16 keys x 16
//     rows, then P^T = 2^(z log2 e - lse) and dS^T = P^T (dP^T - D) z',
//     and writes both to shared memory in bf16 (as FlashAttention-2
//     rounds P and dS); (B) each warp adds P^T dO and dS^T Q into f32 dv
//     and dk: at hd 64, 128 and 256 all 32 keys over every fourth
//     16-column step (a dO or Q fragment feeds both key groups), at the
//     other head dims 16 keys over every other step (balanced for 5, 9
//     and 10 steps).  That split is what fits hd 256: a warp's dk and dv
//     hold 32 keys x 64 columns (128 registers), not 32 x 256.  A chunk
//     writes its dk, dv in f32 and a flag that it saw a live tile.
//  6. dk/dv reduce: per element, the flagged chunks summed in order,
//     then bf16.
// Chunks: a block's walk (key tiles for dq, row tiles for dk/dv) is cut
// into chunks of consecutive live tiles, as many as bring the grid to
// about 800 blocks (at most 8, each at least 8 tiles; from shapes only).
// At gemma3-4b's frame the 160 row blocks and 160 key blocks (40 x 4 kv
// heads) each become 5 chunks: 800 + 800 blocks, two resident an SM at
// hd 256 (107.5 KB of shared memory for dk/dv, 101.5 KB for dq), instead
// of 160 blocks on 132 SMs whose longest causal walk (80 tiles) set the
// kernel's time.
// No atomics: every output and partial element is written once, by one
// thread, from sums in a fixed order, and the chunks are merged in chunk
// order, so two launches give the same bits.
//
// Registers (`chip_smoke.py` phase 1, ptxas), bf16 dq / dk/dv kernel:
// hd 16: 96 / 72, 32: 126 / 72, 64: 128 / 122 (the dq kernel spills 8
// bytes there, as it has since the ragged path's build), 80: 163 / 127,
// 128: 168 / 161, 144: 167 / 167, 160: 167 / 167, 256: 239 / 220 (two
// 4-warp blocks an SM fit 255); the summaries 20, row records 26, merge
// 32-60, reduce 30-32.
//
// f32 storage: the same position summaries, row records, walks, chunk
// merge and sums, on the tensor cores at f32 accuracy, in four launches.
// One TF32 product keeps 11 bits of each operand (2^-11 relative), above
// the f32 tolerance of 1e-4 x max(1, max |g|) and the card-vs-CPU check
// of whole training steps.  So every product is 3xTF32, the scheme of
// CUTLASS's OpMultiplyAddFastF32 (the f32 path of PyTorch's memory-
// efficient attention): each f32 operand x = hi + lo, hi = x rounded to
// TF32 and lo = (x - hi) rounded to TF32 (to nearest, ties away, as
// cvt.rna.tf32.f32), ~21 bits of x, and a b = lo_a hi_b + hi_a lo_b +
// hi_a hi_b into f32 sums, the small terms first, on mma.sync m16n8k8.
// P and dS stay in f32 and are split like any operand (bf16 rounds them).
// ldmatrix moves 16-bit elements, so every fragment is read by 32-bit
// shared loads from rows of HD + 4 floats (4 or 20 words mod 32: each load
// of a warp hits 32 banks); the products whose B operand runs along the
// rows (dS K, P^T dO, dS^T Q) take their A operand straight from the C
// fragment of the product before, its k order permuted (fragA_of_C) and B
// read in that order (load_b), so P^T and dS^T never go to shared memory.
// The operands are split as they are loaded: storing hi and lo would
// double the tiles.
//  1. prep: the summaries and the row records, one launch.
//  2. dq: one-warp blocks of 16 rows walking key tiles of 16 through a
//     cp.async ring (16-byte copies; the ragged path's 4-byte ones; two
//     stages, one when a chunk is one tile), the online softmax of the
//     bf16 kernel, dS~ handed from registers to acc += dS~ K.
//  3. dk/dv: one-warp blocks of 16 keys (two blocks above hd 128, each
//     summing half of dk's and dv's columns, for registers; S^T and dP^T
//     are computed in both) walking row tiles of 16 the same way; each
//     row's lse comes from the dq chunks' (m, l), copied in with its
//     tile, as the merge takes it.
//  4. final: the dq merge and the dk/dv sums, one launch.
// Registers (ptxas, no spills and no stack at any f32 instance), dq /
// dk/dv: hd 16: 80 / 71, 32: 124 / 96, 64: 157 / 157, 80: 161 / 212, 96
// (ragged): 156 / 176, 128: 158 / 233, 144: 164 / 157, 160: 167 / 167,
// 256: 236 / 248; prep 26-32, final 40-94.  Shared memory a block, dq /
// dk/dv with two ring stages (one): hd 32: 13.6 / 18.0 KB (9.1 / 11.2),
// 96: 37.6 / 42.0 (25.1 / 27.2), 256: 97.6 / 102.0 (65.1 / 67.2).
// Errors at the f32 training frames (the tiny pair, the draft-head loss,
// granite's draft): 0.007-0.024 of the tolerance (`--flash-bwd`, H100).
// Walks are chunked down to single tiles toward 1056 blocks (eight an
// SM; at most 16 chunks): a lone warp's walk is what the small frames
// wait on, and tiles of 16 halve it (granite's frame on the H100: 0.0420
// ms against 0.0635 with tiles of 32; PERF.md, row 4b).  Launches
// 2-4 are programmatic (cudaLaunchKernelEx): each starts while the one
// before runs, copies its own inputs (Q and dO; K and V), then waits.

#include <climits>

#include "decode_attention.cuh"

// REPRO_BWD_STOP (a -D flag; 0 by default) cuts the kernels short for
// `chip_smoke.py --flash-bwd`: 1 stops every tile after its copies, 3
// skips the copies of every tile after the first (compute alone), 4
// leaves the dk/dv kernel out (the rest timed alone).
#ifndef REPRO_BWD_STOP
#define REPRO_BWD_STOP 0
#endif

namespace {

// Both storage types run on the tensor cores: bf16 as mma.sync m16n8k16
// (bf16 in, f32 sums), f32 as mma.sync m16n8k8 over TF32 pairs (3xTF32).
namespace tc {

constexpr int kThreads = 128;  // 4 warps
constexpr int kSpan = 16;      // rows or keys per position summary
constexpr int kQRows = 64;     // dq kernel: query rows per block, 16 a warp
constexpr int kKBlock = 32;    // dk/dv kernel: keys per block
constexpr int kRTile = 32;     // dk/dv kernel: query rows per tile
constexpr int kTargetBlocks = 800;  // chunks are added up to about this
constexpr int kMinChunk = 8;        // tiles a chunk walks, at least
constexpr int kMaxChunks = 8;       // chunks a walk is split into, at most
constexpr unsigned kFull = 0xffffffffu;
// f32: one-warp blocks of 16 query rows (dq) and 16 keys (dk/dv) over
// tiles of 16 keys or rows, walks chunked down to single tiles until a
// kernel has eight blocks an SM
constexpr int kF32Rows = 16;
constexpr int kF32Keys = 16;
constexpr int kF32Tile = 16;
static_assert(kF32Tile == kSpan, "an f32 tile is one position summary");
constexpr int kF32Target = 1056;
constexpr int kF32MinChunk = 1;

// the dq kernel's keys per tile: 16 above hd 128 (registers, and two
// blocks an SM)
__host__ __device__ constexpr int key_tile(int hd) { return hd > 128 ? 16 : 32; }

// the chunks each of n_units walks of n_tiles tiles is split into: as
// many as bring the grid to about `target` blocks, each at least
// `min_chunk` tiles long (causal walks differ in length, and a kernel
// lasts as long as its longest block; more blocks also hide more latency)
__host__ __device__ constexpr int chunks_of(int n_tiles, int n_units,
                                            int target = kTargetBlocks,
                                            int min_chunk = kMinChunk,
                                            int max_chunks = kMaxChunks) {
  const int want = (target + n_units - 1) / n_units;
  const int fit = n_tiles / min_chunk;
  const int n = want < fit ? want : fit;
  return n < 1 ? 1 : (n > max_chunks ? max_chunks : n);
}

// The blocks of each storage type: query rows of a dq block, keys of a
// dk/dv block, the dq kernel's key tile, the dk/dv kernel's row tile and
// its column splits (f32 above hd 128: two blocks a key block, each
// summing half the columns of dk and dv, for registers), and the chunk
// plan's target and shortest chunk.
template <typename E>
struct Geo;
template <>
struct Geo<__nv_bfloat16> {
  static constexpr int rows = kQRows, keys = kKBlock;
  static constexpr int target = kTargetBlocks, min_chunk = kMinChunk;
  static constexpr int max_chunks = kMaxChunks;
  __host__ __device__ static constexpr int key_tile(int hd) {
    return tc::key_tile(hd);
  }
  __host__ __device__ static constexpr int row_tile(int) { return kRTile; }
  __host__ __device__ static constexpr int splits(int) { return 1; }
};
template <>
struct Geo<float> {
  static constexpr int rows = kF32Rows, keys = kF32Keys;
  static constexpr int target = kF32Target, min_chunk = kF32MinChunk;
  static constexpr int max_chunks = 2 * kMaxChunks;
  __host__ __device__ static constexpr int key_tile(int) { return kF32Tile; }
  __host__ __device__ static constexpr int row_tile(int) { return kF32Tile; }
  __host__ __device__ static constexpr int splits(int hd) {
    return hd > 128 ? 2 : 1;
  }
};

template <typename E>
struct ArgsT {
  const E *q, *k, *v, *o, *dout;
  const int *q_pos, *q_ctx, *k_pos;
  E *dq, *dk, *dv;
  float4* rows;    // (B, KV, T * G): {lse2, D, q_pos, q_ctx} per query row
  int4* spans;     // (B, n_rspan + n_kspan): position summaries
  int* flags;      // (B, KV, n_kb, n_ck): a dk/dv chunk saw a live tile
  float2* stat_q;  // (n_cq, B, KV, n_rb * rows): a dq chunk's (m, l) per row
  float* part_q;   // (n_cq, B, KV, n_rb * rows, HD): its unnormalised dq
  float* part_k;   // (n_ck, 2, B, n_kb * keys, KV, HD): a chunk's dk, dv
  int B, T, S, H, KV, G, causal, window, n_rspan, n_kspan;
  int n_rb, n_cq, cq;  // dq: row blocks; chunks of a walk, key tiles each
  int n_kb, n_ck, ck;  // dk/dv: key blocks; chunks, row tiles each
  float cap, inv_cap, scale;  // inv_cap: 1 / cap (0 without a softcap)
  int hd;  // the head dim: the rows' stride (<= the compiled width)
};
using Args = ArgsT<__nv_bfloat16>;

template <typename E>
__device__ __forceinline__ bool sees(const ArgsT<E>& a, int qp, int qc,
                                     int kp) {
  return kp >= 0 && (!a.causal || kp <= qc) &&
         (a.window <= 0 || (long long)qp - kp < a.window);
}

// the soft-capped scaled logit, and d z / d (q.k) at it
template <typename E>
__device__ __forceinline__ float logit(const ArgsT<E>& a, float dot) {
  const float s = dot * a.scale;
  return a.cap > 0.f ? a.cap * tanhf(s * a.inv_cap) : s;
}
template <typename E>
__device__ __forceinline__ float dlogit(const ArgsT<E>& a, float z) {
  if (a.cap <= 0.f) return a.scale;
  const float t = z * a.inv_cap;
  return (1.f - t * t) * a.scale;
}

// element offset / HD of query row r = t * G + g of kv head kvh
template <typename E>
__device__ __forceinline__ size_t row_base(const ArgsT<E>& a, int b, int kvh,
                                           int r) {
  const int t = r / a.G;
  return ((size_t)b * a.T + t) * a.H + (size_t)kvh * a.G + (r - t * a.G);
}

// Copies n_rows (<= 32 a warp) rows of HD bf16 from two tensors with the
// same row offsets into shared rows of stride RS (16-byte cp.async): a
// warp copies 32 / (HD / 8) rows a step, one chunk a lane.  Lane i first
// computes the offset of the warp's i-th row (off(r): row r's element
// offset, or -1 past the valid rows: zeros), and the copy loop takes it
// by shuffle, so a row's address (a division by G for query rows) costs
// one lane, not a warp instruction per row.  kRag: rows of hs (<= HD)
// values at any 2-byte boundary, a row at a time per warp and a word a
// lane (decode_attention.cuh's ragged_row; lane i computes the offset of
// the warp's i-th row): a row whose start is 2 bytes past a word lands
// one column late, and shift_rows2 moves it once it has landed.
template <int HD, int RS, bool kRag, typename Off>
__device__ __forceinline__ void copy_rows2(unsigned char* d0,
                                           unsigned char* d1,
                                           const __nv_bfloat16* s0,
                                           const __nv_bfloat16* s1,
                                           int n_rows, int warp, int lane,
                                           int hs, Off off) {
  constexpr int NW = kThreads / 32;
  if constexpr (kRag) {
    const int ri = warp + lane * NW;
    const long long mine = ri < n_rows ? off(ri) : -1;
    for (int j = 0; warp + j * NW < n_rows; ++j) {
      const long long o = __shfl_sync(kFull, mine, j);
      const int r = warp + j * NW;
      const size_t e = o >= 0 ? (size_t)o : 0;
      ragged_row<__nv_bfloat16, HD>(d0 + r * RS, d1 + r * RS, s0 + e, s1 + e,
                                    o >= 0, hs, lane);
    }
    return;
  }
  constexpr int CPR = HD / 8, RPS = CPR >= 32 ? 1 : 32 / CPR;
  const int ri = warp * RPS + (lane / RPS) * NW * RPS + lane % RPS;
  const long long mine = ri < n_rows ? off(ri) : -1;
  const int sub = lane / CPR, part = lane - sub * CPR;
  const int steps = (n_rows + NW * RPS - 1) / (NW * RPS);
  for (int j = 0; j < steps; ++j) {
    const long long o =
        __shfl_sync(kFull, mine, j * RPS + (sub < RPS ? sub : 0));
    const int r = warp * RPS + j * NW * RPS + sub;
    if (sub < RPS && r < n_rows) {
      const bool ok = o >= 0;
      const size_t e = ok ? (size_t)o + part * 8 : 0;
      cp_async16(d0 + r * RS + part * 16, s0 + e, ok);
      cp_async16(d1 + r * RS + part * 16, s1 + e, ok);
    }
  }
}

// After copy_rows2<kRag>'s copies have landed (and a block barrier): each
// warp moves the led rows (decode_attention.cuh's ragged_row: a bf16 row
// starting 2 bytes past a word) of rows warp, warp + 4, ... into place;
// off as copy_rows2's.  The caller then waits at a barrier.
template <int HD, int RS, typename Off>
__device__ __forceinline__ void shift_rows2(unsigned char* d0,
                                            unsigned char* d1,
                                            const __nv_bfloat16* s0,
                                            const __nv_bfloat16* s1,
                                            int n_rows, int warp, int lane,
                                            int hs, Off off) {
  for (int r = warp; r < n_rows; r += kThreads / 32) {
    const long long o = off(r);
    if (o < 0) continue;
    if ((reinterpret_cast<uintptr_t>(s0 + o) >> 1) & 1)
      ragged_shift<HD>(d0 + r * RS, hs, lane);
    if ((reinterpret_cast<uintptr_t>(s1 + o) >> 1) & 1)
      ragged_shift<HD>(d1 + r * RS, hs, lane);
  }
}

__device__ __forceinline__ float dot8(const uint4& x, const uint4& y) {
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 xf = __bfloat1622float2(xp[i]);
    const float2 yf = __bfloat1622float2(yp[i]);
    s = fmaf(xf.x, yf.x, s);
    s = fmaf(xf.y, yf.y, s);
  }
  return s;
}

// Position summaries.  A row span: {min q_pos, max q_pos, min q_ctx, max
// q_ctx} over its real rows.  A key span: {min k_pos, max k_pos, every
// key valid, some key valid} over its keys (valid: s < S, k_pos >= 0).
__device__ __forceinline__ int4 merge_rows(int4 x, int4 y) {
  return make_int4(min(x.x, y.x), max(x.y, y.y), min(x.z, y.z),
                   max(x.w, y.w));
}
__device__ __forceinline__ int4 merge_keys(int4 x, int4 y) {
  return make_int4(min(x.x, y.x), max(x.y, y.y), x.z & y.z, x.w | y.w);
}

// A tile of (rows r, keys k): 0 when the summaries prove that no pair
// sees (skipped), 2 when every pair sees (no per-element mask; `whole`:
// the tile has no pad rows), else 1 (an edge tile, masked per element).
template <typename E>
__device__ __forceinline__ int tile_class(const ArgsT<E>& a, int4 r, int4 k,
                                          bool whole) {
  if (!k.w) return 0;
  if (a.causal && r.w < k.x) return 0;
  if (a.window > 0 && (long long)r.x - k.y >= a.window) return 0;
  const bool full = k.z && whole && (!a.causal || k.y <= r.z) &&
                    (a.window <= 0 || (long long)r.y - k.x < a.window);
  return full ? 2 : 1;
}

// A walk over live tiles, 32 at a time: bit j of live (full) marks tile
// base + j as live (seen by every pair).  One ballot pair per 32 tiles;
// every warp evaluates the same summaries and gets the same bits, so no
// block barrier decides.
struct Walk {
  int base;
  unsigned live, full;
  template <typename F>
  __device__ __forceinline__ void load(int b, int n, int lane, F cls) {
    base = b;
    const int j = b + lane;
    const int c = j < n ? cls(j) : 0;
    live = __ballot_sync(kFull, c != 0);
    full = __ballot_sync(kFull, c == 2);
  }
  // the first live tile after cur (n when none), and its class
  template <typename F>
  __device__ __forceinline__ int next(int cur, int n, int lane, F cls,
                                      int& cls_out) {
    const int sh = cur - base;
    unsigned m = sh >= 31 ? 0u : live & (0xfffffffeu << sh);
    while (!m) {
      if (base + 32 >= n) {
        cls_out = 0;
        return n;
      }
      load(base + 32, n, lane, cls);
      m = live;
    }
    const int j = __ffs(m) - 1;
    cls_out = (full >> j) & 1u ? 2 : 1;
    return base + j;
  }
};

// The nth (0-based) tile whose class is not 0, and its class; n when
// there are fewer: 32 tiles a step, counted by ballot.
template <typename F>
__device__ __forceinline__ int nth_live(int nth, int n, int lane, F cls,
                                        int& cls_out) {
  for (int base = 0; base < n; base += 32) {
    const int j = base + lane;
    const int c = j < n ? cls(j) : 0;
    unsigned m = __ballot_sync(kFull, c != 0);
    const int cnt = __popc(m);
    if (nth < cnt) {
      for (int i = 0; i < nth; ++i) m &= m - 1;
      const int src = __ffs(m) - 1;
      cls_out = __shfl_sync(kFull, c, src);
      return base + src;
    }
    nth -= cnt;
  }
  cls_out = 0;
  return n;
}

// One summary per 16 lanes: row spans first, then key spans.
template <typename E>
__device__ __forceinline__ void spans_body(const ArgsT<E>& a, int bx,
                                           int b) {
  const int i = (bx * kThreads + threadIdx.x) / kSpan;
  const int e = threadIdx.x % kSpan;
  const int n = a.n_rspan + a.n_kspan;
  int lo1 = INT_MAX, hi1 = INT_MIN, lo2 = INT_MAX, hi2 = INT_MIN;
  int all = 1, any = 0;
  if (i < a.n_rspan) {
    const int r = i * kSpan + e;
    if (r < a.T * a.G) {
      const size_t bt = (size_t)b * a.T + r / a.G;
      lo1 = hi1 = a.q_pos[bt];
      lo2 = hi2 = a.q_ctx[bt];
    }
  } else if (i < n) {
    const int s = (i - a.n_rspan) * kSpan + e;
    const int kp = s < a.S ? a.k_pos[(size_t)b * a.S + s] : -1;
    if (kp >= 0) lo1 = hi1 = kp;
    all = kp >= 0;
    any = kp >= 0;
  }
#pragma unroll
  for (int off = kSpan / 2; off > 0; off >>= 1) {
    lo1 = min(lo1, __shfl_xor_sync(kFull, lo1, off));
    hi1 = max(hi1, __shfl_xor_sync(kFull, hi1, off));
    lo2 = min(lo2, __shfl_xor_sync(kFull, lo2, off));
    hi2 = max(hi2, __shfl_xor_sync(kFull, hi2, off));
    all &= __shfl_xor_sync(kFull, all, off);
    any |= __shfl_xor_sync(kFull, any, off);
  }
  if (e == 0 && i < n)
    a.spans[(size_t)b * n + i] = i < a.n_rspan
                                     ? make_int4(lo1, hi1, lo2, hi2)
                                     : make_int4(lo1, hi1, all, any);
}
__global__ void __launch_bounds__(kThreads)
    flash_bwd_spans_kernel(const Args a) {
  spans_body(a, blockIdx.x, blockIdx.y);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Per query row (one a warp): D = rowsum(dO * O) and the row's
// positions, into the row records (lse2 comes from the dq merge).
template <int HD, bool kRag, typename E>
__device__ __forceinline__ void rows_body(const ArgsT<E>& a, int bx) {
  constexpr int CPR = HD * (int)sizeof(E) / 16;  // 16-byte chunks a row
  const int hs = kRag ? a.hd : HD;  // the rows' stride in device memory
  const int lane = threadIdx.x & 31;
  const int nrows = a.T * a.G;
  const long long gid = (long long)bx * (kThreads / 32) +
                        (threadIdx.x >> 5);
  if (gid >= (long long)a.B * a.KV * nrows) return;
  const int r = (int)(gid % nrows);
  const int kvh = (int)(gid / nrows % a.KV), b = (int)(gid / nrows / a.KV);
  const size_t base = row_base(a, b, kvh, r) * hs;
  float part = 0.f;
  if constexpr (kRag) {
    for (int d = lane; d < hs; d += 32)
      part = fmaf(to_f(a.o[base + d]), to_f(a.dout[base + d]), part);
  } else if constexpr (sizeof(E) == 2) {
    for (int c = lane; c < CPR; c += 32)
      part += dot8(*reinterpret_cast<const uint4*>(a.o + base + c * 8),
                   *reinterpret_cast<const uint4*>(a.dout + base + c * 8));
  } else {
    for (int c = lane; c < CPR; c += 32) {
      const float4 x = reinterpret_cast<const float4*>(a.o + base)[c];
      const float4 y = reinterpret_cast<const float4*>(a.dout + base)[c];
      part = fmaf(x.x, y.x, part);
      part = fmaf(x.y, y.y, part);
      part = fmaf(x.z, y.z, part);
      part = fmaf(x.w, y.w, part);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(kFull, part, off);
  if (lane == 0) {
    const size_t bt = (size_t)b * a.T + r / a.G;
    a.rows[gid] = make_float4(0.f, part, __int_as_float(a.q_pos[bt]),
                              __int_as_float(a.q_ctx[bt]));
  }
}
template <int HD, bool kRag>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_rows_kernel(const Args a) {
  rows_body<HD, kRag>(a, blockIdx.x);
}

// four f32 values into the output row at column c * 4: elements below hs
// (kRag: a row may start on any element), else one 8- or 16-byte store
template <bool kRag, typename E>
__device__ __forceinline__ void store4(E* p, int c, int hs, float4 x) {
  if constexpr (kRag) {
    const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c * 4 + i < hs) p[c * 4 + i] = from_f<E>(v[i]);
  } else if constexpr (sizeof(E) == 2) {
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(p + c * 4);
    d[0] = __floats2bfloat162_rn(x.x, x.y);
    d[1] = __floats2bfloat162_rn(x.z, x.w);
  } else {
    reinterpret_cast<float4*>(p)[c] = x;
  }
}

// dq of a row (one a warp) from its chunks' (m, l) and unnormalised sums,
// in chunk order: dq = sum_k 2^(m_k - M) acc_k / sum_k 2^(m_k - M) l_k;
// lse2 = M + log2 of the denominator.  A row that sees no key: dq = 0.
template <int HD, bool kRag, typename E, bool kLse = true>
__device__ __forceinline__ void merge_body(const ArgsT<E>& a, int bx) {
  const int hs = kRag ? a.hd : HD;  // the rows' stride in device memory
  const int lane = threadIdx.x & 31;
  const int nrows = a.T * a.G, nrp = a.n_rb * Geo<E>::rows;
  const long long gid = (long long)bx * (kThreads / 32) +
                        (threadIdx.x >> 5);
  if (gid >= (long long)a.B * a.KV * nrows) return;
  const int r = (int)(gid % nrows);
  const long long bk = gid / nrows;  // b * KV + kvh
  const int kvh = (int)(bk % a.KV), b = (int)(bk / a.KV);
  const size_t stride = (size_t)a.B * a.KV * nrp;  // one chunk's rows
  const size_t row = (size_t)bk * nrp + r;
  float M = kNegBig;
  for (int k = 0; k < a.n_cq; ++k) {
    const float2 ml = a.stat_q[k * stride + row];
    if (ml.y > 0.f) M = fmaxf(M, ml.x);
  }
  float w[Geo<E>::max_chunks], L = 0.f;
#pragma unroll
  for (int k = 0; k < Geo<E>::max_chunks; ++k) {
    w[k] = 0.f;
    if (k < a.n_cq) {
      const float2 ml = a.stat_q[k * stride + row];
      if (ml.y > 0.f) {
        w[k] = exp2f(ml.x - M);
        L += w[k] * ml.y;
      }
    }
  }
  const float inv = L > 0.f ? 1.f / L : 0.f;
  E* dq = a.dq + row_base(a, b, kvh, r) * hs;
  for (int c = lane; c < (kRag ? (hs + 3) / 4 : HD / 4); c += 32) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < Geo<E>::max_chunks; ++k) {
      if (w[k] != 0.f) {
        const float4 x = reinterpret_cast<const float4*>(
            a.part_q + (k * stride + row) * HD)[c];
        acc.x = fmaf(w[k], x.x, acc.x);
        acc.y = fmaf(w[k], x.y, acc.y);
        acc.z = fmaf(w[k], x.z, acc.z);
        acc.w = fmaf(w[k], x.w, acc.w);
      }
    }
    store4<kRag>(dq, c, hs, make_float4(acc.x * inv, acc.y * inv,
                                        acc.z * inv, acc.w * inv));
  }
  if (kLse && lane == 0) a.rows[gid].x = L > 0.f ? M + log2f(L) : 0.f;
}
template <int HD, bool kRag>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_merge_kernel(const Args a) {
  merge_body<HD, kRag>(a, blockIdx.x);
}

// dk and dv (four columns a thread) from the chunks that saw a live tile,
// summed in chunk order; no live chunk: 0.  The chunks' rows hold HD
// columns; kRag stores the columns below hs, element by element.
template <int HD, bool kRag, typename E>
__device__ __forceinline__ void reduce_body(const ArgsT<E>& a, int bx) {
  constexpr int KB = Geo<E>::keys;
  const long long i = (long long)bx * kThreads + threadIdx.x;
  const long long n4 = (long long)a.B * a.S * a.KV * (HD / 4);
  if (i >= n4) return;
  const int c = (int)(i % (HD / 4));
  const int hs = kRag ? a.hd : HD;  // the rows' stride in device memory
  if (kRag && c * 4 >= hs) return;
  const long long bsk = i / (HD / 4);  // (b * S + s) * KV + kvh
  const int kvh = (int)(bsk % a.KV);
  const int s = (int)(bsk / a.KV % a.S), b = (int)(bsk / a.KV / a.S);
  const int kb = s / KB, sp = a.n_kb * KB;
  const size_t prow = ((size_t)b * sp + s) * a.KV + kvh;  // in a chunk half
  const size_t half = (size_t)a.B * sp * a.KV * HD;
  const int* fl = a.flags + (((size_t)b * a.KV + kvh) * a.n_kb + kb) * a.n_ck;
  float4 dk = make_float4(0.f, 0.f, 0.f, 0.f), dv = dk;
  for (int k = 0; k < a.n_ck; ++k) {
    if (!fl[k]) continue;
    const float* base = a.part_k + 2 * k * half + prow * HD;
    const float4 x = reinterpret_cast<const float4*>(base)[c];
    const float4 y = reinterpret_cast<const float4*>(base + half)[c];
    dk.x += x.x; dk.y += x.y; dk.z += x.z; dk.w += x.w;
    dv.x += y.x; dv.y += y.y; dv.z += y.z; dv.w += y.w;
  }
  if constexpr (kRag) {
    const float xk[4] = {dk.x, dk.y, dk.z, dk.w};
    const float xv[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c * 4 + e < hs) {
        a.dk[bsk * hs + c * 4 + e] = from_f<E>(xk[e]);
        a.dv[bsk * hs + c * 4 + e] = from_f<E>(xv[e]);
      }
    }
    return;
  }
  store4<false>(a.dk + bsk * HD, c, hs, dk);
  store4<false>(a.dv + bsk * HD, c, hs, dv);
}
template <int HD, bool kRag>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_reduce_kernel(const Args a) {
  reduce_body<HD, kRag>(a, blockIdx.x);
}

template <int HD>
struct DqSmem {
  static constexpr int RS = HD * 2 + kPad;           // a bf16 row's stride
  static constexpr int KT = key_tile(HD);            // keys per tile
  static constexpr int kQ = kQRows * RS;             // Q, then dO
  static constexpr int kTile = KT * RS;              // a K or V tile
  static constexpr int kStage = 2 * kTile + KT * 4;  // K, V, k_pos
  static constexpr int kBytes = 2 * kQ + 2 * kStage;
};

// One chunk of a 64-row block's walk over its live key tiles, in one
// pass: the online softmax of the forward, with dS~ = p~ (dP - D) z'
// summed into acc as p~ is into O; the chunk's acc and (m, l) per row go
// to the dq merge.
template <int HD, bool kRag>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_mma_kernel(const Args a) {
  using L = DqSmem<HD>;
  constexpr int RS = L::RS, KT = L::KT, NKT = KT / 8, KS = HD / 16;
  const int hs = kRag ? a.hd : HD;  // the rows' stride in device memory
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sQ = smem;
  unsigned char* sO = sQ + L::kQ;
  unsigned char* ring = sO + L::kQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, kvh = blockIdx.y;
  // chunk `chunk` of the walk of row block rb; the last rows first: under
  // a causal mask they see the most keys
  const int chunk = blockIdx.x % a.n_cq;
  const int r0 = (a.n_rb - 1 - (int)(blockIdx.x / a.n_cq)) * kQRows;
  const int nrows = a.T * a.G;
  const float masked = -__int_as_float(0x7f800000);  // -inf
  const size_t prow = ((size_t)chunk * a.B * a.KV + (size_t)b * a.KV + kvh) *
                          a.n_rb * kQRows + r0;  // the block's partial rows

  const int4* rsp = a.spans + (size_t)b * (a.n_rspan + a.n_kspan);
  const int4* ksp = rsp + a.n_rspan;
  int4 R = rsp[r0 / kSpan];
#pragma unroll
  for (int i = 1; i < kQRows / kSpan; ++i)
    if (r0 / kSpan + i < a.n_rspan) R = merge_rows(R, rsp[r0 / kSpan + i]);
  const bool whole = r0 + kQRows <= nrows;
  const int n_kt = (a.S + KT - 1) / KT;
  auto cls = [&](int j) {
    int4 K = ksp[j * (KT / kSpan)];
    if (KT > kSpan) {
      if (j * 2 + 1 < a.n_kspan) K = merge_keys(K, ksp[j * 2 + 1]);
      else K.z = 0;
    }
    return tile_class(a, R, K, whole);
  };
  // K, V and k_pos of key tile j into a ring stage (one cp.async group
  // a call, empty when j is past the last tile)
  auto issue = [&](int j, int stage) {
    if (j < n_kt) {
      unsigned char* st = ring + stage * L::kStage;
      const int s0 = j * KT;
      copy_rows2<HD, RS, kRag>(st, st + L::kTile, a.k, a.v, KT, warp, lane,
                               hs, [&](int jj) -> long long {
                                 return s0 + jj < a.S
                                            ? (long long)((((size_t)b * a.S +
                                                            s0 + jj) * a.KV +
                                                           kvh) * hs)
                                            : -1;
                               });
      if (tid < KT) {
        const int s = s0 + tid;
        const bool ok = s < a.S;
        cp_async4n(st + 2 * L::kTile + tid * 4,
                   a.k_pos + (ok ? (size_t)b * a.S + s : 0), ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  int cur_cls;
  int cur = nth_live(chunk * a.cq, n_kt, lane, cls, cur_cls);
  if (cur >= n_kt) {  // no live tile in this chunk: its rows see nothing
    if (tid < kQRows) a.stat_q[prow + tid] = make_float2(kNegBig, 0.f);
    return;
  }
  Walk walk;
  walk.load(cur & ~31, n_kt, lane, cls);
  if constexpr (kRag) {  // the tiles' columns past hs, once (Q, dO; K, V)
    zero_tails<HD, 2, RS>(sQ, 2 * kQRows, hs, tid, kThreads);
    zero_tails<HD, 2, RS>(ring, 2 * KT, hs, tid, kThreads);
    zero_tails<HD, 2, RS>(ring + L::kStage, 2 * KT, hs, tid, kThreads);
    __syncthreads();
  }
  copy_rows2<HD, RS, kRag>(sQ, sO, a.q, a.dout, kQRows, warp, lane, hs,
                           [&](int rr) -> long long {
                             return r0 + rr < nrows
                                        ? (long long)(row_base(a, b, kvh,
                                                               r0 + rr) * hs)
                                        : -1;
                           });
  cp_async_commit();
  issue(cur, 0);

  // the warp's fragment rows ra (C elements 0, 1) and rb (2, 3)
  const int g = lane >> 2, quad = lane & 3;
  const int rA = r0 + warp * 16 + g, rB = rA + 8;
  const bool realA = rA < nrows, realB = rB < nrows;
  // their D and positions, from the row records
  const float4* rec = a.rows + ((size_t)b * a.KV + kvh) * nrows;
  const float4 iA = realA ? rec[rA] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 iB = realB ? rec[rB] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float DA = iA.y, DB = iB.y;
  const int qpA = __float_as_int(iA.z), qcA = __float_as_int(iA.w);
  const int qpB = __float_as_int(iB.z), qcB = __float_as_int(iB.w);

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = kNegBig, m_b = kNegBig, l_a = 0.f, l_b = 0.f;
  const unsigned char* qfrag =
      sQ + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
      (lane >> 4) * 16;
  const unsigned char* ofrag = qfrag + L::kQ;
  const int krow = (lane & 7) + ((lane >> 4) << 3), kcol = ((lane >> 3) & 1) * 8;
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8, vcol = (lane >> 4) * 8;
  int stage = 0, left = a.cq;
  [[maybe_unused]] bool first = true;  // kRag: Q / dO (K / V) still led
  while (cur < n_kt) {
    int nxt_cls = 0, nxt = n_kt;
    if (--left > 0) nxt = walk.next(cur, n_kt, lane, cls, nxt_cls);
    cp_async_wait<0>();
    __syncthreads();  // the tile is in; every warp is done with the other stage
#if REPRO_BWD_STOP == 3
    cp_async_commit();
#else
    issue(nxt, stage ^ 1);
#endif
    if constexpr (kRag) {  // the led rows of this tile (and of Q, dO)
      unsigned char* st = ring + stage * L::kStage;
      const int s0 = cur * KT;
      shift_rows2<HD, RS>(st, st + L::kTile, a.k, a.v, KT, warp, lane, hs,
                          [&](int jj) -> long long {
                            return s0 + jj < a.S
                                       ? (long long)((((size_t)b * a.S + s0 +
                                                       jj) * a.KV + kvh) * hs)
                                       : -1;
                          });
      if (first)
        shift_rows2<HD, RS>(sQ, sO, a.q, a.dout, kQRows, warp, lane, hs,
                            [&](int rr) -> long long {
                              return r0 + rr < nrows
                                         ? (long long)(row_base(a, b, kvh,
                                                                r0 + rr) * hs)
                                         : -1;
                            });
      first = false;
      __syncthreads();
    }
    const unsigned char* Kt = ring + stage * L::kStage;
    const unsigned char* Vt = Kt + L::kTile;
    const int* kpt = reinterpret_cast<const int*>(Kt + 2 * L::kTile);
#if REPRO_BWD_STOP == 1
    acc[0][0] += kpt[lane & 15];
    cur = nxt;
    cur_cls = nxt_cls;
    stage ^= 1;
    continue;
#endif

    // S = Q K^T and dP = dO V^T: rows ra, rb at keys nt * 8 + 2 quad + {0, 1}
    float s[NKT][4], dp[NKT][4];
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], oa[4];
      ldsm_x4(qa, qfrag + kk * 32);
      ldsm_x4(oa, ofrag + kk * 32);
#pragma unroll
      for (int np = 0; np < NKT / 2; ++np) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, Kt + (np * 16 + krow) * RS + (kk * 16 + kcol) * 2);
        ldsm_x4(bv, Vt + (np * 16 + krow) * RS + (kk * 16 + kcol) * 2);
        mma_bf16(s[2 * np], qa, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
        mma_bf16(dp[2 * np], oa, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], oa, bv[2], bv[3]);
      }
    }
    // logits (natural units) where seen, -inf elsewhere; the rows' maxima
    const int s0 = cur * KT;
    float mx_a = masked, mx_b = masked;
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jj = nt * 8 + 2 * quad + e;
        bool va = true, vb = true;
        if (cur_cls != 2) {
          const int kp = kpt[jj];
          const bool ks = s0 + jj < a.S;
          va = ks && realA && sees(a, qpA, qcA, kp);
          vb = ks && realB && sees(a, qpB, qcB, kp);
        }
        s[nt][e] = va ? logit(a, s[nt][e]) : masked;
        s[nt][2 + e] = vb ? logit(a, s[nt][2 + e]) : masked;
        mx_a = fmaxf(mx_a, s[nt][e]);
        mx_b = fmaxf(mx_b, s[nt][2 + e]);
      }
    }
#pragma unroll
    for (int msk = 1; msk <= 2; msk <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, msk));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, msk));
    }
    const float mn_a = fmaxf(m_a, mx_a * kLog2e);
    const float mn_b = fmaxf(m_b, mx_b * kLog2e);
    const float cr_a = exp2f(m_a - mn_a), cr_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    // p~ = 2^(z log2 e - m) and dS~ = p~ (dP - D) z' (into s)
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float za = s[nt][e], zb = s[nt][2 + e];
        float pa = 0.f, pb = 0.f;
        if (za != masked) pa = exp2f(za * kLog2e - mn_a);
        if (zb != masked) pb = exp2f(zb * kLog2e - mn_b);
        ps_a += pa;
        ps_b += pb;
        s[nt][e] = pa == 0.f ? 0.f : pa * (dp[nt][e] - DA) * dlogit(a, za);
        s[nt][2 + e] =
            pb == 0.f ? 0.f : pb * (dp[nt][2 + e] - DB) * dlogit(a, zb);
      }
    }
    l_a = l_a * cr_a + ps_a;  // this lane's keys; the quad sums at the end
    l_b = l_b * cr_b + ps_b;
    if (__any_sync(kFull, cr_a != 1.f || cr_b != 1.f)) {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[n][0] *= cr_a;
        acc[n][1] *= cr_a;
        acc[n][2] *= cr_b;
        acc[n][3] *= cr_b;
      }
    }
    // acc += dS~ K: dS~ in bf16 as the A operand, K through ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < KT / 16; ++kc) {
      const uint32_t af[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dd = 0; dd < KS; ++dd) {
        uint32_t bk[4];
        ldsm_x4_t(bk, Kt + (kc * 16 + vrow) * RS + (dd * 16 + vcol) * 2);
        mma_bf16(acc[2 * dd], af, bk[0], bk[1]);
        mma_bf16(acc[2 * dd + 1], af, bk[2], bk[3]);
      }
    }
    cur = nxt;
    cur_cls = nxt_cls;
    stage ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int msk = 1; msk <= 2; msk <<= 1) {
    l_a += __shfl_xor_sync(kFull, l_a, msk);
    l_b += __shfl_xor_sync(kFull, l_b, msk);
  }
  // the chunk's part: unnormalised dq rows and (m, l), merged later
  const int la = warp * 16 + g, lb = la + 8;  // rows within the block
  float* pa = a.part_q + (prow + la) * HD + 2 * quad;
  float* pb = a.part_q + (prow + lb) * HD + 2 * quad;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    *reinterpret_cast<float2*>(pa + n * 8) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(pb + n * 8) = make_float2(acc[n][2], acc[n][3]);
  }
  if (quad == 0) {
    a.stat_q[prow + la] = make_float2(m_a, l_a);
    a.stat_q[prow + lb] = make_float2(m_b, l_b);
  }
}

template <int HD>
struct DkvSmem {
  static constexpr int RS = HD * 2 + kPad;
  static constexpr int PS = kRTile * 2 + kPad;            // P^T, dS^T rows
  static constexpr int kKV = kKBlock * RS;                 // K or V
  static constexpr int kTile = kRTile * RS;                // a Q or dO tile
  static constexpr int kStage = 2 * kTile + kRTile * 16;  // Q, dO, rows
  static constexpr int kP = kKBlock * PS;
  static constexpr int kBytes = 2 * kKV + 2 * kStage + 2 * kP;
};

// One chunk of a 32-key block's walk over the live row tiles (all G
// heads) of its kv head.  Per tile: (A) each warp recomputes S^T = K Q^T
// and dP^T = V dO^T for 16 keys x 16 rows and writes P^T and dS^T to
// shared memory in bf16; (B) each warp adds P^T dO and dS^T Q into its
// share of dv and dk (see kShare).  The chunk's dk, dv go to the reduce.
template <int HD, bool kRag>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_mma_kernel(const Args a) {
#if REPRO_BWD_STOP == 4
  return;
#endif
  using L = DkvSmem<HD>;
  constexpr int RS = L::RS, PS = L::PS, KS = HD / 16;
  const int hs = kRag ? a.hd : HD;  // the rows' stride in device memory
  // phase B's split: with a multiple of 4 column steps (hd 64, 128, 256)
  // each warp takes all 32 keys (kJ key groups) over every fourth step,
  // so a dO / Q fragment feeds both key groups; else (hd 16, 32, 80, 144,
  // 160) one key group over every other step, which balances odd counts
  constexpr bool kShare = KS % 4 == 0;
  constexpr int kJ = kShare ? 2 : 1, kStride = kShare ? 4 : 2;
  constexpr int NCS = (KS + kStride - 1) / kStride;  // steps of a warp
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sK = smem;
  unsigned char* sV = sK + L::kKV;
  unsigned char* ring = sV + L::kKV;
  unsigned char* sP = ring + 2 * L::kStage;
  unsigned char* sDS = sP + L::kP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, kvh = blockIdx.y;
  // chunk `chunk` of the walk of key block kb
  const int kb = blockIdx.x / a.n_ck, chunk = blockIdx.x % a.n_ck;
  const int s0 = kb * kKBlock;
  const int nrows = a.T * a.G;

  const int4* rsp = a.spans + (size_t)b * (a.n_rspan + a.n_kspan);
  const int4* ksp = rsp + a.n_rspan;
  int4 K = ksp[s0 / kSpan];
  if (s0 / kSpan + 1 < a.n_kspan) K = merge_keys(K, ksp[s0 / kSpan + 1]);
  else K.z = 0;
  const int n_rt = (nrows + kRTile - 1) / kRTile;
  auto cls = [&](int i) {
    int4 R = rsp[2 * i];
    if (2 * i + 1 < a.n_rspan) R = merge_rows(R, rsp[2 * i + 1]);
    return tile_class(a, R, K, (i + 1) * kRTile <= nrows);
  };
  // Q, dO and row records of row tile i into a ring stage (one group)
  auto issue = [&](int i, int stage) {
    if (i < n_rt) {
      unsigned char* st = ring + stage * L::kStage;
      const int r0 = i * kRTile;
      copy_rows2<HD, RS, kRag>(st, st + L::kTile, a.q, a.dout, kRTile, warp,
                               lane, hs, [&](int rr) -> long long {
                                 return r0 + rr < nrows
                                            ? (long long)(row_base(
                                                  a, b, kvh, r0 + rr) * hs)
                                            : -1;
                               });
      if (tid < kRTile) {
        const bool ok = r0 + tid < nrows;
        cp_async16(st + 2 * L::kTile + tid * 16,
                   a.rows + (ok ? ((size_t)b * a.KV + kvh) * nrows + r0 + tid
                                : 0),
                   ok);
      }
    }
    cp_async_commit();
  };
  int cur_cls;
  int cur = nth_live(chunk * a.ck, n_rt, lane, cls, cur_cls);
  if (tid == 0)
    a.flags[(((size_t)b * a.KV + kvh) * a.n_kb + kb) * a.n_ck + chunk] =
        cur < n_rt;
  if (cur >= n_rt) return;  // no live tile in this chunk: no part
  Walk walk;
  walk.load(cur & ~31, n_rt, lane, cls);
  if constexpr (kRag) {  // the tiles' columns past hs, once (K, V; Q, dO)
    zero_tails<HD, 2, RS>(sK, 2 * kKBlock, hs, tid, kThreads);
    zero_tails<HD, 2, RS>(ring, 2 * kRTile, hs, tid, kThreads);
    zero_tails<HD, 2, RS>(ring + L::kStage, 2 * kRTile, hs, tid, kThreads);
    __syncthreads();
  }
  copy_rows2<HD, RS, kRag>(sK, sV, a.k, a.v, kKBlock, warp, lane, hs,
                           [&](int jj) -> long long {
                             return s0 + jj < a.S
                                        ? (long long)((((size_t)b * a.S + s0 +
                                                        jj) * a.KV + kvh) *
                                                      hs)
                                        : -1;
                           });
  cp_async_commit();
  issue(cur, 0);

  // phase A: keys kg * 16 + (g, g + 8), rows rh * 16 + nt * 8 + 2 quad + e
  const int kg = warp & 1, rh = warp >> 1;
  const int g = lane >> 2, quad = lane & 3;
  const int kA = s0 + kg * 16 + g, kB = kA + 8;
  const bool okA = kA < a.S, okB = kB < a.S;
  const int kpA = okA ? a.k_pos[(size_t)b * a.S + kA] : -1;
  const int kpB = okB ? a.k_pos[(size_t)b * a.S + kB] : -1;
  // ldmatrix lanes: A operands and .trans B operands (arow, acol), and
  // B operands read without .trans (brow, bcol)
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, acol = (lane >> 4) * 8;
  const int brow = (lane & 7) + ((lane >> 4) << 3), bcol = ((lane >> 3) & 1) * 8;

  // phase B: key groups kg0 + j (j < kJ) x the 16-column steps cs = cs0
  // + kStride i
  const int kg0 = kShare ? 0 : warp & 1, cs0 = kShare ? warp : warp >> 1;
  float dv[kJ][NCS][2][4], dk[kJ][NCS][2][4];
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int i = 0; i < NCS; ++i)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dv[j][i][nt][e] = dk[j][i][nt][e] = 0.f;
  int stage = 0, left = a.ck;
  [[maybe_unused]] bool first = true;  // kRag: Q / dO (K / V) still led
  while (cur < n_rt) {
    int nxt_cls = 0, nxt = n_rt;
    if (--left > 0) nxt = walk.next(cur, n_rt, lane, cls, nxt_cls);
    cp_async_wait<0>();
    __syncthreads();  // the tile is in; every warp is done with the last one
#if REPRO_BWD_STOP == 3
    cp_async_commit();
#else
    issue(nxt, stage ^ 1);
#endif
    if constexpr (kRag) {  // the led rows of this tile (and of K, V)
      unsigned char* st = ring + stage * L::kStage;
      const int r0 = cur * kRTile;
      shift_rows2<HD, RS>(st, st + L::kTile, a.q, a.dout, kRTile, warp, lane,
                          hs, [&](int rr) -> long long {
                            return r0 + rr < nrows
                                       ? (long long)(row_base(a, b, kvh,
                                                              r0 + rr) * hs)
                                       : -1;
                          });
      if (first)
        shift_rows2<HD, RS>(sK, sV, a.k, a.v, kKBlock, warp, lane, hs,
                            [&](int jj) -> long long {
                              return s0 + jj < a.S
                                         ? (long long)((((size_t)b * a.S +
                                                         s0 + jj) * a.KV +
                                                        kvh) * hs)
                                         : -1;
                            });
      first = false;
      __syncthreads();
    }
    const unsigned char* Qt = ring + stage * L::kStage;
    const unsigned char* Ot = Qt + L::kTile;
    const float4* info = reinterpret_cast<const float4*>(Qt + 2 * L::kTile);
#if REPRO_BWD_STOP == 1
    dv[0][0][0][0] += info[lane].x;
    cur = nxt;
    cur_cls = nxt_cls;
    stage ^= 1;
    continue;
#endif

    float st[2][4], dpt[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4], bq[4], bo[4];
      ldsm_x4(ka, sK + (kg * 16 + arow) * RS + (kk * 16 + acol) * 2);
      ldsm_x4(va, sV + (kg * 16 + arow) * RS + (kk * 16 + acol) * 2);
      ldsm_x4(bq, Qt + (rh * 16 + brow) * RS + (kk * 16 + bcol) * 2);
      ldsm_x4(bo, Ot + (rh * 16 + brow) * RS + (kk * 16 + bcol) * 2);
      mma_bf16(st[0], ka, bq[0], bq[1]);
      mma_bf16(st[1], ka, bq[2], bq[3]);
      mma_bf16(dpt[0], va, bo[0], bo[1]);
      mma_bf16(dpt[1], va, bo[2], bo[3]);
    }
    // P^T = 2^(z log2 e - lse2) and dS^T = P^T (dP^T - D) z' where seen
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int rr = rh * 16 + nt * 8 + 2 * quad + e;
        const float4 ri = info[rr];
        bool vA = true, vB = true;
        if (cur_cls != 2) {
          const int qp = __float_as_int(ri.z), qc = __float_as_int(ri.w);
          const bool real = cur * kRTile + rr < nrows;
          vA = real && okA && sees(a, qp, qc, kpA);
          vB = real && okB && sees(a, qp, qc, kpB);
        }
        float pA = 0.f, pB = 0.f, dA = 0.f, dB = 0.f;
        if (vA) {
          const float z = logit(a, st[nt][e]);
          pA = exp2f(z * kLog2e - ri.x);
          dA = pA * (dpt[nt][e] - ri.y) * dlogit(a, z);
        }
        if (vB) {
          const float z = logit(a, st[nt][2 + e]);
          pB = exp2f(z * kLog2e - ri.x);
          dB = pB * (dpt[nt][2 + e] - ri.y) * dlogit(a, z);
        }
        st[nt][e] = pA;
        st[nt][2 + e] = pB;
        dpt[nt][e] = dA;
        dpt[nt][2 + e] = dB;
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = (rh * 16 + nt * 8 + 2 * quad) * 2;
      const int ra = (kg * 16 + g) * PS + col, rb = ra + 8 * PS;
      *reinterpret_cast<uint32_t*>(sP + ra) = pack_bf16(st[nt][0], st[nt][1]);
      *reinterpret_cast<uint32_t*>(sP + rb) = pack_bf16(st[nt][2], st[nt][3]);
      *reinterpret_cast<uint32_t*>(sDS + ra) =
          pack_bf16(dpt[nt][0], dpt[nt][1]);
      *reinterpret_cast<uint32_t*>(sDS + rb) =
          pack_bf16(dpt[nt][2], dpt[nt][3]);
    }
    __syncthreads();

    // phase B: dv += P^T dO, dk += dS^T Q over the warp's column steps
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      uint32_t pa[kJ][4], da[kJ][4];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int kr = (kg0 + j) * 16 + arow;
        ldsm_x4(pa[j], sP + kr * PS + (kc * 16 + acol) * 2);
        ldsm_x4(da[j], sDS + kr * PS + (kc * 16 + acol) * 2);
      }
#pragma unroll
      for (int i = 0; i < NCS; ++i) {
        const int cs = cs0 + kStride * i;
        if (cs < KS) {
          uint32_t bo[4], bq[4];
          ldsm_x4_t(bo, Ot + (kc * 16 + arow) * RS + (cs * 16 + acol) * 2);
          ldsm_x4_t(bq, Qt + (kc * 16 + arow) * RS + (cs * 16 + acol) * 2);
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            mma_bf16(dv[j][i][0], pa[j], bo[0], bo[1]);
            mma_bf16(dv[j][i][1], pa[j], bo[2], bo[3]);
            mma_bf16(dk[j][i][0], da[j], bq[0], bq[1]);
            mma_bf16(dk[j][i][1], da[j], bq[2], bq[3]);
          }
        }
      }
    }
    cur = nxt;
    cur_cls = nxt_cls;
    stage ^= 1;
  }
  cp_async_wait<0>();

  // the chunk's part: keys (kg0 + j) * 16 + (g, g + 8), columns cs * 16 +
  // nt * 8 + 2 quad + {0, 1}, f32 (the reduce sums the chunks in order)
  const size_t sp = (size_t)a.n_kb * kKBlock;
  const size_t half = (size_t)a.B * sp * a.KV * HD;
  float* pk = a.part_k + 2 * chunk * half;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const size_t oa = (((size_t)b * sp + s0 + (kg0 + j) * 16 + g) * a.KV +
                       kvh) * HD + 2 * quad;
    const size_t ob = oa + (size_t)8 * a.KV * HD;
#pragma unroll
    for (int i = 0; i < NCS; ++i) {
      const int cs = cs0 + kStride * i;
      if (cs >= KS) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = cs * 16 + nt * 8;
        *reinterpret_cast<float2*>(pk + oa + col) =
            make_float2(dk[j][i][nt][0], dk[j][i][nt][1]);
        *reinterpret_cast<float2*>(pk + half + oa + col) =
            make_float2(dv[j][i][nt][0], dv[j][i][nt][1]);
        *reinterpret_cast<float2*>(pk + ob + col) =
            make_float2(dk[j][i][nt][2], dk[j][i][nt][3]);
        *reinterpret_cast<float2*>(pk + half + ob + col) =
            make_float2(dv[j][i][nt][2], dv[j][i][nt][3]);
      }
    }
  }
}

// ---- f32 storage: 3xTF32 tiles (mma.sync m16n8k8) ----------------------

// Programmatic dependent launch (the f32 chain): a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start once every
// block of the kernel before it has called launch_dependents() (or
// exited); dependency_wait() blocks until that kernel has completed and
// its writes are visible.  Before the wait a kernel reads only the call's
// inputs (q, k, v, o, dO, positions), which the chain's first kernel,
// launched without the attribute, already waited for.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

// The f32 chain's first kernel: the position summaries (n_sb blocks an
// item, below B * n_sb) and the row records (the rest), in one launch.
template <int HD, bool kRag>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_prep_kernel(const ArgsT<float> a, int n_sb) {
  launch_dependents();
  const int bx = blockIdx.x;
  if (bx < a.B * n_sb) spans_body(a, bx % n_sb, bx / n_sb);
  else rows_body<HD, kRag>(a, bx - a.B * n_sb);
}

// The f32 chain's last kernel: dq from its chunks (blocks below n_mb; no
// row record is written: the dk/dv kernel took lse from the chunks' (m, l)
// itself), then dk and dv from theirs, in one launch.
template <int HD, bool kRag>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_final_kernel(const ArgsT<float> a, int n_mb) {
  dependency_wait();
  const int bx = blockIdx.x;
  if (bx < n_mb) merge_body<HD, kRag, float, false>(a, bx);
  else reduce_body<HD, kRag>(a, bx - n_mb);
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: the bits cvt.rna.tf32.f32 gives, by two integer operations: half
// a TF32 unit in the last place (0x1000) added to the magnitude's bits, a
// carry into the exponent included, then the 13 low bits cleared.  That
// rounds, it does not truncate: |x - tf32(x)| <= 2^-11 |x|.  On the H100
// the whole backward took 0.80-0.95x the time of a build with the
// instruction at the f32 training frames (PERF.md, row 4b).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo, both TF32 (hi to nearest, lo the rounded rest): ~21 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
// c += a (16x8 tf32, row) * b (8x8 tf32, col), f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// An A operand (16 x 8) and a B operand (8 x 8) of f32 values, each
// element as its TF32 pair
struct AFrag {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float x0, float x1, float x2,
                                      float x3) {
    split_tf32(x0, hi[0], lo[0]);
    split_tf32(x1, hi[1], lo[1]);
    split_tf32(x2, hi[2], lo[2]);
    split_tf32(x3, hi[3], lo[3]);
  }
};
struct BFrag {
  uint32_t hi0, hi1, lo0, lo1;
  __device__ __forceinline__ void set(float x0, float x1) {
    split_tf32(x0, hi0, lo0);
    split_tf32(x1, hi1, lo1);
  }
};
// c += a b at f32 accuracy (3xTF32): the cross terms lo * hi and hi * lo
// first, then hi * hi; lo * lo (below 2^-22 of the product) is dropped
__device__ __forceinline__ void mma3(float (&c)[4], const AFrag& a,
                                     const BFrag& b) {
  mma_tf32(c, a.lo, b.hi0, b.hi1);
  mma_tf32(c, a.hi, b.lo0, b.lo1);
  mma_tf32(c, a.hi, b.hi0, b.hi1);
}

// The fragments below read f32 rows of stride RF floats with 32-bit
// loads (ldmatrix moves 16-bit elements).  RF = HD + 4 is 4 or 20 mod 32,
// so every load of a warp hits 32 distinct banks.
// The A operand of rows (g, g + 8) at columns (k0 + quad, k0 + quad + 4):
// m16n8k8's a0..a3
template <int RF>
__device__ __forceinline__ void load_a(AFrag& f, const float* p, int k0,
                                       int g, int quad) {
  const float* r = p + g * RF + k0 + quad;
  f.set(r[0], r[8 * RF], r[4], r[8 * RF + 4]);
}
// The B operand of a product against the rows' transpose (k = the rows'
// columns k0 + quad, k0 + quad + 4; n = row n0 + g)
template <int RF>
__device__ __forceinline__ void load_bt(BFrag& f, const float* p, int n0,
                                        int k0, int g, int quad) {
  const float* r = p + (n0 + g) * RF + k0 + quad;
  f.set(r[0], r[4]);
}
// The B operand of a product over the rows (k = rows k0 + 2 quad and
// k0 + 2 quad + 1, n = column c0 + g): the k order in which fragA_of_C
// hands a C fragment on as an A operand
template <int RF>
__device__ __forceinline__ void load_b(BFrag& f, const float* p, int k0,
                                       int c0, int g, int quad) {
  const float* r = p + (k0 + 2 * quad) * RF + c0 + g;
  f.set(r[0], r[RF]);
}
// A C fragment (rows g, g + 8 at columns 2 quad, 2 quad + 1) as the A
// operand of a product over its 8 columns: a k index's order within the
// step is free as long as B follows it (load_b), so the result of one
// product feeds the next from registers
__device__ __forceinline__ void fragA_of_C(AFrag& f, const float (&c)[4]) {
  f.set(c[0], c[2], c[1], c[3]);
}

// Copies n_rows (<= 32) rows of HD f32 from two tensors with the same row
// offsets into shared rows of RF floats, by one warp: 16-byte cp.async, a
// chunk a lane (kRag: rows of hs <= HD values at any 4-byte boundary, a
// row at a time and an element a lane, decode_attention.cuh's ragged_row;
// an f32 row never starts inside a word).  Lane i computes the offset of
// row i (off(i), -1 past the valid rows: zeros), and the copy loop takes
// it by shuffle.
template <int HD, int RF, bool kRag, typename Off>
__device__ __forceinline__ void copy_rows_f32(float* d0, float* d1,
                                              const float* s0,
                                              const float* s1, int n_rows,
                                              int lane, int hs, Off off) {
  const long long mine = lane < n_rows ? off(lane) : -1;
  if constexpr (kRag) {
    for (int r = 0; r < n_rows; ++r) {
      const long long o = __shfl_sync(kFull, mine, r);
      const size_t e = o >= 0 ? (size_t)o : 0;
      ragged_row<float, HD>(reinterpret_cast<unsigned char*>(d0 + r * RF),
                            reinterpret_cast<unsigned char*>(d1 + r * RF),
                            s0 + e, s1 + e, o >= 0, hs, lane);
    }
  } else {
    constexpr int CPR = HD / 4;  // 16-byte chunks a row
    const int n = n_rows * CPR;
    for (int j = 0; j < n; j += 32) {
      const int i = j + lane, r = i / CPR, part = i - r * CPR;
      const long long o = __shfl_sync(kFull, mine, r < 32 ? r : 31);
      if (i < n) {
        const bool ok = o >= 0;
        const size_t e = ok ? (size_t)o + part * 4 : 0;
        cp_async16(d0 + r * RF + part * 4, s0 + e, ok);
        cp_async16(d1 + r * RF + part * 4, s1 + e, ok);
      }
    }
  }
}

template <int HD>
struct DqSmemF32 {
  static constexpr int RF = HD + 4;                  // a row's stride, floats
  static constexpr int RS = RF * 4;                  // in bytes
  static constexpr int KT = Geo<float>::key_tile(HD);
  static constexpr int kQ = kF32Rows * RS;           // Q, then dO
  static constexpr int kTile = KT * RS;              // a K or V tile
  static constexpr int kStage = 2 * kTile + KT * 4;  // K, V, k_pos
  // with a ring of `stages` (1 when a chunk walks one tile: more blocks
  // an SM)
  static constexpr int bytes(int stages) { return 2 * kQ + stages * kStage; }
};

// f32: one chunk of a 16-row block's walk over its live key tiles, by one
// warp, in one pass (the bf16 dq kernel's online softmax): S = Q K^T and
// dP = dO V^T, then dS~ = p~ (dP - D) z' in f32 registers as the A
// operand of acc += dS~ K.  Every product is 3xTF32.
template <int HD, bool kRag>
__global__ void __launch_bounds__(32)
    flash_bwd_dq_tf32_kernel(const ArgsT<float> a) {
  launch_dependents();
  using L = DqSmemF32<HD>;
  constexpr int RF = L::RF, KT = L::KT, NKT = KT / 8, KS = HD / 8;
  const int hs = kRag ? a.hd : HD;  // the rows' stride in device memory
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sO = sQ + kF32Rows * RF;
  unsigned char* ring = smem + 2 * L::kQ;
  const int lane = threadIdx.x;
  const int b = blockIdx.z, kvh = blockIdx.y;
  // chunk `chunk` of the walk of row block rb; the last rows first
  const int chunk = blockIdx.x % a.n_cq;
  const int r0 = (a.n_rb - 1 - (int)(blockIdx.x / a.n_cq)) * kF32Rows;
  const int nrows = a.T * a.G;
  const float masked = -__int_as_float(0x7f800000);  // -inf
  const size_t prow = ((size_t)chunk * a.B * a.KV + (size_t)b * a.KV + kvh) *
                          a.n_rb * kF32Rows + r0;  // the block's partial rows
  // Q and dO first (inputs of the call: before the wait)
  if constexpr (kRag) {  // the tiles' columns past hs, once (Q, dO; K, V)
    zero_tails<HD, 4, L::RS>(smem, 2 * kF32Rows, hs, lane, 32);
    zero_tails<HD, 4, L::RS>(ring, 2 * KT, hs, lane, 32);
    if (a.cq > 1)  // a second stage
      zero_tails<HD, 4, L::RS>(ring + L::kStage, 2 * KT, hs, lane, 32);
    __syncwarp();
  }
  copy_rows_f32<HD, RF, kRag>(sQ, sO, a.q, a.dout, kF32Rows, lane, hs,
                              [&](int rr) -> long long {
                                return r0 + rr < nrows
                                           ? (long long)(row_base(a, b, kvh,
                                                                  r0 + rr) *
                                                         hs)
                                           : -1;
                              });
  cp_async_commit();
  dependency_wait();  // the summaries and row records are in

  const int4* rsp = a.spans + (size_t)b * (a.n_rspan + a.n_kspan);
  const int4* ksp = rsp + a.n_rspan;
  const int4 R = rsp[r0 / kSpan];  // the block's 16 rows: one summary
  const bool whole = r0 + kF32Rows <= nrows;
  const int n_kt = (a.S + KT - 1) / KT;
  // a key tile is one summary's span
  auto cls = [&](int j) { return tile_class(a, R, ksp[j], whole); };
  // K, V and k_pos of key tile j into a ring stage (one cp.async group a
  // call, empty when j is past the last tile)
  auto issue = [&](int j, int stage) {
    if (j < n_kt) {
      unsigned char* st = ring + stage * L::kStage;
      const int s0 = j * KT;
      copy_rows_f32<HD, RF, kRag>(
          reinterpret_cast<float*>(st),
          reinterpret_cast<float*>(st + L::kTile), a.k, a.v, KT, lane, hs,
          [&](int jj) -> long long {
            return s0 + jj < a.S
                       ? (long long)((((size_t)b * a.S + s0 + jj) * a.KV +
                                      kvh) * hs)
                       : -1;
          });
      if (lane < KT) {
        const int s = s0 + lane;
        const bool ok = s < a.S;
        cp_async4n(st + 2 * L::kTile + lane * 4,
                   a.k_pos + (ok ? (size_t)b * a.S + s : 0), ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  int cur_cls;
  int cur = nth_live(chunk * a.cq, n_kt, lane, cls, cur_cls);
  if (cur >= n_kt) {  // no live tile in this chunk: its rows see nothing
    if (lane < kF32Rows) a.stat_q[prow + lane] = make_float2(kNegBig, 0.f);
    cp_async_wait<0>();
    return;
  }
  Walk walk;
  walk.load(cur & ~31, n_kt, lane, cls);
  issue(cur, 0);

  // the fragment rows ra (C elements 0, 1) and rb (2, 3)
  const int g = lane >> 2, quad = lane & 3;
  const int rA = r0 + g, rB = rA + 8;
  const bool realA = rA < nrows, realB = rB < nrows;
  // their D and positions, from the row records
  const float4* rec = a.rows + ((size_t)b * a.KV + kvh) * nrows;
  const float4 iA = realA ? rec[rA] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 iB = realB ? rec[rB] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float DA = iA.y, DB = iB.y;
  const int qpA = __float_as_int(iA.z), qcA = __float_as_int(iA.w);
  const int qpB = __float_as_int(iB.z), qcB = __float_as_int(iB.w);

  float acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = kNegBig, m_b = kNegBig, l_a = 0.f, l_b = 0.f;
  int stage = 0, left = a.cq;
  while (cur < n_kt) {
    int nxt_cls = 0, nxt = n_kt;
    if (--left > 0) nxt = walk.next(cur, n_kt, lane, cls, nxt_cls);
    cp_async_wait<0>();
    __syncwarp();  // the tile is in; every lane is done with the other stage
#if REPRO_BWD_STOP == 3
    cp_async_commit();
#else
    issue(nxt, stage ^ 1);
#endif
    const float* Kt = reinterpret_cast<const float*>(ring + stage * L::kStage);
    const float* Vt = Kt + KT * RF;
    const int* kpt = reinterpret_cast<const int*>(Kt + 2 * KT * RF);
#if REPRO_BWD_STOP == 1
    acc[0][0] += kpt[lane & 15];
    cur = nxt;
    cur_cls = nxt_cls;
    stage ^= 1;
    continue;
#endif

    // S = Q K^T and dP = dO V^T: rows ra, rb at keys nt * 8 + 2 quad + {0, 1}
    float s[NKT][4], dp[NKT][4];
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      AFrag qa, oa;
      load_a<RF>(qa, sQ, kk * 8, g, quad);
      load_a<RF>(oa, sO, kk * 8, g, quad);
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt) {
        BFrag bk, bv;
        load_bt<RF>(bk, Kt, nt * 8, kk * 8, g, quad);
        load_bt<RF>(bv, Vt, nt * 8, kk * 8, g, quad);
        mma3(s[nt], qa, bk);
        mma3(dp[nt], oa, bv);
      }
    }
    // logits (natural units) where seen, -inf elsewhere; the rows' maxima
    const int s0 = cur * KT;
    float mx_a = masked, mx_b = masked;
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jj = nt * 8 + 2 * quad + e;
        bool va = true, vb = true;
        if (cur_cls != 2) {
          const int kp = kpt[jj];
          const bool ks = s0 + jj < a.S;
          va = ks && realA && sees(a, qpA, qcA, kp);
          vb = ks && realB && sees(a, qpB, qcB, kp);
        }
        s[nt][e] = va ? logit(a, s[nt][e]) : masked;
        s[nt][2 + e] = vb ? logit(a, s[nt][2 + e]) : masked;
        mx_a = fmaxf(mx_a, s[nt][e]);
        mx_b = fmaxf(mx_b, s[nt][2 + e]);
      }
    }
#pragma unroll
    for (int msk = 1; msk <= 2; msk <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, msk));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, msk));
    }
    const float mn_a = fmaxf(m_a, mx_a * kLog2e);
    const float mn_b = fmaxf(m_b, mx_b * kLog2e);
    const float cr_a = exp2f(m_a - mn_a), cr_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    // p~ = 2^(z log2 e - m) and dS~ = p~ (dP - D) z' (into s), in f32
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float za = s[nt][e], zb = s[nt][2 + e];
        float pa = 0.f, pb = 0.f;
        if (za != masked) pa = exp2f(za * kLog2e - mn_a);
        if (zb != masked) pb = exp2f(zb * kLog2e - mn_b);
        ps_a += pa;
        ps_b += pb;
        s[nt][e] = pa == 0.f ? 0.f : pa * (dp[nt][e] - DA) * dlogit(a, za);
        s[nt][2 + e] =
            pb == 0.f ? 0.f : pb * (dp[nt][2 + e] - DB) * dlogit(a, zb);
      }
    }
    l_a = l_a * cr_a + ps_a;  // this lane's keys; the quad sums at the end
    l_b = l_b * cr_b + ps_b;
    if (__any_sync(kFull, cr_a != 1.f || cr_b != 1.f)) {
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        acc[n][0] *= cr_a;
        acc[n][1] *= cr_a;
        acc[n][2] *= cr_b;
        acc[n][3] *= cr_b;
      }
    }
    // acc += dS~ K over the tile's keys, 8 a step, dS~ from registers
#pragma unroll
    for (int kc = 0; kc < NKT; ++kc) {
      AFrag da;
      fragA_of_C(da, s[kc]);
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        BFrag bk;
        load_b<RF>(bk, Kt, kc * 8, n * 8, g, quad);
        mma3(acc[n], da, bk);
      }
    }
    cur = nxt;
    cur_cls = nxt_cls;
    stage ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int msk = 1; msk <= 2; msk <<= 1) {
    l_a += __shfl_xor_sync(kFull, l_a, msk);
    l_b += __shfl_xor_sync(kFull, l_b, msk);
  }
  // the chunk's part: unnormalised dq rows and (m, l), merged later
  float* pa = a.part_q + (prow + g) * HD + 2 * quad;
  float* pb = a.part_q + (prow + g + 8) * HD + 2 * quad;
#pragma unroll
  for (int n = 0; n < KS; ++n) {
    *reinterpret_cast<float2*>(pa + n * 8) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(pb + n * 8) = make_float2(acc[n][2], acc[n][3]);
  }
  if (quad == 0) {
    a.stat_q[prow + g] = make_float2(m_a, l_a);
    a.stat_q[prow + g + 8] = make_float2(m_b, l_b);
  }
}

template <int HD>
struct DkvSmemF32 {
  static constexpr int RF = HD + 4, RS = RF * 4;
  static constexpr int RT = Geo<float>::row_tile(HD);
  static constexpr int kKV = kF32Keys * RS;           // K or V
  static constexpr int kTile = RT * RS;               // a Q or dO tile
  // Q, dO, row records, the dq chunks' (m, l) of the rows
  static constexpr int kStage =
      2 * kTile + RT * 16 + Geo<float>::max_chunks * RT * 8;
  static constexpr int bytes(int stages) { return 2 * kKV + stages * kStage; }
};

// f32: one chunk of a 16-key block's walk over the live row tiles (all G
// heads) of its kv head, by one warp, for one column split of dk and dv.
// Per tile: each row's lse from the dq chunks' (m, l) (as the merge takes
// it, so this kernel need not wait for the merge), S^T = K Q^T and dP^T =
// V dO^T (16 keys x RT rows), P^T and dS^T in f32 registers, then dv +=
// P^T dO and dk += dS^T Q with those as A operands: no shared-memory round
// trip and no barrier.  Every product is 3xTF32.
template <int HD, bool kRag>
__global__ void __launch_bounds__(32)
    flash_bwd_dkdv_tf32_kernel(const ArgsT<float> a) {
  launch_dependents();
#if REPRO_BWD_STOP == 4
  dependency_wait();
  return;
#endif
  using L = DkvSmemF32<HD>;
  constexpr int RF = L::RF, RT = L::RT, NRT = RT / 8, KS = HD / 8;
  constexpr int NSPLIT = Geo<float>::splits(HD), CW = HD / NSPLIT;
  constexpr int NC = CW / 8;  // the split's 8-column steps
  const int hs = kRag ? a.hd : HD;  // the rows' stride in device memory
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + kF32Keys * RF;
  unsigned char* ring = smem + 2 * L::kKV;
  const int lane = threadIdx.x;
  const int b = blockIdx.z, kvh = blockIdx.y;
  // chunk `chunk` of the walk of key block kb, columns c0 on
  const int chunk = blockIdx.x % a.n_ck;
  const int kb = blockIdx.x / a.n_ck / NSPLIT;
  const int split = blockIdx.x / a.n_ck % NSPLIT;
  const int s0 = kb * kF32Keys;
  const int nrows = a.T * a.G;
  // K and V first (inputs of the call: before the wait)
  if constexpr (kRag) {  // the tiles' columns past hs, once (K, V; Q, dO)
    zero_tails<HD, 4, L::RS>(smem, 2 * kF32Keys, hs, lane, 32);
    zero_tails<HD, 4, L::RS>(ring, 2 * RT, hs, lane, 32);
    if (a.ck > 1)  // a second stage
      zero_tails<HD, 4, L::RS>(ring + L::kStage, 2 * RT, hs, lane, 32);
    __syncwarp();
  }
  copy_rows_f32<HD, RF, kRag>(sK, sV, a.k, a.v, kF32Keys, lane, hs,
                              [&](int jj) -> long long {
                                return s0 + jj < a.S
                                           ? (long long)((((size_t)b * a.S +
                                                           s0 + jj) * a.KV +
                                                          kvh) * hs)
                                           : -1;
                              });
  cp_async_commit();
  dependency_wait();  // the summaries, row records and dq chunks are in

  const int4* rsp = a.spans + (size_t)b * (a.n_rspan + a.n_kspan);
  const int4 K = rsp[a.n_rspan + s0 / kSpan];  // the block's 16 keys
  // the dq chunks' (m, l) of this kv head's rows
  const size_t nrp = (size_t)a.n_rb * kF32Rows;
  const float2* stq = a.stat_q + ((size_t)b * a.KV + kvh) * nrp;
  const size_t cstride = (size_t)a.B * a.KV * nrp;
  const int n_rt = (nrows + RT - 1) / RT;
  // a row tile is one summary's span
  auto cls = [&](int i) {
    return tile_class(a, rsp[i], K, (i + 1) * RT <= nrows);
  };
  // Q, dO and row records of row tile i into a ring stage (one group)
  auto issue = [&](int i, int stage) {
    if (i < n_rt) {
      unsigned char* st = ring + stage * L::kStage;
      const int r0 = i * RT;
      copy_rows_f32<HD, RF, kRag>(
          reinterpret_cast<float*>(st),
          reinterpret_cast<float*>(st + L::kTile), a.q, a.dout, RT, lane, hs,
          [&](int rr) -> long long {
            return r0 + rr < nrows
                       ? (long long)(row_base(a, b, kvh, r0 + rr) * hs)
                       : -1;
          });
      if (lane < RT) {
        const bool ok = r0 + lane < nrows;
        cp_async16(st + 2 * L::kTile + lane * 16,
                   a.rows + (ok ? ((size_t)b * a.KV + kvh) * nrows + r0 + lane
                                : 0),
                   ok);
        for (int c = 0; c < a.n_cq; ++c)
          cp_async8(st + 2 * L::kTile + RT * 16 + (c * RT + lane) * 8,
                    stq + (ok ? c * cstride + r0 + lane : 0), ok);
      }
    }
    cp_async_commit();
  };
  int cur_cls;
  int cur = nth_live(chunk * a.ck, n_rt, lane, cls, cur_cls);
  if (lane == 0 && split == 0)
    a.flags[(((size_t)b * a.KV + kvh) * a.n_kb + kb) * a.n_ck + chunk] =
        cur < n_rt;
  if (cur >= n_rt) {  // no live tile in this chunk: no part
    cp_async_wait<0>();
    return;
  }
  Walk walk;
  walk.load(cur & ~31, n_rt, lane, cls);
  issue(cur, 0);

  // keys kA = s0 + g (C elements 0, 1) and kB = kA + 8 (2, 3); a tile's
  // rows nt * 8 + 2 quad + {0, 1}
  const int g = lane >> 2, quad = lane & 3;
  const int kA = s0 + g, kB = kA + 8;
  const bool okA = kA < a.S, okB = kB < a.S;
  const int kpA = okA ? a.k_pos[(size_t)b * a.S + kA] : -1;
  const int kpB = okB ? a.k_pos[(size_t)b * a.S + kB] : -1;
  const int c0 = split * CW;

  float dv[NC][4], dk[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = dk[n][e] = 0.f;
  int stage = 0, left = a.ck;
  while (cur < n_rt) {
    int nxt_cls = 0, nxt = n_rt;
    if (--left > 0) nxt = walk.next(cur, n_rt, lane, cls, nxt_cls);
    cp_async_wait<0>();
    __syncwarp();  // the tile is in; every lane is done with the other stage
#if REPRO_BWD_STOP == 3
    cp_async_commit();
#else
    issue(nxt, stage ^ 1);
#endif
    const float* Qt = reinterpret_cast<const float*>(ring + stage * L::kStage);
    const float* Ot = Qt + RT * RF;
    float4* info = reinterpret_cast<float4*>(ring + stage * L::kStage +
                                             2 * L::kTile);
    if (lane < RT) {  // lane's row: lse2 = M + log2 sum_c 2^(m_c - M) l_c
      const float2* ml = reinterpret_cast<const float2*>(info + RT);
      float M = kNegBig, Lsum = 0.f;
      for (int c = 0; c < a.n_cq; ++c)
        if (ml[c * RT + lane].y > 0.f) M = fmaxf(M, ml[c * RT + lane].x);
      for (int c = 0; c < a.n_cq; ++c) {
        const float2 x = ml[c * RT + lane];
        if (x.y > 0.f) Lsum += exp2f(x.x - M) * x.y;
      }
      info[lane].x = Lsum > 0.f ? M + log2f(Lsum) : 0.f;
    }
    __syncwarp();
#if REPRO_BWD_STOP == 1
    dv[0][0] += info[lane].x;
    cur = nxt;
    cur_cls = nxt_cls;
    stage ^= 1;
    continue;
#endif

    // S^T = K Q^T and dP^T = V dO^T: keys kA, kB at rows nt * 8 + 2 quad + e
    float st[NRT][4], dpt[NRT][4];
#pragma unroll
    for (int nt = 0; nt < NRT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      AFrag ka, va;
      load_a<RF>(ka, sK, kk * 8, g, quad);
      load_a<RF>(va, sV, kk * 8, g, quad);
#pragma unroll
      for (int nt = 0; nt < NRT; ++nt) {
        BFrag bq, bo;
        load_bt<RF>(bq, Qt, nt * 8, kk * 8, g, quad);
        load_bt<RF>(bo, Ot, nt * 8, kk * 8, g, quad);
        mma3(st[nt], ka, bq);
        mma3(dpt[nt], va, bo);
      }
    }
    // P^T = 2^(z log2 e - lse2) and dS^T = P^T (dP^T - D) z' where seen
#pragma unroll
    for (int nt = 0; nt < NRT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int rr = nt * 8 + 2 * quad + e;
        const float4 ri = info[rr];
        bool vA = true, vB = true;
        if (cur_cls != 2) {
          const int qp = __float_as_int(ri.z), qc = __float_as_int(ri.w);
          const bool real = cur * RT + rr < nrows;
          vA = real && okA && sees(a, qp, qc, kpA);
          vB = real && okB && sees(a, qp, qc, kpB);
        }
        float pA = 0.f, pB = 0.f, dA = 0.f, dB = 0.f;
        if (vA) {
          const float z = logit(a, st[nt][e]);
          pA = exp2f(z * kLog2e - ri.x);
          dA = pA * (dpt[nt][e] - ri.y) * dlogit(a, z);
        }
        if (vB) {
          const float z = logit(a, st[nt][2 + e]);
          pB = exp2f(z * kLog2e - ri.x);
          dB = pB * (dpt[nt][2 + e] - ri.y) * dlogit(a, z);
        }
        st[nt][e] = pA;
        st[nt][2 + e] = pB;
        dpt[nt][e] = dA;
        dpt[nt][2 + e] = dB;
      }
    }
    // dv += P^T dO and dk += dS^T Q over the tile's rows, 8 a step
#pragma unroll
    for (int kc = 0; kc < NRT; ++kc) {
      AFrag pa, da;
      fragA_of_C(pa, st[kc]);
      fragA_of_C(da, dpt[kc]);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        BFrag bo, bq;
        load_b<RF>(bo, Ot, kc * 8, c0 + n * 8, g, quad);
        load_b<RF>(bq, Qt, kc * 8, c0 + n * 8, g, quad);
        mma3(dv[n], pa, bo);
        mma3(dk[n], da, bq);
      }
    }
    cur = nxt;
    cur_cls = nxt_cls;
    stage ^= 1;
  }
  cp_async_wait<0>();

  // the chunk's part: keys kA, kB at columns c0 + n * 8 + 2 quad + {0, 1}
  const size_t sp = (size_t)a.n_kb * kF32Keys;
  const size_t half = (size_t)a.B * sp * a.KV * HD;
  float* pk = a.part_k + 2 * chunk * half;
  const size_t oa = (((size_t)b * sp + kA) * a.KV + kvh) * HD + c0 + 2 * quad;
  const size_t ob = oa + (size_t)8 * a.KV * HD;
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    *reinterpret_cast<float2*>(pk + oa + n * 8) =
        make_float2(dk[n][0], dk[n][1]);
    *reinterpret_cast<float2*>(pk + half + oa + n * 8) =
        make_float2(dv[n][0], dv[n][1]);
    *reinterpret_cast<float2*>(pk + ob + n * 8) =
        make_float2(dk[n][2], dk[n][3]);
    *reinterpret_cast<float2*>(pk + half + ob + n * 8) =
        make_float2(dv[n][2], dv[n][3]);
  }
}

template <int HD, bool kRag>
int launch(const ArgsT<float>& a, cudaStream_t st) {
  constexpr int max_q = DqSmemF32<HD>::bytes(2);
  constexpr int max_k = DkvSmemF32<HD>::bytes(2);
  static_assert(max_q <= 232448 && max_k <= 232448,
                "a block's shared memory on sm_90");
  const int smem_q = DqSmemF32<HD>::bytes(a.cq > 1 ? 2 : 1);
  const int smem_k = DkvSmemF32<HD>::bytes(a.ck > 1 ? 2 : 1);
  const int B = a.B, n_sp = a.n_rspan + a.n_kspan;
  const long long n_rows = (long long)B * a.KV * a.T * a.G;
  const int row_blocks = (int)((n_rows + kThreads / 32 - 1) / (kThreads / 32));
  const int n_sb = (n_sp * kSpan + kThreads - 1) / kThreads;
  const long long n4 = (long long)B * a.S * a.KV * (HD / 4);
  const int red_blocks = (int)((n4 + kThreads - 1) / kThreads);
  // the shared memory a block takes, and the largest shared-memory share
  // (more one-warp blocks an SM)
  auto smem = [](void (*k)(ArgsT<float>), int bytes) {
    const int rc = (int)cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    return rc != 0 ? rc
                   : (int)cudaFuncSetAttribute(
                         k, cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
  };
  int rc;
  if ((rc = smem(flash_bwd_dq_tf32_kernel<HD, kRag>, max_q)) != 0 ||
      (rc = smem(flash_bwd_dkdv_tf32_kernel<HD, kRag>, max_k)) != 0)
    return rc;
  // the first kernel waits for the stream as usual; the other three
  // launch programmatically (each may start while the one before runs)
  flash_bwd_prep_kernel<HD, kRag>
      <<<B * n_sb + row_blocks, kThreads, 0, st>>>(a, n_sb);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = st;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(a.n_rb * a.n_cq, a.KV, B);
  cfg.blockDim = dim3(32);
  cfg.dynamicSmemBytes = smem_q;
  cudaLaunchKernelEx(&cfg, flash_bwd_dq_tf32_kernel<HD, kRag>, a);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  cfg.gridDim = dim3(a.n_kb * Geo<float>::splits(HD) * a.n_ck, a.KV, B);
  cfg.dynamicSmemBytes = smem_k;
  cudaLaunchKernelEx(&cfg, flash_bwd_dkdv_tf32_kernel<HD, kRag>, a);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  cfg.gridDim = dim3(row_blocks + red_blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cudaLaunchKernelEx(&cfg, flash_bwd_final_kernel<HD, kRag>, a, row_blocks);
  return (int)cudaGetLastError();
}

template <int HD, bool kRag>
int launch(const Args& a, cudaStream_t st) {
  constexpr int smem_q = DqSmem<HD>::kBytes, smem_k = DkvSmem<HD>::kBytes;
  static_assert(smem_q <= 232448 && smem_k <= 232448,
                "a block's shared memory on sm_90");
  const int B = a.B, n_sp = a.n_rspan + a.n_kspan;
  const long long n_rows = (long long)B * a.KV * a.T * a.G;
  const int row_blocks = (int)((n_rows + kThreads / 32 - 1) / (kThreads / 32));
  flash_bwd_spans_kernel<<<dim3((n_sp * kSpan + kThreads - 1) / kThreads, B),
                           kThreads, 0, st>>>(a);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  flash_bwd_rows_kernel<HD, kRag><<<row_blocks, kThreads, 0, st>>>(a);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  rc = (int)cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<HD, kRag>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_q);
  if (rc != 0) return rc;
  rc = (int)cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<HD, kRag>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_k);
  if (rc != 0) return rc;
  // the largest shared-memory share, so that two blocks fit on an SM
  rc = (int)cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<HD, kRag>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
  if (rc != 0) return rc;
  rc = (int)cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<HD, kRag>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
  if (rc != 0) return rc;
  flash_bwd_dq_mma_kernel<HD, kRag>
      <<<dim3(a.n_rb * a.n_cq, a.KV, B), kThreads, smem_q, st>>>(a);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  flash_bwd_dq_merge_kernel<HD, kRag><<<row_blocks, kThreads, 0, st>>>(a);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  flash_bwd_dkdv_mma_kernel<HD, kRag>
      <<<dim3(a.n_kb * a.n_ck, a.KV, B), kThreads, smem_k, st>>>(a);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const long long n4 = (long long)B * a.S * a.KV * (HD / 4);
  flash_bwd_dkdv_reduce_kernel<HD, kRag>
      <<<(int)((n4 + kThreads - 1) / kThreads), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <bool kRag, typename E>
int dispatch(const ArgsT<E>& a, int width, cudaStream_t s) {
  if constexpr (kRag) {
    switch (width) {
      case 16: return launch<16, true>(a, s);
      case 32: return launch<32, true>(a, s);
      case 64: return launch<64, true>(a, s);
      case 96: return launch<96, true>(a, s);
      case 128: return launch<128, true>(a, s);
      case 160: return launch<160, true>(a, s);
      case 256: return launch<256, true>(a, s);
      default: return -1;
    }
  } else {
    switch (width) {
      case 16: return launch<16, false>(a, s);
      case 32: return launch<32, false>(a, s);
      case 64: return launch<64, false>(a, s);
      case 80: return launch<80, false>(a, s);
      case 128: return launch<128, false>(a, s);
      case 144: return launch<144, false>(a, s);
      case 160: return launch<160, false>(a, s);
      case 256: return launch<256, false>(a, s);
      default: return -1;
    }
  }
}

}  // namespace tc


// one storage type's and load path's launches (the C entries below): the
// chunk plan, from shapes only, and the scratch layout; refuses scratch
// of any other size than that layout's (n_work f32, n_ints int32)
template <bool kRag, typename E>
int bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const int* q_pos, const int* q_ctx, const int* k_pos,
    void* dq, void* dk, void* dv, float* work, long long n_work, int* spans,
    long long n_ints, int B, int T, int S, int H, int KV, int hd, int width,
    int causal, int window, float cap, float scale, void* stream) {
  using namespace tc;
  using Gm = Geo<E>;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kRag ? (hd < 1 || hd > width) : hd != width) return -1;
  const int G = H / KV;
  const int NR = T * G, KT = Gm::key_tile(width), RT = Gm::row_tile(width);
  const int n_rb = (NR + Gm::rows - 1) / Gm::rows, n_kt = (S + KT - 1) / KT;
  const int n_cq = chunks_of(n_kt, B * KV * n_rb, Gm::target, Gm::min_chunk,
                             Gm::max_chunks);
  const int cq = (n_kt + n_cq - 1) / n_cq;
  const int n_kb = (S + Gm::keys - 1) / Gm::keys;
  const int n_rt = (NR + RT - 1) / RT;
  const int n_ck = chunks_of(n_rt, B * KV * n_kb * Gm::splits(width),
                             Gm::target, Gm::min_chunk, Gm::max_chunks);
  const int ck = (n_rt + n_ck - 1) / n_ck;
  const int n_rspan = (NR + kSpan - 1) / kSpan;
  const int n_kspan = (S + kSpan - 1) / kSpan;
  const size_t q_rows = (size_t)n_cq * B * KV * n_rb * Gm::rows;
  const size_t k_rows = (size_t)n_ck * 2 * B * n_kb * Gm::keys * KV;
  if ((size_t)n_work != (size_t)B * H * T * 4 + q_rows * (2 + width) +
                            k_rows * width ||
      (size_t)n_ints != (size_t)B * (n_rspan + n_kspan) * 4 +
                            (size_t)B * KV * n_kb * n_ck)
    return -1;
  float* stat_q = work + (size_t)B * H * T * 4;
  float* part_q = stat_q + q_rows * 2;
  float* part_k = part_q + q_rows * width;
  int* flags = spans + (size_t)B * (n_rspan + n_kspan) * 4;
  const ArgsT<E> a{static_cast<const E*>(q),    static_cast<const E*>(k),
                   static_cast<const E*>(v),    static_cast<const E*>(o),
                   static_cast<const E*>(dout), q_pos,
                   q_ctx,                       k_pos,
                   static_cast<E*>(dq),         static_cast<E*>(dk),
                   static_cast<E*>(dv),         reinterpret_cast<float4*>(work),
                   reinterpret_cast<int4*>(spans), flags,
                   reinterpret_cast<float2*>(stat_q), part_q, part_k,
                   B, T, S, H, KV, G, causal, window, n_rspan, n_kspan,
                   n_rb, n_cq, cq, n_kb, n_ck, ck, cap,
                   cap > 0.f ? 1.f / cap : 0.f, scale, hd};
  return dispatch<kRag>(a, width, s);
}

}  // namespace

// The bf16 ragged instances and the f32 instances (aligned and ragged)
// build as objects of their own (flash_attention_bwd_ragged.cu,
// flash_attention_bwd_f32.cu and flash_attention_bwd_f32_ragged.cu include
// this file with REPRO_RAGGED_PART and / or REPRO_F32_PART defined), so
// nvcc compiles them in parallel with the aligned bf16 ones; the entry
// reaches them through weak symbols (a build of this source alone, as a
// probe's, refuses their calls).
#define REPRO_BWD_PART_ARGS                                                  \
  const void *q, const void *k, const void *v, const void *o,               \
      const void *dout, const int *q_pos, const int *q_ctx,                  \
      const int *k_pos, void *dq, void *dk, void *dv, float *work,          \
      long long n_work, int *spans, long long n_ints, int B, int T, int S,  \
      int H, int KV, int hd, int width, int causal, int window, float cap,  \
      float scale, void *stream
#define REPRO_BWD_PART_CALL                                                  \
  q, k, v, o, dout, q_pos, q_ctx, k_pos, dq, dk, dv, work, n_work, spans,    \
      n_ints, B, T, S, H, KV, hd, width, causal, window, cap, scale, stream
#if defined(REPRO_F32_PART) && defined(REPRO_RAGGED_PART)
extern "C" int repro_flash_attention_bwd_f32_ragged(REPRO_BWD_PART_ARGS) {
  return bwd_launch<true, float>(REPRO_BWD_PART_CALL);
}
#elif defined(REPRO_F32_PART)
extern "C" int repro_flash_attention_bwd_f32(REPRO_BWD_PART_ARGS) {
  return bwd_launch<false, float>(REPRO_BWD_PART_CALL);
}
#elif defined(REPRO_RAGGED_PART)
extern "C" int repro_flash_attention_bwd_ragged(REPRO_BWD_PART_ARGS) {
  return bwd_launch<true, __nv_bfloat16>(REPRO_BWD_PART_CALL);
}
#else
extern "C" __attribute__((weak)) int repro_flash_attention_bwd_ragged(
    REPRO_BWD_PART_ARGS);
extern "C" __attribute__((weak)) int repro_flash_attention_bwd_f32(
    REPRO_BWD_PART_ARGS);
extern "C" __attribute__((weak)) int repro_flash_attention_bwd_f32_ragged(
    REPRO_BWD_PART_ARGS);

// q, o, dout, dq (B,T,H,hd); k, v, dk, dv (B,S,KV,hd); q_pos, q_ctx (B,T)
// and k_pos (B,S) int32; work (n_work f32) and spans (n_ints int32)
// scratch, sized by kernels/flash_attention.py::bwd_plan (a size other
// than this entry's layout is refused): work holds the row records
// (B,H,T,4), the dq chunks' (m, l) and sums and the dk/dv chunks' sums,
// spans the position summaries and the dk/dv chunks' live flags.  width
// and ragged: the compiled width and load path
// (kernels/decode_attention.py::head_dim_path; the chunks' sums have rows
// of width columns).  is_bf16 selects bf16 storage, else f32.  causal 0
// drops the horizon; cap <= 0 means no softcap, window <= 0 no window.
// The kernels run on the stream, in order.  Returns cudaGetLastError(),
// or -1 for a width or head dim it does not take or scratch of the wrong
// size.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const int* q_pos, const int* q_ctx, const int* k_pos,
    void* dq, void* dk, void* dv, float* work, long long n_work, int* spans,
    long long n_ints, int B, int T, int S, int H, int KV, int hd, int width,
    int ragged, int causal, int window, float cap, float scale, int is_bf16,
    void* stream) {
  if (is_bf16 && !ragged)
    return bwd_launch<false, __nv_bfloat16>(REPRO_BWD_PART_CALL);
  auto* part = is_bf16  ? repro_flash_attention_bwd_ragged
               : ragged ? repro_flash_attention_bwd_f32_ragged
                        : repro_flash_attention_bwd_f32;
  return part ? part(REPRO_BWD_PART_CALL) : -1;
}
#endif
