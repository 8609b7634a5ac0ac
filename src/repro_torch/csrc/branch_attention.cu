// Shared-prefix branch decode attention (Eq. 8) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ops.py::branch_decode_attention, which runs
// the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention twice (a prefix pass with shared_kv and a suffix pass,
// both with out_stats) and merges the two partial softmaxes by (m, l) in
// jnp.  k branches share one prefix K/V (1, Sp, KV, hd), stored once; each
// branch b has its own suffix K/V (k, Ss, KV, hd).  Query t of branch b
// sees key s when k_pos >= 0 and k_pos <= q_pos[b, t] (causal), with the
// optional tanh softcap; the scale 1/sqrt(hd) is applied to the f32
// logits; the sum is f32 and the output q's dtype.  A query that sees no
// key at all writes zeros.
//
// One fused pass: the tile loop of decode_attention.cuh (shared with the
// paged and flash kernels, head dims 16, 32, 64, 80, 128 and 256), with
// this file's addressing.  A block holds the query rows of every branch
// of its row tile (all k branches at the 7B width: k * G * Tq = 6 rows)
// for one kv head, so each prefix tile is read once per kv head, not
// once per branch.  Its key range is the prefix (pair (k, v)) followed by the
// suffixes of its branches (pair (k2, v2)); a suffix key is owned by its
// branch and masked to that branch's rows.  Nothing round-trips through
// device memory between the two halves; when the host splits the key
// axis, the splits merge inside the launch, through shared memory.
//
// What bounds it on the H100: memory.  The least traffic reads the prefix
// K/V once, every suffix once and q once, which this layout does.

#include "decode_attention.cuh"

namespace {

struct BranchKeys {
  static constexpr int kAhead = 1;  // prefix and suffix tiles are live
  const int* pp;  // prefix_pos (Sp,)
  const int* sp;  // suffix_pos (k, Ss)
  const int* qp;  // q_pos (k, Tq), token tl = b * Tq + t
  int Tq, Sp, Ss;
  struct Blk {
    int b0, nb;  // the row tile's first branch and its branch count
  };
  __device__ Tok token(int, int tl) const {
    const int p = qp[tl];
    return {p, p, tl / Tq};
  }
  __device__ Blk block(int, int tl0, int tl1) const {
    return {tl0 / Tq, tl1 / Tq - tl0 / Tq + 1};
  }
  __device__ int bound(const Blk& k) const { return Sp + k.nb * Ss; }
  __device__ int limit(const Blk& k) const { return bound(k); }
  __device__ Key key(const Blk& k, int s) const {
    if (s < Sp) return {pp[s], -1, 0, s};
    const int j = s - Sp, bi = k.b0 + j / Ss;
    const int row = bi * Ss + (j - (j / Ss) * Ss);
    return {sp[row], bi, 1, row};
  }
};

}  // namespace

// q (k,T,H,hd); prefix k/v (Sp,KV,hd); prefix_pos (Sp,); suffix k/v
// (k,Ss,KV,hd); suffix_pos (k,Ss); q_pos (k,T); out (k,T,H,hd).  The key
// axis runs in n_split (<= 8) splits of split_len keys.  is_bf16 selects
// bf16 storage, else f32.  cap <= 0 means no softcap.  Returns
// cudaGetLastError().
extern "C" int repro_branch_attention(
    const void* q, const void* prefix_k, const void* prefix_v,
    const int* prefix_pos, const void* suffix_k, const void* suffix_v,
    const int* suffix_pos, const int* q_pos, void* out, int nb, int T,
    int Sp, int Ss, int H, int KV, int hd, int n_split, int split_len,
    float cap, float scale, int is_bf16, void* stream) {
  const BranchKeys keys{prefix_pos, suffix_pos, q_pos, T, Sp, Ss};
  const int G = H / KV;
  const DecodeArgs a{q, prefix_k, prefix_v, suffix_k, suffix_v, out,
                     nb * T, H, KV, G, (nb * T * G + kRows - 1) / kRows,
                     n_split, split_len, /*window=*/0, cap, scale};
  return decode_launch<false>(keys, a, 1, hd, is_bf16, stream);
}
