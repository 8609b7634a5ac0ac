// Shared-prefix branch decode attention (Eq. 8) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ops.py::branch_decode_attention, which runs
// the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention twice (a prefix pass with shared_kv and a suffix pass,
// both with out_stats) and merges the two partial softmaxes by (m, l) in
// jnp.  k branches share one prefix K/V (1, Sp, KV, hd), stored once; each
// branch b has its own suffix K/V (k, Ss, KV, hd).  Query t of branch b
// sees key s when k_pos >= 0 and k_pos <= q_pos[b, t] (causal), with the
// optional tanh softcap; the scale 1/sqrt(hd) multiplies q in f32; the sum
// is f32 and the output q's dtype.  A query that sees no key at all
// writes zeros.
//
// One fused pass: the tile loop of attention.cuh, with this file's
// addressing, walks key s < Sp as prefix row s (the pair (k, v), shared by
// every branch) and key s >= Sp as suffix row b * Ss + s - Sp (the pair
// (k2, v2)), in ONE online softmax per (branch, kv head, T tile) block.
// Nothing round-trips through device memory between the two halves: no
// (m, l) outputs, no merge launches.  A 64-key tile may straddle the
// boundary; each key is addressed on its own.
//
// What bounds it on the H100: memory.  The least traffic reads the prefix
// K/V once, every suffix once and q once; the blocks of the k branches
// re-read the prefix tiles of their kv head, which the 50 MB L2 serves
// after the first read at the 7B decode widths (k = 6, Sp ~ 500: 8.3 MB of
// prefix).

#include "attention.cuh"

namespace {

struct BranchKeys {
  const int* pp;  // prefix_pos (Sp,)
  const int* sp;  // suffix_pos (k, Ss)
  const int* qp;  // q_pos (k, T)
  int T, Sp, Ss;
  __device__ int n_keys(int) const { return Sp + Ss; }
  __device__ int k_pos(int b, int s) const {
    return s < Sp ? pp[s] : sp[(size_t)b * Ss + s - Sp];
  }
  __device__ int kv_buf(int, int s) const { return s >= Sp; }
  __device__ int kv_row(int b, int s) const {
    return s < Sp ? s : b * Ss + s - Sp;
  }
  __device__ int q_pos(int b, int t) const { return qp[(size_t)b * T + t]; }
  __device__ int q_ctx(int b, int t) const { return qp[(size_t)b * T + t]; }
};

}  // namespace

extern "C" size_t repro_branch_attention_smem(int rows, int hd) {
  return smem_bytes(rows, rows, hd);  // t_tile <= rows: an upper bound
}

// q (k,T,H,hd); prefix k/v (Sp,KV,hd); prefix_pos (Sp,); suffix k/v
// (k,Ss,KV,hd); suffix_pos (k,Ss); q_pos (k,T); out (k,T,H,hd).  is_bf16
// selects bf16 storage, else f32.  cap <= 0 means no softcap.  Returns
// cudaGetLastError().
extern "C" int repro_branch_attention(
    const void* q, const void* prefix_k, const void* prefix_v,
    const int* prefix_pos, const void* suffix_k, const void* suffix_v,
    const int* suffix_pos, const int* q_pos, void* out, int nb, int T,
    int Sp, int Ss, int H, int KV, int hd, int t_tile, float cap,
    float scale, int is_bf16, void* stream) {
  const BranchKeys keys{prefix_pos, suffix_pos, q_pos, T, Sp, Ss};
  return launch_attention(q, prefix_k, prefix_v, out, keys, nb, T, H, KV, hd,
                          t_tile, /*causal=*/1, /*window=*/0, cap, scale,
                          is_bf16, stream, suffix_k, suffix_v);
}
