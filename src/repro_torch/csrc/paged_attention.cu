// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention.py::paged_decode_attention (body
// _kernel): online-softmax GQA attention read straight through a page
// table.  Key position = j * ps + o for slot o of logical page j; a key is
// visible to query token t of row b when kpos < lens[b] and
// kpos <= q_start[b] + t (plus the optional sliding window and tanh
// softcap); the scale is 1/sqrt(hd), applied to the f32 logits.  Fully
// masked keys add zero mass and a zero-length row writes zeros, as the
// TPU kernel does.
//
// The tile loop, and what bounds it, is decode_attention.cuh's (shared
// with branch_attention.cu and flash_attention.cu, any head dim from 1
// to 256 on its aligned or ragged load path); this file gives it the paged
// addressing:
// key s of row b is slot s % ps of page table[b, s / ps].  A block's key range is planned from n_max * ps,
// which the host knows; the loop walks only the row's first lens[b] keys
// (a serve's tables are as wide as its longest request), and the first
// page-table entries are read together with lens, so no K/V copy waits
// on lens.  T is tiled (16 rows of G heads x tokens per
// block) because bucketed prefill sends whole prompt rungs through this
// kernel, not only verify chunks.

#include "decode_attention.cuh"

namespace {

struct PagedKeys {
  static constexpr int kAhead = 1;  // a row's tiles up to its length are live
  const int* table;    // (B, n_max) physical page of each logical page
  const int* lens;     // (B,) valid keys per row, the T queries included
  const int* q_start;  // (B,) position of the row's first query token
  int ps, n_max;
  struct Blk {
    int b, lim;
  };
  __device__ Tok token(int b, int t) const {
    const int p = q_start[b] + t;
    return {p, p, 0};
  }
  __device__ Blk block(int b, int, int) const {
    return {b, min(max(lens[b], 0), n_max * ps)};
  }
  __device__ int bound(const Blk&) const { return n_max * ps; }
  __device__ int limit(const Blk& k) const { return k.lim; }
  __device__ Key key(const Blk& k, int s) const {
    const int page = table[(size_t)k.b * n_max + s / ps];
    return {s < k.lim ? s : -1, -1, 0, page * ps + s % ps};
  }
};

}  // namespace

// q (B,T,H,hd); k/v pages (P,ps,KV,hd); table (B,n_max); lens, q_start
// (B,); out (B,T,H,hd).  width and ragged: the compiled width and load
// path (kernels/decode_attention.py::head_dim_path).  The key axis runs
// in n_split (<= 8) splits of split_len keys.  is_bf16 selects bf16
// storage, else f32.  cap <= 0
// means no softcap, window <= 0 no window.  Returns cudaGetLastError().
extern "C" int repro_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const int* table, const int* lens, const int* q_start, void* out, int B,
    int T, int H, int KV, int hd, int width, int ragged, int ps, int n_max,
    int n_split,
    int split_len, int window, float cap, float scale, int is_bf16,
    void* stream) {
  const PagedKeys keys{table, lens, q_start, ps, n_max};
  const int G = H / KV;
  const DecodeArgs a{q, k_pages, v_pages, k_pages, v_pages, out, T, H, KV,
                     G, (T * G + kRows - 1) / kRows, n_split, split_len,
                     window, cap, scale, hd};
  return ragged ? decode_launch<false, true>(keys, a, B, width, is_bf16,
                                            stream)
                : decode_launch<false, false>(keys, a, B, width, is_bf16,
                                              stream);
}
