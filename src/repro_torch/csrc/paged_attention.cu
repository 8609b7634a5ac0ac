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
// The tile loop, and what bounds it, is attention.cuh's; this file gives
// it the paged addressing: key s of row b is slot s % ps of page
// table[b, s / ps], and the block walks only the row's first lens[b]
// keys, so short rows cost nothing past their length.  T is tiled
// because bucketed prefill sends whole prompt rungs through this kernel,
// not only verify chunks.

#include "attention.cuh"

namespace {

struct PagedKeys {
  const int* table;    // (B, n_max) physical page of each logical page
  const int* lens;     // (B,) valid keys per row, the T queries included
  const int* q_start;  // (B,) position of the row's first query token
  int ps, n_max;
  __device__ int n_keys(int b) const {
    return min(max(lens[b], 0), n_max * ps);
  }
  __device__ int k_pos(int, int s) const { return s; }
  __device__ int kv_buf(int, int) const { return 0; }
  __device__ int kv_row(int b, int s) const {
    return table[(size_t)b * n_max + s / ps] * ps + s % ps;
  }
  __device__ int q_pos(int b, int t) const { return q_start[b] + t; }
  __device__ int q_ctx(int b, int t) const { return q_start[b] + t; }
};

}  // namespace

extern "C" size_t repro_paged_attention_smem(int rows, int hd) {
  return smem_bytes(rows, rows, hd);  // t_tile <= rows: an upper bound
}

// q (B,T,H,hd); k/v pages (P,ps,KV,hd); table (B,n_max); lens, q_start
// (B,); out (B,T,H,hd).  is_bf16 selects bf16 storage, else f32.  cap <= 0
// means no softcap, window <= 0 no window.  Returns cudaGetLastError().
extern "C" int repro_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const int* table, const int* lens, const int* q_start, void* out,
    int B, int T, int H, int KV, int hd, int ps, int n_max, int t_tile,
    int window, float cap, float scale, int is_bf16, void* stream) {
  const PagedKeys keys{table, lens, q_start, ps, n_max};
  return launch_attention(q, k_pages, v_pages, out, keys, B, T, H, KV, hd,
                          t_tile, /*causal=*/1, window, cap, scale, is_bf16,
                          stream);
}
