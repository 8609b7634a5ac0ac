// Flash attention over position-masked dense KV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (body _kernel),
// the function src/repro/models/layers.py::attend computes for every
// attention call of the dense ring cache and of the cache-less forward:
// online-softmax GQA attention where key s is visible to query t when
// k_pos[s] >= 0 (unwritten ring slots hold -1), k_pos[s] <= q_ctx[t]
// (causal; q_ctx is q_pos unless the caller gives a horizon) and
// q_pos[t] - k_pos[s] < window (window > 0), with an optional tanh
// softcap; the scale 1/sqrt(hd) multiplies q in f32 before the product.
// Positions are read as given: the ring wraps and a rollback leaves stale
// slots, so nothing assumes they are sorted or contiguous.  A query that
// sees no key writes zeros (masked keys add zero mass; the plain version
// averages V over its padded width there instead, and the runner never
// produces such a query).
//
// The tile loop, and what bounds it, is attention.cuh's; this file gives
// it the dense addressing: key s of row b is K/V row b * S + s.

#include "attention.cuh"

namespace {

struct DenseKeys {
  const int* qp;  // q_pos (B, T)
  const int* qc;  // q_ctx (B, T)
  const int* kp;  // k_pos (B, S)
  int T, S;
  __device__ int n_keys(int) const { return S; }
  __device__ int k_pos(int b, int s) const { return kp[(size_t)b * S + s]; }
  __device__ int kv_row(int b, int s) const { return b * S + s; }
  __device__ int q_pos(int b, int t) const { return qp[(size_t)b * T + t]; }
  __device__ int q_ctx(int b, int t) const { return qc[(size_t)b * T + t]; }
};

}  // namespace

extern "C" size_t repro_flash_attention_smem(int rows, int hd) {
  return smem_bytes(rows, rows, hd);  // t_tile <= rows: an upper bound
}

// q (B,T,H,hd); k/v (B,S,KV,hd); q_pos, q_ctx (B,T); k_pos (B,S); out
// (B,T,H,hd).  is_bf16 selects bf16 storage, else f32.  cap <= 0 means no
// softcap, window <= 0 no window.  Returns cudaGetLastError().
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* q_ctx, const int* k_pos, void* out, int B, int T, int S,
    int H, int KV, int hd, int t_tile, int causal, int window, float cap,
    float scale, int is_bf16, void* stream) {
  const DenseKeys keys{q_pos, q_ctx, k_pos, T, S};
  return launch_attention(q, k, v, out, keys, B, T, H, KV, hd, t_tile,
                          causal, window, cap, scale, is_bf16, stream);
}
