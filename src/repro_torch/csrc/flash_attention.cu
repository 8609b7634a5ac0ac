// Flash attention over position-masked dense KV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (body _kernel),
// the function src/repro/models/layers.py::attend computes for every
// attention call of the dense ring cache and of the cache-less forward:
// online-softmax GQA attention where key s is visible to query t when
// k_pos[s] >= 0 (unwritten ring slots hold -1), k_pos[s] <= q_ctx[t]
// (causal; q_ctx is q_pos unless the caller gives a horizon; no horizon
// when causal is 0) and q_pos[t] - k_pos[s] < window (window > 0), with
// an optional tanh softcap on the entries a query sees; the scale
// 1/sqrt(hd) multiplies the f32 logits.  Positions are read as given: the
// ring wraps and a rollback leaves stale slots, so nothing assumes they
// are sorted or contiguous.  A query that sees no key writes zeros
// (masked keys add zero mass; the plain version averages V over its
// padded width there instead, and the runner never produces such a
// query).
//
// The tile loop, and what bounds it, is decode_attention.cuh's; this file
// gives it the dense addressing: key s of row b is K/V row b * S + s at
// position k_pos[b, s].  Both the key range's bound and its limit are S,
// which the host knows, so the split plan comes from S.  On the
// sequential runner's early rings most of S is -1: key positions are read
// ahead of their copies, and a 16-key tile that no row of the block sees
// is neither copied nor computed.  Prefill, cache-less and bidirectional
// calls with at least 64 query rows (T x G) per item and kv head take the
// loop's wide block: 64 rows that share each K/V tile read, instead of one
// 16-row block per tile re-reading it.

#include "decode_attention.cuh"

namespace {

struct DenseKeys {
  // an early ring is mostly -1: runs of tiles no row sees
  static constexpr int kAhead = 4;
  const int* qp;  // q_pos (B, T)
  const int* qc;  // q_ctx (B, T)
  const int* kp;  // k_pos (B, S)
  int T, S, causal;
  struct Blk {
    int b;
  };
  __device__ Tok token(int b, int t) const {
    const size_t i = (size_t)b * T + t;
    return {causal ? qc[i] : 0x7fffffff, qp[i], 0};
  }
  __device__ Blk block(int b, int, int) const { return {b}; }
  __device__ int bound(const Blk&) const { return S; }
  __device__ int limit(const Blk&) const { return S; }
  __device__ Key key(const Blk& k, int s) const {
    const int row = k.b * S + s;
    return {kp[row], -1, 0, row};
  }
};

// one load path's launch (the C entries below)
template <bool kRag>
int flash_launch(const void* q, const void* k, const void* v,
                 const int* q_pos, const int* q_ctx, const int* k_pos,
                 void* out, int B, int T, int S, int H, int KV, int hd,
                 int width, int wide, int n_split, int split_len, int causal,
                 int window, float cap, float scale, int is_bf16,
                 void* stream) {
  const DenseKeys keys{q_pos, q_ctx, k_pos, T, S, causal};
  const int G = H / KV, rows = wide ? kWideRows : kRows;
  const DecodeArgs a{q, k, v, k, v, out, T, H, KV, G,
                     (T * G + rows - 1) / rows, n_split, split_len,
                     window, cap, scale, hd};
  return wide ? decode_launch<true, kRag>(keys, a, B, width, is_bf16, stream)
              : decode_launch<false, kRag>(keys, a, B, width, is_bf16,
                                           stream);
}

}  // namespace

// The ragged path's instances build as an object of their own
// (flash_attention_ragged.cu includes this file with REPRO_RAGGED_PART
// defined), so nvcc compiles them in parallel with the aligned ones; the
// entry reaches them through a weak symbol (a build of this source alone,
// as a probe's, refuses ragged calls).
#ifdef REPRO_RAGGED_PART
extern "C" int repro_flash_attention_ragged(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* q_ctx, const int* k_pos, void* out, int B, int T, int S,
    int H, int KV, int hd, int width, int wide, int n_split, int split_len,
    int causal, int window, float cap, float scale, int is_bf16,
    void* stream) {
  return flash_launch<true>(q, k, v, q_pos, q_ctx, k_pos, out, B, T, S, H,
                            KV, hd, width, wide, n_split, split_len, causal,
                            window, cap, scale, is_bf16, stream);
}
#else
extern "C" __attribute__((weak)) int repro_flash_attention_ragged(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* q_ctx, const int* k_pos, void* out, int B, int T, int S,
    int H, int KV, int hd, int width, int wide, int n_split, int split_len,
    int causal, int window, float cap, float scale, int is_bf16,
    void* stream);

// q (B,T,H,hd); k/v (B,S,KV,hd); q_pos, q_ctx (B,T); k_pos (B,S); out
// (B,T,H,hd).  width and ragged: the compiled width and load path
// (kernels/decode_attention.py::head_dim_path).  wide selects blocks of
// 64 query rows (else 16).  The key axis runs in n_split (<= 8) splits of
// split_len keys.  is_bf16 selects bf16 storage, else f32.  causal 0
// drops the horizon; cap <= 0 means no softcap, window <= 0 no window.
// Returns cudaGetLastError().
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* q_ctx, const int* k_pos, void* out, int B, int T, int S,
    int H, int KV, int hd, int width, int ragged, int wide, int n_split,
    int split_len, int causal, int window, float cap, float scale,
    int is_bf16, void* stream) {
  if (ragged)
    return repro_flash_attention_ragged
               ? repro_flash_attention_ragged(
                     q, k, v, q_pos, q_ctx, k_pos, out, B, T, S, H, KV, hd,
                     width, wide, n_split, split_len, causal, window, cap,
                     scale, is_bf16, stream)
               : (int)cudaErrorInvalidValue;
  return flash_launch<false>(q, k, v, q_pos, q_ctx, k_pos, out, B, T, S, H,
                             KV, hd, width, wide, n_split, split_len, causal,
                             window, cap, scale, is_bf16, stream);
}
#endif
