// Backward of the Mamba-1 selective scan (carry mode) for Hopper (sm_90a),
// from chunk checkpoints.
//
// The TPU kernel it stands behind is src/repro/kernels/ssm_scan.py:80
// (ssm_scan), which has no backward: the reference's training path
// differentiates the chunked lax.scan of src/repro/models/layers.py::mamba
// (chunk = min(128, T), jax.checkpoint on each chunk's body) with
// jax.value_and_grad, so it saves only the state at each chunk boundary
// and recomputes the steps inside a chunk.  This kernel does the same: the
// forward's chunk mode (ssm_scan.cu, repro_ssm_scan_chunks) saves hc
// (B, nC, E, N), the state entering each chunk of kK steps (nC =
// ceil(T / kK)), and kernels/ssm_scan.py::SsmScanFn launches this kernel
// from it.
//
// Forward, all in f32:  a_t = exp(dt_t * A),  h_t = a_t * h_{t-1} +
// (dt_t * x_t) * B_t,  y_t = <h_t, C_t> + D * x_t, with x, dt (B, T, E),
// Bm, Cm (B, T, N), A (E, N), D (E,), h0 (B, E, N).  The reverse
// recurrence, with g_t the total gradient reaching h_t
// (g_{T-1} = dhT + dy_{T-1} C_{T-1}; g_t = a_{t+1} g_{t+1} + dy_t C_t):
//   dx_t   = dy_t D + dt_t <g_t, B_t>
//   ddt_t  = x_t <g_t, B_t> + <g_t, h_{t-1} a_t A>
//   dB_t   = sum_e g_t (dt_t x_t)            dC_t = sum_e dy_t h_t
//   dA     = sum_{b,t} g_t h_{t-1} a_t dt_t  dD   = sum_{b,t} dy_t x_t
//   dh0    = a_0 g_0
//
// What bounds it on the H100.  Bytes, as a contract: x, dt, dy in and dx,
// ddt out (B, T, E each), hc in (4 bytes x B x nC x E x N): ~44 MB at
// falcon-mamba-7b's training frame (B = 1, T = 256, E = 8192, N = 16, x
// bf16, kK = 16), 0.013 ms at 3.35 TB/s, against the 134 MB of the
// every-state hs the previous design read (0.051 ms).  In practice the
// work and its latency: the recomputed forward's exp (~9 instructions)
// and ~25 more a (b, t, e, n) in the main stage, ~8 in the carry stage,
// each chunk's walk sequential in t; the measured time (PERF.md row 7c)
// is ~7x the bytes bound.
//
// Design: parallel over time, four launches in order on the stream, the
// last three programmatic (PDL: each may start while the one before it
// runs and waits for it only where it reads its output).
// 1. Carry stage (ssm_bwd_local_kernel, over (channel group, chunk 1..nC-1,
//    b)): the reverse recurrence is linear, so the adjoint a chunk hands
//    to the one before it is L_k + P_k c_k, with c_k the carry it gets
//    from the one after it, L_k its own adjoint walked from a zero carry
//    and P_k = exp(A * sum_{t in k} dt_t) the product of its decays.  This
//    kernel walks each chunk from zero (dt, dy and C only; no states) and
//    writes L_k and sum dt.
// 2. Join (ssm_bwd_join_kernel, one thread per (b, e, four states)): walks
//    the chunks from the last, c_{nC-1} = dhT, c_{k-1} = L_k + P_k c_k,
//    writing each chunk's carry in place of its successor's L.
// 3. Main stage (ssm_bwd_main_kernel, over (channel group, chunk, b): 4096
//    blocks at falcon's frame): a block stages its chunk's x, dt, dy, B and
//    C in shared memory with 16-byte cp.async copies, recomputes the
//    chunk's states from its checkpoint with the forward's own step
//    (ssm_scan_step.cuh) and keeps them in shared memory (C channels x kK
//    x N x 4 B = 32 KB at kK = 16, 43.5 KB in all: five blocks an SM),
//    sums dC over its channels, and only then waits for the join: that
//    much overlaps the carry stage.  Then it walks the chunk backward
//    from its carry: dx and ddt go straight to device memory from each
//    channel's lanes (stores do not stall the walk; L2 merges a warp's
//    8-channel pieces), and g_t u_t overwrites each spent state, whose
//    sum over the channels is dB.  A channel's N states lie on N/4
//    lanes of one warp, four each, so the dot products over N take
//    log2(N/4) shuffles; dB and dC are summed over channels in shared
//    memory (one (step, four states) item a thread; where items are
//    fewer than threads, in channel parts joined in order), not by
//    shuffles a step.  The adjoint's decays are
//    one ex2.approx each (exp's ~9 instructions were a third of the walk);
//    the recomputed states keep expf.  dA and dD: one partial per (b,
//    chunk); dh0: chunk 0's walk.
// 4. Reduction (ssm_bwd_reduce_kernel): a 256-thread block per (b, t) sums
//    its dB/dC partials (one per channel block) with coalesced reads, then
//    across the block in a fixed order; dA and dD are summed over the (b,
//    chunk) partials, a thread an output.
// Every float sum runs in a fixed order (no atomics): two launches give
// the same bits.  -DREPRO_SCAN_BWD_STOP builds phase-by-phase variants
// for chip_smoke.py --scan-bwd (1: the carry stage only; 2: the main
// stage's staging copies only; 3: all but the reduction), and
// -DREPRO_SCAN_CHUNK sets kK (16, 32 or 64; ssm_scan_step.cuh, which
// the forward reads it from too).  kK = 16 by measurement at falcon's
// training frame: 0.098 ms against 0.116 (32) and 0.153 (64); the longer
// chunks halve the checkpoints and carries but hold two blocks an SM
// (64 KB of states each) or one.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ssm_scan_step.cuh"

#ifndef REPRO_SCAN_BWD_STOP
#define REPRO_SCAN_BWD_STOP 0
#endif

namespace {

constexpr int kK = kScanChunk;   // steps of a chunk (ssm_scan_step.cuh)
constexpr int kStop = REPRO_SCAN_BWD_STOP;
constexpr int kThreads = 128;
constexpr int kRedThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// The tile of one block for state size N: G lanes a channel, C channels
// (C * N = 512 states), shared-memory row strides padded so that the
// dB / dC sums read conflict-free, and the channel parts P of those sums.
template <int N>
struct Tile {
  static constexpr int G = N / 4;
  static constexpr int C = kThreads / G;
  static constexpr int SC = C + 4;           // dt / dy row stride (floats)
  static constexpr int SLOT = C * N + N;     // one step's states (floats)
  static constexpr int ITEMS = kK * G;       // (step, four states) items
  static constexpr int P = ITEMS >= kThreads ? 1 : kThreads / ITEMS;
  static constexpr int CP = C / P;           // channels of a part
  static constexpr size_t main_smem(size_t xsize) {
    return 4 * ((size_t)kK * (SLOT + 2 * SC + 2 * N) +
                (P > 1 ? 4 * kThreads : 0)) +
           kK * C * xsize;
  }
  static constexpr size_t local_smem() {
    return 4 * (size_t)kK * (2 * SC + N);
  }
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Programmatic dependent launch: a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start once every
// block of the kernel before it has called launch_dependents() (or
// exited), and dependency_wait() blocks until that kernel has completed
// and its writes are visible (at once for a kernel launched without the
// attribute).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The adjoint's decay exp(dv * A) (and the join's exp(A S)) from a2 = A
// log2(e): one ex2.approx a state (relative error ~2^-22 beside the
// product's rounding), where the recomputed states keep the forward's
// expf (ssm_step).
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float4 adj_decay(float dv, float4 a2) {
  return make_float4(ex2(dv * a2.x), ex2(dv * a2.y), ex2(dv * a2.z),
                     ex2(dv * a2.w));
}
__device__ __forceinline__ float4 log2e_times(float4 a) {
  constexpr float kLog2e = 1.4426950408889634f;
  return make_float4(a.x * kLog2e, a.y * kLog2e, a.z * kLog2e,
                     a.w * kLog2e);
}

// rows x LEN elements of T from global src (row stride src_stride) to
// shared dst (row stride dst_stride, 16-byte aligned rows), the block's
// threads together: 16-byte cp.async copies where a vector is aligned and
// inside the first `valid` elements of its row, element by element
// elsewhere, zeros past `valid`.
template <typename T, int LEN>
__device__ __forceinline__ void stage(T* dst, int dst_stride, const T* src,
                                      size_t src_stride, int rows,
                                      int valid) {
  constexpr int V = 16 / sizeof(T);
  constexpr int VPR = LEN / V;
  static_assert(LEN % V == 0, "rows must be whole 16-byte vectors");
  for (int i = threadIdx.x; i < rows * VPR; i += blockDim.x) {
    const int r = i / VPR, v = (i - r * VPR) * V;
    T* d = dst + r * dst_stride + v;
    const T* s = src + r * src_stride + v;
    if (v + V <= valid && aligned16(s)) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) d[q] = v + q < valid ? s[q] : from_f<T>(0.f);
    }
  }
}

// The block's dB or dC partials of one chunk: for each step j < kc and
// four states q, the sum over the block's channels, in channel order, of
// v[j][c][4q..] (times w[j][c] when W): v = the spent states' g_t u_t
// (dB, W false) or the recomputed states with w = dy (dC).  Where there
// are fewer items than threads, each item's channels are split in P
// parts, summed in part order through red.  Stored to part_bc (rows (b,
// t), nparts x 2N) at part `part`, column off.
template <int N, bool W>
__device__ __forceinline__ void sum_channels(const float* slot,
                                             const float* w, float* red,
                                             float* part_bc, size_t row0,
                                             int nparts, int part, int kc,
                                             int off) {
  using L = Tile<N>;
  for (int i = threadIdx.x; i < L::ITEMS * L::P; i += kThreads) {
    const int item = i % L::ITEMS, p = i / L::ITEMS;
    const int j = item / L::G, q = item - j * L::G;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < kc) {
      const float* v = slot + j * L::SLOT + p * L::CP * N + 4 * q;
#pragma unroll 8
      for (int cc = 0; cc < L::CP; ++cc) {
        const float4 h = ld4(v + cc * N);
        const float m = W ? w[j * L::SC + p * L::CP + cc] : 1.f;
        s.x = fmaf(m, h.x, s.x);
        s.y = fmaf(m, h.y, s.y);
        s.z = fmaf(m, h.z, s.z);
        s.w = fmaf(m, h.w, s.w);
      }
    }
    float* dst = part_bc + ((row0 + j) * nparts + part) * 2 * N + off + 4 * q;
    if (L::P == 1) {
      if (j < kc) st4(dst, s);
    } else {
      st4(red + 4 * i, s);
      __syncthreads();       // every thread reaches it: i < ITEMS * P
      if (p == 0 && j < kc) {
        for (int pp = 1; pp < L::P; ++pp) {
          const float4 o = ld4(red + 4 * (pp * L::ITEMS + item));
          s.x += o.x;
          s.y += o.y;
          s.z += o.z;
          s.w += o.w;
        }
        st4(dst, s);
      }
      __syncthreads();       // red is free again
    }
  }
}

struct Grads {
  void* dx;            // (B, T, E) in x's dtype
  float* ddt;          // (B, T, E)
  float* dh0;          // (B, E, N)
  float* carry;        // (B, nC - 1, E, N): L_k, then the joined carries
  float* S;            // (B, nC - 1, E): sum of dt over chunk k
  float* part_bc;      // (B, T, nparts, 2N): dB then dC partials
  float* part_a;       // (B, nC, E, N)
  float* part_d;       // (B, nC, E)
  int nparts;
};

// Stage 1: each chunk k >= 1's adjoint walked from a zero carry (L_k) and
// its sum of dt, to carry[b, k - 1] and S[b, k - 1].
template <int N>
__global__ void __launch_bounds__(kThreads) ssm_bwd_local_kernel(
    const float* __restrict__ dt, const float* __restrict__ Cm,
    const float* __restrict__ A, const float* __restrict__ dy, Grads gr,
    int T, int E) {
  using L = Tile<N>;
  extern __shared__ __align__(16) float smem[];
  float* sdt = smem;
  float* sdy = sdt + kK * L::SC;
  float* sC = sdy + kK * L::SC;
  launch_dependents();        // the join may start; it waits for this grid
  const int k = blockIdx.y + 1, b = blockIdx.z, nC = gridDim.y + 1;
  const int g = threadIdx.x % L::G, c = threadIdx.x / L::G;
  const int e0 = blockIdx.x * L::C, e = e0 + c;
  const bool live = e < E;
  const int valid = min(L::C, E - e0);
  const int t0 = k * kK, kc = min(kK, T - t0);
  const size_t r0 = (size_t)b * T + t0;
  const size_t EN = (size_t)E * N, ch = (size_t)e * N + 4 * g;
  stage<float, L::C>(sdt, L::SC, dt + r0 * E + e0, E, kc, valid);
  stage<float, L::C>(sdy, L::SC, dy + r0 * E + e0, E, kc, valid);
  stage<float, N>(sC, N, Cm + r0 * N, N, kc, N);
  const float4 a2 = log2e_times(
      live ? ld4(A + ch) : make_float4(0.f, 0.f, 0.f, 0.f));
  cp_async_wait_all();
  __syncthreads();
  float4 adj = make_float4(0.f, 0.f, 0.f, 0.f);
  float s = 0.f;
  for (int j = kc - 1; j >= 0; --j) {
    const float dv = sdt[j * L::SC + c], dyv = sdy[j * L::SC + c];
    const float4 cj = ld4(sC + j * N + 4 * g);
    const float4 dec = adj_decay(dv, a2);
    adj.x = fmaf(dyv, cj.x, adj.x) * dec.x;
    adj.y = fmaf(dyv, cj.y, adj.y) * dec.y;
    adj.z = fmaf(dyv, cj.z, adj.z) * dec.z;
    adj.w = fmaf(dyv, cj.w, adj.w) * dec.w;
    s += dv;
  }
  if (live) {
    const size_t slab = (size_t)b * (nC - 1) + k - 1;
    st4(gr.carry + slab * EN + ch, adj);
    if (g == 0) gr.S[slab * E + e] = s;
  }
}

// Stage 2: the carries, from the last chunk back: c = dhT, then for k =
// nC-1 .. 1, c = L_k + exp(A S_k) c is chunk k - 1's carry, written over
// L_k's slot k - 1.  One thread per (b, e, four states).
__global__ void __launch_bounds__(kThreads) ssm_bwd_join_kernel(
    const float* __restrict__ A, const float* __restrict__ dhT, Grads gr,
    int B, int E, int N, int nC) {
  const int G = N / 4;
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (size_t)B * E * G) {
    launch_dependents();
    return;
  }
  const int b = (int)(i / ((size_t)E * G));
  const int r = (int)(i - (size_t)b * E * G);
  const int e = r / G;
  const size_t EN = (size_t)E * N, ch = (size_t)r * 4;
  const float4 a2 = log2e_times(ld4(A + ch));
  float4 c = dhT != nullptr ? ld4(dhT + b * EN + ch)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
  launch_dependents();        // the main stage may start its first half
  dependency_wait();          // the carry stage's L and S are written
#pragma unroll 4
  for (int k = nC - 1; k >= 1; --k) {
    const size_t slab = (size_t)b * (nC - 1) + k - 1;
    float* p = gr.carry + slab * EN + ch;
    const float4 l = ld4(p);
    const float4 dec = adj_decay(gr.S[slab * E + e], a2);
    c = make_float4(fmaf(dec.x, c.x, l.x), fmaf(dec.y, c.y, l.y),
                    fmaf(dec.z, c.z, l.z), fmaf(dec.w, c.w, l.w));
    st4(p, c);
  }
}

// Stage 3: one (channel group, chunk, b) a block (see the note above).
template <int N, typename XT>
__global__ void __launch_bounds__(kThreads) ssm_bwd_main_kernel(
    const XT* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ A, const float* __restrict__ Dv,
    const float* __restrict__ hc, const float* __restrict__ dy,
    const float* __restrict__ dhT, Grads gr, int T, int E) {
  using L = Tile<N>;
  extern __shared__ __align__(16) float smem[];
  float* slot = smem;                        // kK x SLOT states
  float* sdt = slot + kK * L::SLOT;
  float* sdy = sdt + kK * L::SC;
  float* sB = sdy + kK * L::SC;
  float* sC = sB + kK * N;
  float* red = sC + kK * N;                  // 4 x kThreads where P > 1
  XT* sx = reinterpret_cast<XT*>(red + (L::P > 1 ? 4 * kThreads : 0));
  const int k = blockIdx.y, b = blockIdx.z, nC = gridDim.y;
  const int g = threadIdx.x % L::G, c = threadIdx.x / L::G;
  const int e0 = blockIdx.x * L::C, e = e0 + c;
  const bool live = e < E;
  const int valid = min(L::C, E - e0);
  const int t0 = k * kK, kc = min(kK, T - t0);
  const size_t r0 = (size_t)b * T + t0;
  const size_t EN = (size_t)E * N, ch = (size_t)e * N + 4 * g;

  stage<XT, L::C>(sx, L::C, x + r0 * E + e0, E, kc, valid);
  stage<float, L::C>(sdt, L::SC, dt + r0 * E + e0, E, kc, valid);
  stage<float, L::C>(sdy, L::SC, dy + r0 * E + e0, E, kc, valid);
  stage<float, N>(sB, N, Bm + r0 * N, N, kc, N);
  stage<float, N>(sC, N, Cm + r0 * N, N, kc, N);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 a = zero, hin = zero, adj = zero;
  float d = 0.f;
  if (live) {
    a = ld4(A + ch);
    d = Dv[e];
    hin = ld4(hc + ((size_t)b * nC + k) * EN + ch);
    if (k + 1 == nC && dhT != nullptr) adj = ld4(dhT + b * EN + ch);
  }
  cp_async_wait_all();
  __syncthreads();

  if (kStop != 2) {
    // the chunk's states, recomputed with the forward's step
    float* my = slot + c * N + 4 * g;
    float4 h = hin;
#pragma unroll 4
    for (int j = 0; j < kc; ++j) {
      ssm_step(h, a, sdt[j * L::SC + c], to_f(sx[j * L::C + c]),
               ld4(sB + j * N + 4 * g));
      st4(my + j * L::SLOT, h);
    }
    __syncthreads();
    sum_channels<N, true>(slot, sdy, red, gr.part_bc, r0, gr.nparts,
                          blockIdx.x, kc, N);                 // dC
    // everything so far needs no carry: with a programmatic launch it ran
    // beside the carry stage; the carry is the join's
    if (k + 1 < nC) {         // the last chunk's carry is dhT
      dependency_wait();
      if (live) adj = ld4(gr.carry + ((size_t)b * (nC - 1) + k) * EN + ch);
    }
    __syncthreads();
    // the reverse walk from the chunk's carry; dx and ddt go straight to
    // device memory (the shuffles leave the sums in every lane of the
    // channel, and all of them store: the same address and value, merged
    // into one transaction, with no divergent branch in the step)
    const float4 a2 = log2e_times(a);
    XT* dx = static_cast<XT*>(gr.dx) + r0 * E + e;
    float* ddt = gr.ddt + r0 * E + e;
    float4 dacc = zero;
    float dd = 0.f;
#pragma unroll 2
    for (int j = kc - 1; j >= 0; --j) {
      const float xv = to_f(sx[j * L::C + c]);
      const float dv = sdt[j * L::SC + c];
      const float dyv = sdy[j * L::SC + c];
      const float4 bj = ld4(sB + j * N + 4 * g);
      const float4 cj = ld4(sC + j * N + 4 * g);
      adj.x = fmaf(dyv, cj.x, adj.x);        // g_t
      adj.y = fmaf(dyv, cj.y, adj.y);
      adj.z = fmaf(dyv, cj.z, adj.z);
      adj.w = fmaf(dyv, cj.w, adj.w);
      const float4 hp = j > 0 ? ld4(my + (j - 1) * L::SLOT) : hin;
      const float4 dec = adj_decay(dv, a2);
      // w = g_t h_{t-1} a_t: dA's term over dt, ddt's over A
      const float4 w = make_float4(adj.x * hp.x * dec.x,
                                   adj.y * hp.y * dec.y,
                                   adj.z * hp.z * dec.z,
                                   adj.w * hp.w * dec.w);
      float gB = (adj.x * bj.x + adj.y * bj.y) + (adj.z * bj.z + adj.w * bj.w);
      float gha = (w.x * a.x + w.y * a.y) + (w.z * a.z + w.w * a.w);
#pragma unroll
      for (int off = 1; off < L::G; off <<= 1) {
        gB += __shfl_xor_sync(kFull, gB, off);
        gha += __shfl_xor_sync(kFull, gha, off);
      }
      dacc.x = fmaf(w.x, dv, dacc.x);
      dacc.y = fmaf(w.y, dv, dacc.y);
      dacc.z = fmaf(w.z, dv, dacc.z);
      dacc.w = fmaf(w.w, dv, dacc.w);
      dd = fmaf(dyv, xv, dd);
      const float u = __fmul_rn(dv, xv);
      st4(my + j * L::SLOT,
          make_float4(adj.x * u, adj.y * u, adj.z * u, adj.w * u));
      if (live) {     // every lane of the channel: one merged store
        ddt[(size_t)j * E] = fmaf(xv, gB, gha);
        dx[(size_t)j * E] = from_f<XT>(fmaf(dv, gB, dyv * d));
      }
      adj.x *= dec.x;                        // a_t g_t
      adj.y *= dec.y;
      adj.z *= dec.z;
      adj.w *= dec.w;
    }
    launch_dependents();      // the reduction may start; it waits
    if (live) {
      if (k == 0) st4(gr.dh0 + b * EN + ch, adj);
      st4(gr.part_a + ((size_t)b * nC + k) * EN + ch, dacc);
      if (g == 0) gr.part_d[((size_t)b * nC + k) * E + e] = dd;
    }
    __syncthreads();
    sum_channels<N, false>(slot, nullptr, red, gr.part_bc, r0, gr.nparts,
                           blockIdx.x, kc, 0);                // dB
  }
}

// Stage 4: dB, dC (blocks 0 .. B*T - 1: one (b, t) row of nparts x 2N
// partials each, read coalesced, each thread summing the columns equal to
// its index mod 2N, then the block's threads of one column in order) and
// dA, dD (the later blocks: one output a thread, over the B x nC (b,
// chunk) partials in order).
__global__ void __launch_bounds__(kRedThreads) ssm_bwd_reduce_kernel(
    Grads gr, float* __restrict__ dBm, float* __restrict__ dCm,
    float* __restrict__ dA, float* __restrict__ dD, int BT, int E, int N,
    int n_a) {
  __shared__ float red[kRedThreads];
  dependency_wait();          // the main stage's partials are written
  if ((int)blockIdx.x < BT) {
    const int W = 2 * N;
    const int len = gr.nparts * W;
    const float* row = gr.part_bc + (size_t)blockIdx.x * len;
    float s = 0.f;
#pragma unroll 8
    for (int i = threadIdx.x; i < len; i += kRedThreads) s += row[i];
    red[threadIdx.x] = s;
    __syncthreads();
    if ((int)threadIdx.x < W) {
      float t = 0.f;
      for (int i = threadIdx.x; i < kRedThreads; i += W) t += red[i];
      if ((int)threadIdx.x < N)
        dBm[(size_t)blockIdx.x * N + threadIdx.x] = t;
      else
        dCm[(size_t)blockIdx.x * N + threadIdx.x - N] = t;
    }
    return;
  }
  size_t i = (size_t)(blockIdx.x - BT) * kRedThreads + threadIdx.x;
  const size_t EN = (size_t)E * N;
  if (i < EN) {
    float s = 0.f;
    for (int p = 0; p < n_a; ++p) s += gr.part_a[p * EN + i];
    dA[i] = s;
    return;
  }
  i -= EN;
  if (i < (size_t)E) {
    float s = 0.f;
    for (int p = 0; p < n_a; ++p) s += gr.part_d[(size_t)p * E + i];
    dD[i] = s;
  }
}

template <int N>
int n_parts(int E) {
  return (E + Tile<N>::C - 1) / Tile<N>::C;
}

int parts_for(int E, int N) {
  switch (N) {
    case 4: return n_parts<4>(E);
    case 8: return n_parts<8>(E);
    case 16: return n_parts<16>(E);
    default: return -1;
  }
}

size_t up4(size_t n) { return (n + 3) / 4 * 4; }

// float offsets of carry, S, part_bc, part_a, part_d in the scratch
// buffer (each 16-byte aligned); returns the total
size_t layout(int B, int T, int E, int N, size_t* off) {
  const size_t nC = (T + kK - 1) / kK, EN = (size_t)E * N;
  const size_t sizes[5] = {
      (size_t)B * (nC - 1) * EN, (size_t)B * (nC - 1) * E,
      (size_t)B * T * parts_for(E, N) * 2 * N, (size_t)B * nC * EN,
      (size_t)B * nC * E};
  size_t at = 0;
  for (int i = 0; i < 5; ++i) {
    off[i] = at;
    at += up4(sizes[i]);
  }
  return at;
}

template <int N, typename XT>
int launch(const void* x, const float* dt, const float* Bm, const float* Cm,
           const float* A, const float* D, const float* hc, const float* dy,
           const float* dhT, Grads gr, float* dBm, float* dCm, float* dA,
           float* dD, int B, int T, int E, cudaStream_t s) {
  using L = Tile<N>;
  const size_t sm_main = L::main_smem(sizeof(XT)), sm_local = L::local_smem();
  int rc;
  // set on each launch (the limit is per device)
  if ((rc = (int)cudaFuncSetAttribute(
           ssm_bwd_main_kernel<N, XT>,
           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm_main)) != 0)
    return rc;
  if ((rc = (int)cudaFuncSetAttribute(
           ssm_bwd_local_kernel<N>,
           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm_local)) != 0)
    return rc;
  const int nblk = (E + L::C - 1) / L::C, nC = (T + kK - 1) / kK;
  // the join, the main stage and the reduction launch programmatically
  // (each may start while the kernel before it runs, and waits for it
  // where it must)
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  if (kStop != 2 && nC > 1) {
    ssm_bwd_local_kernel<N><<<dim3(nblk, nC - 1, B), kThreads, sm_local, s>>>(
        dt, Cm, A, dy, gr, T, E);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
    const size_t n = (size_t)B * E * (N / 4);
    cfg.gridDim = dim3((unsigned)((n + kThreads - 1) / kThreads));
    cfg.dynamicSmemBytes = 0;
    cudaLaunchKernelEx(&cfg, ssm_bwd_join_kernel, A, dhT, gr, B, E, N, nC);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
  }
  if (kStop == 1) return 0;
  // one chunk: no join before it, so an ordinary launch (dy and the
  // other inputs may come from the kernel just before)
  cfg.numAttrs = nC > 1 && kStop != 2 ? 1 : 0;
  cfg.gridDim = dim3(nblk, nC, B);
  cfg.dynamicSmemBytes = sm_main;
  cudaLaunchKernelEx(&cfg, ssm_bwd_main_kernel<N, XT>,
                     static_cast<const XT*>(x), dt, Bm, Cm, A, D, hc, dy,
                     dhT, gr, T, E);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  if (kStop != 0) return 0;
  const size_t n_ad = (size_t)E * N + E;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(
      (unsigned)(B * T + (n_ad + kRedThreads - 1) / kRedThreads));
  cfg.blockDim = dim3(kRedThreads);
  cfg.dynamicSmemBytes = 0;
  cudaLaunchKernelEx(&cfg, ssm_bwd_reduce_kernel, gr, dBm, dCm, dA, dD,
                     B * T, E, N, B * nC);
  return (int)cudaGetLastError();
}

template <typename XT>
int dispatch_n(int N, const void* x, const float* dt, const float* Bm,
               const float* Cm, const float* A, const float* D,
               const float* hc, const float* dy, const float* dhT, Grads gr,
               float* dBm, float* dCm, float* dA, float* dD, int B, int T,
               int E, cudaStream_t s) {
  switch (N) {
    case 4:
      return launch<4, XT>(x, dt, Bm, Cm, A, D, hc, dy, dhT, gr, dBm, dCm,
                           dA, dD, B, T, E, s);
    case 8:
      return launch<8, XT>(x, dt, Bm, Cm, A, D, hc, dy, dhT, gr, dBm, dCm,
                           dA, dD, B, T, E, s);
    case 16:
      return launch<16, XT>(x, dt, Bm, Cm, A, D, hc, dy, dhT, gr, dBm, dCm,
                            dA, dD, B, T, E, s);
    default:
      return -1;
  }
}

}  // namespace

// Floats of scratch the backward needs for (B, T, E, N), or -1 for an N
// it does not take.
extern "C" long long repro_ssm_scan_bwd_scratch(int B, int T, int E, int N) {
  if (parts_for(E, N) < 0) return -1;
  size_t off[5];
  return (long long)layout(B, T, E, N, off);
}

// x (B, T, E) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); dt (B, T, E), Bm /
// Cm (B, T, N), A (E, N), D (E,), hc (B, ceil(T/kK), E, N) the forward's
// chunk checkpoints (repro_ssm_scan_chunks), dy (B, T, E),
// dhT (B, E, N) or null, all f32.  Out: dx (B, T, E) in x's dtype; ddt
// (B, T, E), dBm / dCm (B, T, N), dA (E, N), dD (E,), dh0 (B, E, N) f32.
// scratch: repro_ssm_scan_bwd_scratch(B, T, E, N) floats, 16-byte
// aligned.  N in {4, 8, 16}; T >= 1.  Up to four kernels on the stream,
// in order.  Returns cudaGetLastError(), or -1 for an N it does not take.
extern "C" int repro_ssm_scan_bwd(
    const void* x, const float* dt, const float* Bm, const float* Cm,
    const float* A, const float* D, const float* hc, const float* dy,
    const float* dhT, void* dx, float* ddt, float* dBm, float* dCm,
    float* dA, float* dD, float* dh0, float* scratch, int B, int T, int E,
    int N, int x_bf16, void* stream) {
  const int nparts = parts_for(E, N);
  if (nparts < 0) return -1;
  size_t off[5];
  layout(B, T, E, N, off);
  const Grads gr{dx,
                 ddt,
                 dh0,
                 scratch + off[0],
                 scratch + off[1],
                 scratch + off[2],
                 scratch + off[3],
                 scratch + off[4],
                 nparts};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? dispatch_n<__nv_bfloat16>(N, x, dt, Bm, Cm, A, D, hc, dy,
                                            dhT, gr, dBm, dCm, dA, dD, B, T,
                                            E, s)
                : dispatch_n<float>(N, x, dt, Bm, Cm, A, D, hc, dy, dhT, gr,
                                    dBm, dCm, dA, dD, B, T, E, s);
}
