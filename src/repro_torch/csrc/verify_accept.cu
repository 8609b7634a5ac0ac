// Fused speculative verification for Hopper (sm_90a), two entry points
// over one per-row body:
//
// - repro_verify_accept_batched replaces the Pallas TPU kernel
//   src/repro/kernels/verify_accept.py::verify_accept_batched (body
//   _batched_kernel): (B, R, V) f32 logits with ragged lens;
// - repro_verify_accept replaces the single-request Pallas TPU kernel
//   src/repro/kernels/verify_accept.py::verify_accept (body _kernel):
//   (R, V) logits, f32 or bf16 (read as f32), every row valid.
//
// For each (row b, draft position r < lens[b]):
// softmax of the target logits p and draft logits q over V; accept =
// u <= p[t] / max(q[t], 1e-30); p_tok = p[t], q_tok = q[t]; residual token
// = inverse CDF of norm(max(p - q, 0)) (p itself when that mass is
// <= 1e-12) with the cdf renormalised by its last entry: the count of
// entries with cdf <= w, clamped to V - 1.  Rows r >= lens[b] return
// zeros and read nothing.
//
// What bounds it on the H100: memory, then the latency of one row.  Each
// (b, r) needs its two f32 logit rows read once (2 * 4 * V bytes) for a
// handful of flops per element, but the verdict of a row depends on
// reductions over all of V (max, exp-sums, the residual mass, the cdf's
// prefix) that follow one another.  One block per row (the earlier
// design) walked V serially six times over L2: ~280 us at B=8, R=16,
// V=32000.  Split over a cluster, a row costs its load plus three rounds,
// each a pass over shared memory and a cluster barrier (~0.5 us each).
//
// Design: split V across a thread-block cluster.  One row is a cluster of
// n_split blocks (grid (n_split, rows), cluster (n_split, 1, 1)); block k
// owns the contiguous slice [k * slice, (k + 1) * slice) of V (slice a
// multiple of 4; trailing slices may be ragged or empty) and brings its
// slices of p and q into shared memory ONCE, with coalesced 16-byte
// cp.async copies where the rows are 16-byte aligned (4-byte copies
// otherwise; bf16 rows through registers).  Every later pass reads shared
// memory, four floats a load.  The cross-slice reductions go through
// distributed shared memory: each block publishes its partial in its own
// shared memory, one cluster barrier, and every warp of every block reads
// the n_split partials (lane z reads rank z) and reduces them with the
// same shuffle tree, so all blocks agree bit for bit.  Rounds, one
// barrier each:
//   1. (max, sum of exp(x - max)) of p and of q, each thread over its own
//      entries (whose exp(x - its max) it keeps in place), merged over
//      the block and then the cluster;
//   2. p = exp(x - max) / sum and r = max(p - q, 0) in place (the kept
//      exps rescaled: no second exp), summed per warp and per slice,
//      which give the residual mass z, the choice of r or p, each
//      slice's starting cdf value (an exclusive scan over ranks) and the
//      total (the cdf's last entry);
//   3. the count of cdf / total <= w (as cdf <= w * total): each warp
//      owns a contiguous run of its slice; a run whose end is <= w counts
//      whole, one whose start is > w counts nothing, and in the run that
//      holds the crossing each lane sums its own consecutive entries, a
//      __shfl_up_sync scan gives each lane its prefix, and each lane
//      counts its entries.  The counts add (atomically, through
//      distributed shared memory) into the block that owns token t.
// The bulk exps are exp2f of one FMA (x log2 e - max log2 e); p[t] and
// q[t], which decide the accept flag, take expf and a true division, as
// the softmax does.  After the third barrier the block that owns t
// writes the four outputs; no block reads another's shared memory after
// it.  A masked row (r >= lens[b]) exits as a whole cluster before any
// barrier.  n_split (at most 8, portable; 16 only where a slice would not
// fit in shared memory) is chosen by the wrapper from V and the row
// count; V up to 16 x 28672 is taken.

// REPRO_VERIFY_STOP (a -D flag; 0 by default) ends every row early for
// `chip_smoke.py --probe`: 1 after its load, 2 after round 1, 3 after
// round 2, each after one more cluster barrier (no block leaves while
// its shared memory may be read) and a store that keeps the round's
// results live.  REPRO_VERIFY_SYNCS adds that many cluster barriers
// after the load (what one costs).
#ifndef REPRO_VERIFY_STOP
#define REPRO_VERIFY_STOP 0
#endif
#ifndef REPRO_VERIFY_SYNCS
#define REPRO_VERIFY_SYNCS 0
#endif

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// What a block shares with its cluster (one slot per round, so no round's
// writes race an earlier round's remote reads) and its own scratch.
struct Shared {
  float ms[4];            // round 1: slice (max, exp-sum) of p, then of q
  float sum[2];           // round 2: slice sums of r and of p
  int cnt;                // round 3: the row's count (the owner's copy)
  float wsum[2][kWarps];  // per-warp sums of r and of p
  float red[4][kWarps];   // per-warp (max, exp-sum) of p and q
  float lt[2];            // the p and q logits at t where this slice holds t
};

constexpr float kLog2e = 1.4426950408889634f;

// Merge (m2, s2) into (m, s), s = sum exp(x - m): the larger max, each sum
// rescaled to it; an empty part (m = -inf) adds nothing, exactly.
// Commutative bit for bit, so a butterfly leaves its lanes one value.
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float M = fmaxf(m, m2);
  const float a = m == -INFINITY ? 0.f : s * exp2f((m - M) * kLog2e);
  const float b = m2 == -INFINITY ? 0.f : s2 * exp2f((m2 - M) * kLog2e);
  m = M;
  s = a + b;
}

// Butterfly merges over the first `width` lanes (the rest hold empty
// parts); every lane gets lane 0's result.
__device__ __forceinline__ void warp_merge(float& m, float& s, int width) {
  for (int off = 1; off < width; off <<= 1)
    merge(m, s, __shfl_xor_sync(kFull, m, off),
          __shfl_xor_sync(kFull, s, off));
  m = __shfl_sync(kFull, m, 0);
  s = __shfl_sync(kFull, s, 0);
}

__device__ __forceinline__ float warp_sum(float v, int width) {
  for (int off = 1; off < width; off <<= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return __shfl_sync(kFull, v, 0);
}

__device__ __forceinline__ float pick(float4 a, int j) {
  return j == 0 ? a.x : j == 1 ? a.y : j == 2 ? a.z : a.w;
}

__device__ __forceinline__ float max4(float4 a) {
  return fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w));
}

// exp(x - m) as exp2(x log2 e - mL), mL = m log2 e (one FMA and one ex2)
__device__ __forceinline__ float exp_sub(float x, float mL) {
  return exp2f(fmaf(x, kLog2e, -mL));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// n floats of src into shared dst (16-byte aligned), asynchronously.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += kThreads)
      cp_async16(dst + 4 * i, src + 4 * i);
    i0 = 4 * n4;
  }
  for (int i = i0 + threadIdx.x; i < n; i += kThreads)
    cp_async4(dst + i, src + i);
}
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src,
                                      int n) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    dst[i] = __bfloat162float(src[i]);
}

// The verdict of one draft position: p, q its target and draft logit rows
// (V,), t the drafted token, uv the accept uniform, wv the residual
// uniform; the four outputs go to index `at`.  Every thread of every
// block of the row's cluster calls it (it has cluster-wide barriers).
template <typename T>
__device__ void verify_row(const T* __restrict__ p, const T* __restrict__ q,
                           int t, float uv, float wv, int V, int slice,
                           int at, int* __restrict__ acc,
                           int* __restrict__ res, float* __restrict__ ptok,
                           float* __restrict__ qtok) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nsplit = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int v0 = min(V, rank * slice);
  const int n = min(V, v0 + slice) - v0;      // this slice's length
  const int n4 = (n + 3) >> 2;                // its float4s (last padded)
  float* sp = smem;                           // p: logits, then p
  float* sq = smem + slice;                   // q: logits, then r

  stage(sp, p + v0, n);
  stage(sq, q + v0, n);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (tid < 4 * n4 - n) {   // pad the last float4: -inf adds nothing
    sp[n + tid] = -INFINITY;
    sq[n + tid] = -INFINITY;
  }
  if (tid == 0) sh.cnt = 0;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  for (int i = 0; i < REPRO_VERIFY_SYNCS; ++i) cluster.sync();
#if REPRO_VERIFY_STOP == 1
  cluster.sync();
  return;
#endif

  // round 1: (max, sum of exp(x - max)) of p and q, each thread over its
  // own float4s first (lane-strided over its warp's contiguous run [lo,
  // hi) of the slice, a multiple of 32 long; the same float4s as in
  // round 2), then merged over the block and the cluster.  exp(x - the
  // thread's max) stays in place, so round 2 only rescales it; the raw
  // logits at t are kept for the verdict.
  const int run = ((slice + kWarps - 1) / kWarps + 31) & ~31;
  const int lo = min(n, warp * run), hi = min(n, lo + run);
  float4* wp4 = reinterpret_cast<float4*>(sp);
  float4* wq4 = reinterpret_cast<float4*>(sq);
  float pm = -INFINITY, qm = -INFINITY, ps = 0.f, qs = 0.f;
#pragma unroll 4
  for (int i = lo + 4 * lane; i < hi; i += 128) {
    pm = fmaxf(pm, max4(wp4[i >> 2]));
    qm = fmaxf(qm, max4(wq4[i >> 2]));
  }
  const float tpm = pm, tqm = qm;             // this thread's maxima
  {
    const float pmL = pm == -INFINITY ? 0.f : pm * kLog2e;
    const float qmL = qm == -INFINITY ? 0.f : qm * kLog2e;
#pragma unroll 4
    for (int i = lo + 4 * lane; i < hi; i += 128) {
      const float4 a = wp4[i >> 2], b = wq4[i >> 2];
      const int j = t - v0 - i;
      if (j >= 0 && j < 4) {
        sh.lt[0] = pick(a, j);
        sh.lt[1] = pick(b, j);
      }
      const float4 ea = make_float4(exp_sub(a.x, pmL), exp_sub(a.y, pmL),
                                    exp_sub(a.z, pmL), exp_sub(a.w, pmL));
      const float4 eb = make_float4(exp_sub(b.x, qmL), exp_sub(b.y, qmL),
                                    exp_sub(b.z, qmL), exp_sub(b.w, qmL));
      wp4[i >> 2] = ea;
      wq4[i >> 2] = eb;
      ps += (ea.x + ea.y) + (ea.z + ea.w);
      qs += (eb.x + eb.y) + (eb.z + eb.w);
    }
  }
  warp_merge(pm, ps, 32);
  warp_merge(qm, qs, 32);
  if (lane == 0) {
    sh.red[0][warp] = pm;
    sh.red[1][warp] = ps;
    sh.red[2][warp] = qm;
    sh.red[3][warp] = qs;
  }
  __syncthreads();
  if (warp == 0) {
    const bool in = lane < kWarps;
    pm = in ? sh.red[0][lane] : -INFINITY;
    ps = in ? sh.red[1][lane] : 0.f;
    qm = in ? sh.red[2][lane] : -INFINITY;
    qs = in ? sh.red[3][lane] : 0.f;
    warp_merge(pm, ps, kWarps);
    warp_merge(qm, qs, kWarps);
    if (lane == 0) {
      sh.ms[0] = pm;
      sh.ms[1] = ps;
      sh.ms[2] = qm;
      sh.ms[3] = qs;
    }
  }
  cluster.sync();
  {
    const Shared* o = lane < nsplit ? cluster.map_shared_rank(&sh, lane)
                                    : nullptr;
    pm = o ? o->ms[0] : -INFINITY;
    ps = o ? o->ms[1] : 0.f;
    qm = o ? o->ms[2] : -INFINITY;
    qs = o ? o->ms[3] : 0.f;
    warp_merge(pm, ps, nsplit);
    warp_merge(qm, qs, nsplit);
  }

#if REPRO_VERIFY_STOP == 2
  cluster.sync();
  if (tid == 0) ptok[at] = pm + ps + qm + qs;
  return;
#endif

  // round 2: p and r = max(p - q, 0) in place (the kept exps rescaled
  // from the thread's maxima to the row's), summed per warp
  {
    const float cp = tpm == -INFINITY
        ? 0.f : exp2f((tpm - pm) * kLog2e) * (1.f / ps);
    const float cq = tqm == -INFINITY
        ? 0.f : exp2f((tqm - qm) * kLog2e) * (1.f / qs);
    float rsum = 0.f, psum = 0.f;
#pragma unroll 4
    for (int i = lo + 4 * lane; i < hi; i += 128) {
      const float4 a = wp4[i >> 2], b = wq4[i >> 2];
      float4 pv, rv;
      pv.x = a.x * cp;
      pv.y = a.y * cp;
      pv.z = a.z * cp;
      pv.w = a.w * cp;
      rv.x = fmaxf(pv.x - b.x * cq, 0.f);
      rv.y = fmaxf(pv.y - b.y * cq, 0.f);
      rv.z = fmaxf(pv.z - b.z * cq, 0.f);
      rv.w = fmaxf(pv.w - b.w * cq, 0.f);
      wp4[i >> 2] = pv;
      wq4[i >> 2] = rv;
      psum += (pv.x + pv.y) + (pv.z + pv.w);
      rsum += (rv.x + rv.y) + (rv.z + rv.w);
    }
    rsum = warp_sum(rsum, 32);
    psum = warp_sum(psum, 32);
    if (lane == 0) {
      sh.wsum[0][warp] = rsum;
      sh.wsum[1][warp] = psum;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const bool in = lane < kWarps;
    const float a = warp_sum(in ? sh.wsum[0][lane] : 0.f, kWarps);
    const float b = warp_sum(in ? sh.wsum[1][lane] : 0.f, kWarps);
    if (lane == 0) {
      sh.sum[0] = a;
      sh.sum[1] = b;
    }
  }
  cluster.sync();
  // the residual mass, then the scanned kind's slice prefix and total
  float off, thr;
  bool residual;
  {
    const Shared* o = lane < nsplit ? cluster.map_shared_rank(&sh, lane)
                                    : nullptr;
    const float rz = o ? o->sum[0] : 0.f;
    residual = warp_sum(rz, nsplit) > 1e-12f;
    const float v = residual ? rz : (o ? o->sum[1] : 0.f);
    float incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float u = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += u;
    }
    off = __shfl_sync(kFull, incl - v, rank);
    // cdf / total <= w  as  cdf <= w * total
    thr = wv * fmaxf(__shfl_sync(kFull, incl, 31), 1e-30f);
  }
  const int k = residual ? 0 : 1;
  const float* s = residual ? sq : sp;
  for (int i = 0; i < warp; ++i) off += sh.wsum[k][i];

#if REPRO_VERIFY_STOP == 3
  cluster.sync();
  if (tid == 0) ptok[at] = off + thr + (float)k + s[0];
  return;
#endif

  // round 3: count cdf <= w * total over this warp's run; in the run
  // that holds the crossing each lane owns `per` consecutive entries
  int cnt = 0;
  if (off + sh.wsum[k][warp] <= thr) {
    cnt = lane == 0 ? hi - lo : 0;            // the whole run counts
  } else if (off <= thr) {
    const int per = run / 32;
    const int a = min(hi, lo + lane * per), e = min(hi, a + per);
    float part = 0.f;
#pragma unroll 4
    for (int i = a; i < e; ++i) part += s[i];
    float incl = part;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float u = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += u;
    }
    float c = off + incl - part;              // the cdf before entry a
    if (c <= thr) {
      for (int i = a; i < e; ++i) {
        c += s[i];
        if (c > thr) break;
        ++cnt;
      }
    }
  }
  // the counts add into the shared memory of the block that owns t; no
  // block reads another's shared memory after the barrier below, so
  // every block but the owner may leave right after it
  cnt = __reduce_add_sync(kFull, cnt);
  if (lane == 0 && cnt != 0)
    atomicAdd(cluster.map_shared_rank(
                  &sh.cnt, max(0, min(t / slice, nsplit - 1))), cnt);
  cluster.sync();
  if (tid == 0 && t >= v0 && t < v0 + n) {
    // p[t], q[t] as the softmax gives them: expf and a true division
    const float p_t = expf(sh.lt[0] - pm) / ps;
    const float q_t = expf(sh.lt[1] - qm) / qs;
    acc[at] = uv <= p_t / fmaxf(q_t, 1e-30f) ? 1 : 0;
    res[at] = min(sh.cnt, V - 1);
    ptok[at] = p_t;
    qtok[at] = q_t;
  }
}

__global__ void __launch_bounds__(kThreads) verify_accept_batched_kernel(
    const float* __restrict__ p_logits, const float* __restrict__ q_logits,
    const int* __restrict__ tokens, const int* __restrict__ lens,
    const float* __restrict__ u, const float* __restrict__ w,
    int* __restrict__ acc, int* __restrict__ res, float* __restrict__ ptok,
    float* __restrict__ qtok, int R, int V, int slice) {
  const int br = blockIdx.y;
  const int b = br / R, r = br - b * R;
  if (r >= lens[b]) {  // uniform over the cluster: no barrier is skipped
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      acc[br] = 0;
      res[br] = 0;
      ptok[br] = 0.f;
      qtok[br] = 0.f;
    }
    return;
  }
  verify_row(p_logits + (size_t)br * V, q_logits + (size_t)br * V,
             tokens[br], u[br], w[br], V, slice, br, acc, res, ptok, qtok);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) verify_accept_kernel(
    const T* __restrict__ p_logits, const T* __restrict__ q_logits,
    const int* __restrict__ tokens, const float* __restrict__ u,
    const float* __restrict__ w, int* __restrict__ acc,
    int* __restrict__ res, float* __restrict__ ptok,
    float* __restrict__ qtok, int V, int slice) {
  const int r = blockIdx.y;
  verify_row(p_logits + (size_t)r * V, q_logits + (size_t)r * V, tokens[r],
             u[r], w[r], V, slice, r, acc, res, ptok, qtok);
}

// One launch of `kern` over rows clusters of nsplit blocks, each with two
// slices of floats of dynamic shared memory.
template <typename... Params, typename... Args>
int launch(void (*kern)(Params...), int nsplit, int rows, int V,
           cudaStream_t stream, Args... args) {
  const int slice = (((V + nsplit - 1) / nsplit) + 3) & ~3;
  const size_t smem = 2 * (size_t)slice * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (nsplit > 8) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, rows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = nsplit;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, args..., slice);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// p_logits, q_logits (B,R,V) f32; tokens (B,R) i32; lens (B,) i32;
// u, w (B,R) f32; outputs acc, res (B,R) i32 and ptok, qtok (B,R) f32.
// nsplit in 1..16 blocks per row.  Returns cudaGetLastError().
extern "C" int repro_verify_accept_batched(
    const float* p_logits, const float* q_logits, const int* tokens,
    const int* lens, const float* u, const float* w, int* acc, int* res,
    float* ptok, float* qtok, int B, int R, int V, int nsplit,
    void* stream) {
  return launch(verify_accept_batched_kernel, nsplit, B * R, V,
                static_cast<cudaStream_t>(stream), p_logits, q_logits,
                tokens, lens, u, w, acc, res, ptok, qtok, R, V);
}

// p_logits, q_logits (R,V), f32 or bf16 (is_bf16); tokens (R,) i32; u, w
// (R,) f32; outputs acc, res (R,) i32 and ptok, qtok (R,) f32.  nsplit in
// 1..16 blocks per row.  Returns cudaGetLastError().
extern "C" int repro_verify_accept(const void* p_logits, const void* q_logits,
                                   const int* tokens, const float* u,
                                   const float* w, int* acc, int* res,
                                   float* ptok, float* qtok, int R, int V,
                                   int is_bf16, int nsplit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch(verify_accept_kernel<__nv_bfloat16>, nsplit, R, V, s,
                  static_cast<const __nv_bfloat16*>(p_logits),
                  static_cast<const __nv_bfloat16*>(q_logits), tokens, u, w,
                  acc, res, ptok, qtok, V);
  return launch(verify_accept_kernel<float>, nsplit, R, V, s,
                static_cast<const float*>(p_logits),
                static_cast<const float*>(q_logits), tokens, u, w, acc, res,
                ptok, qtok, V);
}
