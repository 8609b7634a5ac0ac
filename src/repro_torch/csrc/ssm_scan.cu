// Mamba-1 selective scan for Hopper (sm_90a), two entry points over one
// kernel body.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py::ssm_scan
// (body _kernel):
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
//   y_t = <h_t, C_t> + D * x_t                        (all in float32)
// x, dt (B, T, E); Bm, Cm (B, T, N); A (E, N); D (E,).
//
// - repro_ssm_scan: h0 (B, E, N) in; y (B, T, E), hT (B, E, N) and, when
//   asked for, hs (B, T, E, N) out (the post-step carry at every
//   position).  The carry and cache-less Mamba paths call it.
// - repro_ssm_scan_ring: the serving layer's checkpoint ring
//   h_ring (rows, Rg, E, N), addressed in place.  Lane b starts from
//   h_ring[row_b, p0_b % Rg], or from zeros where p0_b == 0 or row_b < 0
//   (a pad lane), and writes the post-step state of each of its trailing
//   min(T, Rg) steps to h_ring[row_b, (p0_b + t + 1) % Rg] (a span longer
//   than the ring laps it and leaves the last Rg checkpoints); a pad lane
//   reads and writes no ring memory.  Only y (B, T, E) is allocated: the
//   (B, T, E, N) hs tensor, its index_put into the ring and the h0
//   gather of the PyTorch glue this entry replaces do not exist.
//   In-place safety: each thread reads its own h0 entries (four states of
//   one channel of one ring row) before it writes any ring slot, and no
//   other thread writes those addresses, so a span with T >= Rg that
//   rewrites slot p0 % Rg is safe.  Precondition: no two live lanes share
//   a ring row (the engines give every lane its own row).
//
// What bounds it on the H100: bytes.  Per (b, t, e, n) the recurrence
// costs one exp and ~6 flops, while x, dt, y and above all the N states
// per (b, t, e) written back (hs, or the ring slots) cross device memory:
// at the falcon-mamba-7b verify call (B=8, T=8, E=8192, N=16, x bf16) the
// ring entry moves ~42.6 MB, 33.5 MB of it the checkpoint writes.
//
// Design.  The recurrence is sequential in T and independent per (b, e)
// channel.  A channel's N states are split over a group of N/4 lanes,
// four states each (N = 16: 4 lanes), so the falcon decode shape runs
// 4 x 65536 threads, and the <h, C> dot product is reduced inside the
// group with __shfl_xor_sync.  A warp's state store at one step is then
// one contiguous run (32 lanes x 16 bytes = 512 bytes of hs or of one
// ring slot).  A block covers 128 / (N/4) consecutive channels of one
// row (grid (ceil(E / channels), B)) and stages a chunk of kTc timesteps
// of x, dt, B and C in shared memory with coalesced loads, all issued
// before one barrier, so the recurrence reads no device memory but its A
// and h0 row at the start.  N is a template parameter over {4, 8, 16};
// expf (not __expf) keeps the plain version's rounding within 2e-5.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTc = 32;         // timesteps of x / dt / B / C per chunk
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_x(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load_x(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// where the initial state comes from and where the states go
enum Mode { kCarry = 0, kStates = 1, kRing = 2 };

struct Ring {
  float* h;            // (rows, Rg, E, N)
  const int* p0;       // start position of lane b at p0[b * p0_stride]
  int p0_stride;
  const int* rows;     // ring row of lane b, or null: lane b is row b
  int Rg;
};

template <int N, typename XT, int MODE>
__global__ void __launch_bounds__(kThreads) ssm_scan_kernel(
    const XT* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ A, const float* __restrict__ Dv,
    const float* __restrict__ h0, float* __restrict__ y,
    float* __restrict__ hT, float* __restrict__ hs, Ring ring, int T,
    int E) {
  constexpr int G = N / 4;              // lanes of one channel
  constexpr int C = kThreads / G;       // channels of one block
  __shared__ __align__(16) float sB[kTc * N];
  __shared__ __align__(16) float sC[kTc * N];
  __shared__ float sx[kTc * C];
  __shared__ float sdt[kTc * C];
  const int b = blockIdx.y;
  const int g = threadIdx.x % G;        // states 4g .. 4g+3
  const int c = threadIdx.x / G;
  const int e0 = blockIdx.x * C;
  const int e = e0 + c;
  const bool live = e < E;

  int row = b, slot = 0, first_write = 0;
  bool load = true, store = true;
  if (MODE == kRing) {
    const int p0 = ring.p0[(size_t)b * ring.p0_stride];
    if (ring.rows != nullptr) row = ring.rows[b];
    store = row >= 0;
    load = store && p0 != 0;
    slot = p0 % ring.Rg;
    first_write = T - min(T, ring.Rg);
  }
  const size_t ch = (size_t)e * N + 4 * g;     // (e, 4g) in an (E, N) slab
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), h = a;
  float d = 0.f;
  if (live) {
    a = *reinterpret_cast<const float4*>(A + ch);
    if (MODE != kRing)
      h = *reinterpret_cast<const float4*>(h0 + (size_t)b * E * N + ch);
    else if (load)
      h = *reinterpret_cast<const float4*>(
          ring.h + ((size_t)row * ring.Rg + slot) * E * N + ch);
    d = Dv[e];
  }

  const size_t bt0 = (size_t)b * T;           // (b, t) row index base
  for (int t0 = 0; t0 < T; t0 += kTc) {
    const int tc = min(kTc, T - t0);
    __syncthreads();   // the previous chunk's reads are done
    for (int i = threadIdx.x; i < tc * N; i += kThreads) {
      sB[i] = Bm[(bt0 + t0) * N + i];
      sC[i] = Cm[(bt0 + t0) * N + i];
    }
#pragma unroll 4
    for (int i = threadIdx.x; i < tc * C; i += kThreads) {
      const int j = i / C, ee = e0 + i - j * C;
      const size_t xe = (bt0 + t0 + j) * E + ee;
      sx[i] = ee < E ? load_x(x, xe) : 0.f;
      sdt[i] = ee < E ? dt[xe] : 0.f;
    }
    __syncthreads();
    // every lane runs every step (dead channels on zeros): the group
    // reduction below shuffles over the full warp
    for (int j = 0; j < tc; ++j) {
      const float xv = sx[j * C + c];
      const float dv = sdt[j * C + c];
      const float u = dv * xv;
      const float4 bj = *reinterpret_cast<const float4*>(sB + j * N + 4 * g);
      const float4 cj = *reinterpret_cast<const float4*>(sC + j * N + 4 * g);
      h.x = expf(dv * a.x) * h.x + u * bj.x;
      h.y = expf(dv * a.y) * h.y + u * bj.y;
      h.z = expf(dv * a.z) * h.z + u * bj.z;
      h.w = expf(dv * a.w) * h.w + u * bj.w;
      float acc = h.x * cj.x + h.y * cj.y + h.z * cj.z + h.w * cj.w;
#pragma unroll
      for (int off = 1; off < G; off <<= 1)
        acc += __shfl_xor_sync(kFull, acc, off);
      const int t = t0 + j;
      const size_t xe = (bt0 + t) * E + e;
      if (live && g == 0) y[xe] = acc + d * xv;
      if (MODE == kStates && live)
        *reinterpret_cast<float4*>(hs + xe * N + 4 * g) = h;
      if (MODE == kRing) {
        slot = slot + 1 == ring.Rg ? 0 : slot + 1;   // (p0 + t + 1) % Rg
        if (live && store && t >= first_write)
          *reinterpret_cast<float4*>(
              ring.h + ((size_t)row * ring.Rg + slot) * E * N + ch) = h;
      }
    }
  }
  if (MODE != kRing && live)
    *reinterpret_cast<float4*>(hT + (size_t)b * E * N + ch) = h;
}

template <int N, typename XT>
int launch(int mode, const void* x, const float* dt, const float* Bm,
           const float* Cm, const float* A, const float* D, const float* h0,
           float* y, float* hT, float* hs, Ring ring, int B, int T, int E,
           cudaStream_t s) {
  constexpr int C = kThreads / (N / 4);
  const dim3 grid((E + C - 1) / C, B);
  const XT* xp = static_cast<const XT*>(x);
  switch (mode) {
    case kCarry:
      ssm_scan_kernel<N, XT, kCarry><<<grid, kThreads, 0, s>>>(
          xp, dt, Bm, Cm, A, D, h0, y, hT, hs, ring, T, E);
      return 0;
    case kStates:
      ssm_scan_kernel<N, XT, kStates><<<grid, kThreads, 0, s>>>(
          xp, dt, Bm, Cm, A, D, h0, y, hT, hs, ring, T, E);
      return 0;
    default:
      ssm_scan_kernel<N, XT, kRing><<<grid, kThreads, 0, s>>>(
          xp, dt, Bm, Cm, A, D, h0, y, hT, hs, ring, T, E);
      return 0;
  }
}

template <typename XT>
int dispatch_n(int N, int mode, const void* x, const float* dt,
               const float* Bm, const float* Cm, const float* A,
               const float* D, const float* h0, float* y, float* hT,
               float* hs, Ring ring, int B, int T, int E, cudaStream_t s) {
  switch (N) {
    case 4:
      return launch<4, XT>(mode, x, dt, Bm, Cm, A, D, h0, y, hT, hs, ring,
                           B, T, E, s);
    case 8:
      return launch<8, XT>(mode, x, dt, Bm, Cm, A, D, h0, y, hT, hs, ring,
                           B, T, E, s);
    case 16:
      return launch<16, XT>(mode, x, dt, Bm, Cm, A, D, h0, y, hT, hs, ring,
                            B, T, E, s);
    default:
      return -1;
  }
}

int run(int N, int mode, int x_bf16, const void* x, const float* dt,
        const float* Bm, const float* Cm, const float* A, const float* D,
        const float* h0, float* y, float* hT, float* hs, Ring ring, int B,
        int T, int E, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      x_bf16 ? dispatch_n<__nv_bfloat16>(N, mode, x, dt, Bm, Cm, A, D, h0,
                                         y, hT, hs, ring, B, T, E, s)
             : dispatch_n<float>(N, mode, x, dt, Bm, Cm, A, D, h0, y, hT,
                                 hs, ring, B, T, E, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, T, E) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); dt (B, T, E), Bm / Cm
// (B, T, N), A (E, N), D (E,), h0 (B, E, N) f32; y (B, T, E), hT (B, E, N)
// and hs (B, T, E, N) or null, f32.  N in {4, 8, 16}; T >= 1.
// Returns cudaGetLastError(), or -1 for an N it does not take.
extern "C" int repro_ssm_scan(const void* x, const float* dt, const float* Bm,
                              const float* Cm, const float* A, const float* D,
                              const float* h0, float* y, float* hT, float* hs,
                              int B, int T, int E, int N, int x_bf16,
                              void* stream) {
  return run(N, hs != nullptr ? kStates : kCarry, x_bf16, x, dt, Bm, Cm, A,
             D, h0, y, hT, hs, Ring{nullptr, nullptr, 0, nullptr, 1}, B, T,
             E, stream);
}

// The ring entry: x, dt, Bm, Cm, A, D as above; h_ring (rows, Rg, E, N)
// f32, read and written in place; p0 start positions (>= 0) at
// p0[b * p0_stride], int32; rows (B,) int32 ring rows (< 0: a pad lane),
// or null for lane b = row b; y (B, T, E) f32 out.  Returns
// cudaGetLastError(), or -1 for an N it does not take.
extern "C" int repro_ssm_scan_ring(const void* x, const float* dt,
                                   const float* Bm, const float* Cm,
                                   const float* A, const float* D,
                                   float* h_ring, const int* p0,
                                   const int* rows, float* y, int p0_stride,
                                   int Rg, int B, int T, int E, int N,
                                   int x_bf16, void* stream) {
  return run(N, kRing, x_bf16, x, dt, Bm, Cm, A, D, nullptr, y, nullptr,
             nullptr, Ring{h_ring, p0, p0_stride, rows, Rg}, B, T, E,
             stream);
}
