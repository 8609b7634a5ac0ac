// The Mamba-1 selective scan's single step, shared by the forward kernel
// (ssm_scan.cu) and the backward kernel (ssm_scan_bwd.cu), so that the
// states the backward recomputes from its chunk checkpoints come from the
// forward's own arithmetic (one expression, compiled with the same flags
// in both files):
//   a_t = exp(dt_t * A),  h_t = a_t * h_{t-1} + (dt_t * x_t) * B_t
// for the four states of one lane.  expf (not __expf) keeps the plain
// version's rounding.  (Spelling the FMA out with __fmaf_rn / __fmul_rn
// made the forward's step loop 6-18% slower on the H100.)
// It also fixes the chunk length K of the chunk checkpoints: the forward's
// chunk mode writes the state entering each chunk of kScanChunk steps and
// the backward recomputes each chunk from it, so both read K from here.
// -DREPRO_SCAN_CHUNK (16, 32 or 64) builds another K (chip_smoke.py
// --scan-bwd's probe); 16 by measurement (ssm_scan_bwd.cu's note).
#pragma once

#include <cuda_runtime.h>

#ifndef REPRO_SCAN_CHUNK
#define REPRO_SCAN_CHUNK 16
#endif

constexpr int kScanChunk = REPRO_SCAN_CHUNK;   // steps of a chunk
static_assert(kScanChunk == 16 || kScanChunk == 32 || kScanChunk == 64,
              "chunk must be 16, 32 or 64");

static __device__ __forceinline__ void ssm_step(float4& h, float4 a,
                                                float dv, float xv,
                                                float4 b) {
  const float u = dv * xv;
  h.x = expf(dv * a.x) * h.x + u * b.x;
  h.y = expf(dv * a.y) * h.y + u * b.y;
  h.z = expf(dv * a.z) * h.z + u * b.z;
  h.w = expf(dv * a.w) * h.w + u * b.w;
}
