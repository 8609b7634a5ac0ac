#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero):
  1. build   — compile the CUDA kernels of src/repro_torch/csrc with nvcc
               (one process per source, in parallel); print the build time
               and the card's name and power limit.
  2. kernels — each kernel against its plain PyTorch version on the card at
               the shapes the main path gives it (full-width LLaMA-68M/7B
               and the tiny committed pair), with the tolerance stated per
               check; median device times (CUDA events) beside the least
               time the card could take (bound), a library call where
               one exists, the split count of the decode kernels (paged,
               branch) and the timing floor (a one-element add and a
               10 MB copy under the same timer); besides the main path's
               shapes, page tables as wide as a serve's, a long row at
               B = 1 and a 2048-key shared prefix, and the parallel-draft
               frames of phase 13 (flash with q_ctx clamped below q_pos on
               the slot columns and slot keys at -1; paged with lens =
               q_start + real tokens < q_start + T).  The shared-prefix
               branch decode and the single-request verify lie on no
               engine path, in either package: their path is the kernel
               API (``kernels.ops``, as the reference's
               benchmarks/kernels_bench.py drives it), driven here once
               per checked shape with the counters zeroed before and read
               after.  The scan's ring entry is held against its plain
               version on a whole checkpoint ring (untouched slots bit for
               bit) at the falcon-mamba-7b serve's shape and on a lapping
               prefill, beside the PyTorch path it replaced (gather, scan
               with states, index_put); the plain scan's carry mode (the
               one the sequential engines launch) at their shapes; each
               verify case logs its blocks per row.
  3. tiny    — the committed Zipf-Markov pair (f32) served through
               ContinuousBatchScheduler: greedy streams must equal the
               port's own target-only greedy decode; temperature 1 (with
               the default confidence threshold, then with none, so that
               drafted chains reach the verify kernel) must launch the
               verify kernel, every verdict it gives must equal the plain
               route's on the same inputs (VerifyShadow), and its streams
               are compared with the same serve on the CPU; a small pool
               must preempt and read the swap back through the gather
               kernel.
  4. full    — the paper's LLaMA-68M / LLaMA-7B pair at full width, bf16,
               random weights from fixed seeds: 8 requests x 32 new tokens
               at temperature 0 and at temperature 1 as in phase 3.  Every
               greedy token must be the argmax, within TF_MARGIN, of a
               cache-less target forward over its own request's served
               stream (teacher forcing); the temperature-1 verdicts are
               shadowed as in phase 3.  Then one profiled serve (8 new
               tokens) for the card's busy share and device time by
               kernel.
  5. seq tiny — the sequential engines (dense ring cache, flash kernel) on
               the committed pair: every engine's greedy stream must equal
               the port's own AR greedy decode; SpS and SpecBranch at
               temperature 1 are compared with the same serve on the CPU
               (printed); the flash kernel must have run.
  6. seq full — the full-width pair through the sequential engines: AR,
               SpS and SpecBranch greedy (2 requests x 32 new tokens,
               teacher-forced as in phase 4) and SpecBranch at
               temperature 1 with epsilon 0; wall tokens/s and rounds per
               engine; one profiled SpecBranch serve for the busy share.
  7. hybrid tiny — the falcon-shaped (Mamba) and jamba-shaped (Mamba +
               attention + MoE) random-init pairs, f32: batched greedy
               streams must equal the port's own target-only greedy
               decode; temperature 1 (epsilon 0.3, then 0) is shadowed as
               in phase 3 and compared with the same serve on the CPU; a
               jamba-shaped serve with a small pool must preempt, swap its
               attention half through the gather kernel, restore its ring
               snapshots and give the same streams as without preemption;
               sequential SpecBranch and SpS greedy must equal AR greedy.
               The selective-scan kernel must have run.
  8. falcon  — falcon-mamba-7b (64 Mamba layers, d_model 4096) with its
               draft() at full width, bf16, random weights from fixed
               seeds: batched SpecBranch, 8 requests x 32 new tokens,
               greedy (teacher-forced as in phase 4) and temperature 1
               with epsilon 0; wall tokens/s, rounds, mean accepted length
               and launches; the ring scans' shapes (the serve must run
               phase 2's ring case shape); device memory of the weights
               and rings; one profiled serve for the busy share and
               device time by kernel, and one for the scan kernels'
               device time beside the PyTorch kernels on the h rings.
  9. H-RAD and SpS tiny — the committed pair with an H-RAD MLP from the
               port's init_mlp (generator seed HRAD_SEED): batched SpS,
               batched SpecBranch with H-RAD (also under a preempting
               200-page pool of page size 4) and sequential SpecBranch
               with H-RAD; greedy streams must equal the target's greedy
               decode; temperature 1 is shadowed as in phase 3 and
               compared with the same serve on the CPU (printed); the
               H-RAD signal histogram must hold all three classes.
 10. H-RAD and SpS full — the LLaMA-68M/7B pair again: batched SpS 8 x 32
               greedy and temperature 1, batched SpecBranch with H-RAD
               8 x 32 greedy, sequential SpecBranch with H-RAD 2 x 32
               greedy, each greedy serve teacher-forced as in phase 4;
               wall tokens/s, rounds, mean accepted length, signal
               histogram, peak memory and a profiled serve's busy share,
               beside the same serves without H-RAD from phases 4 and 6.
 11. dense   — the dense attention backend (N-row ring caches, the flash
               kernel on every attention call, branch forks as row
               copies): batched SpecBranch and SpS on the tiny committed
               pair, greedy, temperature 1 (epsilon 0.3 and 0, shadowed
               as in phase 3) and under a preempting pool that swaps; each
               drive's streams must equal the same serve on the CPU and
               the card's own paged serve; the jamba-shaped hybrid, whose
               preempted rows recompute their prefix; the full-width
               LLaMA-68M/7B batched SpecBranch 8 x 32 greedy,
               teacher-forced as in phase 4, what a fork's row copy costs,
               and a profiled serve's flash launches and device time
               beside phase 4's paged figures.
 12. trace   — the full-width 7B batched SpecBranch greedy serve (paged)
               untraced, then with a TraceRecorder and the loop's profiler
               ranges inside obs.profiler_session: host fetches, transfer
               bytes and streams must be equal; a table of each round's
               and each span lane's host wall time against the device-busy
               time inside it (the host's share of a round).  It runs in a
               fresh process (``--trace-modes``), whose one profiler
               session also traces the same serve in parallel draft mode
               for phase 13.
 13. parallel — single-pass parallel drafting and the history predictor.
               Tiny committed pair with draft heads from init_draft_heads
               (generator seed SV.HEADS_SEED): batched SpS and SpecBranch
               in parallel draft mode on paged and dense, greedy and at
               temperature 1 (epsilon 0.3 and 0, shadowed as in phase 3),
               one preempting pool that swaps, sequential SpS and
               SpecBranch, and the predictor on (batched, both draft
               modes, and sequential); every drive's streams must equal
               the same serve on the CPU, every greedy stream the
               target's greedy decode, and batched SpS must take exactly
               2 dispatches a round.  Full width (LLaMA-68M/7B, bf16,
               random weights and heads, 8 x 32, paged): batched
               SpecBranch and SpS in parallel draft mode beside the same
               serves in sequential draft mode (wall tokens/s,
               dispatches per round, rounds, greedy teacher-forced as in
               phase 4), profiled serves' device time by kernel, the
               draft frames' attention launches and draft_chunk's device
               time; phase 12's host-share table for the parallel-mode
               SpecBranch serve beside the sequential-mode one; batched
               SpecBranch with the predictor on: its decided-gamma
               histogram and rollback tokens per request beside off.
Each main-path drive zeroes the kernel launch counters right before it
and reads them right after; launches made to compare a kernel with its
plain version are not counted.  The second-to-last lines are the kernel
table as one JSON object and the card's name and power limit; the last
line is the device JSON.

Exits non-zero without a result when no CUDA device is visible.

Modes that give no smoke result (exit 3): ``--kernels`` stops after
phase 2; ``--probe`` times the attention tile loops phase by phase from
variants built with -DREPRO_ATTN_STOP (1: K/V loads only, 2: loads and
logits, 0: whole kernel) beside the timing floor, and the batched
verify's rounds (-DREPRO_VERIFY_STOP) and cluster barrier cost;
``--scan`` times phase 2's plain-scan cases (states and carry modes)
alone; ``--profile`` runs phases 4 and 6's profiled serves, the batched LLaMA
serve at temperature 1 (verify device time) and phase 8's falcon serve
(scan and h-ring device time) only, and with ``--src DIR`` imports the
port from DIR (another checkout's src) to compare two commits in one
run.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# ``--src DIR`` imports the port from another checkout's src (a parent
# commit unpacked beside this one) for ``--profile`` or ``--scan``;
# default: this one's
SRC = (sys.argv[sys.argv.index("--src") + 1] if "--src" in sys.argv
       else os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.abspath(SRC))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.core import hrad as H  # noqa: E402
from repro_torch.kernels import branch_attention as BA  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
try:                        # absent from checkouts before the decode loop
    from repro_torch.kernels import decode_attention as DA  # noqa: E402
except ImportError:
    DA = None
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import paged as PG  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import ssm_scan as SS  # noqa: E402
from repro_torch.kernels import verify_accept as VA  # noqa: E402
from repro_torch.launch import serve as SV  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.runtime import engines as TE  # noqa: E402
from repro_torch.runtime import runner as RN  # noqa: E402
from repro_torch.runtime.engines import EngineConfig  # noqa: E402
from repro_torch.serving import device_loop as DL  # noqa: E402

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
# Largest gap (in logits) allowed between a served greedy token's logit and
# the top logit of the cache-less teacher-forced target forward, bf16.  The
# random 7B's logits are ~N(0, 1) over 32000 ids (top ~4.2, bf16 spacing
# 1/32 there), and two bf16 forwards that differ only in shapes and
# reduction order disagree by ~0.1 on an H100 (printed as the noise
# yardstick); a token served from a wrong context sits ~1-4 below the top.
TF_MARGIN = 0.25
# A uniform within this distance of a boundary (an accept ratio or a cdf
# entry) may go either way between two float summation orders.
BOUNDARY_EPS = 1e-6
EPS = EngineConfig.epsilon      # the engines' default confidence threshold
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # CUDA f32 / bf16

KERNELS = {
    "paged_attention": dict(
        route="cuda", source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:161"),
    "verify_accept_batched": dict(
        route="cuda", source="src/repro_torch/csrc/verify_accept.cu",
        replaces="src/repro/kernels/verify_accept.py:144"),
    "paged_gather": dict(
        route="cuda", source="src/repro_torch/csrc/paged_gather.cu",
        replaces="src/repro/kernels/paged.py:42"),
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:102"),
    "ssm_scan": dict(
        route="cuda", source="src/repro_torch/csrc/ssm_scan.cu",
        replaces="src/repro/kernels/ssm_scan.py:80"),
    # the same TPU kernel with the serving layer's checkpoint-ring gather
    # and scatter around it, addressed in place (second entry point)
    "ssm_scan_ring": dict(
        route="cuda", source="src/repro_torch/csrc/ssm_scan.cu",
        replaces="src/repro/kernels/ssm_scan.py:80"),
    "branch_decode_attention": dict(
        route="cuda", source="src/repro_torch/csrc/branch_attention.cu",
        replaces="src/repro/kernels/ops.py:38"),
    "verify_accept": dict(
        route="cuda", source="src/repro_torch/csrc/verify_accept.cu",
        replaces="src/repro/kernels/verify_accept.py:74"),
}
# the H-RAD MLP of phases 9-10: the port's init_mlp under this generator
# seed (untrained; on the tiny pair it gives all three signal classes)
HRAD_SEED = 0
# the selective scan against its plain version: the tolerance the
# reference's own tests hold its Pallas kernel to (both sides f32; only
# exp's rounding and the FMA contraction differ)
SSM_RTOL = SSM_ATOL = 2e-5
# the falcon-mamba-7b serve's checkpoint ring depth (gamma 4, the
# engines' default branch gamma, phase 8's config), and its phase-2 case
FALCON_RING = 92
FALCON_RING_CASE = "falcon-7b serve B=8 T=16 Rg=92"
# the swap readback at the LLaMA-7B target's full width (swap_dim 262144
# f32 per token: K and V of 32 layers x 32 heads x 128), 60 rows of 4 pages
GATHER_FULL_CASE = "llama-7b swap 4x16 dim=262144 60 rows"


def log(*a) -> None:
    print(*a, flush=True)


T0 = time.time()


def log_phase(msg: str) -> None:
    """A phase's header line, with the seconds since the script started."""
    log(f"{msg} (t={time.time() - T0:.0f}s)")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


_FLUSH = None


def time_ms(fn, iters: int = 21, warmup: int = 3,
            flush: str = "dirty") -> float:
    """Median device time of one call, from CUDA events recorded right
    before and after it.  A spin kernel holds the card while the host
    enqueues every call, so the calls then run back to back and the events
    time device work, not host launch overhead.  The 50 MB L2 is flushed
    (a bitwise_not pass over 64 MB, outside the events) before every call,
    as the main path finds its inputs cold; that pass leaves L2 full of
    dirty lines.  ``flush="clean"`` flushes with a read-only pass (a max
    over the 64 MB) instead and ``"none"`` not at all (``--probe`` reads
    the harness's own share from the three)."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(16 << 20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(100_000_000)          # ~50 ms of device spin
    for a, b in ev:
        if flush == "dirty":
            _FLUSH.bitwise_not_()
        elif flush == "clean":
            _FLUSH.max()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def check_close(name, got, want) -> tuple:
    """Hold an attention kernel's output against its plain version; returns
    (max abs error, its largest share of the elementwise bound).  f32:
    1e-4 absolute.  bf16: min(2e-2, 1.6e-2 * |want| + 1e-3 * rms(want))
    per element -- two bf16 spacings of the value (both sides round an f32
    result that differs only in summation order), never above 2e-2."""
    err = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        lim = torch.full_like(err, 1e-4)
    else:
        w = want.float()
        rms = w.pow(2).mean().sqrt()
        lim = (1.6e-2 * w.abs() + 1e-3 * rms).clamp_max(2e-2)
    share = (err / lim).max().item()
    if not math.isfinite(share) or share > 1.0:
        raise AssertionError(f"{name}: max err {err.max().item():.3e} is "
                             f"{share:.2f}x its bound")
    return err.max().item(), share


def bound(nbytes: float, ops_: float, dtype) -> tuple:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops_ / PEAK_OPS[dtype] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def attn_case(rng, B, T, H, KV, hd, ps, dtype, n_idle=0, max_len=112,
              min_len=17, n_max=None, nreal=None):
    """Fragmented page tables over random ragged rows; ``n_idle`` rows are
    unbound (lens 0), as most draft rows are on the main path.  ``n_max``
    widens the tables (trash-padded) to a serve's width, which covers its
    longest request, not the rows at hand.  ``nreal`` (B,) makes a
    parallel-draft frame: row b's queries start at lens - nreal[b], so
    its last T - nreal[b] queries (the draft slots) lie at or past
    lens."""
    lens = [int(rng.integers(max(T, min_len), max_len + 1))
            for _ in range(B)]
    for b in range(B - n_idle, B):
        lens[b] = 0
    n_pages = [-(-ln // ps) for ln in lens]
    P = sum(n_pages)
    n_max = max(max(n_pages), 1, n_max or 0)
    table = np.full((B, n_max), P, np.int32)
    perm = rng.permutation(P)
    off = 0
    for b, n in enumerate(n_pages):
        table[b, :n] = perm[off:off + n]
        off += n
    dev = "cuda"
    kp = torch.from_numpy(rng.standard_normal((P + 1, ps, KV, hd),
                                              np.float32)).to(dev, dtype)
    vp = torch.from_numpy(rng.standard_normal((P + 1, ps, KV, hd),
                                              np.float32)).to(dev, dtype)
    q = torch.from_numpy(rng.standard_normal((B, T, H, hd),
                                             np.float32)).to(dev, dtype)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    back = T if nreal is None else torch.tensor(nreal, dtype=torch.int32,
                                                device=dev)
    qs = torch.clamp(lens_t - back, min=0).to(torch.int32)
    return q, kp, vp, torch.from_numpy(table).to(dev), lens_t, qs


def check_attention(rng, label, B, T, H, KV, hd, ps, dtype, n_idle=0,
                    window=0, **lens_kw):
    """The paged kernel against its plain version on ``attn_case``'s
    tables (its keyword arguments in ``lens_kw``)."""
    q, kp, vp, table, lens, qs = attn_case(rng, B, T, H, KV, hd, ps, dtype,
                                           n_idle, **lens_kw)
    kw = dict(window=window)
    out = PA.paged_attention(q, kp, vp, table, lens, qs, **kw)
    want = ref.paged_attention_ref(q, kp, vp, table, lens, qs, **kw)
    torch.cuda.synchronize()
    err, share = check_close(f"paged_attention {label}", out, want)
    es = kp.element_size()
    ps_ = kp.shape[1]
    S = table.shape[1] * ps_
    kpos = torch.arange(S, device="cuda")
    qpos = qs.long()[:, None] + torch.arange(T, device="cuda")[None]
    vis = ((kpos[None, None] < lens.long()[:, None, None])
           & (kpos[None, None] <= qpos[:, :, None]))
    if window > 0 or "nreal" in lens_kw:
        # the work a window or a frame leaves: the keys some query sees,
        # read once, and the products the queries compute
        if window > 0:
            vis &= (qpos[:, :, None] - kpos[None, None]) < window
        nbytes = (2 * int(vis.any(1).sum()) * KV * hd * es
                  + 2 * q.numel() * es + (table.numel() + 2 * B) * 4)
        flops = 4 * H * hd * int(vis.sum())
    else:
        pages = int(sum(-(-int(n) // ps_) for n in lens.tolist()))
        nbytes = (2 * pages * ps_ * KV * hd * es + 2 * q.numel() * es
                  + (table.numel() + 2 * B) * 4)
        keys = sum(int(n) for n in lens.tolist())
        flops = 4 * T * H * hd * keys
    bms, by = bound(nbytes, flops, dtype)
    ms = time_ms(lambda: PA.paged_attention(q, kp, vp, table, lens, qs,
                                            **kw))
    plain = time_ms(lambda: ref.paged_attention_ref(q, kp, vp, table, lens,
                                                    qs, **kw))
    # library yardstick: SDPA over the pre-gathered dense KV (timed only)
    kd = kp[table.long()].reshape(B, S, KV, hd).transpose(1, 2)
    vd = vp[table.long()].reshape(B, S, KV, hd).transpose(1, 2)
    kd = kd.repeat_interleave(H // KV, dim=1).contiguous()
    vd = vd.repeat_interleave(H // KV, dim=1).contiguous()
    mask = vis[:, None]
    qd = q.transpose(1, 2).contiguous()
    lib = time_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                         attn_mask=mask))
    splits = PA.split_plan(B, T, H, KV, table.shape[1], ps_,
                           DA.sm_count(q.device))[0]
    return dict(case=label, max_abs_err=err, err_share=share, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                splits=splits)


def cdf_distance(p_lg, q_lg, tok_a, tok_b, w) -> float:
    """Distance, in f64, from the residual uniform w to the nearest cdf
    entry between two residual tokens of one draft position (p_lg, q_lg
    its (V,) logits): where it is below BOUNDARY_EPS the two draws differ
    only by float summation order."""
    p = torch.softmax(p_lg.double(), -1)
    qq = torch.softmax(q_lg.double(), -1)
    rr = (p - qq).clamp_min(0)
    rr = rr / rr.sum() if rr.sum() > 1e-12 else p
    cdf = torch.cumsum(rr, 0)
    cdf = (cdf / cdf[-1]).cpu()
    lo, hi = sorted((int(tok_a), int(tok_b)))
    return float((cdf[max(lo - 1, 0):hi] - float(w)).abs().min())


def check_verify(rng, label, B, R, V, lens_to=None):
    """The batched verify against its plain version; ``lens_to`` replaces
    the drawn lens after the draw (so later draws stay as they were)."""
    dev = "cuda"
    pl = torch.from_numpy(3 * rng.standard_normal((B, R, V), np.float32)
                          ).to(dev)
    ql = torch.from_numpy(3 * rng.standard_normal((B, R, V), np.float32)
                          ).to(dev)
    tok = torch.from_numpy(rng.integers(0, V, (B, R)).astype(np.int32)
                           ).to(dev)
    lens = torch.from_numpy(rng.integers(0, R + 1, B).astype(np.int32)
                            ).to(dev)
    u = torch.from_numpy(rng.random((B, R), np.float32)).to(dev)
    w = torch.from_numpy(rng.random((B, R), np.float32)).to(dev)
    if lens_to is not None:
        lens = torch.full((B,), lens_to, dtype=torch.int32, device=dev)
    got = VA.verify_accept_batched(pl, ql, tok, lens, u, w)
    want = ref.verify_accept_batched_ref(pl, ql, tok, lens, u, w)
    torch.cuda.synchronize()
    acc, res, pt, qt = (x.cpu() for x in got)
    acc_w, res_w, pt_w, qt_w = (x.cpu() for x in want)
    if not torch.equal(acc, acc_w):
        raise AssertionError(f"verify {label}: accept flags differ")
    for name, a, b in (("p_tok", pt, pt_w), ("q_tok", qt, qt_w)):
        if not torch.allclose(a, b, rtol=1e-5, atol=0.0):
            raise AssertionError(f"verify {label}: {name} differs beyond "
                                 "rtol 1e-5")
    # residual tokens may differ only where w lies within 1e-6 of a cdf
    # boundary of the plain version
    boundary = 0
    for b, r in zip(*torch.nonzero(res != res_w, as_tuple=True)):
        b, r = int(b), int(r)
        if cdf_distance(pl[b, r], ql[b, r], res[b, r], res_w[b, r],
                        w[b, r]) > BOUNDARY_EPS:
            raise AssertionError(f"verify {label}: residual token differs "
                                 f"at ({b},{r}) away from a cdf boundary")
        boundary += 1
    valid = int(lens.sum())
    nbytes = 2 * valid * V * 4 + B * R * (4 * 4 + 4 * 4) + B * 4
    bms, by = bound(nbytes, 8 * valid * V, torch.float32)
    ms = time_ms(lambda: VA.verify_accept_batched(pl, ql, tok, lens, u, w))
    plain = time_ms(lambda: ref.verify_accept_batched_ref(pl, ql, tok, lens,
                                                          u, w))
    err = max((pt - pt_w).abs().max().item(), (qt - qt_w).abs().max().item())
    n = VA.split_plan(V, B * R, DA.sm_count(pl.device))
    return dict(case=label, max_abs_err=err, boundary_cases=boundary,
                ms=ms, plain_ms=plain, library_ms=None, bound_ms=bms,
                bound_by=by, splits=n, live_rows=valid)


def check_gather(rng, label, P, ps, dim, n, valid):
    pages = torch.from_numpy(rng.standard_normal((P, ps, dim), np.float32)
                             ).cuda()
    table = torch.from_numpy(rng.permutation(P)[:n].astype(np.int32)).cuda()
    out = PG.paged_gather(pages, table, valid)
    want = ref.paged_gather_ref(pages, table, valid)
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise AssertionError(f"paged_gather {label}: not bitwise equal")
    nbytes = valid * dim * 4 + n * ps * dim * 4 + n * 4
    bms, by = bound(nbytes, 0, torch.float32)
    ms = time_ms(lambda: PG.paged_gather(pages, table, valid))
    plain = time_ms(lambda: ref.paged_gather_ref(pages, table, valid))
    # yardstick: index_select moves the same pages (without the tail zeros)
    lib = time_ms(lambda: torch.index_select(pages, 0, table))
    return dict(case=label, max_abs_err=0.0, ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=bms, bound_by=by)


def flash_case(rng, B, T, S, H, KV, hd, L, dtype, stale=0):
    """A dense ring of S slots after L tokens, as the runner leaves it:
    slot s holds the newest position p < L with p % S == s (the ring
    wraps when L > S) or -1; ``stale`` slots hold positions past L (a
    rollback's leftovers).  The T queries sit at L - T .. L - 1."""
    kpos = np.full((B, S), -1, np.int32)
    for b in range(B):
        for p in range(max(0, L - S), L):
            kpos[b, p % S] = p
        own = {p % S for p in range(L - T, L)}
        free = [s for s in range(S) if s not in own]
        kpos[b, rng.permutation(np.asarray(free, np.int64))[:stale]] = L + 2
    qpos = np.ascontiguousarray(np.broadcast_to(
        np.arange(L - T, L, dtype=np.int32), (B, T)))
    dev = "cuda"
    return [torch.from_numpy(rng.standard_normal(shape, np.float32)
                             ).to(dev, dtype)
            for shape in ((B, T, H, hd), (B, S, KV, hd), (B, S, KV, hd))] + [
        torch.from_numpy(qpos).to(dev), torch.from_numpy(kpos).to(dev)]


def check_flash(rng, label, B, T, S, H, KV, hd, L, dtype, stale=0,
                window=0, cap=None, causal=True):
    q, k, v, qp, kp = flash_case(rng, B, T, S, H, KV, hd, L, dtype, stale)
    kw = dict(window=window, cap=cap, causal=causal)
    out = FA.flash_attention(q, k, v, qp, kp, **kw)
    want = ref.flash_attention_ref(q, k, v, qp, kp, **kw)
    torch.cuda.synchronize()
    err, share = check_close(f"flash_attention {label}", out, want)
    # the work these positions need: per query the keys it sees; per
    # (row, kv head) the K/V of keys some query of the row sees
    kpl, qpl = kp.long()[:, None, :], qp.long()[:, :, None]
    vis = (kpl >= 0) & ((kpl <= qpl) if causal else True)
    if window > 0:
        vis &= (qpl - kpl) < window
    G = H // KV
    es = q.element_size()
    keys_row = int(vis.any(1).sum())
    nbytes = (2 * keys_row * KV * hd * es + 2 * q.numel() * es
              + (kp.numel() + qp.numel()) * 4)
    flops = 4 * hd * int(vis.sum()) * KV * G
    bms, by = bound(nbytes, flops, dtype)
    ms = time_ms(lambda: FA.flash_attention(q, k, v, qp, kp, **kw))
    plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, qp, kp, **kw))
    lib = None
    if cap is None:
        # library yardstick: SDPA with a boolean mask over the same dense
        # KV, heads expanded for the group (timed only)
        kd = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        vd = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        qd = q.transpose(1, 2).contiguous()
        mask = vis[:, None]
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask))
    splits = FA.split_plan(B, T, H, KV, S, DA.sm_count(q.device))[0]
    return dict(case=label, max_abs_err=err, err_share=share, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                splits=splits)


def check_flash_frame(rng, label, B, T, S, H, KV, hd, L, dtype, nreal):
    """Flash at a parallel-draft frame of the dense backend: after L
    committed tokens, row b's T queries sit at L .. L + T - 1, the first
    nreal[b] real and the rest draft slots, whose keys were written to
    their ring slots at position -1 and whose queries see up to the last
    real position (q_ctx < q_pos)."""
    kpos = np.full((B, S), -1, np.int32)
    qctx = np.zeros((B, T), np.int32)
    for b in range(B):
        for p in range(max(0, L + T - S), L + nreal[b]):
            kpos[b, p % S] = p
        qctx[b] = np.minimum(L + np.arange(T), L + nreal[b] - 1)
    qpos = np.ascontiguousarray(np.broadcast_to(
        np.arange(L, L + T, dtype=np.int32), (B, T)))
    dev = "cuda"
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).to(dev, dtype)
               for shape in ((B, T, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    qp, kp, qc = (torch.from_numpy(x).to(dev) for x in (qpos, kpos, qctx))
    out = FA.flash_attention(q, k, v, qp, kp, q_ctx=qc)
    want = ref.flash_attention_ref(q, k, v, qp, kp, q_ctx=qc)
    torch.cuda.synchronize()
    err, share = check_close(f"flash_attention {label}", out, want)
    kpl, qcl = kp.long()[:, None, :], qc.long()[:, :, None]
    vis = (kpl >= 0) & (kpl <= qcl)
    G = H // KV
    es = q.element_size()
    nbytes = (2 * int(vis.any(1).sum()) * KV * hd * es + 2 * q.numel() * es
              + (kp.numel() + 2 * qp.numel()) * 4)
    bms, by = bound(nbytes, 4 * hd * int(vis.sum()) * KV * G, dtype)
    ms = time_ms(lambda: FA.flash_attention(q, k, v, qp, kp, q_ctx=qc))
    plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, qp, kp,
                                                    q_ctx=qc))
    kd = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    vd = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    qd = q.transpose(1, 2).contiguous()
    mask = vis[:, None]
    lib = time_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                         attn_mask=mask))
    splits = FA.split_plan(B, T, H, KV, S, DA.sm_count(q.device))[0]
    return dict(case=label, max_abs_err=err, err_share=share, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                splits=splits)


def check_ssm(rng, label, B, T, E, N, xdtype, states):
    """The selective-scan kernel against ``ssm_scan_ref`` on inputs shaped
    like a Mamba layer's: dt = softplus(normal), A = -exp(0.2 normal)."""
    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).cuda()
    x = f(B, T, E).to(xdtype)
    dt = F.softplus(f(B, T, E))
    Bm, Cm, h0 = f(B, T, N), f(B, T, N), f(B, E, N)
    A = -torch.exp(f(E, N) * 0.2)
    D = torch.ones(E, device="cuda")
    args = (x, dt, Bm, Cm, A, D, h0)
    got = SS.ssm_scan(*args, return_states=states)
    want = ref.ssm_scan_ref(*args, return_states=states)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w in zip(("y", "hT", "hs"), got, want):
        d = (g - w).abs()
        if not bool((d <= SSM_ATOL + SSM_RTOL * w.abs()).all()):
            raise AssertionError(f"ssm_scan {label}: {name} differs beyond "
                                 f"rtol=atol={SSM_RTOL} (max "
                                 f"{d.max().item():.3e})")
        err = max(err, d.max().item())
    nbytes = (x.numel() * x.element_size() + (dt.numel() + Bm.numel()
              + Cm.numel() + A.numel() + D.numel() + h0.numel()) * 4
              + sum(g.numel() for g in got) * 4)
    bms, by = bound(nbytes, 7 * B * T * E * N, torch.float32)
    ms = time_ms(lambda: SS.ssm_scan(*args, return_states=states))
    plain = time_ms(lambda: ref.ssm_scan_ref(*args, return_states=states))
    # no single PyTorch call computes a selective scan: library_ms null
    return dict(case=label, max_abs_err=err, ms=ms, plain_ms=plain,
                library_ms=None, bound_ms=bms, bound_by=by)


# the carry mode (no states) at the sequential engines' shapes, the only
# mode an engine launches through ``ssm_scan``: phase 7's most frequent
# (SpecBranch's branch tick over 4 branches of the tiny pairs' draft, and
# their target's verify chunk of gamma + 1 = 5), and that chunk at
# falcon-mamba-7b's width
SEQ_CARRY_CASE = "seq branch tick B=4 T=1 E=64 f32"


def carry_cases(rng) -> list:
    f32, bf16 = torch.float32, torch.bfloat16
    return [check_ssm(rng, SEQ_CARRY_CASE, 4, 1, 64, 16, f32, False),
            check_ssm(rng, "seq verify B=1 T=5 E=128 f32", 1, 5, 128, 16,
                      f32, False),
            check_ssm(rng, "falcon-7b seq verify B=1 T=5", 1, 5, 8192, 16,
                      bf16, False)]


def phase_scan() -> None:
    """``--scan``: phase 2's plain-scan cases, both modes, alone (with
    ``--src``, of another checkout's kernel)."""
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16
    rows = [check_ssm(rng, "falcon-7b decode B=8 T=8", 8, 8, 8192, 16, bf16,
                      True),
            check_ssm(rng, "falcon-7b cache-less B=8 T=48", 8, 48, 8192, 16,
                      bf16, False)] + carry_cases(rng)
    timing_floor()
    for r in rows:
        log(f"  {r['case']:32s} err={r['max_abs_err']:.2e} "
            f"ms={r['ms']:.4f} bound={r['bound_ms']:.4f} "
            f"plain={r['plain_ms']:.4f}")


def ring_written(B, T, Rg, n_rows, p0, rows) -> torch.Tensor:
    """(n_rows, Rg) mask of the ring slots a ring scan writes: the
    trailing min(T, Rg) steps of every live lane."""
    w = torch.zeros((n_rows, Rg), dtype=torch.bool)
    for b in range(B):
        if rows[b] >= 0:
            for t in range(T - min(T, Rg), T):
                w[rows[b], (p0[b] + t + 1) % Rg] = True
    return w


def check_ssm_ring(rng, label, B, T, E, N, Rg, n_rows, xdtype, p0, rows):
    """The ring entry against ``ssm_scan_ring_ref`` on one whole ring
    h_ring (n_rows, Rg, E, N): slots no lane writes bit for bit
    untouched, y and the written slots within SSM_RTOL / SSM_ATOL.  p0
    start positions (0: a fresh lane), rows the lane map (-1: a pad
    lane).  Also times the PyTorch path this entry replaces: the gather
    of h0, the scan kernel with every post-step state and the index_put
    of the trailing states (``glue_ms``)."""
    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).cuda()
    x = f(B, T, E).to(xdtype)
    dt = F.softplus(f(B, T, E))
    Bm, Cm = f(B, T, N), f(B, T, N)
    A = -torch.exp(f(E, N) * 0.2)
    D = torch.ones(E, device="cuda")
    ring = f(n_rows, Rg, E, N)
    args = (x, dt, Bm, Cm, A, D)
    p0_t = torch.tensor(p0, dtype=torch.int32, device="cuda")
    rows_t = torch.tensor(rows, dtype=torch.int32, device="cuda")
    got_ring, want_ring = ring.clone(), ring.clone()
    y = SS.ssm_scan_ring(*args, got_ring, p0_t, rows_t)
    yw = ref.ssm_scan_ring_ref(*args, want_ring, p0_t, rows_t)
    torch.cuda.synchronize()
    wr = ring_written(B, T, Rg, n_rows, p0, rows).cuda()
    if not torch.equal(got_ring[~wr], ring[~wr]):
        raise AssertionError(f"ssm_scan_ring {label}: a slot no lane "
                             "writes changed")
    err = 0.0
    for name, g, w in (("y", y, yw), ("ring", got_ring[wr], want_ring[wr])):
        d = (g - w).abs()
        if not bool((d <= SSM_ATOL + SSM_RTOL * w.abs()).all()):
            raise AssertionError(f"ssm_scan_ring {label}: {name} differs "
                                 f"beyond rtol=atol={SSM_RTOL} (max "
                                 f"{d.max().item():.3e})")
        err = max(err, d.max().item())
    live = [b for b in range(B) if rows[b] >= 0]
    loads = sum(1 for b in live if p0[b] != 0)
    nbytes = (x.numel() * x.element_size()
              + (dt.numel() + Bm.numel() + Cm.numel() + A.numel()
                 + D.numel() + y.numel()) * 4 + 2 * B * 4
              + (loads + len(live) * min(T, Rg)) * E * N * 4)
    bms, by = bound(nbytes, 7 * B * T * E * N, torch.float32)
    ms = time_ms(lambda: SS.ssm_scan_ring(*args, got_ring, p0_t, rows_t))
    plain = time_ms(lambda: ref.ssm_scan_ring_ref(*args, want_ring, p0_t,
                                                  rows_t))
    rl = rows_t.long()
    live_t = rl >= 0
    fresh = ((p0_t == 0) | ~live_t)[:, None, None]
    Tr = min(T, Rg)
    slots = (p0_t.long()[:, None]
             + torch.arange(T - Tr, T, device="cuda")[None] + 1) % Rg
    lidx = live_t.nonzero()[:, 0]
    lrows, lslots = rl[lidx], slots[lidx]

    def glue():     # the layer's ring path before the ring entry
        h0 = torch.where(fresh, 0.0, want_ring[rl.clamp_min(0),
                                               p0_t.long() % Rg])
        out = SS.ssm_scan(*args, h0.contiguous(), return_states=True)
        want_ring[lrows[:, None], lslots] = out[2][lidx, T - Tr:]
    glue_ms = time_ms(glue)
    # no single PyTorch call computes a selective scan: library_ms null
    return dict(case=label, max_abs_err=err, ms=ms, plain_ms=plain,
                library_ms=None, bound_ms=bms, bound_by=by, glue_ms=glue_ms)


def branch_case(rng, kb, Tq, Sp, Ss, Hh, KV, hd, dtype, dead=0):
    """k branches over one shared prefix of Sp keys (``dead`` of them
    unwritten, position -1) and Ss suffix keys each; the Tq queries of
    each branch sit at the last positions, so Tq > 1 cuts the suffix
    causally."""
    dev = "cuda"
    ppos = np.arange(Sp, dtype=np.int32)[None].copy()
    ppos[0, 1:1 + dead] = -1
    spos = np.ascontiguousarray(np.broadcast_to(
        np.arange(Sp, Sp + Ss, dtype=np.int32), (kb, Ss)))
    qpos = np.ascontiguousarray(np.broadcast_to(
        np.arange(Sp + Ss - Tq + 1, Sp + Ss + 1, dtype=np.int32), (kb, Tq)))
    q, pk, pv, sk, sv = (
        torch.from_numpy(rng.standard_normal(shape, np.float32)
                         ).to(dev, dtype)
        for shape in ((kb, Tq, Hh, hd), (1, Sp, KV, hd), (1, Sp, KV, hd),
                      (kb, Ss, KV, hd), (kb, Ss, KV, hd)))
    return (q, pk, pv, torch.from_numpy(ppos).to(dev), sk, sv,
            torch.from_numpy(spos).to(dev), torch.from_numpy(qpos).to(dev))


def check_branch(rng, label, kb, Tq, Sp, Ss, Hh, KV, hd, dtype, dead=0,
                 cap=None):
    args = branch_case(rng, kb, Tq, Sp, Ss, Hh, KV, hd, dtype, dead)
    q, pk, pv, ppos, sk, sv, spos, qpos = args
    out = BA.branch_decode_attention(*args, cap=cap)
    want = ref.branch_decode_ref(*args, cap=cap)
    torch.cuda.synchronize()
    err, share = check_close(f"branch_decode_attention {label}", out, want)
    # the work these inputs need: the prefix keys some query of some
    # branch sees, read ONCE; each branch's visible suffix keys
    qpl = qpos.long()[:, :, None]
    pvis = (ppos.long()[:, None, :] >= 0) & (ppos.long()[:, None, :] <= qpl)
    svis = (spos.long()[:, None, :] >= 0) & (spos.long()[:, None, :] <= qpl)
    es = q.element_size()
    nbytes = ((int(pvis.any(1).any(0).sum()) + int(svis.any(1).sum()))
              * 2 * KV * hd * es + 2 * q.numel() * es
              + (ppos.numel() + spos.numel() + qpos.numel()) * 4)
    flops = 4 * hd * Hh * (int(pvis.sum()) + int(svis.sum()))
    bms, by = bound(nbytes, flops, dtype)
    ms = time_ms(lambda: BA.branch_decode_attention(*args, cap=cap))
    plain = time_ms(lambda: ref.branch_decode_ref(*args, cap=cap))
    lib = None
    if cap is None:
        # library yardstick: masked SDPA over the prefix concatenated with
        # each branch's suffix, heads expanded for the group; the
        # concatenation is built outside the timed region
        G = Hh // KV
        kd = torch.cat([pk.expand(kb, -1, -1, -1), sk], 1)
        vd = torch.cat([pv.expand(kb, -1, -1, -1), sv], 1)
        kd = kd.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        vd = vd.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        qd = q.transpose(1, 2).contiguous()
        mask = torch.cat([pvis.expand(kb, -1, -1), svis], -1)[:, None]
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask))
    splits = BA.split_plan(kb, Tq, Hh, KV, Sp, Ss,
                           DA.sm_count(q.device))[0]
    return dict(case=label, max_abs_err=err, err_share=share, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                args=args, cap=cap, splits=splits)


def check_single_verify(rng, label, R, V, dtype):
    """The single-request (R, V) verify: accept flags and residual tokens
    equal (a residual may differ only where w lies within BOUNDARY_EPS of
    a cdf boundary), p_tok / q_tok within 1e-6."""
    dev = "cuda"
    pl, ql = (torch.from_numpy(2 * rng.standard_normal((R, V), np.float32)
                               ).to(dev, dtype) for _ in range(2))
    tok = torch.from_numpy(rng.integers(0, V, R).astype(np.int32)).to(dev)
    u, w = (torch.from_numpy(rng.random(R, np.float32)).to(dev)
            for _ in range(2))
    args = (pl, ql, tok, u, w)
    got = [x.cpu() for x in VA.verify_accept(*args)]
    want = [x.cpu() for x in ref.verify_accept_ref(*args)]
    torch.cuda.synchronize()
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"verify_accept {label}: accept flags differ")
    err = max((got[i] - want[i]).abs().max().item() for i in (2, 3))
    if err > 1e-6:
        raise AssertionError(f"verify_accept {label}: p_tok/q_tok differ "
                             f"by {err:.2e} > 1e-6")
    boundary = 0
    for r in torch.nonzero(got[1] != want[1])[:, 0].tolist():
        if cdf_distance(pl[r], ql[r], got[1][r], want[1][r],
                        w[r]) > BOUNDARY_EPS:
            raise AssertionError(f"verify_accept {label}: residual token "
                                 f"differs at row {r} away from a cdf "
                                 "boundary")
        boundary += 1
    es = pl.element_size()
    bms, by = bound(2 * R * V * es + R * (3 * 4 + 4 * 4), 8 * R * V,
                    torch.float32)
    ms = time_ms(lambda: VA.verify_accept(*args))
    plain = time_ms(lambda: ref.verify_accept_ref(*args))
    # no single PyTorch call computes the verdict: library_ms null
    return dict(case=label, max_abs_err=err, boundary_cases=boundary, ms=ms,
                plain_ms=plain, library_ms=None, bound_ms=bms, bound_by=by,
                args=args, splits=VA.split_plan(V, R, DA.sm_count(pl.device)))


def timing_floor(flush: str = "dirty") -> dict:
    """What ``time_ms`` shows for next to no work: a one-element add, and
    a device copy of 10 MB (about the attention kernels' byte bounds);
    each kernel's bound is read against these."""
    one = torch.zeros(1, device="cuda")
    src = torch.ones(5 << 20, dtype=torch.bfloat16, device="cuda")
    dst = torch.empty_like(src)
    out = dict(one_element_ms=time_ms(lambda: one.add_(1.0), flush=flush),
               copy_10mb_ms=time_ms(lambda: dst.copy_(src), flush=flush),
               copy_10mb_bound_ms=2 * src.numel() * 2 / HBM_BYTES_PER_S
               * 1e3)
    log(f"  timing floor ({flush} L2 flush): one-element add "
        f"{out['one_element_ms']:.4f} ms, 10 MB device copy "
        f"{out['copy_10mb_ms']:.4f} ms (bound "
        f"{out['copy_10mb_bound_ms']:.4f})")
    return out


def phase_probe() -> dict:
    """``--probe``: the attention kernels' tile loop timed phase by phase
    at the 7B shapes, from variants built with ``-DREPRO_ATTN_STOP``:
    1 stops every tile after its K/V loads, 2 after its logits, 0 is the
    whole kernel; the timing floor and three kernel calls after a dirty
    L2 flush (the default), a clean one and none; the split plan's size
    knob; the batched verify's rounds (``probe_verify``)."""
    import ctypes
    floor = {f: timing_floor(f) for f in ("dirty", "clean", "none")}
    bf = torch.bfloat16
    rng = np.random.default_rng(0)
    paged = {T: attn_case(rng, 8, T, 32, 32, 128, 16, bf) for T in (1, 8)}
    branch = branch_case(rng, 6, 1, 504, 8, 32, 32, 128, bf)
    flash = {"7B B=1 T=5 S=512": (flash_case(rng, 1, 5, 512, 32, 32, 128,
                                             40, bf, 3), {}),
             "7B B=6 T=10 S=512": (flash_case(rng, 6, 10, 512, 32, 32, 128,
                                              300, bf, 5), {}),
             "7B cache-less T=S=512": (flash_case(rng, 1, 512, 512, 32, 32,
                                                  128, 512, bf), {}),
             "gemma2 window T=16": (flash_case(rng, 1, 16, 4608, 32, 16,
                                               128, 4608, bf),
                                    dict(window=4096))}
    gemma3 = attn_case(rng, 8, 4, 8, 4, 256, 16, bf, max_len=2048,
                       min_len=1500)
    srcs = ("paged_attention.cu", "branch_attention.cu",
            "flash_attention.cu")
    out = {}
    saved = build._lib
    try:
        for stop, what in ((1, "loads only"), (2, "loads + logits"),
                           (0, "whole kernel")):
            build._lib = build.bind(ctypes.CDLL(str(build.build(
                srcs, (f"-DREPRO_ATTN_STOP={stop}",)))))
            for T, a in paged.items():
                ms = time_ms(lambda: PA.paged_attention(*a))
                out[f"paged 7B B=8 T={T} {what}"] = ms
            ms = time_ms(lambda: PA.paged_attention(*gemma3, window=1024))
            out[f"paged gemma3 hd256 B=8 T=4 {what}"] = ms
            ms = time_ms(lambda: BA.branch_decode_attention(*branch))
            out[f"branch 7B k=6 Sp=504 Ss=8 {what}"] = ms
            for name, (a, kw) in flash.items():
                ms = time_ms(lambda: FA.flash_attention(*a, **kw))
                out[f"flash {name} {what}"] = ms
    finally:
        build._lib = saved
    for k, v in out.items():
        log(f"  probe {k:40s} ms={v:.4f}")
    long_row = attn_case(rng, 1, 1, 32, 32, 128, 16, bf, max_len=4096,
                         min_len=3968)
    # the harness's share: the same calls after each flush
    for name, fn in (("paged 7B B=8 T=8", lambda: PA.paged_attention(
                         *paged[8])),
                     ("branch 7B Sp=504", lambda: BA.branch_decode_attention(
                         *branch)),
                     ("paged long row", lambda: PA.paged_attention(
                         *long_row))):
        t = {f: time_ms(fn, flush=f) for f in ("dirty", "clean", "none")}
        out[f"flush {name}"] = t
        log(f"  flush {name:18s} dirty {t['dirty']:.4f} clean "
            f"{t['clean']:.4f} none {t['none']:.4f} ms")
    # the split plan's size knob at the shapes that split
    br2048 = branch_case(rng, 6, 1, 2048, 8, 32, 32, 128, bf)
    sweep = {}
    saved = DA.MIN_SPLIT_KEYS
    try:
        for mk in (128, 256, 512, 1024):
            DA.MIN_SPLIT_KEYS = mk
            for name, fn in (
                    ("paged long row", lambda: PA.paged_attention(
                        *long_row)),
                    ("branch Sp=504", lambda: BA.branch_decode_attention(
                        *branch)),
                    ("branch Sp=2048", lambda: BA.branch_decode_attention(
                        *br2048))):
                sweep[(mk, name)] = time_ms(fn)
    finally:
        DA.MIN_SPLIT_KEYS = saved
    for (mk, name), v in sweep.items():
        log(f"  split sweep min_keys={mk:4d} {name:16s} ms={v:.4f}")
    return dict(floor=floor, phases=out,
                sweep={f"{a} {b}": v for (a, b), v in sweep.items()},
                verify=probe_verify(rng))


def probe_verify(rng) -> dict:
    """The batched verify's rows phase by phase, from variants built with
    ``-DREPRO_VERIFY_STOP``: 1 ends each row after its load, 2 after
    round 1, 3 after round 2, 0 is the whole kernel (each stop adds one
    cluster barrier); and the whole kernel with ten more cluster
    barriers after the load (``-DREPRO_VERIFY_SYNCS=10``), whose
    difference is ten barriers' cost.  V = 32000 (8 blocks a row) with
    16 live rows, phase 2's lens draw (72 of 128 live) and every row
    live; V = 199 (one block a row)."""
    import ctypes

    def case(B, R, V, lens):
        f = [torch.from_numpy(3 * rng.standard_normal((B, R, V), np.float32)
                              ).cuda() for _ in range(2)]
        tok = torch.from_numpy(rng.integers(0, V, (B, R)).astype(np.int32)
                               ).cuda()
        u, w = (torch.from_numpy(rng.random((B, R), np.float32)).cuda()
                for _ in range(2))
        return (*f, tok, torch.tensor(lens, dtype=torch.int32,
                                      device="cuda"), u, w)
    ragged = [10, 14, 8, 3, 11, 12, 14, 0]
    cases = {"V=32000 B=1 R=16 live 16": case(1, 16, 32000, [16]),
             "V=32000 B=8 R=16 live 72": case(8, 16, 32000, ragged),
             "V=32000 B=8 R=16 live 128": case(8, 16, 32000, [16] * 8),
             "V=199 B=8 R=16 live 72": case(8, 16, 199, ragged)}
    variants = (("load", ("-DREPRO_VERIFY_STOP=1",)),
                ("+round 1", ("-DREPRO_VERIFY_STOP=2",)),
                ("+round 2", ("-DREPRO_VERIFY_STOP=3",)),
                ("whole", ()),
                ("+10 barriers", ("-DREPRO_VERIFY_SYNCS=10",)))
    out = {}
    saved = build._lib
    try:
        for what, defines in variants:
            build._lib = build.bind(ctypes.CDLL(str(build.build(
                ("verify_accept.cu",), defines))))
            for name, a in cases.items():
                out[(name, what)] = time_ms(
                    lambda: VA.verify_accept_batched(*a))
    finally:
        build._lib = saved
    for name in cases:
        log(f"  probe verify {name:26s} "
            + " ".join(f"{what} {out[(name, what)]:.4f}"
                       for what, _ in variants) + " ms")
    return {f"{n} {w}": v for (n, w), v in out.items()}


def phase_kernel_api(cases, totals) -> dict:
    """The path of the two kernels no engine calls, in either package: the
    kernel API ``kernels.ops``, driven once per checked shape (as the
    reference's benchmarks/kernels_bench.py drives ``repro.kernels.ops``),
    the counters zeroed just before and read just after."""
    ops.reset_launches()
    for c in cases["branch_decode_attention"]:
        ops.branch_decode_attention(*c["args"], cap=c["cap"])
    for c in cases["verify_accept"]:
        ops.verify_accept(*c["args"])
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    for k, v in counts.items():
        totals[k] += v
    log(f"  kernel API drive: launches={counts}")
    for k in ("branch_decode_attention", "verify_accept"):
        if counts[k] == 0:
            raise AssertionError(f"kernel API drive: {k} not launched")
    return counts


def phase_kernels() -> dict:
    rng = np.random.default_rng(0)
    bf, f32 = torch.bfloat16, torch.float32
    att = []
    for T in (1, 2, 4, 8, 16):
        att.append(check_attention(rng, f"llama-7b B=8 T={T}", 8, T, 32, 32,
                                   128, 16, bf))
    for T in (1, 16):
        att.append(check_attention(rng, f"llama-68m B=56 T={T}", 56, T, 12,
                                   12, 64, 16, bf, n_idle=40))
    for T in (1, 4, 16):
        att.append(check_attention(rng, f"zm-target B=8 T={T}", 8, T, 4, 2,
                                   32, 16, f32))
    att.append(check_attention(rng, "zm-target B=8 T=8 ps=4", 8, 8, 4, 2,
                               32, 4, f32))
    for T in (1, 16):
        att.append(check_attention(rng, f"zm-draft B=56 T={T}", 56, T, 2, 1,
                                   16, 16, f32, n_idle=40))
    ver = [check_verify(rng, "llama V=32000 B=8 R=16", 8, 16, 32000),
           check_verify(rng, "zm V=199 B=8 R=16", 8, 16, 199)]
    gat = [check_gather(rng, "zm swap ps=4 dim=512", 64, 4, 512, 13, 50),
           check_gather(rng, "llama-7b swap ps=16 dim=262144", 8, 16,
                        262144, 5, 70)]
    fl = [check_flash(rng, "llama-7b B=1 T=1 S=512", 1, 1, 512, 32, 32, 128,
                      48, bf),
          check_flash(rng, "llama-7b B=1 T=5 S=512", 1, 5, 512, 32, 32, 128,
                      40, bf, stale=3),
          check_flash(rng, "llama-7b B=6 T=1 S=512", 6, 1, 512, 32, 32, 128,
                      41, bf),
          check_flash(rng, "llama-7b B=6 T=10 S=512", 6, 10, 512, 32, 32,
                      128, 300, bf, stale=5),
          check_flash(rng, "llama-7b prefill B=1 T=15", 1, 15, 512, 32, 32,
                      128, 15, bf),
          check_flash(rng, "llama-7b cache-less B=2 T=S=48", 2, 48, 48, 32,
                      32, 128, 48, bf),
          check_flash(rng, "llama-68m B=6 T=1 S=512", 6, 1, 512, 12, 12, 64,
                      41, bf),
          check_flash(rng, "llama-68m B=1 T=1 S=512", 1, 1, 512, 12, 12, 64,
                      44, bf),
          check_flash(rng, "zm-target B=1 T=5 S=512", 1, 5, 512, 4, 2, 32,
                      40, f32, stale=3),
          check_flash(rng, "zm-draft B=6 T=1 S=512", 6, 1, 512, 2, 1, 16,
                      41, f32),
          check_flash(rng, "gemma2 window B=1 T=1 S=4608", 1, 1, 4608, 32,
                      16, 128, 4608, bf, window=4096, cap=50.0),
          check_flash(rng, "gemma2 window B=1 T=16 S=4608", 1, 16, 4608, 32,
                      16, 128, 4608, bf, window=4096, cap=50.0),
          check_flash(rng, "gemma2 window B=1 T=16 f32", 1, 16, 4608, 32, 16,
                      128, 4608, f32, window=4096, cap=50.0)]
    bf16 = torch.bfloat16
    ss = [check_ssm(rng, "falcon-7b decode B=8 T=8", 8, 8, 8192, 16, bf16,
                    True),
          check_ssm(rng, "falcon-7b prefill B=8 T=16", 8, 16, 8192, 16,
                    bf16, True),
          check_ssm(rng, "falcon draft tick B=56 T=1", 56, 1, 1024, 16,
                    bf16, True),
          check_ssm(rng, "falcon-7b cache-less B=8 T=48", 8, 48, 8192, 16,
                    bf16, False),
          check_ssm(rng, "tiny f32 B=3 T=8 E=128", 3, 8, 128, 16, f32,
                    True),
          check_ssm(rng, "odd length B=1 T=130 E=32 N=8", 1, 130, 32, 8,
                    f32, True)]
    br = [check_branch(rng, "llama-7b k=6 Sp=504 Ss=8", 6, 1, 504, 8, 32,
                       32, 128, bf),
          check_branch(rng, "tiny f32 k=3 Tq=3 Sp=29 Ss=5", 3, 3, 29, 5, 4,
                       2, 32, f32, dead=2),
          check_branch(rng, "llama-7b cap k=6 Sp=504 Ss=8", 6, 1, 504, 8,
                       32, 32, 128, bf, cap=50.0)]
    sv = [check_single_verify(rng, "llama V=32000 R=9", 9, 32000, f32)]
    # cases after the earlier slices' (their inputs stay the same draws):
    # page tables as wide as a serve's, a long row at B = 1 and a long
    # shared prefix, which split the key axis
    for T in (1, 5):
        att.append(check_attention(rng, f"llama-7b B=8 T={T} 32-page table",
                                   8, T, 32, 32, 128, 16, bf, n_max=32))
    att.append(check_attention(rng, "llama-68m B=56 T=1 32-page table", 56,
                               1, 12, 12, 64, 16, bf, n_idle=40, n_max=32))
    att.append(check_attention(rng, "llama-7b B=1 T=1 long row", 1, 1, 32,
                               32, 128, 16, bf, max_len=4096,
                               min_len=3968))
    br.append(check_branch(rng, "llama-7b k=6 Sp=2048 Ss=8", 6, 1, 2048, 8,
                           32, 32, 128, bf))
    # head dims 80 and 256 on the decode loop, a 512-token cache-less
    # prefill and the long windowed row without a cap (SDPA's yardstick)
    fl.append(check_flash(rng, "llama-7b cache-less B=1 T=S=512", 1, 512,
                          512, 32, 32, 128, 512, bf))
    fl.append(check_flash(rng, "gemma2 window B=1 T=16 no cap", 1, 16, 4608,
                          32, 16, 128, 4608, bf, window=4096))
    fl.append(check_flash(rng, "gemma3-4b window B=1 T=5 S=2048", 1, 5, 2048,
                          8, 4, 256, 1800, bf, stale=3, window=1024))
    fl.append(check_flash(rng, "hubert-xl hd80 B=2 T=S=256 bidir", 2, 256,
                          256, 16, 16, 80, 256, bf, causal=False))
    att.append(check_attention(rng, "gemma3-4b B=8 T=4 window 1024", 8, 4, 8,
                               4, 256, 16, bf, window=1024, max_len=2048,
                               min_len=1500))
    br.append(check_branch(rng, "gemma3-4b k=6 Sp=504 Ss=8", 6, 1, 504, 8,
                           8, 4, 256, bf))
    br.append(check_branch(rng, "hd80 H=16 k=6 Sp=504 Ss=8", 6, 1, 504, 8,
                           16, 16, 80, bf))
    # the scan's ring entry at the falcon-mamba-7b serve's two target
    # shapes (8 lanes of T = 16, its most frequent, and of T = 8, over 8
    # ring rows of depth FALCON_RING; two fresh lanes, two wrapping past
    # slot Rg - 1, one pad lane) and a lapping prefill; the verify with
    # every row full, with a V its split does not divide, and at gemma3-4b's
    # vocabulary (16 blocks per row, the non-portable cluster)
    lanes = dict(p0=[0, 37, FALCON_RING - 2, 0, 12, 55, 90, 3],
                 rows=[5, 0, 7, 2, -1, 1, 6, 3])
    rr = [check_ssm_ring(rng, FALCON_RING_CASE, 8, 16, 8192, 16,
                         FALCON_RING, 8, bf16, **lanes),
          check_ssm_ring(rng, "falcon-7b serve B=8 T=8 Rg=92", 8, 8, 8192,
                         16, FALCON_RING, 8, bf16, **lanes),
          check_ssm_ring(rng, "lapping prefill B=4 T=130 E=1024 Rg=92", 4,
                         130, 1024, 16, 92, 6, bf16, p0=[0, 0, 7, 0],
                         rows=[4, 1, 0, -1])]
    ver.append(check_verify(rng, "llama V=32000 B=8 R=16 full", 8, 16,
                            32000, lens_to=16))
    ver.append(check_verify(rng, "V=30011 B=8 R=16", 8, 16, 30011))
    ver.append(check_verify(rng, "gemma3-4b V=262144 B=4 R=6", 4, 6,
                            262144))
    ss += carry_cases(rng)
    # the dense backend's flash shapes (phase 11's 7B serve: the target's
    # 8 rows verifying a bucket-8 chunk and prefilling a 16-wide rung on a
    # fresh 512-slot view, the 68M draft's 56 rows ticking) and the swap
    # readback at the 7B target's full width (4 pages of 16, 60 rows)
    fl.append(check_flash(rng, "llama-7b dense B=8 T=8 S=512", 8, 8, 512,
                          32, 32, 128, 40, bf, stale=4))
    fl.append(check_flash(rng, "llama-7b dense prefill B=8 T=16 S=512", 8,
                          16, 512, 32, 32, 128, 16, bf))
    fl.append(check_flash(rng, "llama-68m dense B=56 T=1 S=512", 56, 1,
                          512, 12, 12, 64, 41, bf))
    gat.append(check_gather(rng, GATHER_FULL_CASE, 8, 16, 262144, 4, 60))
    # the parallel-draft frames (phase 13): the 68M draft's B=8 rows (SpS)
    # and 56 rows, 40 idle (SpecBranch), T = 16 (pending + slots on the
    # bucket ladder), S = 512; the tiny draft's f32 frame
    nr8 = [1, 2, 5, 1, 3, 9, 1, 2]
    fl.append(check_flash_frame(rng, "llama-68m frame B=8 T=16 S=512", 8,
                                16, 512, 12, 12, 64, 41, bf, nr8))
    fl.append(check_flash_frame(rng, "zm-draft frame B=8 T=16 S=512", 8,
                                16, 512, 2, 1, 16, 41, f32, nr8))
    att.append(check_attention(rng, "llama-68m frame B=8 T=16", 8, 16, 12,
                               12, 64, 16, bf, n_max=32, nreal=nr8))
    att.append(check_attention(rng, "llama-68m frame B=56 T=16", 56, 16,
                               12, 12, 64, 16, bf, n_idle=40, n_max=32,
                               nreal=nr8 * 7))
    att.append(check_attention(rng, "zm-draft frame B=8 T=16", 8, 16, 2, 1,
                               16, 16, f32, nreal=nr8))
    timing_floor()
    for r in att + ver + gat + fl + ss + rr + br + sv:
        lib = r["library_ms"]
        log(f"  {r['case']:32s} err={r['max_abs_err']:.2e} "
            + (f"({r['err_share']:.2f} of bound) "
               if "err_share" in r else "") +
            f"ms={r['ms']:.4f} bound={r['bound_ms']:.4f} "
            f"({r['bound_by']}) plain={r['plain_ms']:.4f} "
            f"lib={'null' if lib is None else f'{lib:.4f}'}"
            + (f" boundary={r['boundary_cases']}"
               if "boundary_cases" in r else "")
            + (f" splits={r['splits']}" if "splits" in r else "")
            + (f" live_rows={r['live_rows']}" if "live_rows" in r else "")
            + (f" glue={r['glue_ms']:.4f}" if "glue_ms" in r else ""))
    return {"paged_attention": att, "verify_accept_batched": ver,
            "paged_gather": gat, "flash_attention": fl, "ssm_scan": ss,
            "ssm_scan_ring": rr, "branch_decode_attention": br,
            "verify_accept": sv}


# ---------------------------------------------------------------------------
# phases 3-4: the main path
# ---------------------------------------------------------------------------

class VerifyShadow:
    """While active, every kernel-route ``device_loop.branch_verify`` call
    is computed a second time by the plain route (``kernel=False``:
    probabilities through ``sampling.verify_chain_device``, no kernel) on
    the same inputs.  The packets must agree: the branch-stage columns
    exactly, the chain verdict except where a uniform lies within
    BOUNDARY_EPS of the boundary that decides it (the accept ratio at the
    first position the routes disagree on, or a residual cdf entry between
    the two tokens), recomputed in f64 from the kernel's own inputs.  Such
    cases are counted.  The plain route launches no counted kernel."""

    def __init__(self):
        self.calls = self.rows = self.positions = self.boundary = 0
        self._bv, self._cv = DL.branch_verify, DL._chain_via_kernel
        self._sv = DL.sps_verify
        self._inputs = None

    def __enter__(self):
        DL.branch_verify, DL._chain_via_kernel = self._verify, self._chain
        DL.sps_verify = self._sps
        return self

    def __exit__(self, *exc):
        DL.branch_verify, DL._chain_via_kernel = self._bv, self._cv
        DL.sps_verify = self._sv

    def _chain(self, *a):
        self._inputs = a
        return self._cv(*a)

    def _verify(self, *a, **kw):
        return self._shadow(self._bv, "branch stage", *a, **kw)

    def _sps(self, *a, **kw):
        # the SpS packet's columns past the chain verdict are the drafted
        # tokens, the same on both routes
        return self._shadow(self._sv, "drafted tokens", *a, **kw)

    def _shadow(self, fn, tail, *a, **kw):
        self._inputs = None
        got = fn(*a, **kw)
        if not kw.get("kernel"):
            return got
        launched = self._inputs is not None    # a chunk reached the kernel
        want = fn(*a, **dict(kw, kernel=False))
        self.calls += launched
        self.rows += got.shape[0] if launched else 0
        self.positions += int(self._inputs[3].sum()) if launched else 0
        if not torch.equal(got[:, 3:], want[:, 3:]):
            raise AssertionError(f"verify shadow: {tail} differs")
        for s in torch.nonzero((got[:, :3] != want[:, :3]).any(1))[:, 0]:
            if not launched or not self._near_boundary(int(s), got[s],
                                                       want[s]):
                raise AssertionError(
                    f"verify shadow: kernel route {got[s].tolist()} != "
                    f"plain route {want[s].tolist()} away from a boundary")
            self.boundary += 1
        return got

    def _near_boundary(self, s, got, want) -> bool:
        p_lg, q_lg, toks, lens, ugrid = self._inputs
        p = torch.softmax(p_lg[s].double(), -1)
        q = torch.softmax(q_lg[s].double(), -1)
        R, L = toks.shape[1], int(lens[s])
        n_g, n_w = int(got[0]), int(want[0])
        if n_g != n_w:                         # an accept test flipped
            j = min(n_g, n_w)
            t = int(toks[s, j])
            ratio = p[j, t] / q[j, t].clamp_min(1e-30)
            return abs(float(ugrid[s, j]) - float(ratio)) <= BOUNDARY_EPS
        pos = min(n_g, R - 1)                  # the residual draw flipped
        r = (p[pos] - q[pos]).clamp_min(0)
        r = r / r.sum() if r.sum() > 1e-12 else p[pos]
        cdf = torch.cumsum(r, 0)
        cdf = cdf / cdf[-1]
        lo, hi = sorted((int(got[1]), int(want[1])))
        near = (cdf[max(lo - 1, 0):hi] - float(ugrid[s, L])).abs().min()
        return float(near) <= BOUNDARY_EPS


def drive(pair, ecfg, prompts, n_new, dev, attn_backend="paged", **kw):
    """One main-path drive with the launch counters zeroed just before and
    read just after."""
    ops.reset_launches()
    res, rep, eng, wall = SV.serve(pair, ecfg, prompts, n_new, device=dev,
                                   attn_backend=attn_backend, **kw)
    counts = dict(ops.LAUNCHES)
    for rid, r in res.items():
        if len(r.tokens) != n_new:
            raise AssertionError(f"request {rid} got {len(r.tokens)} tokens")
    eng.pool.check()
    return res, rep, counts, wall, eng


def phase_tiny(dev, totals) -> dict:
    from repro_torch.training.pairs import get_pair
    pair = get_pair("misaligned", device=dev,
                    cache_dir=os.path.join(ROOT, ".cache", "pairs"))
    prompts = SV.make_prompts(4)
    n_new = 48
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    greedy = M.greedy_reference(pair[2], pair[3], prompts, n_new)
    out = {}
    for name, temp, eps, kw in (("greedy", 0.0, EPS, {}),
                                ("temp1", 1.0, EPS, {}),
                                ("temp1-chains", 1.0, 0.0, {}),
                                ("preempt", 0.0, EPS, dict(page_size=4,
                                                           pool_pages=200))):
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp,
                            epsilon=eps, max_len=max_len)
        with VerifyShadow() as sh:
            res, rep, counts, wall, _ = drive(pair, ecfg, prompts, n_new,
                                              dev, **kw)
        for k, v in counts.items():
            totals[k] += v
        log(f"  tiny {name}: rounds={rep['rounds']} "
            f"preemptions={rep['preemptions']} wall={wall:.2f}s "
            f"launches={counts}")
        if temp > 0:
            check_shadow(f"tiny {name}", sh, counts, chains=eps == 0.0)
            out[name + " cpu"] = compare_cpu(f"tiny {name}", ecfg, prompts,
                                             n_new, res, cpu_pair())
        if temp == 0.0:
            bad = [i for i in range(len(prompts))
                   if res[i].tokens != greedy[i]]
            if bad:
                raise AssertionError(f"tiny {name}: requests {bad} differ "
                                     "from greedy decoding")
        if counts["paged_attention"] == 0:
            raise AssertionError(f"tiny {name}: paged_attention not run")
        if temp > 0 and counts["verify_accept_batched"] == 0:
            raise AssertionError(f"tiny {name}: verify kernel not launched")
        if name == "preempt" and (rep["preemptions"] == 0
                                  or counts["paged_gather"] == 0):
            raise AssertionError("tiny preempt: no preemption / swap-in "
                                 f"({rep['preemptions']}, {counts})")
        out[name] = dict(rounds=rep["rounds"], preemptions=rep["preemptions"],
                         wall_s=wall, launches=counts)
    return out


def check_shadow(label, sh, counts, chains: bool) -> None:
    """Every verify launch of the drive was shadowed; with the confidence
    stop off (epsilon 0) the chains must also have reached the kernel:
    with the default epsilon the near-flat drafts of these pairs stop at
    their first token, so every chain the kernel sees is empty."""
    log(f"  {label}: verify shadow {sh.calls} calls, {sh.rows} rows, "
        f"{sh.positions} chain positions, {sh.boundary} boundary cases")
    if sh.calls != counts["verify_accept_batched"]:
        raise AssertionError(f"{label}: shadowed calls != verify launches")
    if chains and sh.positions == 0:
        raise AssertionError(f"{label}: no chain position reached the "
                             "verify kernel")


def cpu_pair():
    from repro_torch.training.pairs import get_pair
    return get_pair("misaligned", device="cpu",
                    cache_dir=os.path.join(ROOT, ".cache", "pairs"))


def compare_cpu(name, ecfg, prompts, n_new, res, pair, **kw) -> dict:
    """Serve the same drive on the CPU (every kernel's plain version) with
    the same weights and compare the streams.  Printed, not asserted: f32
    logits of the card and the CPU differ in the last bits, which can flip
    a draw that lands near a cdf boundary (or an H-RAD signal whose MLP
    logits lie within that noise of each other); the kernel route itself
    is held exactly by VerifyShadow."""
    cres, _, _, wall = SV.serve(pair, ecfg, prompts, n_new, device="cpu",
                                **kw)
    first = {}
    for i in range(len(prompts)):
        a, b = res[i].tokens, cres[i].tokens
        first[i] = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                        None if len(a) == len(b) else min(len(a), len(b)))
    same = sum(v is None for v in first.values())
    stats = sum(res[i].stats == cres[i].stats for i in range(len(prompts)))
    sig = sum(res[i].stats.hrad_signals == cres[i].stats.hrad_signals
              for i in range(len(prompts)))
    log(f"  {name} vs the same serve on the CPU ({wall:.1f}s): "
        f"{same}/{len(prompts)} streams equal, {stats} GenStats equal, "
        f"{sig} H-RAD signal sequences equal, first divergence by request "
        f"{first}")
    return dict(streams_equal=same, stats_equal=stats, signals_equal=sig,
                first_divergence=first)


def teacher_forced(tp, tcfg, prompts, res, greedy, n_new) -> dict:
    """Teacher-forced check of a greedy serve: one cache-less target
    forward over each prompt plus its served tokens; every served token
    must be the argmax there, or within TF_MARGIN of the top logit.  Also
    reads, for each request, the first position where the served stream
    leaves the AR greedy decode and the top-2 logit gap there, and a noise
    yardstick: the largest change of those logits when the same forward
    runs one request at a time (other shapes, other reduction order)."""
    P = len(prompts[0])
    if any(len(p) != P for p in prompts):
        raise AssertionError("teacher forcing expects equal prompt lengths")
    dev = tp["embed"].device
    seqs = torch.tensor([list(p) + res[i].tokens
                         for i, p in enumerate(prompts)], device=dev)
    with torch.no_grad():
        lg, _ = M.forward(tp, tcfg, seqs)
        lg1 = torch.cat([M.forward(tp, tcfg, seqs[i:i + 1])[0]
                         for i in range(len(prompts))])
    pred = lg[:, P - 1:P - 1 + n_new]
    if not bool(torch.isfinite(pred).all()):
        raise AssertionError("teacher forcing: non-finite logits")
    served = seqs[:, P:].long()
    gap = pred.max(-1).values - pred.gather(-1, served[..., None])[..., 0]
    top2 = pred.topk(2, -1).values
    t2 = (top2[..., 0] - top2[..., 1]).cpu()
    noise = float((lg1 - lg)[:, P - 1:P - 1 + n_new].abs().max())
    first = []
    for i in range(len(prompts)):
        j = next((j for j, (a, b) in enumerate(zip(res[i].tokens, greedy[i]))
                  if a != b), None)
        first.append(None if j is None else (j, round(float(t2[i, j]), 5)))
    out = dict(argmax=int((gap == 0).sum()), tokens=int(gap.numel()),
               max_gap=float(gap.max()), noise=noise, margin=TF_MARGIN,
               first_divergence=first)
    log(f"  full greedy teacher-forced: {out['argmax']}/{out['tokens']} "
        f"served tokens are the argmax, max gap to the top logit "
        f"{out['max_gap']:.5f} (margin {TF_MARGIN}), noise yardstick "
        f"{noise:.5f}; first divergence from AR and top-2 gap there by "
        f"request: {first}")
    if not out["max_gap"] <= TF_MARGIN:
        raise AssertionError(f"full greedy: a served token lies "
                             f"{out['max_gap']} below the top logit")
    return out


def busy_profile(run) -> dict:
    """Run ``run()`` under the CUDA profiler: the share of the wall window
    in which the card ran a kernel or copy (the union of their intervals
    over the host-clock wall time, profiler overhead included) and the
    device time by kernel name."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    busy, end, by_name = 0, None, {}
    for s, e in sorted((e.start_ns(), e.end_ns()) for e in evs):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    for e in evs:
        by_name[e.name()[:60]] = by_name.get(e.name()[:60], 0) \
            + e.duration_ns()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    # the attention kernels by their addressing struct (the same names in
    # the parent's tile loops, so an A/B reads both)
    paged = [e.duration_ns() for e in evs if "PagedKeys" in e.name()]
    flash = [e.duration_ns() for e in evs if "DenseKeys" in e.name()]
    # the scan (both entries) and the batched verify, by kernel name (the
    # same names in the parent's kernels)
    scan = [e.duration_ns() for e in evs if "ssm_scan_kernel" in e.name()]
    verify = [e.duration_ns() for e in evs
              if "verify_accept_batched_kernel" in e.name()]
    return dict(wall_s=wall, busy_share=busy / 1e9 / wall,
                device_s=sum(by_name.values()) / 1e9,
                top=[(n, t / 1e9) for n, t in top],
                paged_ms=sum(paged) / 1e6, paged_launches=len(paged),
                flash_ms=sum(flash) / 1e6, flash_launches=len(flash),
                scan_ms=sum(scan) / 1e6, scan_launches=len(scan),
                verify_ms=sum(verify) / 1e6, verify_launches=len(verify))


def ring_glue_profile(run, ring_shapes) -> dict:
    """Run ``run()`` under the profiler with CPU ops and their input
    shapes: by kernel name, the device time and launches of the kernels
    that PyTorch ops launch on a checkpoint ring (an op whose first
    input has one of ``ring_shapes``, one layer's h_ring): the gather of
    the initial state and the index_put of the checkpoints that the ring
    entry of the scan replaced."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        run()
        torch.cuda.synchronize()
    shapes = {tuple(x) for x in ring_shapes}
    by_kernel = {}
    for ev in prof.events():
        ins = getattr(ev, "input_shapes", None) or []
        if not ins or tuple(ins[0]) not in shapes:
            continue
        for k in getattr(ev, "kernels", []):
            name = f"{ev.name}: {k.name[:50]}"
            ms, n = by_kernel.get(name, (0.0, 0))
            by_kernel[name] = (ms + k.duration / 1e3, n + 1)
    return dict(ms=sum(v[0] for v in by_kernel.values()),
                launches=sum(v[1] for v in by_kernel.values()),
                by_kernel=by_kernel)


def ring_shapes(eng) -> list:
    """One layer's h_ring shape in each of an engine's decoders."""
    return sorted({tuple(c["h_ring"].shape[1:])
                   for dec in (eng.tgt_dec, eng.dft_dec)
                   for c in M.iter_slots(dec.cache) if "h_ring" in c})


def log_ring(prof, glue) -> None:
    log(f"    ssm_scan kernels: {prof['scan_ms']:.2f} ms device time over "
        f"{prof['scan_launches']} launches; PyTorch kernels on the h "
        f"rings: {glue['ms']:.2f} ms over {glue['launches']} launches; "
        f"scan + ring {prof['scan_ms'] + glue['ms']:.2f} ms")
    for name, (ms, n) in sorted(glue["by_kernel"].items(),
                                key=lambda kv: -kv[1][0]):
        log(f"      {ms:8.3f} ms {n:5d}x  {name}")


class RingCensus:
    """While active, counts the ring scan's calls by (lanes, T, E, ring
    depth, ring rows)."""

    def __enter__(self):
        from collections import Counter
        self.shapes = Counter()
        self._orig = ops.ssm_scan_ring

        def spy(x, dt, Bm, Cm, A, D, h_ring, p0, rows=None):
            self.shapes[tuple(x.shape) + (h_ring.shape[1],
                                          h_ring.shape[0])] += 1
            return self._orig(x, dt, Bm, Cm, A, D, h_ring, p0, rows)
        ops.ssm_scan_ring = spy
        return self

    def __exit__(self, *exc):
        ops.ssm_scan_ring = self._orig
        return False


def log_paged(prof) -> None:
    log(f"    paged_attention kernel: {prof['paged_ms']:.2f} ms device time "
        f"over {prof['paged_launches']} launches")


def log_flash(prof) -> None:
    log(f"    flash_attention kernel: {prof['flash_ms']:.2f} ms device time "
        f"over {prof['flash_launches']} launches")


def phase_profile(dev) -> dict:
    """``--profile``: phase 4's profiled greedy serve (full-width
    LLaMA-68M/7B, 8 requests x 8 new tokens), phase 6's profiled
    sequential SpecBranch serve (2 requests x 8 new tokens), the batched
    LLaMA serve at temperature 1 (the verify kernel's device time) and
    phase 8's falcon-mamba-7b batched greedy serve (the scan kernels'
    device time and the PyTorch kernels on its checkpoint rings), each
    after one unprofiled serve, twice; with ``--src`` against another
    checkout's port."""
    pair = SV.load_pair("paper-llama", dev)
    prompts = SV.make_prompts(8)
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0,
                        max_len=SV.auto_max_len(prompts, 32, 4, 10.0))
    SV.serve(pair, ecfg, prompts, 8, device=dev)
    out = []
    for _ in range(2):
        prof = busy_profile(lambda: SV.serve(pair, ecfg, prompts, 8,
                                             device=dev))
        log(f"  profile: card busy {prof['busy_share']:.3f} of "
            f"{prof['wall_s']:.2f}s wall, device {prof['device_s']:.4f}s")
        log_paged(prof)
        out.append(prof)
    # the sequential serve runs flash on every attention call (dense ring)
    sprompts = SV.make_prompts(2)
    secfg = EngineConfig(gamma=4, c=10.0, temperature=0.0,
                         max_len=SV.auto_max_len(sprompts, 32, 4, 10.0))

    def seq():
        done, _, wall = SV.serve_sequential(pair, secfg, "specbranch",
                                            sprompts, 8)
        toks = sum(len(r.result.tokens) for r in done)
        log(f"  seq serve: {toks} tokens, {toks / wall:.2f} wall tokens/s")
    seq()
    for _ in range(2):
        prof = busy_profile(seq)
        log(f"  seq profile: card busy {prof['busy_share']:.3f} of "
            f"{prof['wall_s']:.2f}s wall, device {prof['device_s']:.4f}s")
        log_flash(prof)
        out.append(prof)
    # the paged kernel at the serve's shapes (tables as wide as its
    # longest request), with its inputs in L2 as a forward leaves them,
    # and after the default dirty flush
    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    for label, case in (
            ("7B B=8 T=1", (8, 1, 32, 32, 128)),
            ("7B B=8 T=5", (8, 5, 32, 32, 128)),
            ("68M B=8 T=1", (8, 1, 12, 12, 64))):
        args = attn_case(rng, *case, 16, bf, n_max=32)
        t = {f: time_ms(lambda: PA.paged_attention(*args), flush=f)
             for f in ("none", "dirty")}
        log(f"  paged {label} 32-page table: {t['none']:.4f} ms warm, "
            f"{t['dirty']:.4f} ms after the dirty flush")
    # flash at the sequential serve's shapes: a 512-slot ring early in a
    # request, the 7B verify chunk, the fork and the 68M draft tick
    for label, case in (
            ("7B B=1 T=5 S=512 L=40", (1, 5, 512, 32, 32, 128, 40)),
            ("7B B=6 T=1 S=512 L=41", (6, 1, 512, 32, 32, 128, 41)),
            ("68M B=1 T=1 S=512 L=40", (1, 1, 512, 12, 12, 64, 40))):
        args = flash_case(rng, *case, bf)
        t = {f: time_ms(lambda: FA.flash_attention(*args), flush=f)
             for f in ("none", "dirty")}
        log(f"  flash {label}: {t['none']:.4f} ms warm, "
            f"{t['dirty']:.4f} ms after the dirty flush")
    # the batched LLaMA serve at temperature 1 (epsilon 0, so that the
    # drafted chains reach the verify kernel)
    tecfg = EngineConfig(gamma=4, c=10.0, temperature=1.0, epsilon=0.0,
                         max_len=SV.auto_max_len(prompts, 32, 4, 10.0))
    SV.serve(pair, tecfg, prompts, 8, device=dev)
    for _ in range(2):
        prof = busy_profile(lambda: SV.serve(pair, tecfg, prompts, 8,
                                             device=dev))
        log(f"  temp1 profile: card busy {prof['busy_share']:.3f} of "
            f"{prof['wall_s']:.2f}s wall, device {prof['device_s']:.4f}s")
        log(f"    verify_accept_batched kernel: {prof['verify_ms']:.2f} ms "
            f"device time over {prof['verify_launches']} launches")
        out.append(prof)
    # the falcon-mamba-7b batched greedy serve: the scan and the PyTorch
    # kernels on its checkpoint rings
    del pair
    free_device_memory()
    fpair = SV.load_pair("falcon-mamba-7b", dev)
    fecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0,
                         max_len=SV.auto_max_len(prompts, 32, 4, 10.0))
    _res, _rep, eng, _wall = SV.serve(fpair, fecfg, prompts, 8, device=dev)
    shapes = ring_shapes(eng)
    del eng
    free_device_memory()
    for _ in range(2):
        prof = busy_profile(lambda: SV.serve(fpair, fecfg, prompts, 8,
                                             device=dev))
        glue = ring_glue_profile(lambda: SV.serve(fpair, fecfg, prompts, 8,
                                                  device=dev), shapes)
        log(f"  falcon profile: card busy {prof['busy_share']:.3f} of "
            f"{prof['wall_s']:.2f}s wall, device {prof['device_s']:.4f}s")
        log_ring(prof, glue)
        out.append(dict(prof, ring=glue))
    return out


def phase_full(dev, totals, pair) -> dict:
    prompts = SV.make_prompts(8)
    n_new = 32
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    with torch.no_grad():
        lg, _ = M.forward(pair[2], pair[3],
                          torch.tensor(prompts, device=dev))
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError("full width: non-finite target logits")
    greedy = M.greedy_reference(pair[2], pair[3], prompts, n_new)
    out = {}
    for name, temp, eps in (("greedy", 0.0, EPS), ("temp1", 1.0, EPS),
                            ("temp1-chains", 1.0, 0.0)):
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp,
                            epsilon=eps, max_len=max_len)
        with VerifyShadow() as sh:
            res, rep, counts, wall, _ = drive(pair, ecfg, prompts, n_new,
                                              dev)
        for k, v in counts.items():
            totals[k] += v
        toks = sum(len(r.tokens) for r in res.values())
        agree = sum(a == b for i in range(len(prompts))
                    for a, b in zip(res[i].tokens, greedy[i]))
        mean_acc = float(np.mean([r.stats.mean_accepted
                                  for r in res.values()]))
        log(f"  full {name}: {toks / wall:.1f} tok/s wall, "
            f"rounds={rep['rounds']}, mean accepted={mean_acc:.2f}, "
            f"greedy agreement={agree}/{toks}, launches={counts}")
        if counts["paged_attention"] == 0:
            raise AssertionError(f"full {name}: paged_attention not run")
        if temp > 0 and counts["verify_accept_batched"] == 0:
            raise AssertionError(f"full {name}: verify kernel not launched")
        out[name] = dict(tokens_per_s=toks / wall, wall_s=wall,
                         rounds=rep["rounds"], mean_accepted=mean_acc,
                         greedy_agreement=agree, tokens=toks,
                         launches=counts)
        if temp == 0.0:
            out["teacher_forced"] = teacher_forced(pair[2], pair[3], prompts,
                                                   res, greedy, n_new)
        else:
            check_shadow(f"full {name}", sh, counts, chains=eps == 0.0)
    # where the time goes: one profiled greedy serve (8 new tokens)
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0, max_len=max_len)
    prof = busy_profile(lambda: SV.serve(pair, ecfg, prompts, 8,
                                         device=dev))
    log(f"  full profile: card busy {prof['busy_share']:.3f} of "
        f"{prof['wall_s']:.2f}s wall; device time by kernel:")
    for n, t in prof["top"]:
        log(f"    {t * 1e3:9.2f} ms  {n}")
    log_paged(prof)
    out["profile"] = prof
    return out


# ---------------------------------------------------------------------------
# phases 5-6: the sequential engines
# ---------------------------------------------------------------------------

SEQ_ENGINES = ["autoregressive", "sps", "adaedl", "confidence-sd",
               "lookahead", "pearl", "specbranch"]
# engines the CLI does not list, served by their class
UNLISTED = {"confidence-sd": TE.ConfidenceSDEngine}


def seq_drive(pair, ecfg, engine, prompts, n_new, totals=None,
              need=("flash_attention",), hrad_params=None,
              draft_heads=None):
    """One sequential main-path drive through ``serve.serve_sequential``
    (the confidence-SD baseline, which the CLI does not list, by its class)
    with the launch counters zeroed just before and read just after; each
    kernel in ``need`` must have launched."""
    ops.reset_launches()
    done, _, wall = SV.serve_sequential(
        pair, ecfg, UNLISTED.get(engine, engine), prompts, n_new,
        hrad_params=hrad_params, draft_heads=draft_heads)
    counts = dict(ops.LAUNCHES)
    if totals is not None:
        for k, v in counts.items():
            totals[k] += v
    res = {r.rid: r.result for r in done}
    for rid, r in res.items():
        if len(r.tokens) != n_new:
            raise AssertionError(f"{engine} request {rid} got "
                                 f"{len(r.tokens)} tokens")
    for k in need:
        if counts[k] == 0:
            raise AssertionError(f"{engine}: {k} not run")
    return res, counts, wall


def phase_seq_tiny(dev, totals) -> dict:
    from repro_torch.training.pairs import get_pair
    cache_dir = os.path.join(ROOT, ".cache", "pairs")
    pair = get_pair("misaligned", device=dev, cache_dir=cache_dir)
    prompts = SV.make_prompts(2)
    n_new = 32
    greedy = [RN.greedy_reference(pair[2], pair[3], p, n_new, max_len=512)
              for p in prompts]
    out = {}
    for name in SEQ_ENGINES:
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0, max_len=512)
        res, counts, wall = seq_drive(pair, ecfg, name, prompts, n_new,
                                      totals)
        bad = [i for i in range(len(prompts)) if res[i].tokens != greedy[i]]
        log(f"  seq tiny {name} greedy: wall={wall:.2f}s "
            f"launches={counts['flash_attention']}")
        if bad:
            raise AssertionError(f"seq tiny {name}: requests {bad} differ "
                                 "from the AR greedy decode")
        out[name] = dict(wall_s=wall, launches=counts)
    cpu = get_pair("misaligned", device="cpu", cache_dir=cache_dir)
    for name in ("sps", "specbranch"):
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=1.0, max_len=512)
        res, counts, wall = seq_drive(pair, ecfg, name, prompts, n_new,
                                      totals)
        cres, _, cwall = SV.serve_sequential(cpu, ecfg, name, prompts,
                                             n_new)
        first = {}
        for r in cres:
            a, b = res[r.rid].tokens, r.result.tokens
            first[r.rid] = next((j for j, (x, y) in enumerate(zip(a, b))
                                 if x != y), None)
        same = sum(v is None for v in first.values())
        stats = sum(res[r.rid].stats == r.result.stats for r in cres)
        log(f"  seq tiny {name} temp1 vs the same serve on the CPU "
            f"({cwall:.1f}s): {same}/{len(prompts)} streams equal, {stats} "
            f"GenStats equal, first divergence by request {first}")
        out[name + " temp1"] = dict(wall_s=wall, launches=counts,
                                    streams_equal=same, stats_equal=stats)
    return out


def phase_seq_full(dev, totals, pair) -> dict:
    prompts = SV.make_prompts(2)
    n_new = 32
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    greedy = [RN.greedy_reference(pair[2], pair[3], p, n_new,
                                  max_len=max_len) for p in prompts]
    out = {}
    for name, temp, eps in (("autoregressive", 0.0, EPS),
                            ("sps", 0.0, EPS), ("specbranch", 0.0, EPS),
                            ("specbranch", 1.0, 0.0)):
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp,
                            epsilon=eps, max_len=max_len)
        res, counts, wall = seq_drive(pair, ecfg, name, prompts, n_new,
                                      totals)
        toks = sum(len(r.tokens) for r in res.values())
        rounds = sum(len(r.timeline) for r in res.values())
        mean_acc = float(np.mean([r.stats.mean_accepted
                                  for r in res.values()]))
        label = f"{name} t={temp:g}"
        log(f"  seq full {label}: {toks / wall:.1f} tok/s wall, "
            f"rounds={rounds}, mean accepted={mean_acc:.2f}, "
            f"flash launches={counts['flash_attention']}")
        out[label] = dict(tokens_per_s=toks / wall, wall_s=wall,
                          rounds=rounds, mean_accepted=mean_acc,
                          launches=counts)
        if temp == 0.0:
            out[label]["teacher_forced"] = teacher_forced(
                pair[2], pair[3], prompts, res, greedy, n_new)
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0, max_len=max_len)
    prof = busy_profile(lambda: SV.serve_sequential(pair, ecfg, "specbranch",
                                                    prompts, 8))
    log(f"  seq full profile (specbranch, 8 new tokens): card busy "
        f"{prof['busy_share']:.3f} of {prof['wall_s']:.2f}s wall; device "
        "time by kernel:")
    for n, t in prof["top"]:
        log(f"    {t * 1e3:9.2f} ms  {n}")
    log_flash(prof)
    out["profile"] = prof
    return out


# ---------------------------------------------------------------------------
# phases 7-8: SSM and hybrid serving
# ---------------------------------------------------------------------------

def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


class CountRestores:
    """Counts ring-snapshot restores (``BatchedDecoder.restore``) while
    active."""

    def __init__(self):
        from repro_torch.serving import batched_engine as BE
        self.cls, self.n = BE.BatchedDecoder, 0
        self._orig = self.cls.restore

    def __enter__(self):
        orig = self._orig

        def restore(dec, *a):
            self.n += 1
            return orig(dec, *a)
        self.cls.restore = restore
        return self

    def __exit__(self, *exc):
        self.cls.restore = self._orig


def phase_hybrid(dev, totals) -> dict:
    from repro_torch.training.pairs import HYBRID_KINDS
    prompts = SV.make_prompts(4)
    n_new = 32
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    out = {}
    for kind in HYBRID_KINDS:
        pair = SV.load_pair(kind, dev)
        cpu = tree_to(pair, "cpu")
        attn = kind == "jamba-shaped"
        need = ["ssm_scan_ring"] + (["paged_attention"] if attn else [])
        greedy = M.greedy_reference(pair[2], pair[3], prompts, n_new)
        drives = [("greedy", 0.0, EPS, {}), ("temp1", 1.0, EPS, {}),
                  ("temp1-chains", 1.0, 0.0, {})]
        if attn:
            drives.append(("preempt", 0.0, EPS,
                           dict(page_size=4, pool_pages=160)))
        for name, temp, eps, kw in drives:
            label = f"{kind} {name}"
            ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp,
                                epsilon=eps, max_len=max_len)
            with VerifyShadow() as sh, CountRestores() as cr:
                res, rep, counts, wall, eng = drive(pair, ecfg, prompts,
                                                    n_new, dev, **kw)
            for k, v in counts.items():
                totals[k] += v
            log(f"  {label}: rounds={rep['rounds']} "
                f"preemptions={rep['preemptions']} ring restores={cr.n} "
                f"wall={wall:.2f}s launches={counts}")
            for k in need + (["verify_accept_batched"] if temp > 0 else []):
                if counts[k] == 0:
                    raise AssertionError(f"{label}: {k} not launched")
            if temp > 0:
                check_shadow(label, sh, counts, chains=eps == 0.0)
                out[label + " cpu"] = compare_cpu(label, ecfg, prompts,
                                                  n_new, res, cpu)
            else:
                bad = [i for i in range(len(prompts))
                       if res[i].tokens != greedy[i]]
                if bad:
                    raise AssertionError(f"{label}: requests {bad} differ "
                                         "from greedy decoding")
            if name == "preempt" and (rep["preemptions"] == 0
                                      or counts["paged_gather"] == 0
                                      or eng.swap is None or cr.n == 0):
                raise AssertionError(f"{label}: no preemption, swap-in or "
                                     "ring restore")
            out[label] = dict(rounds=rep["rounds"], wall_s=wall,
                              preemptions=rep["preemptions"],
                              ring_restores=cr.n, launches=counts)
        sprompts = prompts[:2]
        ar = [RN.greedy_reference(pair[2], pair[3], p, n_new, max_len=512)
              for p in sprompts]
        for engine in ("sps", "specbranch"):
            ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0,
                                max_len=512)
            res, counts, wall = seq_drive(
                pair, ecfg, engine, sprompts, n_new, totals,
                need=["ssm_scan"] + (["flash_attention"] if attn else []))
            bad = [i for i in range(len(sprompts))
                   if res[i].tokens != ar[i]]
            log(f"  {kind} seq {engine} greedy: wall={wall:.2f}s "
                f"launches={counts}")
            if bad:
                raise AssertionError(f"{kind} seq {engine}: requests {bad} "
                                     "differ from the AR greedy decode")
            out[f"{kind} seq {engine}"] = dict(wall_s=wall, launches=counts)
    return out


def free_device_memory() -> None:
    """Drop what earlier phases left: an engine's pools hold its decoders'
    COW listeners (a reference cycle), so an engine, and the weights it
    holds, go only when the cycle collector runs."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_falcon(dev, totals) -> dict:
    from repro_torch.configs import falcon_mamba_7b
    free_device_memory()
    base = torch.cuda.memory_allocated()
    pair = SV.load_pair("falcon-mamba-7b", dev)
    tcfg = pair[3]
    if (tcfg.num_layers, tcfg.d_model) != (64, 4096) \
            or tcfg != falcon_mamba_7b.CONFIG:
        raise AssertionError("falcon-mamba-7b is not at full width")
    wbytes = tree_bytes(pair[0]) + tree_bytes(pair[2])
    log(f"  weights: target {tree_bytes(pair[2]) / 1e9:.2f} GB, draft "
        f"{tree_bytes(pair[0]) / 1e9:.3f} GB "
        f"({(torch.cuda.memory_allocated() - base) / 1e9:.2f} GB allocated)")
    prompts = SV.make_prompts(8)
    n_new = 32
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    with torch.no_grad():
        lg, _ = M.forward(pair[2], tcfg, torch.tensor(prompts, device=dev))
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError("falcon: non-finite target logits")
    greedy = M.greedy_reference(pair[2], tcfg, prompts, n_new)
    out = {"weights_gb": wbytes / 1e9}
    for name, temp, eps in (("greedy", 0.0, EPS), ("temp1-chains", 1.0, 0.0)):
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp, epsilon=eps,
                            max_len=max_len)
        torch.cuda.reset_peak_memory_stats()
        with VerifyShadow() as sh, RingCensus() as census:
            res, rep, counts, wall, eng = drive(pair, ecfg, prompts, n_new,
                                                dev)
        peak = torch.cuda.max_memory_allocated()
        rings = tree_bytes(eng.tgt_dec.cache) + tree_bytes(eng.dft_dec.cache)
        shapes = ring_shapes(eng)
        del eng
        free_device_memory()
        for k, v in counts.items():
            totals[k] += v
        toks = sum(len(r.tokens) for r in res.values())
        mean_acc = float(np.mean([r.stats.mean_accepted
                                  for r in res.values()]))
        log(f"  falcon {name}: {toks / wall:.1f} tok/s wall, "
            f"rounds={rep['rounds']}, mean accepted={mean_acc:.2f}, "
            f"ssm_scan_ring launches={counts['ssm_scan_ring']}, "
            f"launches={counts}; rings {rings / 1e9:.2f} GB, peak "
            f"allocated {peak / 1e9:.2f} GB")
        log(f"  falcon {name} ring scans by (lanes, T, E, Rg, rows): "
            f"{dict(census.shapes.most_common())}")
        if counts["ssm_scan_ring"] == 0:
            raise AssertionError(f"falcon {name}: ssm_scan_ring not "
                                 "launched")
        if census.shapes[(8, 16, 8192, FALCON_RING, 8)] == 0:
            raise AssertionError(f"falcon {name}: the serve never ran the "
                                 f"ring scan at phase 2's shape "
                                 f"({FALCON_RING_CASE})")
        out[name] = dict(tokens_per_s=toks / wall, wall_s=wall,
                         rounds=rep["rounds"], mean_accepted=mean_acc,
                         tokens=toks, launches=counts, rings_gb=rings / 1e9,
                         peak_gb=peak / 1e9)
        if temp == 0.0:
            out["teacher_forced"] = teacher_forced(pair[2], tcfg, prompts,
                                                   res, greedy, n_new)
        else:
            if counts["verify_accept_batched"] == 0:
                raise AssertionError("falcon temp1: verify not launched")
            check_shadow(f"falcon {name}", sh, counts, chains=True)
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0, max_len=max_len)
    prof = busy_profile(lambda: SV.serve(pair, ecfg, prompts, 8,
                                         device=dev))
    log(f"  falcon profile (greedy, 8 new tokens): card busy "
        f"{prof['busy_share']:.3f} of {prof['wall_s']:.2f}s wall; device "
        "time by kernel:")
    for n, t in prof["top"]:
        log(f"    {t * 1e3:9.2f} ms  {n}")
    glue = ring_glue_profile(lambda: SV.serve(pair, ecfg, prompts, 8,
                                              device=dev), shapes)
    log_ring(prof, glue)
    out["profile"] = dict(prof, ring=glue)
    return out


# ---------------------------------------------------------------------------
# phases 9-10: H-RAD hybrid drafting and batched SpS
# ---------------------------------------------------------------------------

def hrad_mlp(tcfg, dev):
    """The untrained H-RAD MLP of phases 9-10, drawn on the CPU under
    HRAD_SEED (so the card and the CPU get the same parameters)."""
    return H.init_mlp((EngineConfig.hrad_k_layers + 1) * tcfg.d_model,
                      generator=torch.Generator().manual_seed(HRAD_SEED),
                      device=dev)


def signal_hist(results) -> list:
    hist = [0, 0, 0]
    for r in results:
        for s in r.stats.hrad_signals:
            hist[s] += 1
    return hist


def phase_hrad_tiny(dev, totals) -> dict:
    from repro_torch.training.pairs import get_pair
    pair = get_pair("misaligned", device=dev,
                    cache_dir=os.path.join(ROOT, ".cache", "pairs"))
    cpu = cpu_pair()
    hp, hp_cpu = hrad_mlp(pair[3], dev), hrad_mlp(cpu[3], "cpu")
    prompts = SV.make_prompts(4)
    n_new = 48
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    greedy = M.greedy_reference(pair[2], pair[3], prompts, n_new)
    hist = [0, 0, 0]
    out = {}
    for name, engine, temp, kw in (
            ("sps greedy", "sps", 0.0, {}),
            ("sps temp1", "sps", 1.0, {}),
            ("hrad greedy", "specbranch", 0.0, {}),
            ("hrad preempt", "specbranch", 0.0,
             dict(page_size=4, pool_pages=200)),
            ("hrad temp1", "specbranch", 1.0, {})):
        label = f"tiny {name}"
        hrad = engine == "specbranch"
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp, max_len=max_len)
        with VerifyShadow() as sh:
            res, rep, counts, wall, _ = drive(
                pair, ecfg, prompts, n_new, dev, engine=engine,
                hrad_params=hp if hrad else None, **kw)
        for k, v in counts.items():
            totals[k] += v
        h = signal_hist(res.values())
        hist = [a + b for a, b in zip(hist, h)]
        log(f"  {label}: rounds={rep['rounds']} "
            f"preemptions={rep['preemptions']} s_t histogram={h} "
            f"wall={wall:.2f}s launches={counts}")
        if counts["paged_attention"] == 0:
            raise AssertionError(f"{label}: paged_attention not run")
        if temp > 0:
            if counts["verify_accept_batched"] == 0:
                raise AssertionError(f"{label}: verify kernel not launched")
            # SpS drafts gamma tokens every round: its chains always reach
            # the kernel
            check_shadow(label, sh, counts, chains=engine == "sps")
            out[name + " cpu"] = compare_cpu(
                label, ecfg, prompts, n_new, res, cpu, engine=engine,
                hrad_params=hp_cpu if hrad else None)
        else:
            bad = [i for i in range(len(prompts))
                   if res[i].tokens != greedy[i]]
            if bad:
                raise AssertionError(f"{label}: requests {bad} differ from "
                                     "greedy decoding")
        if name == "hrad preempt" and (rep["preemptions"] == 0
                                       or counts["paged_gather"] == 0):
            raise AssertionError(f"{label}: no preemption / swap-in")
        out[name] = dict(rounds=rep["rounds"], preemptions=rep["preemptions"],
                         signals=h, wall_s=wall, launches=counts)
    sprompts = prompts[:2]
    ar = [RN.greedy_reference(pair[2], pair[3], p, 32, max_len=512)
          for p in sprompts]
    for temp in (0.0, 1.0):
        label = f"tiny seq hrad t={temp:g}"
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp, max_len=512)
        res, counts, wall = seq_drive(pair, ecfg, "specbranch", sprompts,
                                      32, totals, hrad_params=hp)
        h = signal_hist(res.values())
        hist = [a + b for a, b in zip(hist, h)]
        log(f"  {label}: s_t histogram={h} wall={wall:.2f}s "
            f"flash launches={counts['flash_attention']}")
        if temp == 0.0:
            bad = [i for i in range(len(sprompts))
                   if res[i].tokens != ar[i]]
            if bad:
                raise AssertionError(f"{label}: requests {bad} differ from "
                                     "the AR greedy decode")
        else:
            cres, _, _ = SV.serve_sequential(cpu, ecfg, "specbranch",
                                             sprompts, 32,
                                             hrad_params=hp_cpu)
            same = sum(res[r.rid].tokens == r.result.tokens for r in cres)
            sig = sum(res[r.rid].stats.hrad_signals
                      == r.result.stats.hrad_signals for r in cres)
            log(f"  {label} vs the same serve on the CPU: {same}/"
                f"{len(sprompts)} streams equal, {sig} signal sequences "
                "equal")
        out[label] = dict(signals=h, wall_s=wall, launches=counts)
    log(f"  tiny s_t histogram over phase 9 (all-reject, confidence, "
        f"all-accept): {hist}")
    if min(hist) == 0:
        raise AssertionError(f"tiny H-RAD: a signal class never occurred "
                             f"({hist})")
    out["signals"] = hist
    return out


def phase_hrad_full(dev, totals, pair, without) -> dict:
    """``without``: phase 4's and phase 6's results, the same serves
    without H-RAD, printed beside."""
    prompts = SV.make_prompts(8)
    n_new = 32
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    greedy = M.greedy_reference(pair[2], pair[3], prompts, n_new)
    hp = hrad_mlp(pair[3], dev)
    out = {}
    for name, engine, temp, hrad in (("sps greedy", "sps", 0.0, None),
                                     ("sps temp1", "sps", 1.0, None),
                                     ("specbranch+hrad greedy", "specbranch",
                                      0.0, hp)):
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp,
                            max_len=max_len)
        torch.cuda.reset_peak_memory_stats()
        with VerifyShadow() as sh:
            res, rep, counts, wall, eng = drive(
                pair, ecfg, prompts, n_new, dev, engine=engine,
                hrad_params=hrad)
        peak = torch.cuda.max_memory_allocated()
        del eng
        free_device_memory()
        for k, v in counts.items():
            totals[k] += v
        toks = sum(len(r.tokens) for r in res.values())
        mean_acc = float(np.mean([r.stats.mean_accepted
                                  for r in res.values()]))
        prof = busy_profile(lambda: SV.serve(
            pair, ecfg, prompts, 8, device=dev, engine=engine,
            hrad_params=hrad))
        h = signal_hist(res.values())
        log(f"  full {name}: {toks / wall:.1f} tok/s wall, "
            f"rounds={rep['rounds']}, mean accepted={mean_acc:.2f}, "
            f"s_t histogram={h}, peak allocated {peak / 1e9:.2f} GB, "
            f"profiled 8-token serve busy {prof['busy_share']:.3f} of "
            f"{prof['wall_s']:.2f}s, launches={counts}")
        log_paged(prof)
        if counts["paged_attention"] == 0:
            raise AssertionError(f"full {name}: paged_attention not run")
        out[name] = dict(tokens_per_s=toks / wall, wall_s=wall,
                         rounds=rep["rounds"], mean_accepted=mean_acc,
                         signals=h, peak_gb=peak / 1e9,
                         busy_share=prof["busy_share"], launches=counts)
        if temp == 0.0:
            out[name]["teacher_forced"] = teacher_forced(
                pair[2], pair[3], prompts, res, greedy, n_new)
        else:
            if counts["verify_accept_batched"] == 0:
                raise AssertionError(f"full {name}: verify not launched")
            check_shadow(f"full {name}", sh, counts, chains=True)
    sprompts = prompts[:2]
    ar = [RN.greedy_reference(pair[2], pair[3], p, n_new, max_len=max_len)
          for p in sprompts]
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0, max_len=max_len)
    torch.cuda.reset_peak_memory_stats()
    res, counts, wall = seq_drive(pair, ecfg, "specbranch", sprompts, n_new,
                                  totals, hrad_params=hp)
    peak = torch.cuda.max_memory_allocated()
    toks = sum(len(r.tokens) for r in res.values())
    rounds = sum(len(r.timeline) for r in res.values())
    mean_acc = float(np.mean([r.stats.mean_accepted for r in res.values()]))
    prof = busy_profile(lambda: SV.serve_sequential(
        pair, ecfg, "specbranch", sprompts, 8, hrad_params=hp))
    h = signal_hist(res.values())
    log(f"  full seq specbranch+hrad greedy: {toks / wall:.1f} tok/s wall, "
        f"rounds={rounds}, mean accepted={mean_acc:.2f}, s_t histogram={h}, "
        f"peak allocated {peak / 1e9:.2f} GB, profiled 8-token serve busy "
        f"{prof['busy_share']:.3f} of {prof['wall_s']:.2f}s")
    out["seq specbranch+hrad greedy"] = dict(
        tokens_per_s=toks / wall, wall_s=wall, rounds=rounds,
        mean_accepted=mean_acc, signals=h, peak_gb=peak / 1e9,
        busy_share=prof["busy_share"], launches=counts,
        teacher_forced=teacher_forced(pair[2], pair[3], sprompts, res, ar,
                                      n_new))
    b, q = without["batched"]["greedy"], without["seq"]["specbranch t=0"]
    log(f"  without H-RAD in this run (not a claim): batched specbranch "
        f"greedy {b['tokens_per_s']:.1f} tok/s, {b['rounds']} rounds "
        f"(phase 4); sequential specbranch greedy {q['tokens_per_s']:.1f} "
        f"tok/s, {q['rounds']} rounds (phase 6)")
    return out


# ---------------------------------------------------------------------------
# phases 11-12: the dense backend and the trace recorder
# ---------------------------------------------------------------------------

def first_diff(a, b) -> dict:
    """Per request, the first index where two served streams differ (None
    where they are equal)."""
    return {i: next((j for j, (x, y) in enumerate(zip(a[i].tokens,
                                                      b[i].tokens))
                     if x != y), None if len(a[i].tokens)
                    == len(b[i].tokens) else 0) for i in a}


def phase_dense_tiny(dev, totals) -> dict:
    """Batched SpecBranch and SpS on the dense backend, tiny committed
    pair: every drive's streams must equal the same serve on the CPU
    (dense) and the card's own paged serve (the reference's oracle);
    greedy streams the target's greedy decode; temperature-1 verdicts are
    shadowed as in phase 3; the SpecBranch preempting pool must swap and
    read the swap back through the gather kernel.  Then the jamba-shaped
    hybrid on the dense backend, whose preempted rows recompute their
    prefix (a dense hybrid row is not swappable, as in the reference)."""
    from repro_torch.training.pairs import get_pair
    pair = get_pair("misaligned", device=dev,
                    cache_dir=os.path.join(ROOT, ".cache", "pairs"))
    cpu = cpu_pair()
    prompts = SV.make_prompts(4)
    n_new = 48
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    greedy = M.greedy_reference(pair[2], pair[3], prompts, n_new)
    out = {}
    # pools that preempt (SpS splits its pages 1:1 between the decoders,
    # SpecBranch 1:7, so SpS needs a smaller total)
    for engine, pool in (("specbranch", 200), ("sps", 120)):
        for name, temp, eps, kw in (
                ("greedy", 0.0, EPS, {}), ("temp1", 1.0, EPS, {}),
                ("temp1-chains", 1.0, 0.0, {}),
                ("preempt", 0.0, EPS, dict(page_size=4, pool_pages=pool))):
            label = f"dense tiny {engine} {name}"
            ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp,
                                epsilon=eps, max_len=max_len)
            with VerifyShadow() as sh:
                res, rep, counts, wall, eng = drive(
                    pair, ecfg, prompts, n_new, dev, attn_backend="dense",
                    engine=engine, **kw)
            swap = eng.swap is not None
            del eng
            for k, v in counts.items():
                totals[k] += v
            paged = SV.serve(pair, ecfg, prompts, n_new, device=dev,
                             attn_backend="paged", engine=engine, **kw)[0]
            on_cpu = SV.serve(cpu, ecfg, prompts, n_new, device="cpu",
                              attn_backend="dense", engine=engine, **kw)[0]
            d_paged, d_cpu = first_diff(res, paged), first_diff(res, on_cpu)
            log(f"  {label}: rounds={rep['rounds']} "
                f"preemptions={rep['preemptions']} wall={wall:.2f}s "
                f"launches={counts}; first difference from the card's "
                f"paged serve {d_paged}, from the CPU dense serve {d_cpu}")
            if any(v is not None for v in d_paged.values()):
                raise AssertionError(f"{label}: streams differ from the "
                                     "paged serve")
            if any(v is not None for v in d_cpu.values()):
                raise AssertionError(f"{label}: streams differ from the "
                                     "same serve on the CPU")
            if temp == 0.0:
                bad = [i for i in range(len(prompts))
                       if res[i].tokens != greedy[i]]
                if bad:
                    raise AssertionError(f"{label}: requests {bad} differ "
                                         "from greedy decoding")
            else:
                check_shadow(label, sh, counts, chains=eps == 0.0)
                if counts["verify_accept_batched"] == 0:
                    raise AssertionError(f"{label}: verify not launched")
            if counts["flash_attention"] == 0 or counts["paged_attention"]:
                raise AssertionError(f"{label}: the dense serve must run "
                                     f"flash and not paged ({counts})")
            if name == "preempt" and (rep["preemptions"] == 0 or not swap
                                      or counts["paged_gather"] == 0):
                raise AssertionError(f"{label}: no preemption / swap-in "
                                     f"({rep['preemptions']}, {counts})")
            out[label] = dict(rounds=rep["rounds"],
                              preemptions=rep["preemptions"], wall_s=wall,
                              launches=counts)
    # the jamba-shaped hybrid on the dense backend, preempting
    jpair = SV.load_pair("jamba-shaped", dev)
    jgreedy = M.greedy_reference(jpair[2], jpair[3], prompts[:2], 32)
    jmax = SV.auto_max_len(prompts, 32, 4, 10.0)
    for name, kw in (("greedy", {}),
                     ("preempt", dict(page_size=4, pool_pages=160))):
        label = f"dense jamba-shaped {name}"
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0,
                            max_len=jmax)
        with CountRestores() as cr:
            res, rep, counts, wall, eng = drive(
                jpair, ecfg, prompts[:2], 32, dev, attn_backend="dense",
                **kw)
        swap = eng.swap is not None
        del eng
        for k, v in counts.items():
            totals[k] += v
        log(f"  {label}: rounds={rep['rounds']} "
            f"preemptions={rep['preemptions']} swap store={swap} "
            f"ring restores={cr.n} wall={wall:.2f}s launches={counts}")
        bad = [i for i in range(2) if res[i].tokens != jgreedy[i]]
        if bad:
            raise AssertionError(f"{label}: requests {bad} differ from "
                                 "greedy decoding")
        for k in ("ssm_scan_ring", "flash_attention"):
            if counts[k] == 0:
                raise AssertionError(f"{label}: {k} not launched")
        if name == "preempt" and (rep["preemptions"] == 0 or swap
                                  or cr.n):
            raise AssertionError(f"{label}: a dense hybrid must preempt by "
                                 "recompute (no swap store, no restore)")
        out[label] = dict(rounds=rep["rounds"], wall_s=wall,
                          preemptions=rep["preemptions"], launches=counts)
    return out


def phase_dense_full(dev, totals, pair, paged_prof) -> dict:
    """The full-width LLaMA-68M/7B pair on the dense backend: batched
    SpecBranch 8 x 32 greedy, teacher-forced as in phase 4; a profiled
    8-token serve's flash launches and device time beside phase 4's paged
    figures (``paged_prof``); what a SpecBranch fork copies (the draft
    decoder's row, on the dense backend) and what that costs."""
    prompts = SV.make_prompts(8)
    n_new = 32
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    greedy = M.greedy_reference(pair[2], pair[3], prompts, n_new)
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0, max_len=max_len)
    torch.cuda.reset_peak_memory_stats()
    res, rep, counts, wall, eng = drive(pair, ecfg, prompts, n_new, dev,
                                        attn_backend="dense")
    peak = torch.cuda.max_memory_allocated()
    for k, v in counts.items():
        totals[k] += v
    toks = sum(len(r.tokens) for r in res.values())
    log(f"  full dense greedy: {toks / wall:.1f} tok/s wall (information "
        f"only), rounds={rep['rounds']}, peak allocated {peak / 1e9:.2f} "
        f"GB, launches={counts}")
    if counts["flash_attention"] == 0 or counts["paged_attention"]:
        raise AssertionError(f"full dense: flash must run and paged not "
                             f"({counts})")
    out = dict(tokens_per_s=toks / wall, wall_s=wall, rounds=rep["rounds"],
               launches=counts, peak_gb=peak / 1e9)
    out["teacher_forced"] = teacher_forced(pair[2], pair[3], prompts, res,
                                           greedy, n_new)
    # a branch fork on the dense backend copies one draft row (every
    # row-axis leaf); a target row is timed beside it for scale
    for which, dec in (("draft (68M)", eng.dft_dec),
                       ("target (7B)", eng.tgt_dec)):
        nbytes = sum(a[:, 0].numel() * a.element_size()
                     for c in M.iter_slots(dec.cache) for a in c.values())
        ms = time_ms(lambda: dec.copy_row(0, 1))
        bms, _ = bound(2 * nbytes, 0, torch.bfloat16)
        log(f"  dense {which} row copy (a fork's copy_row): "
            f"{nbytes / 1e6:.2f} MB a row, {ms:.4f} ms (bound {bms:.4f})")
        out[f"fork {which}"] = dict(bytes=nbytes, ms=ms, bound_ms=bms)
    del eng
    free_device_memory()
    prof = busy_profile(lambda: SV.serve(pair, ecfg, prompts, 8,
                                         device=dev, attn_backend="dense"))
    log(f"  full dense profile: card busy {prof['busy_share']:.3f} of "
        f"{prof['wall_s']:.2f}s wall, device {prof['device_s']:.4f}s; "
        f"device time by kernel:")
    for n, t in prof["top"]:
        log(f"    {t * 1e3:9.2f} ms  {n}")
    log_flash(prof)
    log(f"    beside phase 4's paged serve: paged_attention "
        f"{paged_prof['paged_ms']:.2f} ms over "
        f"{paged_prof['paged_launches']} launches, device "
        f"{paged_prof['device_s']:.4f}s, busy "
        f"{paged_prof['busy_share']:.3f}")
    if prof["flash_launches"] == 0:
        raise AssertionError("full dense profile: no flash kernel")
    out["profile"] = prof
    return out


def union_ns(iv) -> list:
    """Disjoint union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_in(busy, a: float, b: float) -> float:
    """Seconds of the union ``busy`` (seconds) inside [a, b]."""
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in busy)


# marker kernels (``torch.cuda._sleep`` cycles) before and after each
# traced serve of a session: serve i's start markers sleep MARKS[i][0]
# cycles, its end markers MARKS[i][1]; they are told apart by their
# device time, whose class boundaries are MARK_CLASSES_NS (serve i's
# start markers fall in class 2i, its end markers in class 2i + 1)
MARKS = ((1000, 100_000), (300_000, 1_000_000))
MARK_CLASSES_NS = (20_000, 100_000, 300_000, 1_500_000)
SETTLE = 5_000_000      # the session's settling spin: a class of its own


def mark_class(dur_ns: int) -> int:
    return sum(dur_ns >= t for t in MARK_CLASSES_NS)


def round_table(rec, kernels, starts, ends, serve: int = 0) -> dict:
    """The host's share of a round: per span lane (draft, verify, commit)
    and per round, the host wall time of the recorder's spans against the
    device-busy time inside them (the union of the profiler's kernel
    intervals ``kernels``, (name, start ns, end ns)).  The recorder's
    clock is aligned to the profiler's by the marker kernels (names with
    "spin") launched on an idle card right after the recorder readings
    ``starts`` and ``ends``.  The profiler has been seen to miss the
    markers right after it starts (after earlier sessions in the same
    process), so the found start markers match the last readings, the
    found end markers the first, and one side suffices.  Each offset is
    late by one launch latency; the offset is the median of all.  The
    markers are those of the session's ``serve``-th traced serve
    (``MARKS``)."""
    spins = sorted((s, e) for n, s, e in kernels if "spin" in n)
    s_found = [s for s, e in spins if mark_class(e - s) == 2 * serve]
    e_found = [s for s, e in spins if mark_class(e - s) == 2 * serve + 1]
    if not s_found and not e_found:
        raise AssertionError("trace phase: no marker kernel in the trace")
    s_offs = [k / 1e9 - t for k, t in zip(s_found,
                                          starts[len(starts)
                                                 - len(s_found):])]
    e_offs = [k / 1e9 - t for k, t in zip(e_found, ends)]
    off = float(np.median(s_offs + e_offs))
    drift = (float(np.median(e_offs)) - float(np.median(s_offs))
             if s_offs and e_offs else float("nan"))
    marks = [starts[-1], ends[0]]
    busy = [(s / 1e9 - off, e / 1e9 - off) for s, e in
            union_ns((s, e) for n, s, e in kernels if "spin" not in n)]
    spans = [e for e in rec.events if e["kind"] == "span"]
    rounds = [e for e in rec.events if e["kind"] == "round"]
    lanes = {}
    for e in spans:
        n, tw, td = lanes.get(e["lane"], (0, 0.0, 0.0))
        lanes[e["lane"]] = (n + 1, tw + e["wall1"] - e["wall0"],
                            td + busy_in(busy, e["wall0"], e["wall1"]))
    r_wall = sum(r["wall1"] - r["wall0"] for r in rounds)
    r_busy = sum(busy_in(busy, r["wall0"], r["wall1"]) for r in rounds)
    serve = marks[-1] - marks[0]
    all_busy = busy_in(busy, marks[0], marks[-1])
    first = min((s for n, s, e in kernels if "spin" not in n), default=0)
    log(f"  clock alignment: {len(s_found)}/{len(starts)} start and "
        f"{len(e_found)}/{len(ends)} end markers found; offsets "
        f"{[round(o * 1e6, 1) for o in s_offs]} / "
        f"{[round(o * 1e6, 1) for o in e_offs]} us (drift "
        f"{drift * 1e6:.1f} us over the serve); {len(kernels)} kernel "
        f"records, the first "
        f"{(first / 1e9 - off - marks[0]) * 1e3:.2f} ms after the last "
        f"start reading")
    log(f"  host share of a round (CUDA profiler on; {len(rounds)} rounds, "
        f"{len(spans)} spans): lane, spans, host wall ms, device-busy ms "
        f"inside, host share")
    out = {"lanes": {}, "offset_us": off * 1e6, "drift_us": drift * 1e6}
    for lane in ("draft", "verify", "commit"):
        n, tw, td = lanes.get(lane, (0, 0.0, 0.0))
        share = 1.0 - td / tw if tw > 0 else float("nan")
        log(f"    {lane:7s} {n:5d} {tw * 1e3:10.2f} {td * 1e3:10.2f} "
            f"{share:7.3f}")
        out["lanes"][lane] = dict(spans=n, wall_ms=tw * 1e3,
                                  busy_ms=td * 1e3, host_share=share)
    log(f"    rounds  {len(rounds):5d} {r_wall * 1e3:10.2f} "
        f"{r_busy * 1e3:10.2f} {1.0 - r_busy / max(r_wall, 1e-12):7.3f}")
    log(f"    serve (marker to marker) {serve * 1e3:.2f} ms wall, "
        f"{all_busy * 1e3:.2f} ms device-busy; outside rounds (admission, "
        f"prefill, retire) {(serve - r_wall) * 1e3:.2f} ms wall")
    log("    per round: index, mode, batch, draft steps, wall ms, busy ms "
        "(first 6 and last 2)")
    rows = [dict(index=r["index"], mode=r["mode"], batch=r["batch"],
                 draft_steps=r["draft_steps"],
                 wall_ms=(r["wall1"] - r["wall0"]) * 1e3,
                 busy_ms=busy_in(busy, r["wall0"], r["wall1"]) * 1e3)
            for r in rounds]
    for r in rows[:6] + rows[-2:]:
        log(f"      {r['index']:4d} {r['mode']:8s} {r['batch']:2d} "
            f"{r['draft_steps']:3d} {r['wall_ms']:8.2f} {r['busy_ms']:8.2f}")
    out.update(rounds=rows, round_wall_ms=r_wall * 1e3,
               round_busy_ms=r_busy * 1e3, serve_ms=serve * 1e3,
               serve_busy_ms=all_busy * 1e3)
    return out


def phase_trace(dev, totals, pair, modes) -> list:
    """The full-width 7B batched SpecBranch greedy serve on the paged
    backend in each draft mode of ``modes`` ((draft_mode, draft heads)
    pairs), once untraced and once with a TraceRecorder and the loop's
    profiler ranges on, every traced serve inside ONE
    ``obs.profiler_session`` (CUDA activity), each framed by its own
    markers (``MARKS``).  Returns one table per mode.
    Gate: host fetches and host transfer bytes equal with and without the
    trace (and the streams).  Table: per round and per span lane (draft,
    verify, commit), the host wall time against the device-busy time
    inside it, from the profiler's kernel intervals; the recorder's clock
    is aligned to the profiler's by a marker kernel launched on an idle
    card right after a recorder reading, at both ends of the serve."""
    from repro_torch.obs import TraceRecorder, profiler_session
    prompts = SV.make_prompts(8)
    n_new = 32
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    runs = []
    for mode, heads in modes:
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0,
                            max_len=max_len, draft_mode=mode)
        res0, rep0, counts0, wall0, eng0 = drive(pair, ecfg, prompts, n_new,
                                                 dev, draft_heads=heads)
        runs.append(dict(mode=mode, heads=heads, ecfg=ecfg, res0=res0,
                         wall0=wall0, fetch0=eng0.host_fetches,
                         bytes0=eng0.host_transfer_bytes))
        del eng0
        for k, v in counts0.items():
            totals[k] += v
        free_device_memory()

    def mark(rec, cycles: int) -> float:
        torch.cuda.synchronize()
        t = rec.now()
        torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
        return t

    # the session's Chrome trace (~200 MB a serve) is written to a
    # scratch directory under build/ and removed once its size is read
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"))
    DL.set_trace_annotations(True)
    try:
        with profiler_session(tmp.name, dev) as prof:
            # settle the freshly started session before the first marker
            torch.cuda._sleep(SETTLE)
            torch.cuda.synchronize()
            time.sleep(0.5)
            for i, r in enumerate(runs):
                rec = r["rec"] = TraceRecorder()
                r["starts"] = [mark(rec, MARKS[i][0]) for _ in range(3)]
                ops.reset_launches()
                r["res1"], r["rep1"], eng1, r["wall1"] = SV.serve(
                    pair, r["ecfg"], prompts, n_new, device=dev,
                    attn_backend="paged", rec=rec, draft_heads=r["heads"])
                r["counts1"] = dict(ops.LAUNCHES)
                r["ends"] = [mark(rec, MARKS[i][1]) for _ in range(3)]
                r["fetch1"] = eng1.host_fetches
                r["bytes1"] = eng1.host_transfer_bytes
                del eng1
    finally:
        DL.set_trace_annotations(False)
    chrome = sum(os.path.getsize(os.path.join(tmp.name, f))
                 for f in os.listdir(tmp.name))
    tmp.cleanup()
    kernels = [(e.name(), e.start_ns(), e.end_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    log(f"  one profiler session over {len(runs)} traced serve(s): "
        f"{len(kernels)} kernel records, a {chrome / 1e6:.1f} MB Chrome "
        "trace")
    out = []
    for i, r in enumerate(runs):
        for k, v in r["counts1"].items():
            totals[k] += v
        toks = sum(len(x.tokens) for x in r["res1"].values())
        log(f"  {r['mode']} draft mode: untraced serve "
            f"{toks / r['wall0']:.1f} tok/s wall, {r['fetch0']} host "
            f"fetches, {r['bytes0']} bytes; traced and profiled: "
            f"{toks / r['wall1']:.1f} tok/s wall, {r['fetch1']} host "
            f"fetches, {r['bytes1']} bytes, {len(r['rec'].events)} events "
            "(wall figures for information only)")
        if (r["fetch0"], r["bytes0"]) != (r["fetch1"], r["bytes1"]):
            raise AssertionError(
                f"{r['mode']}: the trace changed the host traffic: "
                f"{(r['fetch0'], r['bytes0'])} vs "
                f"{(r['fetch1'], r['bytes1'])}")
        if first_diff(r["res0"], r["res1"]) != {j: None for j in r["res0"]}:
            raise AssertionError(f"{r['mode']}: the traced serve's streams "
                                 "differ")
        if r["counts1"]["paged_attention"] == 0:
            raise AssertionError(f"{r['mode']}: paged_attention not run")
        t = round_table(r["rec"], kernels, r["starts"], r["ends"], serve=i)
        t.update(mode=r["mode"],
                 dispatches_per_round=r["rep1"].get("dispatches_per_round"),
                 tokens_per_s_untraced=toks / r["wall0"],
                 tokens_per_s_traced=toks / r["wall1"],
                 host_fetches=r["fetch1"], host_bytes=r["bytes1"],
                 launches=r["counts1"])
        out.append(t)
    return out


# ---------------------------------------------------------------------------
# phase 13: single-pass parallel drafting and the history predictor
# ---------------------------------------------------------------------------

def draft_heads(cfg, ecfg, dev):
    """The draft heads a parallel-draft serve of ``cfg`` uses: the
    serve CLI's, drawn from ``SV.HEADS_SEED`` on ``dev``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SV.HEADS_SEED)
    return M.init_draft_heads(cfg, SV.heads_k(ecfg), gen, dev)


def check_dispatches(label, rep, eng, want=None) -> float:
    """Dispatches per round from the serve's report; every round tuple of
    a parallel-draft engine must carry its measured count (``want``: the
    count every round must take)."""
    dpr = rep["dispatches_per_round"]
    counted = [r[3] for r in eng.timeline if len(r) > 3]
    if len(counted) != len(eng.timeline):
        raise AssertionError(f"{label}: a round without its dispatches")
    if want is not None and set(counted) != {want}:
        raise AssertionError(f"{label}: dispatches {sorted(set(counted))} "
                             f"!= {want} a round")
    return dpr


def assert_cpu_equal(label, res, cres) -> None:
    """Streams and GenStats of a card drive equal the same serve's on the
    CPU."""
    diff = first_diff(res, cres)
    if any(v is not None for v in diff.values()):
        raise AssertionError(f"{label}: streams differ from the CPU serve "
                             f"(first divergence by request {diff})")
    bad = [i for i in res if res[i].stats != cres[i].stats]
    if bad:
        raise AssertionError(f"{label}: GenStats differ from the CPU serve "
                             f"for requests {bad}")


def phase_parallel_tiny(dev, totals) -> dict:
    """Parallel drafting and the predictor on the tiny committed pair:
    every drive equals the CPU serve and the greedy decode."""
    from repro_torch.training.pairs import get_pair
    cache_dir = os.path.join(ROOT, ".cache", "pairs")
    pair = get_pair("misaligned", device=dev, cache_dir=cache_dir)
    cpu = get_pair("misaligned", device="cpu", cache_dir=cache_dir)
    prompts = SV.make_prompts(4)
    n_new = 32
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    greedy = M.greedy_reference(pair[2], pair[3], prompts, n_new)
    par = EngineConfig(gamma=4, c=10.0, max_len=max_len,
                       draft_mode="parallel")
    heads = draft_heads(pair[1], par, dev)
    cheads = {k: v.cpu() for k, v in heads.items()}
    out = {}
    drives = []
    for engine in ("specbranch", "sps"):
        for backend in ("paged", "dense"):
            for name, temp, eps in (("greedy", 0.0, EPS),
                                    ("temp1", 1.0, EPS),
                                    ("temp1-chains", 1.0, 0.0)):
                if engine == "sps" and name == "temp1-chains":
                    continue        # SpS has no epsilon stop: as temp1
                drives.append((f"{engine} {backend} {name}", engine,
                               backend, temp, eps, "parallel", "off", {}))
    drives.append(("specbranch paged preempt", "specbranch", "paged", 0.0,
                   0.0, "parallel", "off",
                   dict(page_size=4, pool_pages=200)))
    drives.append(("specbranch paged predictor", "specbranch", "paged",
                   1.0, EPS, "sequential", "on", {}))
    drives.append(("specbranch paged parallel predictor", "specbranch",
                   "paged", 1.0, 0.0, "parallel", "on", {}))
    drives.append(("sps dense parallel predictor", "sps", "dense", 0.0,
                   EPS, "parallel", "on", {}))
    for label, engine, backend, temp, eps, mode, pred, kw in drives:
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp, epsilon=eps,
                            max_len=max_len, draft_mode=mode,
                            spec_predictor=pred)
        hd = heads if mode == "parallel" else None
        with VerifyShadow() as sh:
            res, rep, counts, wall, eng = drive(
                pair, ecfg, prompts, n_new, dev, attn_backend=backend,
                engine=engine, draft_heads=hd, max_batch=4, **kw)
        for k, v in counts.items():
            totals[k] += v
        cres, _, _, cwall = SV.serve(
            cpu, ecfg, prompts, n_new, device="cpu", attn_backend=backend,
            engine=engine, max_batch=4,
            draft_heads=cheads if hd is not None else None, **kw)
        assert_cpu_equal(f"parallel tiny {label}", res, cres)
        if temp == 0.0:
            bad = [i for i in range(len(prompts))
                   if res[i].tokens != greedy[i]]
            if bad:
                raise AssertionError(f"parallel tiny {label}: requests "
                                     f"{bad} differ from greedy decoding")
        else:
            check_shadow(f"parallel tiny {label}", sh, counts,
                         chains=eps == 0.0)
        kernel = "flash_attention" if backend == "dense" \
            else "paged_attention"
        if counts[kernel] == 0:
            raise AssertionError(f"parallel tiny {label}: {kernel} not run")
        dpr = (check_dispatches(f"parallel tiny {label}", rep, eng,
                                2 if engine == "sps" else None)
               if mode == "parallel" else rep["dispatches_per_round"])
        if kw and (rep["preemptions"] == 0 or counts["paged_gather"] == 0):
            raise AssertionError(f"parallel tiny {label}: no preemption / "
                                 f"swap-in ({rep['preemptions']}, {counts})")
        log(f"  parallel tiny {label}: rounds={rep['rounds']} "
            f"dispatches/round={dpr:.2f} preemptions={rep['preemptions']} "
            f"wall={wall:.2f}s (CPU {cwall:.1f}s), streams and GenStats = "
            f"the CPU serve's, launches={counts}")
        out[label] = dict(rounds=rep["rounds"], dispatches_per_round=dpr,
                          wall_s=wall, launches=counts)
        del eng
    # the sequential engines: parallel drafting, and the predictor
    cprompts = prompts[:2]
    for label, engine, temp, eps, mode, pred in (
            ("seq sps parallel", "sps", 0.0, EPS, "parallel", "off"),
            ("seq sps parallel temp1", "sps", 1.0, EPS, "parallel", "off"),
            ("seq specbranch parallel", "specbranch", 0.0, 0.0, "parallel",
             "off"),
            ("seq specbranch parallel temp1", "specbranch", 1.0, EPS,
             "parallel", "off"),
            ("seq specbranch predictor temp1", "specbranch", 1.0, EPS,
             "sequential", "on")):
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp, epsilon=eps,
                            max_len=512, draft_mode=mode,
                            spec_predictor=pred)
        hd = heads if mode == "parallel" else None
        res, counts, wall = seq_drive(pair, ecfg, engine, cprompts, n_new,
                                      totals, draft_heads=hd)
        cdone, _, cwall = SV.serve_sequential(
            cpu, ecfg, engine, cprompts, n_new,
            draft_heads=cheads if hd is not None else None)
        assert_cpu_equal(f"parallel tiny {label}", res,
                         {r.rid: r.result for r in cdone})
        if temp == 0.0 and any(res[i].tokens != greedy[i]
                               for i in range(len(cprompts))):
            raise AssertionError(f"parallel tiny {label}: differs from "
                                 "greedy decoding")
        disp = [r[3] for r in res[0].timeline if len(r) > 3]
        log(f"  parallel tiny {label}: wall={wall:.2f}s (CPU "
            f"{cwall:.1f}s), rounds={len(res[0].timeline)}, dispatches "
            f"{sorted(set(disp))}, streams and GenStats = the CPU serve's, "
            f"flash launches={counts['flash_attention']}")
        out[label] = dict(wall_s=wall, launches=counts)
    return out


class FrameLaunches:
    """While active, counts the attention launches inside the batched
    draft decoders' parallel-draft forwards (``step_draft``)."""

    def __init__(self):
        from repro_torch.serving.batched_engine import BatchedDecoder
        self.cls, self.orig = BatchedDecoder, BatchedDecoder.step_draft
        self.frames, self.launches = 0, {}

    def __enter__(self):
        me = self

        def step_draft(dec, *a, **kw):
            n0 = dict(ops.LAUNCHES)
            out = me.orig(dec, *a, **kw)
            me.frames += 1
            for k, v in ops.LAUNCHES.items():
                if v != n0[k]:
                    me.launches[k] = me.launches.get(k, 0) + v - n0[k]
            return out
        self.cls.step_draft = step_draft
        return self

    def __exit__(self, *exc):
        self.cls.step_draft = self.orig


def time_draft_chunk(eng, dev) -> dict:
    """Device time of one ``draft_chunk`` pass at the serve's shapes (the
    draft decoder's rows, the bucketed frame width of a one-token pending
    plus G slots: G = gamma for SpS, max(gamma, gamma_branch) for
    SpecBranch), on random logits and features."""
    n = eng.dft_dec.n_rows
    G = (eng.ecfg.gamma if eng.name == "batched-sps"
         else max(eng.ecfg.gamma, eng.ecfg.gamma_branch))
    T = DL.bucket(2 + G)
    V, D = eng.dcfg.vocab_size, eng.dcfg.d_model
    g = torch.Generator(device=dev).manual_seed(5)
    lg = torch.randn((n, T, V), generator=g, device=dev)
    feats = torch.randn((n, T, D), generator=g, device=dev,
                        dtype=eng.dcfg.tdtype)
    last = np.ones(n, np.int32)
    rids = np.arange(n, dtype=np.int32)
    ctrs = np.zeros(n, np.int32)

    def run():
        return DL.draft_chunk(lg, feats, eng.dp["final_norm"],
                              eng.draft_heads["heads"], last, rids, ctrs,
                              eng._key, g=G, dtemp=eng._dt, stemp=eng._st,
                              eps=eng.dcfg.norm_eps,
                              cap=eng.dcfg.final_softcap)
    # the device time of its kernels from the profiler (a CUDA-event pair
    # would also hold the host's hashing of the uniform grid and its
    # synchronous upload), over ten passes
    for _ in range(3):
        run()
    prof = busy_profile(lambda: [run() for _ in range(10)])
    ms = prof["device_s"] * 1e3 / 10
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(10):
        run()
    torch.cuda.synchronize()
    host_ms = (time.time() - t0) * 1e3 / 10
    # the bytes it must move: logits and features in, the head stack, the
    # q stack and packet out
    nbytes = (lg.numel() * 4 + feats.numel() * feats.element_size()
              + G * D * V * eng.draft_heads["heads"].element_size()
              + (G + 1) * n * V * 4 + n * (G + 1) * 2 * 4)
    bms, by = bound(nbytes, 2 * n * G * D * V, eng.dcfg.tdtype)
    return dict(ms=ms, wall_ms=host_ms, bound_ms=bms, bound_by=by, rows=n,
                width=T, G=G)


def traced_modes_in_child(totals) -> dict:
    """Run ``--trace-modes`` (the 7B SpecBranch serve traced in sequential
    and in parallel draft mode, one profiler session) in a fresh process,
    echo its log, add its launches to ``totals`` and return its tables by
    draft mode.  A fresh process: a later profiler session of one
    process has lost its marker kernels (all of them, once)."""
    path = os.path.join(ROOT, "build", "trace_modes.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--trace-modes", path], capture_output=True,
                          text=True, timeout=900)
    for ln in proc.stdout.splitlines():
        log(f"  | {ln}")
    if proc.returncode != 3:
        raise AssertionError(f"the traced child exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    with open(path) as f:
        got = json.load(f)
    for k, v in got["launches"].items():
        totals[k] += v
    return {t["mode"]: t for t in got["tables"]}


def phase_trace_modes(dev, path) -> None:
    """``--trace-modes PATH``: phase 12's measurement, the sequential and
    the parallel-draft serve in one profiler session; writes the tables
    and the launches to PATH (JSON)."""
    pair = SV.load_pair("paper-llama", dev)
    heads = draft_heads(pair[1], EngineConfig(gamma=4, c=10.0), dev)
    totals = {k: 0 for k in KERNELS}
    tables = phase_trace(dev, totals, pair, modes=(("sequential", None),
                                                   ("parallel", heads)))
    with open(path, "w") as f:
        json.dump({"tables": tables, "launches": totals}, f)


def phase_parallel_full(dev, totals, pair, traced) -> dict:
    """Parallel drafting and the predictor at full width, paged, 8 x 32
    greedy; ``traced``: phase 12's host-share tables by draft mode (both
    serves in one profiler session)."""
    prompts = SV.make_prompts(8)
    n_new = 32
    max_len = SV.auto_max_len(prompts, n_new, 4, 10.0)
    greedy = M.greedy_reference(pair[2], pair[3], prompts, n_new)
    heads = draft_heads(pair[1], EngineConfig(gamma=4, c=10.0), dev)
    out = {}
    for engine in ("specbranch", "sps"):
        for mode in ("sequential", "parallel"):
            label = f"{engine} {mode} draft"
            ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0,
                                max_len=max_len, draft_mode=mode)
            hd = heads if mode == "parallel" else None
            with FrameLaunches() as fr:
                res, rep, counts, wall, eng = drive(
                    pair, ecfg, prompts, n_new, dev, engine=engine,
                    draft_heads=hd)
            for k, v in counts.items():
                totals[k] += v
            toks = sum(len(r.tokens) for r in res.values())
            dpr = (check_dispatches(f"full {label}", rep, eng,
                                    2 if engine == "sps" else None)
                   if mode == "parallel" else rep["dispatches_per_round"])
            log(f"  full {label}: {toks / wall:.1f} tok/s wall, rounds="
                f"{rep['rounds']}, dispatches/round={dpr:.2f}, "
                f"draft frames={fr.frames} with attention launches "
                f"{fr.launches}, launches={counts}")
            tf = teacher_forced(pair[2], pair[3], prompts, res, greedy,
                                n_new)
            r = dict(tokens_per_s=toks / wall, wall_s=wall,
                     rounds=rep["rounds"], dispatches_per_round=dpr,
                     frames=fr.frames, frame_launches=fr.launches,
                     tf_argmax=tf["argmax"], tf_tokens=tf["tokens"],
                     rollback_per_request=float(np.mean(
                         [r_.stats.rollback_tokens
                          for r_ in res.values()])),
                     launches=counts)
            if mode == "parallel":
                if not fr.frames or not fr.launches.get("paged_attention"):
                    raise AssertionError(f"full {label}: no draft frame "
                                         "ran the paged kernel")
                r["draft_chunk"] = dc = time_draft_chunk(eng, dev)
                log(f"  full {label}: draft_chunk {dc['ms']:.4f} ms of "
                    f"device time a pass ({dc['wall_ms']:.3f} ms of wall "
                    f"with its host work) over {dc['rows']} rows x width "
                    f"{dc['width']}, G={dc['G']} (bound {dc['bound_ms']:.4f}"
                    f", {dc['bound_by']})")
            del eng
            free_device_memory()
            # where the time goes: one profiled serve (8 new tokens)
            prof = busy_profile(lambda: SV.serve(
                pair, ecfg, prompts, 8, device=dev, engine=engine,
                draft_heads=hd))
            log(f"  full {label} profile: card busy "
                f"{prof['busy_share']:.3f} of {prof['wall_s']:.2f}s wall, "
                f"device {prof['device_s']:.4f}s; by kernel:")
            for n, t in prof["top"]:
                log(f"    {t * 1e3:9.2f} ms  {n}")
            log_paged(prof)
            r["profile"] = prof
            out[label] = r
            free_device_memory()
    for engine in ("specbranch", "sps"):
        s, p = out[f"{engine} sequential draft"], \
            out[f"{engine} parallel draft"]
        log(f"  full {engine}: parallel vs sequential draft mode: "
            f"{p['tokens_per_s']:.1f} vs {s['tokens_per_s']:.1f} tok/s wall, "
            f"dispatches/round {p['dispatches_per_round']:.2f} vs "
            f"{s['dispatches_per_round']:.2f}, rounds {p['rounds']} vs "
            f"{s['rounds']}, device "
            f"{p['profile']['device_s']:.4f} vs "
            f"{s['profile']['device_s']:.4f}s a profiled serve")
    # the host's share of a parallel-mode round beside phase 12's
    # sequential-mode one (both serves in phase 12's profiler session)
    del heads
    free_device_memory()
    trace, trace_seq = traced["parallel"], traced["sequential"]
    out["trace"] = trace
    log("  host share, parallel vs sequential draft mode (phase 12's "
        "session): lane, spans, host wall ms, busy ms, host share")
    for lane in ("draft", "verify", "commit"):
        a, b = trace["lanes"][lane], trace_seq["lanes"][lane]
        log(f"    {lane:7s} {a['spans']:4d} {a['wall_ms']:9.2f} "
            f"{a['busy_ms']:8.2f} {a['host_share']:6.3f}   |   "
            f"{b['spans']:4d} {b['wall_ms']:9.2f} {b['busy_ms']:8.2f} "
            f"{b['host_share']:6.3f}")
    for t, name in ((trace, "parallel"), (trace_seq, "sequential")):
        log(f"    rounds ({name}) {len(t['rounds'])} rounds, "
            f"{t['round_wall_ms']:.2f} ms wall, {t['round_busy_ms']:.2f} ms "
            f"busy, host share "
            f"{1.0 - t['round_busy_ms'] / max(t['round_wall_ms'], 1e-9):.3f}"
            f", dispatches/round {t.get('dispatches_per_round')}")
    for t, name in ((trace, "parallel"), (trace_seq, "sequential")):
        w = sorted(r["wall_ms"] for r in t["rounds"]
                   if r["mode"] == "parallel")
        if w:
            log(f"    {name} draft mode: {len(w)} verify (branch-stage) "
                f"rounds, wall {w[0]:.2f}-{w[-1]:.2f} ms (median "
                f"{float(np.median(w)):.2f})")
    # the predictor at full width (sequential draft mode, greedy): the
    # decided-gamma histogram and rollback tokens beside off
    from repro_torch.obs import TraceRecorder
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0, max_len=max_len,
                        spec_predictor="on")
    rec = TraceRecorder()
    res, rep, counts, wall, eng = drive(pair, ecfg, prompts, n_new, dev,
                                        rec=rec)
    del eng
    for k, v in counts.items():
        totals[k] += v
    hist = {}
    for e in rec.events:
        if e["kind"] == "spec" and e.get("pred") is not None:
            hist[e["pred"]["gamma"]] = hist.get(e["pred"]["gamma"], 0) + 1
    rb = float(np.mean([r.stats.rollback_tokens for r in res.values()]))
    toks = sum(len(r.tokens) for r in res.values())
    off = out["specbranch sequential draft"]
    tf = teacher_forced(pair[2], pair[3], prompts, res, greedy, n_new)
    log(f"  full specbranch predictor on: {toks / wall:.1f} tok/s wall, "
        f"rounds={rep['rounds']}, decided gamma histogram "
        f"{dict(sorted(hist.items()))}, rollback tokens per request {rb:.2f}"
        f" (off: {off['rollback_per_request']:.2f}, {off['rounds']} rounds,"
        f" {off['tokens_per_s']:.1f} tok/s)")
    if not hist:
        raise AssertionError("full predictor: no decision recorded")
    out["predictor"] = dict(gamma_hist=hist, rollback_per_request=rb,
                            rounds=rep["rounds"], tokens_per_s=toks / wall,
                            tf_argmax=tf["argmax"])
    return out


def log_ptxas(ptx: str) -> None:
    """Registers and spills of every kernel the build compiled, from
    ``nvcc -Xptxas -v``; the decode loop's variants (decode, and flash's
    wide block) by addressing struct, dtype, head dim and ring stages,
    the scan's by N, x dtype and entry (carry, states, ring), the
    verify's by entry and logit dtype."""
    name, spill = "?", ""
    for ln in ptx.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            m = re.search(r"(decode|wide)_attention_kernelI(\w+?)Li(\d+)E"
                          r"Li(\d+)ENS_\d+(\w+?)Keys", name)
            if m:
                dt = "bf16" if "bfloat" in m.group(2) else "f32"
                name = (f"{m.group(1)} {m.group(5)}Keys {dt} "
                        f"hd={m.group(3)} stages={m.group(4)}")
            m = re.search(r"ssm_scan_kernelILi(\d+)E(13__nv_bfloat16|f)"
                          r"Li(\d)E", name)
            if m:
                dt = "bf16" if "bfloat" in m.group(2) else "f32"
                mode = ("carry", "states", "ring")[int(m.group(3))]
                name = f"ssm_scan N={m.group(1)} x {dt} {mode}"
            m = re.search(r"verify_accept_(batched_)?kernel(I13__nv_bfloat16"
                          r"|If)?E", name)
            if m:
                name = ("verify batched f32" if m.group(1) else
                        "verify single " + ("bf16" if "bfloat"
                                            in (m.group(2) or "") else "f32"))
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            log(f"  ptxas {name[:60]:60s} {regs:>3s} regs; {spill}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    t0 = time.time()
    build.lib()
    log_phase(f"[1] build: {build.BUILD_INFO.get('seconds', 0.0):.1f}s "
              f"({time.time() - t0:.1f}s with load); card: {smi}")
    log_ptxas(str(build.BUILD_INFO.get("ptxas", "")))
    if "--profile" in sys.argv[1:]:
        log(f"[profile] phase 4's profiled serve, port from {SRC}")
        phase_profile(dev)
        return 3                # a profile run gives no smoke result
    if "--scan" in sys.argv[1:]:
        log(f"[scan] the plain scan's cases, port from {SRC}")
        phase_scan()
        return 3                # a scan run gives no smoke result
    if "--probe" in sys.argv[1:]:
        log("[probe] attention tile loop phase by phase")
        phase_probe()
        return 3                # a probe run gives no smoke result
    if "--trace-modes" in sys.argv[1:]:
        log("[trace-modes] the 7B SpecBranch serve traced in both draft "
            "modes")
        phase_trace_modes(dev, sys.argv[sys.argv.index("--trace-modes")
                                        + 1])
        return 3                # a child of phase 13: no smoke result
    log_phase("[2] kernels vs plain versions")
    cases = phase_kernels()
    totals = {k: 0 for k in KERNELS}
    phase_kernel_api(cases, totals)
    if "--kernels" in sys.argv[1:]:
        return 3                # phases 1-2 only: no smoke result
    log_phase("[3] tiny committed pair, f32")
    phase_tiny(dev, totals)
    log_phase("[4] full-width LLaMA-68M/7B pair, bf16, random weights")
    pair = SV.load_pair("paper-llama", dev)
    without = {"batched": phase_full(dev, totals, pair)}
    log_phase("[5] sequential engines, tiny committed pair, f32")
    phase_seq_tiny(dev, totals)
    log_phase("[6] sequential engines, full-width LLaMA-68M/7B pair, "
              "bf16")
    without["seq"] = phase_seq_full(dev, totals, pair)
    del pair
    log_phase("[7] SSM and hybrid tiny pairs (falcon-shaped, "
              "jamba-shaped), f32")
    phase_hybrid(dev, totals)
    log_phase("[8] full-width falcon-mamba-7b with its draft, bf16, "
              "random weights")
    phase_falcon(dev, totals)
    log_phase(f"[9] H-RAD (init seed {HRAD_SEED}) and batched SpS, tiny "
              "committed pair, f32")
    phase_hrad_tiny(dev, totals)
    log_phase("[10] H-RAD and batched SpS, full-width LLaMA-68M/7B pair, "
              "bf16")
    free_device_memory()
    pair = SV.load_pair("paper-llama", dev)
    phase_hrad_full(dev, totals, pair, without)
    log_phase("[11] dense backend: tiny committed and jamba-shaped pairs "
              "(f32), full-width LLaMA-68M/7B (bf16)")
    free_device_memory()
    phase_dense_tiny(dev, totals)
    phase_dense_full(dev, totals, pair, without["batched"]["profile"])
    log_phase("[12] trace recorder: full-width LLaMA-68M/7B batched "
              "SpecBranch, untraced and traced under the CUDA profiler "
              "(a fresh process; its parallel-draft serve is phase 13's)")
    free_device_memory()
    traced = traced_modes_in_child(totals)
    log_phase("[13] parallel drafting and the history predictor: tiny "
              "committed pair (f32), full-width LLaMA-68M/7B (bf16)")
    free_device_memory()
    phase_parallel_tiny(dev, totals)
    free_device_memory()
    phase_parallel_full(dev, totals, pair, traced)
    del pair
    for k, v in totals.items():
        if v == 0:
            raise AssertionError(f"kernel {k} was not launched on the "
                                 "main path")
    # one line per kernel: the main path's representative shape
    rep_case = {"paged_attention": "llama-7b B=8 T=8",
                "verify_accept_batched": "llama V=32000 B=8 R=16",
                "paged_gather": "zm swap ps=4 dim=512",
                "flash_attention": "llama-7b B=1 T=5 S=512",
                "ssm_scan": SEQ_CARRY_CASE,
                "ssm_scan_ring": FALCON_RING_CASE,
                "branch_decode_attention": "llama-7b k=6 Sp=504 Ss=8",
                "verify_accept": "llama V=32000 R=9"}
    table = []
    for name, meta in KERNELS.items():
        c = next(r for r in cases[name] if r["case"] == rep_case[name])
        table.append(dict(name=name, **meta, launches=totals[name],
                          max_abs_err=c["max_abs_err"], ms=c["ms"],
                          plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
                          bound_by=c["bound_by"],
                          library_ms=c["library_ms"], case=c["case"]))
    log_phase("done")
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
