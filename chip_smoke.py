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
               time the card could take (bound) and a library call where
               one exists.
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
Each main-path drive zeroes the kernel launch counters right before it
and reads them right after; launches made to compare a kernel with its
plain version are not counted.  The second-to-last lines are the kernel
table as one JSON object and the card's name and power limit; the last
line is the device JSON.

Exits non-zero without a result when no CUDA device is visible.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import paged as PG  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import verify_accept as VA  # noqa: E402
from repro_torch.launch import serve as SV  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
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
}


def log(*a) -> None:
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


_FLUSH = None


def time_ms(fn, iters: int = 21, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events recorded right
    before and after it.  A spin kernel holds the card while the host
    enqueues every call, so the calls then run back to back and the events
    time device work, not host launch overhead.  The 50 MB L2 is flushed
    (a bitwise_not pass over 64 MB, outside the events) before every call,
    as the main path finds its inputs cold."""
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
        _FLUSH.bitwise_not_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def bound(nbytes: float, ops_: float, dtype) -> tuple:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops_ / PEAK_OPS[dtype] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def attn_case(rng, B, T, H, KV, hd, ps, dtype, n_idle=0, max_len=112):
    """Fragmented page tables over random ragged rows; ``n_idle`` rows are
    unbound (lens 0), as most draft rows are on the main path."""
    lens = [int(rng.integers(max(T, 17), max_len + 1)) for _ in range(B)]
    for b in range(B - n_idle, B):
        lens[b] = 0
    n_pages = [-(-ln // ps) for ln in lens]
    P = sum(n_pages)
    n_max = max(max(n_pages), 1)
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
    qs = torch.clamp(lens_t - T, min=0).to(torch.int32)
    return q, kp, vp, torch.from_numpy(table).to(dev), lens_t, qs


def check_attention(rng, label, B, T, H, KV, hd, ps, dtype, n_idle=0):
    q, kp, vp, table, lens, qs = attn_case(rng, B, T, H, KV, hd, ps, dtype,
                                           n_idle)
    out = PA.paged_attention(q, kp, vp, table, lens, qs)
    want = ref.paged_attention_ref(q, kp, vp, table, lens, qs)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"paged_attention {label}: max err {err} > "
                             f"{tol}")
    es = kp.element_size()
    ps_ = kp.shape[1]
    pages = int(sum(-(-int(n) // ps_) for n in lens.tolist()))
    nbytes = (2 * pages * ps_ * KV * hd * es + 2 * q.numel() * es
              + (table.numel() + 2 * B) * 4)
    keys = sum(int(n) for n in lens.tolist())
    flops = 4 * T * H * hd * keys
    bms, by = bound(nbytes, flops, dtype)
    ms = time_ms(lambda: PA.paged_attention(q, kp, vp, table, lens, qs))
    plain = time_ms(lambda: ref.paged_attention_ref(q, kp, vp, table, lens,
                                                    qs))
    # library yardstick: SDPA over the pre-gathered dense KV (timed only)
    S = table.shape[1] * ps_
    kd = kp[table.long()].reshape(B, S, KV, hd).transpose(1, 2)
    vd = vp[table.long()].reshape(B, S, KV, hd).transpose(1, 2)
    kd = kd.repeat_interleave(H // KV, dim=1).contiguous()
    vd = vd.repeat_interleave(H // KV, dim=1).contiguous()
    kpos = torch.arange(S, device="cuda")
    qpos = qs.long()[:, None] + torch.arange(T, device="cuda")[None]
    mask = ((kpos[None, None] < lens.long()[:, None, None])
            & (kpos[None, None] <= qpos[:, :, None]))[:, None]
    qd = q.transpose(1, 2).contiguous()
    lib = time_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                         attn_mask=mask))
    return dict(case=label, max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=bms, bound_by=by)


def check_verify(rng, label, B, R, V):
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
        p = torch.softmax(pl[b, r].double(), -1)
        qq = torch.softmax(ql[b, r].double(), -1)
        rr = (p - qq).clamp_min(0)
        rr = rr / rr.sum() if rr.sum() > 1e-12 else p
        cdf = torch.cumsum(rr, 0)
        cdf = (cdf / cdf[-1]).cpu()
        lo, hi = sorted((int(res[b, r]), int(res_w[b, r])))
        near = (cdf[max(lo - 1, 0):hi] - float(w[b, r])).abs().min()
        if near > 1e-6:
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
    return dict(case=label, max_abs_err=err, boundary_cases=boundary,
                ms=ms, plain_ms=plain, library_ms=None, bound_ms=bms,
                bound_by=by)


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
    for r in att + ver + gat:
        lib = r["library_ms"]
        log(f"  {r['case']:32s} err={r['max_abs_err']:.2e} "
            f"ms={r['ms']:.4f} bound={r['bound_ms']:.4f} "
            f"({r['bound_by']}) plain={r['plain_ms']:.4f} "
            f"lib={'null' if lib is None else f'{lib:.4f}'}"
            + (f" boundary={r['boundary_cases']}"
               if "boundary_cases" in r else ""))
    return {"paged_attention": att, "verify_accept_batched": ver,
            "paged_gather": gat}


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
        self._inputs = None

    def __enter__(self):
        DL.branch_verify, DL._chain_via_kernel = self._verify, self._chain
        return self

    def __exit__(self, *exc):
        DL.branch_verify, DL._chain_via_kernel = self._bv, self._cv

    def _chain(self, *a):
        self._inputs = a
        return self._cv(*a)

    def _verify(self, *a, **kw):
        self._inputs = None
        got = self._bv(*a, **kw)
        if not kw.get("kernel"):
            return got
        launched = self._inputs is not None    # a chunk reached the kernel
        want = self._bv(*a, **dict(kw, kernel=False))
        self.calls += launched
        self.rows += got.shape[0] if launched else 0
        self.positions += int(self._inputs[3].sum()) if launched else 0
        if not torch.equal(got[:, 3:], want[:, 3:]):
            raise AssertionError("verify shadow: branch stage differs")
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


def drive(pair, ecfg, prompts, n_new, dev, **kw):
    """One main-path drive with the launch counters zeroed just before and
    read just after."""
    ops.reset_launches()
    res, rep, eng, wall = SV.serve(pair, ecfg, prompts, n_new, device=dev,
                                   **kw)
    counts = dict(ops.LAUNCHES)
    for rid, r in res.items():
        if len(r.tokens) != n_new:
            raise AssertionError(f"request {rid} got {len(r.tokens)} tokens")
    eng.pool.check()
    return res, rep, counts, wall


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
            res, rep, counts, wall = drive(pair, ecfg, prompts, n_new, dev,
                                           **kw)
        for k, v in counts.items():
            totals[k] += v
        log(f"  tiny {name}: rounds={rep['rounds']} "
            f"preemptions={rep['preemptions']} wall={wall:.2f}s "
            f"launches={counts}")
        if temp > 0:
            check_shadow(f"tiny {name}", sh, counts, chains=eps == 0.0)
            out[name + " cpu"] = compare_cpu(name, ecfg, prompts, n_new, res)
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


def compare_cpu(name, ecfg, prompts, n_new, res) -> dict:
    """Serve the same drive on the CPU (every kernel's plain version) and
    compare the streams.  Printed, not asserted: f32 logits of the card and
    the CPU differ in the last bits, which can flip a draw that lands near a
    cdf boundary; the kernel route itself is held exactly by VerifyShadow."""
    from repro_torch.training.pairs import get_pair
    pair = get_pair("misaligned", device="cpu",
                    cache_dir=os.path.join(ROOT, ".cache", "pairs"))
    cres, _, _, wall = SV.serve(pair, ecfg, prompts, n_new, device="cpu")
    first = {}
    for i in range(len(prompts)):
        a, b = res[i].tokens, cres[i].tokens
        first[i] = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                        None if len(a) == len(b) else min(len(a), len(b)))
    same = sum(v is None for v in first.values())
    stats = sum(res[i].stats == cres[i].stats for i in range(len(prompts)))
    log(f"  tiny {name} vs the same serve on the CPU ({wall:.1f}s): "
        f"{same}/{len(prompts)} streams equal, {stats} GenStats equal, "
        f"first divergence by request {first}")
    return dict(streams_equal=same, stats_equal=stats, first_divergence=first)


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
    return dict(wall_s=wall, busy_share=busy / 1e9 / wall,
                device_s=sum(by_name.values()) / 1e9,
                top=[(n, t / 1e9) for n, t in top])


def phase_full(dev, totals) -> dict:
    pair = SV.load_pair("paper-llama", dev)
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
            res, rep, counts, wall = drive(pair, ecfg, prompts, n_new, dev)
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
    out["profile"] = prof
    return out


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
    log(f"[1] build: {build.BUILD_INFO.get('seconds', 0.0):.1f}s "
        f"({time.time() - t0:.1f}s with load); card: {smi}")
    ptx = str(build.BUILD_INFO.get("ptxas", ""))
    log("\n".join("  " + ln for ln in ptx.splitlines()
                  if "registers" in ln or "spill" in ln))
    log("[2] kernels vs plain versions")
    cases = phase_kernels()
    totals = {k: 0 for k in KERNELS}
    log("[3] tiny committed pair, f32")
    phase_tiny(dev, totals)
    log("[4] full-width LLaMA-68M/7B pair, bf16, random weights")
    phase_full(dev, totals)
    for k, v in totals.items():
        if v == 0:
            raise AssertionError(f"kernel {k} was not launched on the "
                                 "main path")
    # one line per kernel: the main path's representative shape
    rep_case = {"paged_attention": "llama-7b B=8 T=8",
                "verify_accept_batched": "llama V=32000 B=8 R=16",
                "paged_gather": "zm swap ps=4 dim=512"}
    table = []
    for name, meta in KERNELS.items():
        c = next(r for r in cases[name] if r["case"] == rep_case[name])
        table.append(dict(name=name, **meta, launches=totals[name],
                          max_abs_err=c["max_abs_err"], ms=c["ms"],
                          plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
                          bound_by=c["bound_by"],
                          library_ms=c["library_ms"], case=c["case"]))
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
