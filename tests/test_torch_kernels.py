"""The port's kernels: plain PyTorch versions against the JAX kernels (run
in interpret mode on the CPU, as the reference's own tests run them), the
CPU routing of ``repro_torch.kernels.ops``, and the wrappers' refusal of
CPU tensors.  The CUDA kernels against their plain versions are in
``test_torch_cuda.py``.

Tolerances: paged and flash attention f32 atol 1e-5 (the same math in
another summation order), and so the split-KV emulation of the decode
kernels; branch decode atol 2e-5 f32 and 2e-2 bf16 (the
reference rounds each of its two passes to bf16 before the merge, the
plain version once); verify ints equal and floats rtol 1e-6 (batched) or
atol 1e-6 (single request); gather equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro.kernels import paged_attention as jpa
from repro.kernels import verify_accept as jva
from repro_torch.kernels import branch_attention as tba
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as tlayers
from repro_torch.kernels import paged as tpg
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import verify_accept as tva

# One intra-op thread: the tiny models gain nothing from more, and the
# test workers share the machine's cores (eight threads in each of six
# workers slow every small op here many times over).
torch.set_num_threads(1)


def _layout(rng, lens, ps, n_phys=None):
    """Random fragmented page tables (tests/test_paged_attention.py); the
    trash page is the last physical page and pads the tables."""
    n_pages = [-(-ln // ps) for ln in lens]
    total = sum(n_pages)
    P = total if n_phys is None else n_phys
    table = np.full((len(lens), max(max(n_pages), 1)), P, np.int32)
    perm = rng.permutation(P)
    off = 0
    for b, npg in enumerate(n_pages):
        table[b, :npg] = perm[off:off + npg]
        off += npg
    return table, P


def _attn_inputs(seed, B, T, H, KV, hd, ps, zero_rows=0, cow=False):
    rng = np.random.default_rng(seed)
    lens = [int(rng.integers(T + 1, 6 * ps)) for _ in range(B)]
    for b in range(B - zero_rows, B):
        lens[b] = 0
    n_pages = [-(-ln // ps) for ln in lens]
    table, P = _layout(rng, lens, ps, sum(n_pages) + 2)
    if cow and min(n_pages[0], n_pages[1]) > 1:
        f = min(n_pages[0], n_pages[1])
        table[1, :f - 1] = table[0, :f - 1]       # shared-prefix COW fork
    kp = rng.normal(size=(P + 1, ps, KV, hd)).astype(np.float32)
    vp = rng.normal(size=(P + 1, ps, KV, hd)).astype(np.float32)
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    q_start = np.maximum(lens - T, 0).astype(np.int32)
    return q, kp, vp, table, lens, q_start


def _torch(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


ATTN_CASES = [
    # tests/test_paged_attention.py::test_paged_attention_vs_oracle
    dict(B=1, T=1, H=4, KV=4, hd=32, ps=8),
    dict(B=3, T=5, H=4, KV=2, hd=16, ps=8),
    dict(B=2, T=7, H=8, KV=2, hd=64, ps=16, window=5),
    dict(B=2, T=3, H=6, KV=3, hd=32, ps=4, cap=20.0),
    # zero-length rows (test_paged_attention_zero_length_rows)
    dict(B=3, T=2, H=4, KV=2, hd=16, ps=8, zero_rows=2),
    # fragmented tables with a COW fork (the property test's layout)
    dict(B=4, T=3, H=4, KV=2, hd=16, ps=4, cow=True, seed=7),
    dict(B=3, T=1, H=2, KV=2, hd=16, ps=8, cow=True, seed=8),
    # head dims off the aligned path: granite-moe's draft (3 heads of 85),
    # and 40 with GQA under a window
    dict(B=3, T=4, H=3, KV=3, hd=85, ps=8),
    dict(B=2, T=3, H=4, KV=2, hd=40, ps=4, window=5),
]


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=[f"case{i}" for i in range(len(ATTN_CASES))])
def test_plain_paged_attention_matches_pallas_and_xla(case):
    case = dict(case)
    kw = {k: case.pop(k) for k in ("window", "cap") if k in case}
    seed = case.pop("seed", 5)
    q, kp, vp, table, lens, q_start = _attn_inputs(seed, **case)
    got = ref.paged_attention_ref(*_torch(q, kp, vp, table, lens, q_start),
                                  **kw).numpy()
    pallas = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens), jnp.asarray(q_start), interpret=True, **kw)
    xla = jpa.paged_decode_attention_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens), jnp.asarray(q_start), **kw)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(xla), rtol=0, atol=1e-5)
    assert np.isfinite(got).all()
    if case.get("zero_rows"):
        assert np.abs(got[-case["zero_rows"]:]).max() == 0.0


def _verify_inputs(seed, B, R, V):
    rng = np.random.default_rng(seed)
    pl = (3 * rng.normal(size=(B, R, V))).astype(np.float32)
    ql = (3 * rng.normal(size=(B, R, V))).astype(np.float32)
    tok = rng.integers(0, V, size=(B, R)).astype(np.int32)
    lens = rng.integers(0, R + 1, size=B).astype(np.int32)
    lens[0] = R                                   # one full row
    u = rng.random((B, R), dtype=np.float32)
    w = rng.random((B, R), dtype=np.float32)
    return pl, ql, tok, lens, u, w


@pytest.mark.parametrize("V", [199, 4096])
def test_plain_verify_matches_pallas_and_xla(V):
    args = _verify_inputs(3, 4, 6, V)
    got = [x.numpy() for x in ref.verify_accept_batched_ref(*_torch(*args))]
    jargs = [jnp.asarray(a) for a in args]
    for want in (jva.verify_accept_batched(*jargs, interpret=True),
                 jva.verify_accept_batched_xla(*jargs)):
        want = [np.asarray(x) for x in want]
        np.testing.assert_array_equal(got[0], want[0])       # accept
        np.testing.assert_array_equal(got[1], want[1])       # residual
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=0)
        np.testing.assert_allclose(got[3], want[3], rtol=1e-6, atol=0)
    # masked positions are zeros
    lens = args[3]
    for b in range(len(lens)):
        assert (got[0][b, lens[b]:] == 0).all()
        assert (got[1][b, lens[b]:] == 0).all()


@pytest.mark.parametrize("lens", ["ragged", "zero", "full"])
@pytest.mark.parametrize("V", [199, 32000])
def test_plain_verify_full_and_empty_rows_match_pallas(V, lens):
    """Ragged lens with one all-zero and one all-full row, every row
    masked, and every row full, at the tiny pair's vocabulary and at
    LLaMA's, against the reference's batched kernel in interpret mode.
    p_tok / q_tok within rtol 1e-5 (the card checks' tolerance): two
    summation orders of 32000 f32 exps differ by ~1e-6 relative."""
    args = list(_verify_inputs(6, 3, 4, V))
    args[3] = {"ragged": np.asarray([4, 0, 2], np.int32),
               "zero": np.zeros(3, np.int32),
               "full": np.full(3, 4, np.int32)}[lens]
    got = [x.numpy() for x in ref.verify_accept_batched_ref(*_torch(*args))]
    want = [np.asarray(x) for x in jva.verify_accept_batched(
        *[jnp.asarray(a) for a in args], interpret=True)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=0)
    for b, n in enumerate(args[3]):
        assert not got[0][b, n:].any() and not got[1][b, n:].any()
        assert not got[2][b, n:].any() and not got[3][b, n:].any()


# (V, rows, SMs, blocks per row): LLaMA's vocabulary at the batched and
# the single-request row counts, the tiny pair's, falcon's, gemma's (16,
# where a slice of V / 8 would not fit in shared memory)
@pytest.mark.parametrize("V,rows,sms,want", [
    (32000, 128, 132, 8), (32000, 9, 132, 8), (199, 128, 132, 1),
    (32, 9, 132, 1), (4096, 24, 132, 4), (65024, 128, 132, 8),
    (262144, 128, 132, 16), (1024, 9, 132, 1), (30011, 24, 132, 8)])
def test_verify_split_plan(V, rows, sms, want):
    n = tva.split_plan(V, rows, sms)
    assert n == want
    assert -(-V // n) <= tva.MAX_SLICE


def test_verify_split_plan_refuses_a_vocabulary_past_shared_memory():
    with pytest.raises(ValueError, match="exceeds"):
        tva.split_plan(16 * tva.MAX_SLICE + 1, 8, 132)


# (B, T, S, H, KV, hd, dtype, dq blocks, dk/dv blocks, (dq, dk/dv)
# chunks): gemma3-4b's training frame (window and global share it: 160
# walks of 80 key tiles of 16 and 160 of 80 row tiles of 32, each in 5
# chunks), gemma2's softcap frame (256 walks of 16 key tiles, 2 chunks;
# 256 of 32 row tiles, 4), hubert's and a one-token frame; at f32 (one-warp
# blocks of 16 rows over tiles of 16 keys and of 16 keys over tiles of 16
# rows, walks chunked down to single tiles toward 1056 blocks, eight an
# SM, at most 16 chunks) the frames the repo trains: the tiny pair's (256
# dq walks of 4 key tiles in 4 chunks; 128 dk/dv walks of 8 row tiles in
# 8), the draft-head loss's (192 of 6 in 6; 96 of 12 in 11), granite-moe's
# draft at its compiled width 96 (48 of 16 in 16; 48 of 16 in 16) and a
# reduced config's hd 64 under ``launch.train``'s defaults (128 of 4 in 4;
# 64 of 8 in 8)
@pytest.mark.parametrize("B,T,S,H,KV,hd,dtype,dq,dkdv,chunks", [
    (1, 1280, 1280, 8, 4, 256, torch.bfloat16, 800, 800, (5, 5)),
    (1, 512, 512, 32, 16, 128, torch.bfloat16, 512, 1024, (2, 4)),
    (2, 500, 500, 16, 16, 80, torch.bfloat16, 512, 1024, (2, 2)),
    (16, 63, 63, 4, 2, 32, torch.float32, 1024, 1024, (4, 8)),
    (1, 1, 33, 4, 2, 160, torch.bfloat16, 2, 4, (1, 1)),
    (16, 96, 96, 2, 1, 16, torch.float32, 1152, 1056, (6, 11)),
    (1, 256, 256, 3, 3, 96, torch.float32, 768, 768, (16, 16)),
    (8, 64, 64, 4, 2, 64, torch.float32, 512, 512, (4, 8))])
def test_flash_bwd_plan(B, T, S, H, KV, hd, dtype, dq, dkdv, chunks):
    plan = tfa.bwd_plan(B, T, S, H, KV, hd, dtype)
    assert plan["blocks"]["dq"] == dq and plan["blocks"]["dkdv"] == dkdv
    if dtype == torch.float32:      # a block per SM, from shapes only
        assert dq >= 132 and dkdv >= 132
    n_spans = -(-T * (H // KV) // 16) + -(-S // 16)
    assert (plan["chunks"]["dq"], plan["chunks"]["dkdv"]) == chunks
    # one row record a warp; the summaries one per 16 threads of 128; at
    # f32 both in one launch, and the dq merge with the dk/dv sum in one
    rows, spans = -(-B * H * T // 4), B * -(-n_spans * 16 // 128)
    reduce = -(-B * S * KV * hd // 4 // 128)
    if dtype == torch.bfloat16:
        assert plan["blocks"]["rows"] == plan["blocks"]["dq_merge"] == rows
        assert plan["blocks"]["spans"] == spans
        assert plan["blocks"]["dkdv_reduce"] == reduce
    else:
        assert plan["blocks"]["prep"] == spans + rows
        assert plan["blocks"]["final"] == rows + reduce
    assert plan["ints"] == 4 * B * n_spans + dkdv
    if T == 1280:   # row records + dq chunks' (m, l) and sums + dk/dv sums
        assert plan["work"] == 40960 + 51200 * (2 + 256) + 13107200
    if T == 63:     # the same at f32: 4 x 16 x 2 x 8 row blocks of 16, 8
        # x 2 x 16 x 4 x 2 key blocks of 16, rows of 32 columns
        assert plan["work"] == 16128 + 16384 * (2 + 32) + 1048576


@pytest.mark.parametrize("n_tiles,n_units,want", [
    (80, 160, 5), (80, 2000, 1), (15, 10, 1), (16, 10, 2), (1000, 1, 8),
    (0, 1, 1)])
def test_flash_bwd_chunks(n_tiles, n_units, want):
    assert tfa.bwd_chunks(n_tiles, n_units) == want


LOG2E = np.float32(1.4426950408889634)


def _verify_cluster(pl, ql, tok, lens, u, w, nsplit):
    """The verify kernel's arithmetic over one cluster of ``nsplit``
    slices, in f32: per-slice (max, sum of exp2(x log2 e - max log2 e))
    merged across slices; p and r = max(p - q, 0) with sums per slice,
    the residual mass, each slice's starting cdf value and the total;
    the count of cdf <= w * total per slice, added; p[t], q[t] from
    expf and a true division."""
    B, R, V = pl.shape
    slice_ = (-(-V // nsplit) + 3) // 4 * 4
    out = [torch.zeros((B, R), dtype=d)
           for d in (torch.int32, torch.int32, torch.float32,
                     torch.float32)]

    def ms(x):
        m = x.max()
        return m, torch.exp2(x * LOG2E - m * LOG2E).sum()

    def merge(parts):
        M = max(m for m, _ in parts)
        return M, sum(s * torch.exp2((m - M) * LOG2E) for m, s in parts)

    for b in range(B):
        for r in range(int(lens[b])):
            cuts = [(min(V, k * slice_), min(V, (k + 1) * slice_))
                    for k in range(nsplit)]
            rows = []
            for x in (pl[b, r], ql[b, r]):
                parts = [ms(x[a:e]) for a, e in cuts if e > a]
                rows.append(merge(parts))
            (pm, ps), (qm, qs) = rows
            p = torch.exp2(pl[b, r] * LOG2E - pm * LOG2E) * (1 / ps)
            q = torch.exp2(ql[b, r] * LOG2E - qm * LOG2E) * (1 / qs)
            rr = (p - q).clamp_min(0)
            rsum = [rr[a:e].sum() for a, e in cuts]
            residual = sum(rsum) > 1e-12
            s = rr if residual else p
            sums = rsum if residual else [p[a:e].sum() for a, e in cuts]
            thr = w[b, r] * max(sum(sums), 1e-30)
            off, cnt = 0.0, 0
            for (a, e), tot in zip(cuts, sums):
                cnt += int(((off + torch.cumsum(s[a:e], 0)) <= thr).sum())
                off = off + tot
            t = int(tok[b, r])
            p_t = torch.exp(pl[b, r, t] - pm) / ps
            q_t = torch.exp(ql[b, r, t] - qm) / qs
            out[0][b, r] = int(u[b, r] <= p_t / max(q_t, 1e-30))
            out[1][b, r] = min(cnt, V - 1)
            out[2][b, r], out[3][b, r] = p_t, q_t
    return out


def _cdf_gap(p_lg, q_lg, tok_a, tok_b, w) -> float:
    """Distance, in f64, from w to the nearest cdf entry between two
    residual tokens of one draft position."""
    p = torch.softmax(p_lg.double(), -1)
    q = torch.softmax(q_lg.double(), -1)
    rr = (p - q).clamp_min(0)
    rr = rr / rr.sum() if rr.sum() > 1e-12 else p
    cdf = torch.cumsum(rr, 0) / rr.sum()
    lo, hi = sorted((int(tok_a), int(tok_b)))
    return float((cdf[max(lo - 1, 0):hi] - float(w)).abs().min())


@pytest.mark.parametrize("V,nsplit", [(199, 1), (199, 8), (20, 8),
                                      (32, 3), (4096, 4), (30011, 8)])
def test_verify_cluster_arithmetic_matches_plain(V, nsplit):
    """The kernel's split of V over a cluster (ragged and empty slices
    included), emulated, gives the plain version's verdicts: flags equal,
    p_tok / q_tok within rtol 1e-5, residual tokens equal but where w
    lies within 1e-6 of a cdf boundary (the card checks' tolerances)."""
    args = _torch(*_verify_inputs(7, 3, 4, V))
    got = _verify_cluster(*args, nsplit)
    want = ref.verify_accept_batched_ref(*args)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=0)
    for b, r in zip(*torch.nonzero(got[1] != want[1], as_tuple=True)):
        assert _cdf_gap(args[0][b, r], args[1][b, r], got[1][b, r],
                        want[1][b, r], args[5][b, r]) <= 1e-6


@pytest.mark.parametrize("valid", [None, 21, 0])
def test_plain_gather_matches_pallas(valid):
    rng = np.random.default_rng(4)
    pages = rng.normal(size=(9, 4, 24)).astype(np.float32)
    table = np.asarray([7, 2, 5, 0, 8, 3], np.int32)
    n_valid = table.size * 4 if valid is None else valid
    got = ref.paged_gather_ref(*_torch(pages, table), n_valid).numpy()
    want = np.asarray(jops.paged_gather(pages, table, valid, interpret=True))
    np.testing.assert_array_equal(got, want)


def test_ops_routes_cpu_tensors_to_plain_versions():
    q, kp, vp, table, lens, q_start = _torch(
        *_attn_inputs(1, 2, 3, 4, 2, 16, 8))
    before = dict(ops.LAUNCHES)
    np.testing.assert_array_equal(
        ops.paged_attention(q, kp, vp, table, lens, q_start).numpy(),
        ref.paged_attention_ref(q, kp, vp, table, lens, q_start).numpy())
    vargs = _torch(*_verify_inputs(2, 2, 3, 50))
    for a, b in zip(ops.verify_accept_batched(*vargs),
                    ref.verify_accept_batched_ref(*vargs)):
        assert torch.equal(a, b)
    pages, tab = _torch(np.ones((3, 2, 4), np.float32),
                        np.asarray([2, 0], np.int32))
    assert torch.equal(ops.paged_gather(pages, tab, 3),
                       ref.paged_gather_ref(pages, tab, 3))
    assert ops.LAUNCHES == before          # no kernel ran


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper never runs the plain version: a CPU tensor is an error
    (raised before any build is attempted)."""
    q, kp, vp, table, lens, q_start = _torch(
        *_attn_inputs(1, 2, 3, 4, 2, 16, 8))
    with pytest.raises(ValueError, match="cpu"):
        tpa.paged_attention(q, kp, vp, table, lens, q_start)
    with pytest.raises(ValueError, match="cpu"):
        tva.verify_accept_batched(*_torch(*_verify_inputs(2, 2, 3, 50)))
    with pytest.raises(ValueError, match="cpu"):
        tpg.paged_gather(*_torch(np.ones((3, 2, 4), np.float32),
                                 np.asarray([2, 0], np.int32)), 3)
    q, k, v, qp, kpos = _torch(*_flash_inputs(1, 1, 2, 8, 4, 2, 16, 20))
    with pytest.raises(ValueError, match="cpu"):
        tfa.flash_attention(q, k, v, qp, kpos)
    with pytest.raises(ValueError, match="cpu"):
        tba.branch_decode_attention(*_torch(*_branch_inputs(
            1, 2, 1, 8, 3, 2, 16)))
    with pytest.raises(ValueError, match="cpu"):
        tva.verify_accept(*_torch(*_single_verify_inputs(1, 3, 50)))


def _flash_inputs(seed, B, T, S, H, KV, hd, L, stale=0, dead=0):
    """A dense ring of S slots after L tokens: slot s holds the newest
    position p < L with p % S == s (the ring wraps when L > S), or -1;
    ``dead`` random slots are reset to -1 and ``stale`` others hold
    positions at or past L (left by a rollback).  The T queries sit at
    L - T .. L - 1 and their own slots stay valid, so every query sees a
    key."""
    rng = np.random.default_rng(seed)
    kpos = np.full((B, S), -1, np.int32)
    for b in range(B):
        for p in range(max(0, L - S), L):
            kpos[b, p % S] = p
        own = {p % S for p in range(L - T, L)}
        others = rng.permutation(np.asarray(
            [s for s in range(S) if s not in own], np.int64))
        kpos[b, others[:dead]] = -1
        kpos[b, others[dead:dead + stale]] = L + rng.integers(
            0, 8, size=min(stale, len(others) - dead))
    qpos = np.broadcast_to(np.arange(L - T, L, dtype=np.int32), (B, T))
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    return q, k, v, np.ascontiguousarray(qpos), kpos


FLASH_CASES = [
    # decode on a fresh ring: most slots -1
    dict(B=2, T=1, S=64, H=4, KV=2, hd=32, L=9),
    # verify chunk on a wrapped ring with stale and dead slots, GQA
    dict(B=2, T=5, S=24, H=4, KV=2, hd=16, L=61, stale=4, dead=3),
    # sliding window over a wrapped ring, softcap, MHA
    dict(B=1, T=4, S=16, H=2, KV=2, hd=32, L=40, stale=2, window=6,
         cap=20.0),
    # prefill-shaped: T = S = L, group of 4
    dict(B=1, T=12, S=12, H=8, KV=2, hd=16, L=12, window=5),
    # hubert-xlarge-shaped: head dim 80, bidirectional (no horizon)
    dict(B=1, T=6, S=6, H=2, KV=2, hd=80, L=6, causal=False),
    # gemma3-4b-shaped: head dim 256, GQA 2, window over a wrapped ring
    dict(B=1, T=3, S=20, H=4, KV=2, hd=256, L=30, stale=2, window=7),
    # B >= 2 with T x G > 16 query rows of a kv head (two row tiles)
    dict(B=2, T=9, S=24, H=8, KV=4, hd=16, L=40, stale=3, dead=2),
    # prefill-shaped at head dim 80: 24 rows a kv head, window, softcap
    dict(B=3, T=6, S=16, H=12, KV=3, hd=80, L=16, window=5, cap=10.0),
    # granite-moe's draft head dim 85: a verify chunk on a wrapped ring
    # with stale and dead slots, and bidirectional; hd 200 GQA, softcap
    dict(B=2, T=4, S=24, H=3, KV=3, hd=85, L=40, stale=2, dead=2),
    dict(B=1, T=9, S=9, H=3, KV=3, hd=85, L=9, causal=False),
    dict(B=1, T=3, S=20, H=4, KV=2, hd=200, L=30, window=7, cap=20.0),
]


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"case{i}" for i in range(len(FLASH_CASES))])
def test_plain_flash_attention_matches_pallas_and_attend(case):
    case = dict(case)
    kw = {k: case.pop(k) for k in ("window", "cap", "causal") if k in case}
    q, k, v, qpos, kpos = _flash_inputs(3, **case)
    got = tlayers.attend(*_torch(q, k, v, qpos, kpos), kv_chunk=8,
                         **kw).numpy()
    jargs = [jnp.asarray(a) for a in (q, k, v, qpos, kpos)]
    pallas = jops.flash_attention(*jargs, bq=8, bk=8, interpret=True, **kw)
    plain = jlayers.attend(*jargs, kv_chunk=8, **kw)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(plain), rtol=0, atol=1e-5)
    assert np.isfinite(got).all()


def test_flash_q_ctx_horizon_matches_attend():
    q, k, v, qpos, kpos = _flash_inputs(4, 2, 6, 32, 4, 2, 16, 30)
    qctx = np.minimum(qpos, 26).astype(np.int32)
    got = ops.flash_attention(*_torch(q, k, v, qpos, kpos),
                              q_ctx=torch.from_numpy(qctx)).numpy()
    want = jlayers.attend(*[jnp.asarray(a) for a in (q, k, v, qpos, kpos)],
                          q_ctx=jnp.asarray(qctx))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_flash_route_on_cpu_is_the_plain_version():
    args = _torch(*_flash_inputs(5, 1, 3, 16, 4, 2, 16, 20, stale=2))
    before = dict(ops.LAUNCHES)
    assert torch.equal(ops.flash_attention(*args, window=4, kv_chunk=8),
                       ref.flash_attention_ref(*args, window=4, kv_chunk=8))
    assert ops.LAUNCHES == before and "flash_attention" in ops.LAUNCHES


@pytest.mark.parametrize("hd,offset", [(6, 0), (32, 1)])
def test_attention_wrappers_need_16_byte_rows(hd, offset):
    """The attention kernels load K/V 16 bytes at a time only on their
    aligned path, which needs 16-byte rows from a 16-byte aligned start:
    rows that are not a multiple of 16 bytes, or storage that is not
    16-byte aligned, take the ragged path (element loads at the next
    compiled width) instead of reading past or across rows."""
    flat = torch.zeros(4 * hd + 8)
    k = flat[offset:offset + 4 * hd].view(1, 4, 1, hd)
    assert tda.head_dim_path("attention", hd, k, k) == (
        {6: 16, 32: 32}[hd], True)
    assert tda.head_dim_path("attention", 32, torch.zeros(1, 4, 1, 32),
                             torch.zeros(1, 4, 1, 32)) == (32, False)


# (k branches, Tq, Sp, Ss, KV, hd): the reference's sweep
# (tests/test_kernels.py) with one query after every key, then odd
# lengths with Tq > 1, so the suffix is causally cut, and invalid prefix
# slots
BRANCH_CASES = [(2, 1, 16, 4, 2, 32), (4, 1, 33, 7, 4, 64),
                (6, 1, 8, 1, 1, 16), (3, 3, 29, 5, 2, 32),
                (5, 2, 13, 11, 1, 16),
                # head dims off the aligned path: 85 (granite-moe's
                # draft's) and 40
                (6, 1, 29, 5, 3, 85), (3, 2, 13, 4, 2, 40)]


def _branch_inputs(seed, kb, Tq, Sp, Ss, KV, hd, dead=0):
    rng = np.random.default_rng(seed)
    H = 2 * KV
    pk, pv = (rng.normal(size=(1, Sp, KV, hd)).astype(np.float32)
              for _ in range(2))
    ppos = np.arange(Sp, dtype=np.int32)[None].copy()
    ppos[0, 1:1 + dead] = -1                      # unwritten prefix slots
    sk, sv = (rng.normal(size=(kb, Ss, KV, hd)).astype(np.float32)
              for _ in range(2))
    spos = np.broadcast_to(np.arange(Sp, Sp + Ss, dtype=np.int32),
                           (kb, Ss)).copy()
    q = rng.normal(size=(kb, Tq, H, hd)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(Sp + Ss - Tq + 1, Sp + Ss + 1,
                                     dtype=np.int32), (kb, Tq)).copy()
    return q, pk, pv, ppos, sk, sv, spos, qpos


@pytest.mark.parametrize(
    "case,dtype,cap",
    [(c, d, None) for c in BRANCH_CASES for d in ("float32", "bfloat16")]
    + [(BRANCH_CASES[1], "float32", 5.0), (BRANCH_CASES[3], "bfloat16", 5.0)],
    ids=lambda x: "x".join(map(str, x)) if isinstance(x, tuple) else str(x))
def test_plain_branch_decode_matches_pallas(case, dtype, cap):
    """The plain version against the reference's two flash passes merged
    by (m, l), run in interpret mode."""
    args = _branch_inputs(11, *case, dead=2 if case[1] > 1 else 0)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    fl = (0, 1, 2, 4, 5)                          # q and K/V arrays
    jargs = [jnp.asarray(a).astype(jd) if i in fl else jnp.asarray(a)
             for i, a in enumerate(args)]
    targs = [x.to(td) if i in fl else x
             for i, x in enumerate(_torch(*args))]
    want = jops.branch_decode_attention(*jargs, cap=cap, interpret=True)
    got = ref.branch_decode_ref(*targs, cap=cap)
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=0,
                               atol=2e-5 if dtype == "float32" else 2e-2)
    assert torch.equal(ops.branch_decode_attention(*targs, cap=cap), got)


def _single_verify_inputs(seed, R, V):
    rng = np.random.default_rng(seed)
    pl = (2 * rng.normal(size=(R, V))).astype(np.float32)
    ql = (2 * rng.normal(size=(R, V))).astype(np.float32)
    tok = rng.integers(0, V, size=R).astype(np.int32)
    u = rng.random(R, dtype=np.float32)
    w = rng.random(R, dtype=np.float32)
    return pl, ql, tok, u, w


@pytest.mark.parametrize("R,V,dtype", [(1, 32, "float32"),
                                       (5, 211, "float32"),
                                       (9, 1024, "float32"),
                                       (9, 1024, "bfloat16")])
def test_plain_single_verify_matches_pallas(R, V, dtype):
    """The single-request (R, V) verify against the reference's
    ``verify_accept`` kernel in interpret mode (the sweep of
    tests/test_kernels.py; bf16 logits are read as f32 by both)."""
    args = _single_verify_inputs(5, R, V)
    jargs = [jnp.asarray(a) for a in args]
    targs = list(_torch(*args))
    if dtype == "bfloat16":
        jargs[:2] = [a.astype(jnp.bfloat16) for a in jargs[:2]]
        targs[:2] = [x.bfloat16() for x in targs[:2]]
    want = [np.asarray(x) for x in jva.verify_accept(*jargs,
                                                     interpret=True)]
    got = [x.numpy() for x in ref.verify_accept_ref(*targs)]
    np.testing.assert_array_equal(got[0], want[0])           # accept
    np.testing.assert_array_equal(got[1], want[1])           # residual
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-6)
    for a, b in zip(ops.verify_accept(*targs), ref.verify_accept_ref(*targs)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# split-KV: the decode kernels' split-and-merge arithmetic, emulated
# ---------------------------------------------------------------------------

H100_SMS = 132


def _split_partial(q, k, v, q_pos, k_pos, lo, hi, window=0, cap=None,
                   causal=True):
    """One split of the decode kernel: attention of q (N, T, H, hd) over
    keys [lo, hi) of k, v (N, S, KV, hd) with positions k_pos (N, S) (-1
    invalid), causal by q_pos (N, T) unless ``causal`` is False.  Returns
    (o, m, l) as the kernel writes them: o = sum p v / max(l, 1e-20),
    m = -1e30 and l = 0 where the split shows a query no key."""
    N, T, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    kk = k[:, lo:hi].float()
    vv = v[:, lo:hi].float()
    kp = k_pos[:, lo:hi].long()[:, None, :]                   # (N, 1, s)
    qp = q_pos.long()[:, :, None]                             # (N, T, 1)
    qr = q.float().reshape(N, T, KV, G, hd)
    x = torch.einsum("ntkgh,nskh->nkgts", qr, kk) / np.sqrt(hd)
    if cap is not None:
        x = cap * torch.tanh(x / cap)
    vis = (kp >= 0) & (kp <= qp) if causal else (kp >= 0).expand(
        N, T, -1)
    if window > 0:
        vis &= (qp - kp) < window
    vis = vis[:, None, None]                                  # (N,1,1,T,s)
    x = torch.where(vis, x, torch.full_like(x, -float("inf")))
    m = x.amax(-1).clamp_min(ref.NEG_INF) if x.shape[-1] else \
        torch.full(x.shape[:-1], ref.NEG_INF)
    p = torch.where(vis, torch.exp(x - m[..., None]), torch.zeros_like(x))
    l = p.sum(-1)
    o = torch.einsum("nkgts,nskh->nkgth", p, vv) / l.clamp_min(1e-20)[
        ..., None]
    return o, m, l


def _merge(parts):
    """The merging block's combine: weights l * exp(m - M), M the largest
    m; zeros where every split has l = 0.  parts: [(o (N, KV, G, T, hd),
    m, l (N, KV, G, T))]; returns (N, KV, G, T, hd)."""
    M = torch.stack([m for _, m, _ in parts]).amax(0)
    ws = [l * torch.exp(m - M) for _, m, l in parts]
    den = torch.stack(ws).sum(0).clamp_min(1e-20)
    return sum(o * w[..., None] for (o, _, _), w in zip(parts, ws)) / \
        den[..., None]


def _split_merge(q, k, v, q_pos, k_pos, n_split, split_len, **kw):
    """Attention computed split by split and merged as the kernel merges;
    (N, T, H, hd) f32."""
    S = k.shape[1]
    parts = [_split_partial(q, k, v, q_pos, k_pos, z * split_len,
                            min(S, (z + 1) * split_len), **kw)
             for z in range(n_split)]
    N, T, H, hd = q.shape
    return _merge(parts).permute(0, 3, 1, 2, 4).reshape(N, T, H, hd)


def _paged_dense(kp, vp, table, lens):
    """The paged inputs as dense per-row K/V over n_max * ps slots, key
    positions -1 at and past lens (what the kernel's key() returns)."""
    B, n_max = table.shape
    ps, KV, hd = kp.shape[1:]
    S = n_max * ps
    k = kp[table.long()].reshape(B, S, KV, hd)
    v = vp[table.long()].reshape(B, S, KV, hd)
    pos = torch.arange(S)[None].expand(B, S)
    return k, v, torch.where(pos < lens.long()[:, None], pos, -1)


@pytest.mark.parametrize("units,max_keys,want", [
    (256, 112, (1, 112)),          # 7B decode B=8: the grid fills the card
    (672, 112, (1, 112)),          # 68M B=56
    (32, 4096, (4, 1024)),         # 7B B=1 long row
    (32, 552, (3, 192)),           # 7B branch decode k=6, Sp=504, Ss=8
    (32, 2056, (4, 576)),          # 7B branch decode, Sp=2048
    (4, 100, (1, 100)),            # too few keys to split
    (128, 512, (1, 512)),          # 7B B=4: the grid covers the SMs
    (64, 1024, (2, 512)),          # 7B B=2: half the SMs idle
    (1, 1 << 20, (8, 131072)),     # capped at MAX_SPLITS (a cluster)
    (0, 50, (1, 50)),
])
def test_split_plan(units, max_keys, want):
    got = tda.plan_splits(units, max_keys, H100_SMS)
    assert got == want
    n, length = got
    assert n * length >= max_keys and (n - 1) * length < max_keys
    assert n <= tda.MAX_SPLITS
    if n > 1:
        assert length % tda.SPLIT_ALIGN == 0 and length >= tda.MIN_SPLIT_KEYS


def test_split_plans_of_the_wrappers():
    """The wrappers' plans: blocks = 16-row tiles x kv heads; the branch
    plan covers the prefix and the suffixes of its fullest row tile."""
    assert tpa.split_plan(8, 8, 32, 32, 7, 16, H100_SMS) == (1, 112)
    assert tpa.split_plan(1, 17, 4, 2, 80, 16, H100_SMS) == (7, 192)
    assert tba.split_plan(6, 1, 32, 32, 504, 8, H100_SMS) == (3, 192)
    assert tba.split_plan(6, 1, 32, 32, 2048, 8, H100_SMS) == (4, 576)
    assert tba.max_branches_per_tile(6, 1, 1) == 6
    assert tba.max_branches_per_tile(6, 3, 1) == 6      # 18 rows, 2 tiles
    assert tba.max_branches_per_tile(6, 3, 4) == 2      # 12 rows a branch
    assert tba.max_branches_per_tile(2, 9, 2) == 2
    assert tda.row_tiles(17) == 2 and tda.row_tiles(16) == 1
    # flash plans from the ring's S: the 7B verify chunk and prefill on a
    # 512-slot ring split; the fork (B=6) and the cache-less rows fill the
    # card; gemma2's windowed row: 2 row tiles x 16 kv heads, 4 splits
    assert tfa.split_plan(1, 5, 32, 32, 512, H100_SMS) == (4, 128)
    assert tfa.split_plan(1, 15, 32, 32, 512, H100_SMS) == (4, 128)
    assert tfa.split_plan(6, 10, 32, 32, 512, H100_SMS) == (1, 512)
    assert tfa.split_plan(2, 48, 32, 32, 48, H100_SMS) == (1, 48)
    assert tfa.split_plan(1, 16, 32, 16, 4608, H100_SMS) == (4, 1152)
    assert tfa.split_plan(1, 5, 8, 4, 2048, H100_SMS) == (8, 256)
    # 64 or more rows of an item per kv head take the wide block: the
    # 512-token prefill fills the card with 8 x 32 blocks; 4 x 2 blocks of
    # a long ring split
    assert tfa.block_rows(512, 32, 32) == tda.WIDE_ROWS
    assert tfa.block_rows(48, 32, 32) == tda.ROWS
    assert tfa.block_rows(16, 16, 4) == tda.WIDE_ROWS        # T x G = 64
    assert tfa.split_plan(1, 512, 32, 32, 512, H100_SMS) == (1, 512)
    assert tfa.split_plan(1, 64, 8, 2, 1024, H100_SMS) == (8, 128)


# (B, T, H, KV, hd, ps, lens, window): long rows at B = 1 split as the
# wrapper plans them; a window that leaves whole splits dead; a
# zero-length row; a T tile over 16 rows
PAGED_SPLIT_CASES = [
    (1, 1, 4, 4, 16, 16, [1500], 0),
    (1, 3, 4, 2, 16, 16, [1020], 100),
    (2, 1, 2, 2, 32, 16, [1200, 0], 0),
    (1, 9, 4, 2, 16, 8, [1100], 40),
]


@pytest.mark.parametrize("case", PAGED_SPLIT_CASES,
                         ids=[f"case{i}" for i in range(len(PAGED_SPLIT_CASES))])
def test_split_merge_emulation_matches_plain_paged(case):
    B, T, H, KV, hd, ps, lens, window = case
    rng = np.random.default_rng(21)
    table, P = _layout(rng, lens, ps, sum(-(-n // ps) for n in lens) + 1)
    q, kp, vp = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 for s in ((B, T, H, hd), (P + 1, ps, KV, hd),
                           (P + 1, ps, KV, hd)))
    table = torch.from_numpy(table)
    lens_t = torch.tensor(lens, dtype=torch.int32)
    q_start = torch.clamp(lens_t - T, min=0).to(torch.int32)
    n_split, split_len = tpa.split_plan(
        B, T, H, KV, table.shape[1], ps, H100_SMS)
    assert n_split > 1
    k, v, kpos = _paged_dense(kp, vp, table, lens_t)
    qpos = q_start.long()[:, None] + torch.arange(T)[None]
    got = _split_merge(q, k, v, qpos, kpos, n_split, split_len,
                       window=window)
    want = ref.paged_attention_ref(q, kp, vp, table, lens_t, q_start,
                                   window=window)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    if window:
        # some split shows every query no key: it must weigh nothing
        first = _split_partial(q, k, v, qpos, kpos, 0, split_len,
                               window=window)
        assert (first[2] == 0).all() and torch.isfinite(first[0]).all()
    for b, n in enumerate(lens):
        if n == 0:
            assert (got[b] == 0).all()


# (B, T, S, H, KV, hd, L, stale, dead, window, causal): a wrapped ring
# (positions unsorted along the slots) with stale and dead slots; a
# window that leaves whole splits dead; bidirectional rows over a ring
# with stale slots (seen without a horizon); a group over two row tiles
FLASH_SPLIT_CASES = [
    (1, 3, 1024, 4, 2, 16, 1500, 5, 4, 0, True),
    (1, 2, 768, 2, 2, 16, 700, 0, 0, 100, True),
    (2, 4, 512, 4, 4, 16, 900, 6, 3, 0, False),
    (1, 9, 640, 4, 2, 32, 2000, 3, 0, 300, True),
    (1, 64, 1024, 8, 2, 16, 1500, 4, 2, 200, True),          # wide blocks
]


@pytest.mark.parametrize("case", FLASH_SPLIT_CASES,
                         ids=[f"case{i}" for i in range(len(FLASH_SPLIT_CASES))])
def test_split_merge_emulation_matches_plain_flash(case):
    """Flash on a dense ring as the kernel splits it: key slot ranges of
    split_len at the wrapper's plan, merged by (m, l)."""
    B, T, S, H, KV, hd, L, stale, dead, window, causal = case
    q, k, v, qpos, kpos = _torch(*_flash_inputs(23, B, T, S, H, KV, hd, L,
                                                stale=stale, dead=dead))
    n_split, split_len = tfa.split_plan(B, T, H, KV, S, H100_SMS)
    assert n_split > 1
    kw = dict(window=window, causal=causal)
    got = _split_merge(q, k, v, qpos, kpos, n_split, split_len, **kw)
    want = ref.flash_attention_ref(q, k, v, qpos, kpos, **kw)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    if window:
        # some split shows every query no key: it must weigh nothing
        dead_split = [z for z in range(n_split)
                      if (_split_partial(q, k, v, qpos, kpos, z * split_len,
                                         min(S, (z + 1) * split_len),
                                         **kw)[2] == 0).all()]
        assert dead_split
    if L > S:
        assert not bool((kpos[:, 1:] >= kpos[:, :-1]).all())  # unsorted


def _branch_block(q, pk, pv, ppos, sk, sv, spos):
    """The branch kernel's view of one row tile holding every branch: the
    key sequence is the prefix then each branch's suffix; a suffix key is
    invisible to other branches' rows (position -1 in their copy)."""
    kb, Ss = sk.shape[:2]
    k = torch.cat([pk[0], sk.reshape(kb * Ss, *sk.shape[2:])])
    v = torch.cat([pv[0], sv.reshape(kb * Ss, *sv.shape[2:])])
    pos = []
    for b in range(kb):
        own = torch.full((kb, Ss), -1, dtype=spos.dtype)
        own[b] = spos[b]
        pos.append(torch.cat([ppos[0], own.reshape(-1)]))
    return (k[None].expand(kb, -1, -1, -1), v[None].expand(kb, -1, -1, -1),
            torch.stack(pos))


@pytest.mark.parametrize("case,cap", [((3, 2, 1100, 5, 2, 16), None),
                                      ((6, 1, 1030, 8, 4, 32), 5.0)])
def test_split_merge_emulation_matches_plain_branch(case, cap):
    """Branch decode as the kernel splits it: one block per kv head over
    the prefix and every branch's suffix, at the wrapper's plan."""
    kb, Tq, Sp, Ss, KV, hd = case
    args = _torch(*_branch_inputs(13, *case, dead=3))
    q, pk, pv, ppos, sk, sv, spos, qpos = args
    H = q.shape[2]
    n_split, split_len = tba.split_plan(kb, Tq, H, KV, Sp, Ss, H100_SMS)
    assert n_split > 1
    k, v, kpos = _branch_block(q, pk, pv, ppos, sk, sv, spos)
    got = _split_merge(q, k, v, qpos, kpos, n_split, split_len, cap=cap)
    want = ref.branch_decode_ref(*args, cap=cap)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_split_merge_emulation_matches_the_jax_merge():
    """Two splits, the first the prefix: the emulation against the
    reference's own merge (ops.branch_decode_attention, two flash passes
    with out_stats, interpret mode)."""
    case = (4, 2, 40, 9, 2, 16)
    args = _branch_inputs(17, *case, dead=2)
    targs = _torch(*args)
    q, pk, pv, ppos, sk, sv, spos, qpos = targs
    k, v, kpos = _branch_block(q, pk, pv, ppos, sk, sv, spos)
    got = _split_merge(q, k, v, qpos, kpos, 2, case[2])
    want = jops.branch_decode_attention(*[jnp.asarray(a) for a in args],
                                        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_merge_of_jax_flash_stats_matches_plain():
    """The merge fed by the JAX flash kernel's per-split out_stats
    (interpret mode), one split showing every query no key: the kernel's
    combine gives the plain version's output."""
    q, k, v, qpos, kpos = _flash_inputs(19, 2, 3, 48, 4, 2, 16, 48)
    window = 20                        # keys 0..24 are seen by no query
    parts = []
    for lo, hi in ((0, 16), (16, 32), (32, 48)):
        o, m, l = jfa.flash_attention(
            jnp.asarray(q), jnp.asarray(k[:, lo:hi]), jnp.asarray(v[:, lo:hi]),
            jnp.asarray(qpos), jnp.asarray(kpos[:, lo:hi]), window=window,
            out_stats=True, bq=8, bk=8, interpret=True)
        B, T, H, hd = q.shape
        KV = k.shape[2]
        o = torch.from_numpy(np.array(o)).reshape(
            B, T, KV, H // KV, hd).permute(0, 2, 3, 1, 4)
        parts.append((o, torch.from_numpy(np.array(m)),
                      torch.from_numpy(np.array(l))))
    got = _merge(parts).permute(0, 3, 1, 2, 4).reshape(q.shape)
    want = ref.flash_attention_ref(*_torch(q, k, v, qpos, kpos),
                                   window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    emu = _split_merge(*_torch(q, k, v, qpos, kpos), 3, 16, window=window)
    np.testing.assert_allclose(emu.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_decode_loop_head_dims_cover_the_repos_configs(monkeypatch):
    """No attention-bearing configuration of the repo (src/repro/configs,
    the tiny pairs, the hybrid and local pairs) nor any assigned config's
    ``draft()`` is refused by the decode loop: every head dim is one of
    its aligned widths but granite-moe's draft's (hd 85, which no
    16-byte bf16 row holds), which takes the ragged path at width 96.
    Every head dim from 1 to 256 passes, 257 does not.  The pairs'
    configs are read without initialising their weights."""
    import importlib
    import pkgutil

    import repro.configs as jconfigs
    from repro.configs import ARCH_IDS, get_config
    from repro.configs.paper_pairs import tiny_pair
    from repro.models.config import ModelConfig
    from repro.training import pairs as jpairs

    cfgs = []
    for mod in pkgutil.iter_modules(jconfigs.__path__):
        m = importlib.import_module(f"repro.configs.{mod.name}")
        cfgs += [c for c in vars(m).values() if isinstance(c, ModelConfig)]
    assert {"gemma3-4b", "hubert-xlarge"} <= {c.name for c in cfgs}
    cfgs += list(tiny_pair())
    cfgs += [jpairs.TARGET_CFG, jpairs.DRAFT_MIS_CFG, jpairs.DRAFT_ALI_CFG]
    monkeypatch.setattr(jpairs.M, "init_params", lambda *a, **k: None)
    for kind in jpairs.HYBRID_KINDS:
        _, dcfg, _, tcfg = jpairs.hybrid_pair(kind)
        cfgs += [dcfg, tcfg]
    for kind in jpairs.LOCAL_KINDS:
        _, dcfg, _, tcfg = jpairs.local_pair(kind)
        cfgs += [dcfg, tcfg]
    drafts = [get_config(a).draft() for a in ARCH_IDS]
    dims = {c.name: c.hd for c in cfgs + drafts if c.has_attention()}
    assert {80, 144, 160, 256} <= set(dims.values())
    ragged = {}
    for n, hd in dims.items():
        x = torch.zeros(1, hd, dtype=torch.bfloat16)
        width, rag = tda.head_dim_path("flash_attention", hd, x)
        if rag:
            ragged[n] = width
    assert ragged == {"granite-moe-3b-a800m-draft": 96}, ragged
    for hd in range(1, 257):
        tda.check_head_dim("flash_attention", hd)
    with pytest.raises(ValueError, match="head dim 257 is outside 1-256"):
        tda.check_head_dim("flash_attention", 257)
