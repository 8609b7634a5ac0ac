"""The port's CUDA kernels against their plain PyTorch versions, and the
batched and sequential engines on the card.  Every test needs a CUDA
device and skips without one.  The file imports no JAX, so it also runs
where JAX is not installed:

    PYTHONPATH=src python -m pytest -p no:cacheprovider --noconftest \\
        tests/test_torch_cuda.py

Tolerances: paged and flash attention f32 atol 1e-4; bf16 per element
min(2e-2, 1.6e-2 * |want| + 1e-3 * rms(want)), two bf16 spacings of the
value (another summation order, then bf16 output rounding); the runner's
logits on the card against the CPU, f32, atol 1e-4; verify accept flags
equal, p_tok/q_tok rtol 1e-5, residual tokens equal but for a draw within f32
rounding of a cdf boundary; gather bitwise; selective scan and its ring
entry rtol = atol = 2e-5 (the reference's own Pallas-vs-oracle
tolerance), untouched ring slots bitwise; a Mamba ring forward's
logits against the CPU atol 1e-4 and its conv tails 1e-5 (PyTorch's
elementwise ops on two devices); branch decode as
the other attention kernels; the single-request verify as the batched
one, p_tok/q_tok atol 1e-6.  Backward kernels against their plain
backwards (``ref.flash_attention_bwd_ref``, ``ref.ssm_scan_bwd_ref``):
f32 within 1e-4 x max(1, max |want|) (another summation order in
float32), bf16 within 2^-6 x max |want| of each gradient (a few bf16
spacings at the gradient's scale: both sides read the same bf16
inputs, accumulate in f32 and round once); an f32 training step's
loss and gradients on the card against the CPU's within rtol 1e-3,
atol 1e-4 (the kernels' and PyTorch's summation orders through a whole
forward and backward).
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.core import hrad as H
from repro_torch.kernels import branch_attention as BA
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import ssm_scan as SS
from repro_torch.kernels import verify_accept as VA
from repro_torch.launch import serve as SV
from repro_torch.models import model as M
from repro_torch.runtime import prng
from repro_torch.runtime import runner as R
from repro_torch.runtime.engines import EngineConfig, SpSEngine
from repro_torch.runtime.specbranch import SpecBranchEngine
from repro_torch.configs import get_config
from repro_torch.training import optim as TO
from repro_torch.training import train as TT
from repro_torch.training.pairs import get_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _attn_inputs(seed, B, T, H, KV, hd, ps, zero_rows=0, lens=None):
    """Random fragmented page tables over ragged rows; ``lens`` overrides
    the random lengths (0 for a zero-length row)."""
    rng = np.random.default_rng(seed)
    if lens is None:
        lens = [int(rng.integers(T + 1, 6 * ps)) for _ in range(B)]
        for b in range(B - zero_rows, B):
            lens[b] = 0
    n_pages = [-(-ln // ps) for ln in lens]
    P = sum(n_pages) + 2
    table = np.full((B, max(max(n_pages), 1)), P, np.int32)
    perm = rng.permutation(P)
    off = 0
    for b, n in enumerate(n_pages):
        table[b, :n] = perm[off:off + n]
        off += n
    kp = rng.normal(size=(P + 1, ps, KV, hd)).astype(np.float32)
    vp = rng.normal(size=(P + 1, ps, KV, hd)).astype(np.float32)
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    return q, kp, vp, table, lens, np.maximum(lens - T, 0).astype(np.int32)


def _assert_attn_close(got, want):
    err = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        assert err.max().item() <= 1e-4
        return
    w = want.float()
    lim = (1.6e-2 * w.abs() + 1e-3 * w.pow(2).mean().sqrt()).clamp_max(2e-2)
    assert (err <= lim).all(), (err / lim).max().item()


def _dev(arrays, device):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


ATTN_CASES = [
    dict(B=1, T=1, H=4, KV=4, hd=32, ps=8),
    dict(B=3, T=5, H=4, KV=2, hd=16, ps=8),
    dict(B=2, T=7, H=8, KV=2, hd=64, ps=16, window=5),
    dict(B=2, T=3, H=6, KV=3, hd=32, ps=4, cap=20.0),
    dict(B=3, T=2, H=4, KV=2, hd=16, ps=8, zero_rows=2),
    dict(B=4, T=70, H=4, KV=2, hd=128, ps=16),       # T tiled (140 rows)
    # G * T rows of 8, 16, 17 and 64 at head dims 64, 32, 16 and 128
    dict(B=2, T=8, H=2, KV=2, hd=64, ps=16),
    dict(B=2, T=16, H=4, KV=4, hd=32, ps=8),
    dict(B=3, T=17, H=2, KV=2, hd=16, ps=8),
    dict(B=2, T=16, H=8, KV=2, hd=128, ps=16),
    # a long row at B = 1, 7B head width: the key axis splits
    dict(B=1, T=1, H=32, KV=32, hd=128, ps=16, lens=[4000]),
    # a window that leaves whole splits dead
    dict(B=1, T=4, H=32, KV=32, hd=128, ps=16, lens=[4096], window=700),
    # a zero-length row beside a split one
    dict(B=2, T=1, H=8, KV=8, hd=64, ps=16, lens=[3000, 0]),
    # head dim 80 (hubert-xlarge) over 32 rows; head dim 256 (gemma3-4b
    # widths: GQA 2, window) unsplit and over a long row that splits
    dict(B=2, T=16, H=16, KV=8, hd=80, ps=16),
    dict(B=3, T=4, H=8, KV=4, hd=256, ps=16, window=9),
    dict(B=1, T=2, H=8, KV=4, hd=256, ps=16, lens=[3000], window=1024),
    # the draft() head dims: 160 (gemma3-4b's draft, window; mistral-nemo's)
    # and 144 (gemma2-27b's: nine k-steps), unsplit and over a split row
    dict(B=8, T=4, H=2, KV=2, hd=160, ps=16, window=9),
    dict(B=3, T=4, H=4, KV=4, hd=144, ps=16),
    dict(B=1, T=2, H=4, KV=4, hd=144, ps=16, lens=[3000], window=1024),
    dict(B=1, T=1, H=4, KV=4, hd=160, ps=16, lens=[3000]),
    # the ragged path: granite-moe's draft (3 heads of 85, rows of 170 /
    # 340 bytes) unsplit and over a split row; hd 40 (GQA, softcap) and
    # 200 (a split row beside a short one) at widths 64 and 256
    dict(B=8, T=4, H=3, KV=3, hd=85, ps=16, window=9),
    dict(B=1, T=2, H=3, KV=3, hd=85, ps=16, lens=[3000], window=1024),
    dict(B=3, T=5, H=4, KV=2, hd=40, ps=8, cap=20.0),
    dict(B=2, T=3, H=2, KV=1, hd=200, ps=16, lens=[2500, 7]),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=[f"case{i}" for i in range(len(ATTN_CASES))])
def test_paged_attention_kernel_matches_plain(cuda, case, dtype):
    case = dict(case)
    kw = {k: case.pop(k) for k in ("window", "cap") if k in case}
    q, kp, vp, table, lens, qs = _dev(_attn_inputs(5, **case), cuda)
    dt = getattr(torch, dtype)
    q, kp, vp = q.to(dt), kp.to(dt), vp.to(dt)
    n0 = ops.LAUNCHES["paged_attention"]
    got = ops.paged_attention(q, kp, vp, table, lens, qs, **kw)
    want = ref.paged_attention_ref(q, kp, vp, table, lens, qs, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_attention"] == n0 + 1
    assert got.dtype == dt and got.shape == q.shape
    _assert_attn_close(got, want)


@pytest.mark.requires_cuda
def test_split_decode_calls_are_one_launch_without_host_sync(cuda):
    """A call whose key axis splits is one launch, reads nothing back to
    the host (sync debug mode raises on a synchronising op) and allocates
    nothing on the card but its output (the splits merge in shared
    memory)."""
    q, kp, vp, table, lens, qs = _dev(
        _attn_inputs(9, 1, 2, 32, 32, 128, 16, lens=[4000]), cuda)
    q, kp, vp = (x.bfloat16() for x in (q, kp, vp))
    assert PA.split_plan(1, 2, 32, 32, table.shape[1], 16,
                         DA.sm_count(q.device))[0] > 1
    rng = np.random.default_rng(2)
    bq, pk, pv, sk, sv = (torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(cuda, torch.bfloat16) for s in (
            (6, 1, 32, 128), (1, 2048, 32, 128), (1, 2048, 32, 128),
            (6, 8, 32, 128), (6, 8, 32, 128)))
    ppos, spos, qpos = _dev([np.arange(2048, dtype=np.int32)[None],
                             np.tile(np.arange(2048, 2056, dtype=np.int32),
                                     (6, 1)),
                             np.full((6, 1), 2055, np.int32)], cuda)
    assert BA.split_plan(6, 1, 32, 32, 2048, 8, DA.sm_count(q.device))[0] > 1
    bargs = (bq, pk, pv, ppos, sk, sv, spos, qpos)
    ops.paged_attention(q, kp, vp, table, lens, qs)      # build, warm up
    ops.branch_decode_attention(*bargs)
    n0 = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ops.paged_attention(q, kp, vp, table, lens, qs)
        bgot = ops.branch_decode_attention(*bargs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ops.LAUNCHES["paged_attention"] == n0["paged_attention"] + 1
    assert (ops.LAUNCHES["branch_decode_attention"]
            == n0["branch_decode_attention"] + 1)
    torch.cuda.synchronize()
    assert (torch.cuda.memory_allocated() - mem0
            <= 2 * (got.numel() + bgot.numel()) + 1024)
    _assert_attn_close(got, ref.paged_attention_ref(q, kp, vp, table, lens,
                                                    qs))
    _assert_attn_close(bgot, ref.branch_decode_ref(*bargs))


@pytest.mark.requires_cuda
def test_ragged_paged_call_is_one_launch_without_host_sync(cuda):
    """The ragged path (granite-moe's draft, hd 85, over a row that
    splits; hd 64 pages stored off a 16-byte boundary) is one launch per
    call, reads nothing back to the host and allocates nothing on the
    card but its output: no padded copy of K/V."""
    q, kp, vp, table, lens, qs = (x.bfloat16() if i < 3 else x
                                  for i, x in enumerate(_dev(_attn_inputs(
                                      9, 1, 2, 3, 3, 85, 16, lens=[4000]),
                                      cuda)))
    assert DA.head_dim_path("t", 85, q, kp, vp) == (96, True)
    assert PA.split_plan(1, 2, 3, 3, table.shape[1], 16,
                         DA.sm_count(q.device))[0] > 1
    q2, kp2, vp2, table2, lens2, qs2 = _dev(
        _attn_inputs(4, 2, 3, 4, 2, 64, 8), cuda)
    flat = torch.empty(kp2.numel() + 1, device=cuda)
    kp2 = flat[1:].view(kp2.shape).copy_(kp2)       # 4 bytes off
    assert DA.head_dim_path("t", 64, q2, kp2, vp2) == (64, True)
    ops.paged_attention(q, kp, vp, table, lens, qs)      # build, warm up
    n0 = ops.LAUNCHES["paged_attention"]
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ops.paged_attention(q, kp, vp, table, lens, qs)
        got2 = ops.paged_attention(q2, kp2, vp2, table2, lens2, qs2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ops.LAUNCHES["paged_attention"] == n0 + 2
    torch.cuda.synchronize()
    assert (torch.cuda.memory_allocated() - mem0
            <= 2 * got.numel() + 4 * got2.numel() + 1024)
    _assert_attn_close(got, ref.paged_attention_ref(q, kp, vp, table, lens,
                                                    qs))
    _assert_attn_close(got2, ref.paged_attention_ref(q2, kp2, vp2, table2,
                                                     lens2, qs2))


def _offset_view(x, elems):
    """x's values in a view ``elems`` elements into a larger allocation:
    storage off a 16-byte (at odd ``elems`` in bf16, a 4-byte) boundary."""
    flat = torch.empty(x.numel() + elems, dtype=x.dtype, device=x.device)
    return flat[elems:].view(x.shape).copy_(x)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("hd", [64, 85])
@pytest.mark.parametrize("kernel", ["paged", "flash", "wide", "branch",
                                    "bwd"])
def test_ragged_path_at_a_2_byte_offset(cuda, kernel, hd):
    """bf16 K/V (and q) stored one element into their allocation: every
    row of hd 64 (the compiled width itself), and every other row of hd
    85, starts 2 bytes past a 4-byte word, so the ragged loader copies it
    from that word and moves it into place once it has landed."""
    bf = torch.bfloat16
    if kernel == "paged":
        q, kp, vp, table, lens, qs = _dev(
            _attn_inputs(3, 3, 4, 4, 2, hd, 8), cuda)
        q, kp, vp = (_offset_view(x.to(bf), 1) for x in (q, kp, vp))
        assert DA.head_dim_path("t", hd, q, kp, vp)[1]
        got = ops.paged_attention(q, kp, vp, table, lens, qs)
        want = ref.paged_attention_ref(q, kp, vp, table, lens, qs)
    elif kernel in ("flash", "wide"):
        T, S = (3, 40) if kernel == "flash" else (70, 70)
        q, k, v, qp, kp = _dev(_flash_inputs(4, 2, T, S, 4, 2, hd, S,
                                             dead=2), cuda)
        q, k, v = (_offset_view(x.to(bf), 1) for x in (q, k, v))
        got = ops.flash_attention(q, k, v, qp, kp, window=50)
        want = ref.flash_attention_ref(q, k, v, qp, kp, window=50)
    elif kernel == "branch":
        rng = np.random.default_rng(3)
        q, pk, pv, sk, sv = (_offset_view(x.to(bf), 1) for x in _dev(
            [rng.normal(size=sh).astype(np.float32) for sh in (
                (3, 1, 4, hd), (1, 37, 2, hd), (1, 37, 2, hd),
                (3, 5, 2, hd), (3, 5, 2, hd))], cuda))
        ppos, spos, qpos = _dev([np.arange(37, dtype=np.int32)[None],
                                 np.tile(np.arange(37, 42, dtype=np.int32),
                                         (3, 1)),
                                 np.full((3, 1), 41, np.int32)], cuda)
        args = (q, pk, pv, ppos, sk, sv, spos, qpos)
        got = ops.branch_decode_attention(*args)
        want = ref.branch_decode_ref(*args)
    else:
        q, k, v, do, qp, kp, kw = _bwd_flash_inputs(
            cuda, (1, 40, 47, 4, 2, hd, True, 0, None, False), bf)
        q, k, v, do = (_offset_view(x, 1) for x in (q, k, v, do))
        o = _offset_view(FA.flash_attention(q, k, v, qp, kp, **kw), 1)
        got = FA.flash_attention_bwd(q, k, v, o, do, qp, kp, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, o, do, qp, kp, **kw)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            _assert_grad_close(name, a, b)
        return
    _assert_attn_close(got, want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("hd", [64, 85])
def test_ragged_path_at_a_4_byte_offset(cuda, hd):
    """The f32 backward with q, k, v, o and dO stored one element into
    their allocation: rows 4 bytes past a 16-byte boundary, so hd 64 too
    takes the ragged path (4-byte copies; an f32 row needs no shift)."""
    q, k, v, do, qp, kp, kw = _bwd_flash_inputs(
        cuda, (2, 40, 47, 4, 2, hd, True, 0, None, False), torch.float32)
    q, k, v, do = (_offset_view(x, 1) for x in (q, k, v, do))
    o = _offset_view(FA.flash_attention(q, k, v, qp, kp, **kw), 1)
    assert DA.head_dim_path("t", hd, q, k, v, o, do)[1]
    got = FA.flash_attention_bwd(q, k, v, o, do, qp, kp, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, qp, kp, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _assert_grad_close(name, a, b)


def _verify_args(rng, B, R, V, lens, device):
    lens = {"ragged": np.concatenate(
                [[R], rng.integers(0, R + 1, size=B - 1)]),
            "full": np.full(B, R), "zero": np.zeros(B)}[lens]
    return _dev([(3 * rng.normal(size=(B, R, V))).astype(np.float32),
                 (3 * rng.normal(size=(B, R, V))).astype(np.float32),
                 rng.integers(0, V, size=(B, R)).astype(np.int32),
                 lens.astype(np.int32),
                 rng.random((B, R), dtype=np.float32),
                 rng.random((B, R), dtype=np.float32)], device)


# (V, the plan's blocks per row at B=4 R=6 on an H100): one block at
# V=199, 4 at 4096, 8 at 32000 and 8 that do not divide 30011, and 16
# (the non-portable cluster) at gemma3-4b's 262144
VERIFY_SPLITS = [(199, 1), (4096, 4), (32000, 8), (30011, 8), (262144, 16)]


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


@pytest.mark.requires_cuda
@pytest.mark.parametrize("lens", ["ragged", "full", "zero"])
@pytest.mark.parametrize("V,splits", VERIFY_SPLITS,
                         ids=lambda c: str(c))
def test_verify_kernel_matches_plain(cuda, V, splits, lens):
    rng = np.random.default_rng(3)
    B, R = 4, 6
    assert VA.split_plan(V, B * R, DA.sm_count(cuda)) == splits
    args = _verify_args(rng, B, R, V, lens, cuda)
    got = VA.verify_accept_batched(*args)
    want = ref.verify_accept_batched_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=0)
    # a residual token may differ only where w lies within 1e-6 of a cdf
    # boundary (f32 sums of V terms in another order; the card checks'
    # tolerance)
    for b, r in zip(*torch.nonzero(got[1] != want[1], as_tuple=True)):
        assert _cdf_gap(args[0][b, r], args[1][b, r], got[1][b, r],
                        want[1][b, r], args[5][b, r]) <= 1e-6
    lens_ = args[3].tolist()
    for b in range(B):                        # masked positions are zeros
        assert (got[0][b, lens_[b]:] == 0).all()
        assert (got[1][b, lens_[b]:] == 0).all()
    assert torch.equal(ops.verify_accept_batched(*args)[0], got[0])


@pytest.mark.requires_cuda
def test_verify_calls_are_one_launch_without_host_sync(cuda):
    """A verify call, its V split over a cluster, is one launch, reads
    nothing back to the host (sync debug mode raises on a synchronising
    op) and allocates nothing on the card but its outputs."""
    rng = np.random.default_rng(6)
    args = _verify_args(rng, 8, 16, 32000, "ragged", cuda)
    sargs = [args[0][0, :9], args[1][0, :9], args[2][0, :9],
             args[4][0, :9], args[5][0, :9]]
    assert VA.split_plan(32000, 128, DA.sm_count(cuda)) > 1
    ops.verify_accept_batched(*args)                   # build, warm up
    ops.verify_accept(*sargs)
    n0 = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ops.verify_accept_batched(*args)
        sgot = ops.verify_accept(*sargs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (ops.LAUNCHES["verify_accept_batched"]
            == n0["verify_accept_batched"] + 1)
    assert ops.LAUNCHES["verify_accept"] == n0["verify_accept"] + 1
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - mem0 <= 4 * 4096
    want = ref.verify_accept_batched_ref(*args)
    assert torch.equal(got[0], want[0])
    assert torch.equal(sgot[0], ref.verify_accept_ref(*sargs)[0])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dim,valid", [(24, 21), (30, 9), (512, 40)])
def test_gather_kernel_matches_plain(cuda, dim, valid):
    rng = np.random.default_rng(4)
    pages, table = _dev([rng.normal(size=(9, 4, dim)).astype(np.float32),
                         np.asarray([7, 2, 5, 0, 8, 3], np.int32)], cuda)
    assert torch.equal(ops.paged_gather(pages, table, valid),
                       ref.paged_gather_ref(pages, table, valid))


@pytest.mark.requires_cuda
def test_engine_on_the_card_is_greedy_lossless_and_runs_the_kernels(cuda):
    pair = get_pair("misaligned", device=cuda,
                    cache_dir=os.path.join(ROOT, ".cache", "pairs"))
    prompts = SV.make_prompts(2)
    want = M.greedy_reference(pair[2], pair[3], prompts, 12)
    for temp in (0.0, 1.0):
        ops.reset_launches()
        res, rep, eng, _ = SV.serve(
            pair, EngineConfig(gamma=4, c=10.0, temperature=temp,
                               max_len=512), prompts, 12, device=cuda)
        assert ops.LAUNCHES["paged_attention"] > 0
        if temp == 0.0:
            assert [res[i].tokens for i in range(2)] == want
        else:
            assert ops.LAUNCHES["verify_accept_batched"] > 0
            assert all(len(res[i].tokens) == 12 for i in range(2))


def _flash_inputs(seed, B, T, S, H, KV, hd, L, stale=0, dead=0):
    """A dense ring of S slots after L tokens (wrapped when L > S), with
    ``dead`` slots reset to -1 and ``stale`` slots holding positions past
    L; queries at L - T .. L - 1, their own slots valid."""
    rng = np.random.default_rng(seed)
    kpos = np.full((B, S), -1, np.int32)
    for b in range(B):
        for p in range(max(0, L - S), L):
            kpos[b, p % S] = p
        own = {p % S for p in range(L - T, L)}
        others = rng.permutation(np.asarray(
            [s for s in range(S) if s not in own], np.int64))
        kpos[b, others[:dead]] = -1
        kpos[b, others[dead:dead + stale]] = L + 3
    qpos = np.ascontiguousarray(np.broadcast_to(
        np.arange(L - T, L, dtype=np.int32), (B, T)))
    return [rng.normal(size=(B, T, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32), qpos, kpos]


FLASH_CASES = [
    dict(B=1, T=1, S=512, H=32, KV=32, hd=128, L=20),      # 7B decode
    dict(B=6, T=10, S=512, H=32, KV=32, hd=128, L=300, stale=5),  # fork
    dict(B=1, T=48, S=48, H=32, KV=32, hd=128, L=48),      # 7B prefill
    dict(B=2, T=4, S=512, H=12, KV=12, hd=64, L=90),       # 68M
    dict(B=3, T=5, S=64, H=4, KV=2, hd=32, L=150, stale=4, dead=3),
    dict(B=2, T=3, S=40, H=2, KV=1, hd=16, L=33),          # tiny draft
    dict(B=1, T=16, S=4608, H=32, KV=16, hd=128, L=4608, window=4096,
         cap=50.0),                                        # gemma2 widths
    # hubert-xlarge: head dim 80, bidirectional, 3 row tiles per item
    dict(B=2, T=40, S=40, H=16, KV=16, hd=80, L=40, causal=False),
    # gemma3-4b widths: head dim 256, GQA 2, window, a ring that splits
    dict(B=1, T=5, S=2048, H=8, KV=4, hd=256, L=1800, stale=3,
         window=1024),
    # wide blocks (64 rows of an item per kv head): split over a wrapped
    # ring with a window; bidirectional hd 80 with a 6-row last block;
    # hd 256 GQA over two blocks, split; a group of 4 with a softcap
    dict(B=1, T=64, S=1024, H=8, KV=2, hd=64, L=1500, stale=4,
         window=300),
    dict(B=2, T=70, S=70, H=16, KV=16, hd=80, L=70, causal=False),
    dict(B=1, T=40, S=512, H=8, KV=4, hd=256, L=500, window=128),
    dict(B=2, T=33, S=48, H=8, KV=2, hd=32, L=60, stale=3, dead=2,
         cap=20.0),
    # the draft() head dims 160 and 144: gemma3-4b's draft ring (window,
    # split), a bidirectional wide block with a 6-row last block, a wide
    # GQA block under a window, and a softcapped decode (gemma2's draft)
    dict(B=1, T=5, S=2048, H=2, KV=2, hd=160, L=1800, stale=3,
         window=1024),
    dict(B=2, T=70, S=70, H=4, KV=4, hd=144, L=70, causal=False),
    dict(B=1, T=64, S=512, H=4, KV=2, hd=160, L=500, window=128),
    dict(B=3, T=1, S=512, H=4, KV=4, hd=144, L=300, window=256,
         cap=50.0),
    # the ragged path at hd 85 (granite-moe's draft): its ring under the
    # window (B=8 unsplit, B=1 split), a cache-less wide block and a wide
    # GQA block under a window; hd 200 wide with a softcap, hd 40 decode
    dict(B=8, T=4, S=1040, H=3, KV=3, hd=85, L=1030, window=1024),
    dict(B=1, T=5, S=2048, H=3, KV=3, hd=85, L=1800, stale=3,
         window=1024),
    dict(B=2, T=70, S=70, H=3, KV=3, hd=85, L=70),
    dict(B=1, T=64, S=512, H=4, KV=2, hd=85, L=500, window=128),
    dict(B=2, T=33, S=48, H=4, KV=2, hd=200, L=60, stale=3, dead=2,
         cap=20.0),
    dict(B=3, T=1, S=512, H=4, KV=4, hd=40, L=300, window=256),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"case{i}" for i in range(len(FLASH_CASES))])
def test_flash_kernel_matches_plain(cuda, case, dtype):
    case = dict(case)
    kw = {k: case.pop(k) for k in ("window", "cap", "causal") if k in case}
    q, k, v, qp, kp = _dev(_flash_inputs(6, **case), cuda)
    dt = getattr(torch, dtype)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    n0 = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, qp, kp, **kw)
    want = ref.flash_attention_ref(q, k, v, qp, kp, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == n0 + 1
    assert got.dtype == dt and got.shape == q.shape
    _assert_attn_close(got, want)


@pytest.mark.requires_cuda
def test_split_flash_call_is_one_launch_without_host_sync(cuda):
    """A flash call whose key axis splits (the 7B verify chunk on a
    512-slot ring, mostly -1; a prefill of wide blocks) is one launch,
    reads nothing back to the host and allocates nothing on the card but
    its output."""
    q, k, v, qp, kp = _dev(_flash_inputs(7, 1, 5, 512, 32, 32, 128, 40,
                                         stale=3), cuda)
    q, k, v = (x.bfloat16() for x in (q, k, v))
    assert FA.split_plan(1, 5, 32, 32, 512, DA.sm_count(q.device))[0] > 1
    # and a prefill of wide blocks (64 rows each) that splits
    wargs = [x.bfloat16() if i < 3 else x for i, x in enumerate(_dev(
        _flash_inputs(8, 1, 64, 1024, 8, 2, 64, 1100), cuda))]
    assert FA.block_rows(64, 8, 2) == DA.WIDE_ROWS
    assert FA.split_plan(1, 64, 8, 2, 1024, DA.sm_count(q.device))[0] > 1
    ops.flash_attention(q, k, v, qp, kp)                 # build, warm up
    ops.flash_attention(*wargs)
    n0 = ops.LAUNCHES["flash_attention"]
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ops.flash_attention(q, k, v, qp, kp)
        wgot = ops.flash_attention(*wargs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ops.LAUNCHES["flash_attention"] == n0 + 2
    torch.cuda.synchronize()
    assert (torch.cuda.memory_allocated() - mem0
            <= 2 * (got.numel() + wgot.numel()) + 1024)
    _assert_attn_close(got, ref.flash_attention_ref(q, k, v, qp, kp))
    _assert_attn_close(wgot, ref.flash_attention_ref(*wargs))


@pytest.mark.requires_cuda
def test_runner_on_the_card_matches_the_cpu(cuda):
    """The same runner step script (prefill, verify chunk, fork, batched
    branch steps, select, rollback) on the card and on the CPU."""
    cache = os.path.join(ROOT, ".cache", "pairs")
    gpu, cpu = (get_pair("misaligned", device=d, cache_dir=cache)
                for d in (cuda, "cpu"))
    runners = [R.ModelRunner(p[2], p[3], max_len=64) for p in (gpu, cpu)]
    prompt = SV.make_prompts(1)[0]
    n0 = ops.LAUNCHES["flash_attention"]
    for r in runners:
        r.prefill(prompt)
        r.forward([12, 40])
        r.fork(3)
        r.forward_batched(np.asarray([[4], [9], [33]]))
        r.forward_batched(np.asarray([[1], [2], [3]]))
        r.select(1)
        r.sync_lineage([9, 2])
        r.reset_to(len(prompt) + 2)
        r.forward([18, 19, 20])
    assert ops.LAUNCHES["flash_attention"] > n0
    torch.testing.assert_close(runners[0].last_logits.cpu(),
                               runners[1].last_logits, rtol=0, atol=1e-4)


@pytest.mark.requires_cuda
def test_sequential_engines_on_the_card_are_greedy_lossless(cuda):
    pair = get_pair("misaligned", device=cuda,
                    cache_dir=os.path.join(ROOT, ".cache", "pairs"))
    prompt = SV.make_prompts(1)[0]
    want = R.greedy_reference(pair[2], pair[3], prompt, 12, max_len=128)
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0, max_len=128)
    for cls in (SpSEngine, SpecBranchEngine):
        ops.reset_launches()
        res = cls(*pair, ecfg).generate(prompt, 12, prng.PRNGKey(0))
        assert res.tokens == want
        assert ops.LAUNCHES["flash_attention"] > 0


SSM_CASES = [(8, 8, 256, 16, True), (3, 130, 32, 8, True),
             (56, 1, 1024, 16, True), (2, 48, 200, 4, False)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSM_CASES,
                         ids=lambda c: "B{}T{}E{}N{}{}".format(
                             *c[:4], "s" if c[4] else ""))
def test_ssm_scan_kernel_matches_plain(cuda, case, dtype):
    B, T, E, N, states = case
    g = torch.Generator(device=cuda).manual_seed(5)

    def f(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    x = f(B, T, E).to(getattr(torch, dtype))
    args = (x, torch.nn.functional.softplus(f(B, T, E)), f(B, T, N),
            f(B, T, N), -torch.exp(0.2 * f(E, N)), f(E), f(B, E, N))
    n0 = ops.LAUNCHES["ssm_scan"]
    got = ops.ssm_scan(*args, return_states=states)
    want = ref.ssm_scan_ref(*args, return_states=states)
    assert ops.LAUNCHES["ssm_scan"] == n0 + 1
    assert len(got) == len(want) == (3 if states else 2)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="not contiguous"):
        ops.ssm_scan(x.transpose(0, 2).contiguous().transpose(0, 2),
                     *args[1:])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSM_CASES,
                         ids=lambda c: "B{}T{}E{}N{}".format(*c[:4]))
def test_ssm_scan_ring_kernel_matches_plain(cuda, case, dtype):
    """The ring entry against its plain version on one ring of depth 5
    (T = 8, 48 and 130 lap it) with a lane map holding a pad lane: y and
    the written slots within rtol = atol = 2e-5, every other slot bit
    for bit untouched; lane 0 starts fresh and lane 1 wraps."""
    B, T, E, N, _states = case
    g = torch.Generator(device=cuda).manual_seed(9)

    def f(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    args = (f(B, T, E).to(getattr(torch, dtype)),
            torch.nn.functional.softplus(f(B, T, E)), f(B, T, N),
            f(B, T, N), -torch.exp(0.2 * f(E, N)), f(E))
    Rg, n_rows = 5, B + 2
    ring = f(n_rows, Rg, E, N)
    rows = torch.randperm(n_rows, generator=g, device=cuda)[:B].int()
    if B > 2:
        rows[-1] = -1                                  # a pad lane
    p0 = torch.randint(1, 50, (B,), generator=g, device=cuda).int()
    p0[0] = 0
    if B > 1:
        p0[1] = Rg - 1
    positions = p0[:, None] + torch.arange(T, device=cuda,
                                           dtype=torch.int32)[None]
    for lane_rows in (rows, None):
        got_ring, want_ring = ring.clone(), ring.clone()
        n0 = ops.LAUNCHES["ssm_scan_ring"]
        y = ops.ssm_scan_ring(*args, got_ring, positions[:, 0], lane_rows)
        want = ref.ssm_scan_ring_ref(*args, want_ring, p0, lane_rows)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["ssm_scan_ring"] == n0 + 1
        torch.testing.assert_close(y, want, rtol=2e-5, atol=2e-5)
        written = torch.zeros((n_rows, Rg), dtype=torch.bool, device=cuda)
        live = (torch.arange(B, device=cuda) if lane_rows is None
                else lane_rows.long())
        Tr = min(T, Rg)
        slots = (p0.long()[:, None] + torch.arange(T - Tr, T, device=cuda)
                 + 1) % Rg
        keep = live >= 0
        written[live[keep][:, None], slots[keep]] = True
        torch.testing.assert_close(got_ring[written], want_ring[written],
                                   rtol=2e-5, atol=2e-5)
        assert torch.equal(got_ring[~written], ring[~written])


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


@pytest.mark.requires_cuda
def test_mamba_ring_forward_scans_once_per_layer_and_matches_cpu(cuda):
    """One forward of the falcon-shaped tiny target over checkpoint
    rings (a fresh lane, a lane that wraps, a pad lane) launches the
    ring scan once per Mamba layer and no other scan, and leaves every
    ring as the CPU route (the plain version) does."""
    _dp, _dc, tp, tcfg = SV.load_pair("falcon-shaped", "cpu")
    gen = torch.Generator().manual_seed(11)
    caches = {dev: M.init_paged_cache(tcfg, 4, 4, dev, n_rows=3, ssm_ring=8)
              for dev in ("cpu", cuda)}
    for c_cpu, c_gpu in zip(M.iter_slots(caches["cpu"]),
                            M.iter_slots(caches[cuda])):
        for k in ("h_ring", "conv_ring"):
            c_cpu[k].copy_(torch.randn(c_cpu[k].shape, generator=gen)
                           .to(c_cpu[k].dtype))
            c_gpu[k].copy_(c_cpu[k])
    n_mamba = sum(c["h_ring"].shape[0] for c in M.iter_slots(caches[cuda]))
    assert n_mamba == tcfg.num_layers
    toks = torch.randint(0, tcfg.vocab_size, (3, 5), generator=gen)
    pos = (torch.tensor([0, 6, 9], dtype=torch.int32)[:, None]
           + torch.arange(5, dtype=torch.int32)[None])
    rows = torch.tensor([2, 0, -1])
    want, _ = M.forward(tp, tcfg, toks, cache=caches["cpu"], positions=pos,
                        ring_rows=rows)
    ops.reset_launches()
    got, _ = M.forward(_to(tp, cuda), tcfg, toks.to(cuda),
                       cache=caches[cuda], positions=pos.to(cuda),
                       ring_rows=rows.to(cuda))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssm_scan_ring"] == n_mamba
    assert ops.LAUNCHES["ssm_scan"] == 0
    torch.testing.assert_close(got[:2].cpu(), want[:2], rtol=1e-4,
                               atol=1e-4)
    for c_cpu, c_gpu in zip(M.iter_slots(caches["cpu"]),
                            M.iter_slots(caches[cuda])):
        torch.testing.assert_close(c_gpu["h_ring"].cpu(), c_cpu["h_ring"],
                                   rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(c_gpu["conv_ring"].cpu(),
                                   c_cpu["conv_ring"], rtol=1e-5, atol=1e-5)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["falcon-shaped", "jamba-shaped"])
def test_hybrid_pairs_on_the_card_are_greedy_lossless(cuda, kind):
    """Batched SpecBranch and sequential SpecBranch on the SSM-bearing
    pairs: greedy streams equal the target's greedy decode, and the scan
    ran on the card (the batched engine's through its ring entry)."""
    pair = SV.load_pair(kind, cuda)
    prompts = SV.make_prompts(2)
    want = M.greedy_reference(pair[2], pair[3], prompts, 12)
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0, max_len=256)
    ops.reset_launches()
    res, _, _, _ = SV.serve(pair, ecfg, prompts, 12, device=cuda)
    assert [res[i].tokens for i in range(2)] == want
    assert ops.LAUNCHES["ssm_scan_ring"] > 0
    done, _, _ = SV.serve_sequential(pair, ecfg, "specbranch", prompts, 12)
    assert [r.result.tokens for r in sorted(done, key=lambda r: r.rid)] \
        == want


# (k branches, Tq, Sp, Ss, H, KV, hd): the 7B branch-decode width, a GQA
# case with odd lengths and Tq > 1, a tile straddling the boundary;
# k * G * Tq = 36 rows (three row tiles) with Sp not a multiple of the
# 16-key tile; a long prefix that splits; head dims 16, 80, 256, the
# draft() head dims 160 and 144, and the ragged path's 85 (granite-moe's
# draft; a split prefix; GQA over three row tiles) and 40
BRANCH_CASES = [(6, 1, 504, 8, 32, 32, 128), (3, 3, 29, 5, 4, 2, 32),
                (4, 2, 70, 13, 8, 2, 64), (6, 3, 70, 5, 8, 4, 64),
                (6, 1, 2048, 8, 32, 32, 128), (4, 2, 45, 3, 4, 4, 16),
                (6, 1, 504, 8, 16, 16, 80), (4, 2, 70, 13, 8, 4, 256),
                (6, 1, 504, 8, 2, 2, 160), (4, 2, 70, 13, 4, 4, 144),
                (6, 1, 504, 8, 3, 3, 85), (6, 1, 2048, 8, 3, 3, 85),
                (6, 3, 70, 5, 8, 4, 85), (4, 2, 45, 3, 4, 4, 40)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BRANCH_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_branch_decode_kernel_matches_plain(cuda, case, dtype):
    kb, Tq, Sp, Ss, Hh, KV, hd = case
    rng = np.random.default_rng(8)
    ppos = np.arange(Sp, dtype=np.int32)[None].copy()
    ppos[0, 2:4] = -1                              # unwritten slots
    qpos = np.broadcast_to(np.arange(Sp + Ss - Tq + 1, Sp + Ss + 1,
                                     dtype=np.int32), (kb, Tq))
    spos = np.broadcast_to(np.arange(Sp, Sp + Ss, dtype=np.int32),
                           (kb, Ss))
    dt = getattr(torch, dtype)
    q, pk, pv, sk, sv = (x.to(dt) for x in _dev(
        [rng.normal(size=s).astype(np.float32)
         for s in ((kb, Tq, Hh, hd), (1, Sp, KV, hd), (1, Sp, KV, hd),
                   (kb, Ss, KV, hd), (kb, Ss, KV, hd))], cuda))
    ppos, spos, qpos = _dev([ppos, spos, qpos], cuda)
    for cap in (None, 30.0):
        n0 = ops.LAUNCHES["branch_decode_attention"]
        got = ops.branch_decode_attention(q, pk, pv, ppos, sk, sv, spos,
                                          qpos, cap=cap)
        want = ref.branch_decode_ref(q, pk, pv, ppos, sk, sv, spos, qpos,
                                     cap=cap)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["branch_decode_attention"] == n0 + 1
        assert got.dtype == dt and got.shape == q.shape
        _assert_attn_close(got, want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,V", [(1, 32), (9, 1024), (9, 32000), (9, 30011),
                                 (3, 262144)])
def test_single_verify_kernel_matches_plain(cuda, R, V, dtype):
    rng = np.random.default_rng(4)
    pl, ql, tok, u, w = _dev(
        [(2 * rng.normal(size=(R, V))).astype(np.float32),
         (2 * rng.normal(size=(R, V))).astype(np.float32),
         rng.integers(0, V, size=R).astype(np.int32),
         rng.random(R, dtype=np.float32), rng.random(R, dtype=np.float32)],
        cuda)
    pl, ql = pl.to(getattr(torch, dtype)), ql.to(getattr(torch, dtype))
    n0 = ops.LAUNCHES["verify_accept"]
    got = VA.verify_accept(pl, ql, tok, u, w)
    want = ref.verify_accept_ref(pl, ql, tok, u, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["verify_accept"] == n0 + 1
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=1e-6)
    assert (got[1] != want[1]).sum().item() <= 1


@pytest.mark.requires_cuda
def test_sps_and_hrad_engines_on_the_card_are_greedy_lossless(cuda):
    """Batched SpS, and batched and sequential SpecBranch with an H-RAD
    MLP, serve the target's greedy decode on the card."""
    pair = get_pair("misaligned", device=cuda,
                    cache_dir=os.path.join(ROOT, ".cache", "pairs"))
    prompts = SV.make_prompts(2)
    want = M.greedy_reference(pair[2], pair[3], prompts, 12)
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0, max_len=512)
    hrad = H.init_mlp(5 * pair[3].d_model,
                      generator=torch.Generator().manual_seed(0),
                      device=cuda)
    for engine, hp in (("sps", None), ("specbranch", hrad)):
        ops.reset_launches()
        res, _, _, _ = SV.serve(pair, ecfg, prompts, 12, device=cuda,
                                engine=engine, hrad_params=hp)
        assert [res[i].tokens for i in range(2)] == want, engine
        assert ops.LAUNCHES["paged_attention"] > 0
        if hp is not None:
            assert any(res[i].stats.hrad_signals for i in range(2))
    seq = SpecBranchEngine(*pair, ecfg, hrad_params=hrad).generate(
        prompts[0], 12, prng.PRNGKey(0))
    assert seq.tokens == want[0] and seq.stats.hrad_signals


@pytest.mark.requires_cuda
@pytest.mark.parametrize("engine", ["specbranch", "sps"])
def test_dense_serve_on_the_card_equals_the_paged_serve(cuda, engine):
    """The reference's equivalence oracle on the card: the tiny pair's
    dense serve (flash kernel, row forks) gives the paged serve's
    streams, greedy and at temperature 1, and the greedy decode's."""
    pair = get_pair("misaligned", device=cuda,
                    cache_dir=os.path.join(ROOT, ".cache", "pairs"))
    prompts = SV.make_prompts(3)
    want = M.greedy_reference(pair[2], pair[3], prompts, 16)
    for temp in (0.0, 1.0):
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp, max_len=512)
        out = {}
        for backend in ("dense", "paged"):
            ops.reset_launches()
            res, _, _, _ = SV.serve(pair, ecfg, prompts, 16, device=cuda,
                                    max_batch=2, engine=engine,
                                    attn_backend=backend)
            out[backend] = [res[i].tokens for i in range(3)]
            kernel = ("flash_attention" if backend == "dense"
                      else "paged_attention")
            assert ops.LAUNCHES[kernel] > 0, backend
        assert out["dense"] == out["paged"], temp
        if temp == 0.0:
            assert out["dense"] == want


@pytest.mark.requires_cuda
def test_traced_serve_on_the_card_adds_no_host_fetch(cuda):
    """A recorder (and the profiler ranges) changes nothing that crosses
    the host boundary on the card."""
    from repro_torch.obs import TraceRecorder
    from repro_torch.serving import device_loop as DL
    pair = get_pair("misaligned", device=cuda,
                    cache_dir=os.path.join(ROOT, ".cache", "pairs"))
    prompts = SV.make_prompts(3)
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=1.0, max_len=512)
    got = []
    for rec in (None, TraceRecorder()):
        DL.set_trace_annotations(rec is not None)
        try:
            res, _, eng, _ = SV.serve(
                pair, ecfg, prompts, 16, device=cuda, max_batch=2,
                **({} if rec is None else {"rec": rec}))
        finally:
            DL.set_trace_annotations(False)
        got.append((eng.host_fetches, eng.host_transfer_bytes,
                    [res[i].tokens for i in range(3)]))
    assert got[0] == got[1]
    assert rec.request_totals() and any(
        e["kind"] == "span" for e in rec.events)


# The parallel-draft frames (DESIGN.md §7.12): each row's nreal real
# tokens at L .. L + nreal - 1, then draft slots up to T.  On a dense ring
# the slots' keys are stored at position -1 and their queries clamped by
# q_ctx to the last real position; on pages the slots lie at or past
# lens, so the causal limit of a slot query lies beyond lens.
PDRAFT_CASES = [
    dict(B=8, T=16, S=512, H=12, KV=12, hd=64, L=41, nreal=[1, 2, 5, 1,
                                                            3, 9, 1, 2]),
    dict(B=4, T=8, S=64, H=2, KV=1, hd=16, L=30, nreal=[1, 2, 3, 8]),
    dict(B=2, T=16, S=48, H=32, KV=32, hd=128, L=60, nreal=[4, 1]),
]


def _pdraft_flash_inputs(seed, B, T, S, H, KV, hd, L, nreal):
    rng = np.random.default_rng(seed)
    kpos = np.full((B, S), -1, np.int32)
    qpos = np.zeros((B, T), np.int32)
    qctx = np.zeros((B, T), np.int32)
    for b in range(B):
        for p in range(max(0, L + T - S), L + nreal[b]):
            kpos[b, p % S] = p
        for t in range(nreal[b], T):
            kpos[b, (L + t) % S] = -1        # slot keys stored invisible
        qpos[b] = L + np.arange(T)
        qctx[b] = np.minimum(qpos[b], L + nreal[b] - 1)
    return [rng.normal(size=(B, T, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32), qpos, kpos,
            qctx]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PDRAFT_CASES,
                         ids=[f"case{i}" for i in range(len(PDRAFT_CASES))])
def test_flash_kernel_parallel_draft_frame_matches_plain(cuda, case, dtype):
    """q_ctx below q_pos on the slot columns, slot keys at -1 inside the
    row, past its write head."""
    q, k, v, qp, kp, qc = _dev(_pdraft_flash_inputs(8, **case), cuda)
    dt = getattr(torch, dtype)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    n0 = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, qp, kp, q_ctx=qc)
    want = ref.flash_attention_ref(q, k, v, qp, kp, q_ctx=qc)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == n0 + 1
    _assert_attn_close(got, want)
    # each slot query equals the last real query's attention
    B = q.shape[0]
    for b in range(B):
        n = case["nreal"][b]
        if n == q.shape[1]:
            continue                       # a frame without slot columns
        lastq = ref.flash_attention_ref(q[b:b + 1, n:], k[b:b + 1],
                                        v[b:b + 1], qc[b:b + 1, n:],
                                        kp[b:b + 1])
        _assert_attn_close(got[b:b + 1, n:], lastq)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PDRAFT_CASES,
                         ids=[f"case{i}" for i in range(len(PDRAFT_CASES))])
def test_paged_kernel_parallel_draft_frame_matches_plain(cuda, case, dtype):
    """lens = q_start + nreal < q_start + T: the slot queries' causal
    limit lies past lens, and every query sees only keys < lens."""
    B, T, L = case["B"], case["T"], case["L"]
    lens = [L + n for n in case["nreal"]]
    q, kp, vp, table, lens_, _ = _attn_inputs(
        9, B, T, case["H"], case["KV"], case["hd"], 16, lens=lens)
    qs = np.full(B, L, np.int32)
    q, kp, vp, table, lens_, qs = _dev((q, kp, vp, table, lens_, qs), cuda)
    dt = getattr(torch, dtype)
    q, kp, vp = q.to(dt), kp.to(dt), vp.to(dt)
    n0 = ops.LAUNCHES["paged_attention"]
    got = ops.paged_attention(q, kp, vp, table, lens_, qs)
    want = ref.paged_attention_ref(q, kp, vp, table, lens_, qs)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_attention"] == n0 + 1
    _assert_attn_close(got, want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("engine", ["sps", "specbranch"])
def test_parallel_draft_serve_on_the_card_is_greedy_lossless(cuda, engine):
    """Parallel drafting on both backends serves the greedy decode on the
    card, through the flash or paged kernel; batched SpS takes two
    dispatches a round."""
    pair = get_pair("misaligned", device=cuda,
                    cache_dir=os.path.join(ROOT, ".cache", "pairs"))
    prompts = SV.make_prompts(3)
    want = M.greedy_reference(pair[2], pair[3], prompts, 16)
    ecfg = EngineConfig(gamma=4, c=10.0, temperature=0.0, epsilon=0.0,
                        max_len=512, draft_mode="parallel")
    heads = M.init_draft_heads(pair[1], SV.heads_k(ecfg),
                               torch.Generator(device=cuda).manual_seed(2),
                               cuda)
    for backend in ("dense", "paged"):
        ops.reset_launches()
        res, rep, _, _ = SV.serve(pair, ecfg, prompts, 16, device=cuda,
                                  max_batch=2, engine=engine,
                                  attn_backend=backend, draft_heads=heads)
        assert [res[i].tokens for i in range(3)] == want, backend
        kernel = ("flash_attention" if backend == "dense"
                  else "paged_attention")
        assert ops.LAUNCHES[kernel] > 0, backend
        if engine == "sps":
            assert rep["dispatches_per_round"] == 2.0


# The prefix cache's suffix prefill (DESIGN.md §7.13): a bucketed rung of
# T queries per lane from the page-aligned cached length q0 on, over rows
# whose tables share the cached run's pages; the rung's tail past the
# suffix is pad (queries at or past lens), and one lane is a pad lane
# (lens 0, queries from 0).
SUFFIX_CASES = [
    dict(B=8, T=32, H=32, KV=32, hd=128, ps=16, q0=512, sfx=31),
    dict(B=4, T=8, H=4, KV=2, hd=32, ps=4, q0=8, sfx=2),
    dict(B=3, T=16, H=8, KV=2, hd=64, ps=16, q0=96, sfx=16),
]


def _suffix_inputs(seed, B, T, H, KV, hd, ps, q0, sfx):
    rng = np.random.default_rng(seed)
    shared = q0 // ps
    own = -(-(q0 + sfx) // ps) - shared
    P = shared + (B - 1) * own
    perm = rng.permutation(P)
    table = np.full((B, shared + own), P, np.int32)
    for b in range(B - 1):
        table[b, :shared] = perm[:shared]
        table[b, shared:] = perm[shared + b * own:shared + (b + 1) * own]
    lens = np.array([q0 + sfx] * (B - 1) + [0], np.int32)
    qs = np.array([q0] * (B - 1) + [0], np.int32)
    kp = rng.normal(size=(P + 1, ps, KV, hd)).astype(np.float32)
    vp = rng.normal(size=(P + 1, ps, KV, hd)).astype(np.float32)
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    return q, kp, vp, table, lens, qs


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SUFFIX_CASES,
                         ids=[f"case{i}" for i in range(len(SUFFIX_CASES))])
def test_paged_kernel_suffix_prefill_frame_matches_plain(cuda, case, dtype):
    q, kp, vp, table, lens, qs = _dev(_suffix_inputs(13, **case), cuda)
    dt = getattr(torch, dtype)
    q, kp, vp = q.to(dt), kp.to(dt), vp.to(dt)
    n0 = ops.LAUNCHES["paged_attention"]
    got = ops.paged_attention(q, kp, vp, table, lens, qs)
    want = ref.paged_attention_ref(q, kp, vp, table, lens, qs)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_attention"] == n0 + 1
    _assert_attn_close(got, want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("T", [16, 32])
def test_ssm_scan_ring_suffix_entry_from_a_restored_slot(cuda, T):
    """The ring entry as a prefix-cache hit drives it: lanes start at
    p0 = 256 from the slot a restored snapshot wrote (256 % Rg), a rung
    of T steps, beside a pad lane; falcon-mamba-7b's width (E = 8192, N
    = 16, bf16 x) and its serve's ring depth 92."""
    g = torch.Generator(device=cuda).manual_seed(11)

    def f(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    B, E, N, Rg = 4, 8192, 16, 92
    args = (f(B, T, E).bfloat16(), torch.nn.functional.softplus(f(B, T, E)),
            f(B, T, N), f(B, T, N), -torch.exp(0.2 * f(E, N)), f(E))
    ring = f(B, Rg, E, N)
    rows = torch.tensor([1, 2, 3, -1], dtype=torch.int32, device=cuda)
    p0 = torch.tensor([256, 256, 256, 0], dtype=torch.int32, device=cuda)
    snap = f(E, N)
    ring[1:4, 256 % Rg] = snap                       # the restored slot
    got_ring, want_ring = ring.clone(), ring.clone()
    y = ops.ssm_scan_ring(*args, got_ring, p0, rows)
    want = ref.ssm_scan_ring_ref(*args, want_ring, p0, rows)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got_ring, want_ring, rtol=2e-5, atol=2e-5)
    slots = (256 + torch.arange(T, device=cuda) + 1) % Rg
    untouched = torch.ones((B, Rg), dtype=torch.bool, device=cuda)
    untouched[1:4, slots] = False
    assert torch.equal(got_ring[untouched], ring[untouched])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("engine", ["specbranch", "sps"])
def test_prefix_cached_serve_on_the_card_equals_the_cpu(cuda, engine):
    """A staggered shared-prompt serve with the prefix cache on the card:
    every follower hits, the streams, prefix and pool stats equal the
    same serve's on the CPU and the card's cache-off serve, and the
    greedy streams are the greedy decode's."""
    cache_dir = os.path.join(ROOT, ".cache", "pairs")
    rng = np.random.default_rng(3)
    shared = [int(x) for x in rng.integers(0, 199, size=8)]
    prompts = [shared + [int(x) for x in rng.integers(0, 199, size=3)]
               for _ in range(3)]
    arrivals = [0.0, 300.0, 600.0]
    for temp in (0.0, 1.0):
        ecfg = EngineConfig(gamma=4, c=10.0, temperature=temp, max_len=512)
        out = {}
        for device, cache in ((cuda, True), ("cpu", True), (cuda, False)):
            pair = get_pair("misaligned", device=device, cache_dir=cache_dir)
            ops.reset_launches()
            res, rep, eng, _ = SV.serve(pair, ecfg, prompts, 12,
                                        device=device, max_batch=3,
                                        page_size=4, engine=engine,
                                        prefix_cache=cache,
                                        arrivals=arrivals)
            out[(str(device), cache)] = (
                [res[i].tokens for i in range(3)],
                rep.get("prefix_cache"), rep["pool"])
            if str(device) != "cpu":
                assert ops.LAUNCHES["paged_attention"] > 0
        card, cpu = out[(str(cuda), True)], out[("cpu", True)]
        assert card == cpu, temp
        assert card[1]["hits"] == 2 and card[1]["saved_tokens"] == 16
        assert card[0] == out[(str(cuda), False)][0], temp
        if temp == 0.0:
            assert card[0] == M.greedy_reference(pair[2], pair[3], prompts,
                                                 12)


def _assert_grad_close(name, got, want):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    lim = (1e-4 * max(1.0, scale) if want.dtype == torch.float32
           else 2.0 ** -6 * scale)
    assert err <= lim, (name, err, lim)


# (B, T, S, H, KV, hd, causal, window, cap, frame); frame True: 6 slot
# columns (keys -1, queries clamped); "dead": the first 9 keys -1, so the
# first rows see no key; "perm": the keys' positions shuffled
BWD_FLASH_CASES = [
    (2, 33, 47, 4, 2, 32, True, 0, None, False),
    (1, 70, 70, 8, 4, 256, True, 24, None, False),
    (2, 40, 40, 8, 4, 128, True, 0, 50.0, False),
    (2, 50, 50, 16, 16, 80, False, 0, None, False),
    (3, 24, 24, 2, 1, 16, True, 0, None, True),
    (2, 9, 30, 4, 4, 144, True, 0, None, False),
    (2, 9, 30, 2, 2, 160, True, 0, None, False),
    (1, 5, 20, 4, 2, 64, True, 0, None, False),
    # tile edges of the bf16 kernels (64-row and 32-key blocks, 32-row
    # tiles, 16-row / 16-key summaries): T x G and S off every multiple
    (1, 77, 77, 8, 4, 64, True, 0, None, False),
    (2, 100, 100, 4, 2, 128, True, 5, None, False),   # window < a tile
    (2, 40, 40, 4, 2, 64, True, 0, None, "dead"),
    (1, 70, 70, 8, 2, 128, True, 0, None, True),       # G = 4, q_ctx
    (1, 67, 90, 4, 2, 144, True, 0, 30.0, False),
    (2, 45, 45, 2, 2, 80, True, 16, None, False),
    (1, 48, 60, 4, 2, 256, True, 0, None, "perm"),
    (2, 1, 33, 4, 2, 160, True, 0, None, False),
    (1, 130, 97, 2, 1, 32, False, 0, None, "dead"),
    (1, 1280, 1280, 8, 4, 256, True, 1024, None, False),  # gemma3-4b
    # the ragged path: granite-moe's draft (3 heads of 85) at its
    # training frame and with dead keys under a window; hd 200 (GQA,
    # softcap) and hd 40 (bidirectional slot frame)
    (1, 256, 256, 3, 3, 85, True, 0, None, False),
    (2, 45, 45, 3, 3, 85, True, 16, None, "dead"),
    (1, 70, 70, 4, 2, 200, True, 0, 30.0, False),
    (2, 33, 47, 4, 2, 40, False, 0, None, True),
    # tile edges of the f32 kernels (16-row and 16-key one-warp blocks,
    # key and row tiles of 16): T x G and S off every multiple; then walks
    # long enough to be chunked (f32: 38 row blocks, each walk of 19 key
    # tiles in 16 chunks; 19 key blocks, each walk of 38 row tiles in 16
    # chunks), at hd 160 with its two column splits
    # of dk and dv, a window, a softcap and shuffled keys, and on the
    # ragged path with slot columns
    (1, 23, 37, 4, 2, 32, True, 0, None, False),
    (2, 45, 51, 2, 1, 80, True, 7, None, "dead"),
    (3, 9, 13, 6, 3, 128, False, 0, None, False),
    (1, 300, 300, 2, 1, 64, True, 0, None, False),
    (1, 150, 150, 4, 2, 160, True, 40, 20.0, "perm"),
    (1, 200, 200, 3, 3, 85, True, 0, None, True),
]


def _bwd_flash_inputs(cuda, case, dt):
    B, T, S, H, KV, hd, causal, window, cap, frame = case
    g = torch.Generator(device=cuda).manual_seed(hd + T)
    q, do = (torch.randn(B, T, H, hd, device=cuda, generator=g).to(dt)
             for _ in range(2))
    k, v = (torch.randn(B, S, KV, hd, device=cuda, generator=g).to(dt)
            for _ in range(2))
    qp = torch.arange(S - T, S, device=cuda,
                      dtype=torch.int32)[None].expand(B, T).contiguous()
    kp = torch.arange(S, device=cuda, dtype=torch.int32)[None].repeat(B, 1)
    qc = None
    if frame is True:              # 6 slot columns: keys -1, queries clamped
        kp[:, -6:] = -1
        qc = qp.clone()
        qc[:, -6:] = S - 7
    elif frame == "dead":
        kp[:, :9] = -1
    elif frame == "perm":
        kp = kp[:, torch.randperm(S, device=cuda, generator=g)].contiguous()
    kw = dict(causal=causal, window=window, cap=cap, q_ctx=qc)
    return q, k, v, do, qp, kp, kw


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BWD_FLASH_CASES,
                         ids=[f"case{i}" for i in range(len(BWD_FLASH_CASES))])
def test_flash_backward_kernel_matches_plain(cuda, case, dtype):
    dt = getattr(torch, dtype)
    q, k, v, do, qp, kp, kw = _bwd_flash_inputs(cuda, case, dt)
    o = FA.flash_attention(q, k, v, qp, kp, **kw)
    n0 = ops.LAUNCHES["flash_attention_bwd"]
    got = FA.flash_attention_bwd(q, k, v, o, do, qp, kp, **kw)
    assert ops.LAUNCHES["flash_attention_bwd"] == n0 + 1
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, qp, kp, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype == dt
        _assert_grad_close(name, a, b)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_backward_kernel_is_deterministic(cuda, dtype):
    """Two launches on the same inputs give the same bits (no atomics)."""
    case = (2, 300, 300, 8, 4, 256, True, 100, None, False)
    q, k, v, do, qp, kp, kw = _bwd_flash_inputs(cuda, case,
                                                getattr(torch, dtype))
    o = FA.flash_attention(q, k, v, qp, kp, **kw)
    first = FA.flash_attention_bwd(q, k, v, o, do, qp, kp, **kw)
    second = FA.flash_attention_bwd(q, k, v, o, do, qp, kp, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name
        assert bool(torch.isfinite(a.float()).all()), name


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("key,delta", [("work", -1), ("work", 1),
                                       ("ints", -1)])
def test_flash_backward_refuses_scratch_off_its_layout(cuda, monkeypatch,
                                                       dtype, key, delta):
    """The C entry launches nothing when the scratch ``bwd_plan`` sized
    differs from its own layout (the two plans written apart)."""
    case = (1, 45, 51, 4, 2, 32, True, 0, None, False)
    q, k, v, do, qp, kp, kw = _bwd_flash_inputs(cuda, case,
                                                getattr(torch, dtype))
    o = FA.flash_attention(q, k, v, qp, kp, **kw)
    plan = FA.bwd_plan

    def off(*args):
        out = plan(*args)
        return {**out, key: out[key] + delta}
    monkeypatch.setattr(FA, "bwd_plan", off)
    n0 = ops.LAUNCHES["flash_attention_bwd"]
    with pytest.raises(RuntimeError, match="flash_attention_bwd"):
        FA.flash_attention_bwd(q, k, v, o, do, qp, kp, **kw)
    assert ops.LAUNCHES["flash_attention_bwd"] == n0


def _scan_bwd_inputs(cuda, B, T, E, N, dtype):
    g = torch.Generator(device=cuda).manual_seed(E + N)
    x = torch.randn(B, T, E, device=cuda, generator=g).to(getattr(torch,
                                                                  dtype))
    dt = torch.rand(B, T, E, device=cuda, generator=g) * 0.2
    Bm, Cm = (torch.randn(B, T, N, device=cuda, generator=g)
              for _ in range(2))
    A = -torch.rand(E, N, device=cuda, generator=g) * 2
    D = torch.randn(E, device=cuda, generator=g)
    h0 = torch.randn(B, E, N, device=cuda, generator=g)
    dy = torch.randn(B, T, E, device=cuda, generator=g)
    dhT = torch.randn(B, E, N, device=cuda, generator=g)
    return (x, dt, Bm, Cm, A, D, h0), dy, dhT


# T a multiple of the chunk, not one (37, 33, 250), shorter than it (7),
# an E that leaves a partial channel block (130), B = 2, falcon's width
@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,E,N", [(2, 37, 96, 16), (1, 20, 40, 8),
                                     (2, 33, 130, 4), (1, 64, 8192, 16),
                                     (2, 7, 96, 16), (1, 250, 512, 16)])
def test_ssm_scan_backward_kernel_matches_plain(cuda, B, T, E, N, dtype):
    """The backward kernel from the forward kernel's chunk checkpoints
    against the plain backward from the same checkpoints."""
    ins, dy, dhT = _scan_bwd_inputs(cuda, B, T, E, N, dtype)
    K = SS.scan_chunk()
    _y, _hT, hc = SS.ssm_scan(*ins, chunks=True)
    for dh in (None, dhT):
        got = SS.ssm_scan_bwd(*ins, hc, dy, dh)
        want = ref.ssm_scan_bwd_ref(*ins, hc, dy, dh, chunk=K)
        for name, a, b in zip(("dx", "ddt", "dBm", "dCm", "dA", "dD",
                               "dh0"), got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            _assert_grad_close(name, a, b)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_chunk_mode_and_backward_bits(cuda, dtype):
    """The forward's chunk mode writes the states mode's hs at the chunk
    boundaries (h0 first) and the states mode's y and hT, bit for bit; two
    launches of the backward give the same bits (no atomics)."""
    ins, dy, dhT = _scan_bwd_inputs(cuda, 2, 250, 520, 16, dtype)
    K = SS.scan_chunk()
    y, hT, hs = SS.ssm_scan(*ins, return_states=True)
    yc, hTc, hc = SS.ssm_scan(*ins, chunks=True)
    assert hc.shape == (2, -(-250 // K), 520, 16)
    assert torch.equal(yc, y) and torch.equal(hTc, hT)
    assert torch.equal(hc[:, 0], ins[6])
    for k in range(1, hc.shape[1]):
        assert torch.equal(hc[:, k], hs[:, k * K - 1]), k
    first = SS.ssm_scan_bwd(*ins, hc, dy, dhT)
    second = SS.ssm_scan_bwd(*ins, hc, dy, dhT)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
        assert bool(torch.isfinite(a.float()).all())


@pytest.mark.requires_cuda
def test_forward_only_routes_raise_on_grad(cuda):
    """With grad mode on, a CUDA input that requires grad makes every
    serving route raise (its kernel has no backward); flash and the
    carry scan return tensors with a graph instead."""
    f = dict(device=cuda, requires_grad=True)
    q = torch.randn(1, 1, 2, 16, **f)
    pages = torch.randn(3, 4, 2, 16, **f)
    table = torch.zeros(1, 1, dtype=torch.int32, device=cuda)
    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    calls = {
        "paged_attention": lambda: ops.paged_attention(
            q, pages, pages, table, lens, lens - 1),
        "branch_decode_attention": lambda: ops.branch_decode_attention(
            q, pages[:1], pages[:1],
            torch.zeros(1, 4, dtype=torch.int32, device=cuda), pages[1:2],
            pages[1:2], torch.full((1, 4), 4, dtype=torch.int32,
                                   device=cuda),
            torch.full((1, 1), 8, dtype=torch.int32, device=cuda)),
        "verify_accept": lambda: ops.verify_accept(
            torch.randn(2, 8, **f), torch.randn(2, 8, device=cuda),
            torch.zeros(2, dtype=torch.int32, device=cuda),
            torch.rand(2, device=cuda), torch.rand(2, device=cuda)),
        "verify_accept_batched": lambda: ops.verify_accept_batched(
            torch.randn(1, 2, 8, **f), torch.randn(1, 2, 8, device=cuda),
            torch.zeros(1, 2, dtype=torch.int32, device=cuda),
            torch.full((1,), 2, dtype=torch.int32, device=cuda),
            torch.rand(1, 2, device=cuda), torch.rand(1, 2, device=cuda)),
        "paged_gather": lambda: ops.paged_gather(
            torch.randn(3, 4, 8, **f), table[0], 2),
        "ssm_scan_ring": lambda: ops.ssm_scan_ring(
            torch.randn(1, 2, 4, **f), torch.rand(1, 2, 4, device=cuda),
            torch.randn(1, 2, 4, device=cuda),
            torch.randn(1, 2, 4, device=cuda),
            -torch.rand(4, 4, device=cuda), torch.ones(4, device=cuda),
            torch.zeros(1, 3, 4, 4, device=cuda),
            torch.zeros(1, dtype=torch.int32, device=cuda)),
        "ssm_scan(return_states=True)": lambda: ops.ssm_scan(
            torch.randn(1, 2, 4, **f), torch.rand(1, 2, 4, device=cuda),
            torch.randn(1, 2, 4, device=cuda),
            torch.randn(1, 2, 4, device=cuda),
            -torch.rand(4, 4, device=cuda), torch.ones(4, device=cuda),
            torch.zeros(1, 4, 4, device=cuda), return_states=True),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no backward kernel"):
            call()
        with torch.no_grad():
            call()                       # serving: no grad, no error
    kv = torch.randn(1, 3, 2, 16, **f)
    pos = torch.arange(3, dtype=torch.int32, device=cuda)[None]
    assert ops.flash_attention(torch.randn(1, 3, 2, 16, **f), kv, kv, pos,
                               pos).grad_fn is not None
    y, hT = ops.ssm_scan(torch.randn(1, 2, 4, **f),
                         torch.rand(1, 2, 4, device=cuda),
                         torch.randn(1, 2, 4, device=cuda),
                         torch.randn(1, 2, 4, device=cuda),
                         -torch.rand(4, 4, device=cuda),
                         torch.ones(4, device=cuda),
                         torch.zeros(1, 4, 4, device=cuda))
    assert y.grad_fn is not None and hT.grad_fn is not None


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["gemma3-4b", "falcon-mamba-7b",
                                  "jamba-1.5-large-398b", "hubert-xlarge"])
def test_train_step_gradients_on_the_card_equal_the_cpu(cuda, arch):
    """One f32 lm_loss backward of a reduced config on the card (the
    flash and scan backward kernels) against the CPU's (autograd over
    the plain versions), from the same parameters."""
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, 0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 17)))
    want = TT.value_and_grad(TT.lm_loss, params, cfg, toks)
    card = TO.tree_map(lambda t: t.to(cuda), params)
    ops.reset_launches()
    got = TT.value_and_grad(TT.lm_loss, card, cfg, toks.to(cuda))
    mamba = any(m == "mamba" for m, _ in cfg.pattern)
    attn = any(m in ("attn", "local") for m, _ in cfg.pattern)
    assert (ops.LAUNCHES["ssm_scan_bwd"] > 0) == mamba
    assert (ops.LAUNCHES["flash_attention_bwd"] > 0) == attn
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-3,
                               atol=1e-4)
    for a, b in zip(TO.tree_leaves(got[2]), TO.tree_leaves(want[2])):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-4)
