"""The port's CUDA kernels against their plain PyTorch versions, and the
batched engine on the card.  Every test needs a CUDA device and skips
without one.  The file imports no JAX, so it also runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -p no:cacheprovider --noconftest \\
        tests/test_torch_cuda.py

Tolerances: paged attention f32 atol 1e-4 and bf16 atol 2e-2 (another
summation order; bf16 output rounding); verify accept flags equal,
p_tok/q_tok rtol 1e-5, residual tokens equal but for a draw within f32
rounding of a cdf boundary; gather bitwise.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as SV
from repro_torch.models import model as M
from repro_torch.runtime.engines import EngineConfig
from repro_torch.training.pairs import get_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _attn_inputs(seed, B, T, H, KV, hd, ps, zero_rows=0):
    rng = np.random.default_rng(seed)
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


def _dev(arrays, device):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


ATTN_CASES = [
    dict(B=1, T=1, H=4, KV=4, hd=32, ps=8),
    dict(B=3, T=5, H=4, KV=2, hd=16, ps=8),
    dict(B=2, T=7, H=8, KV=2, hd=64, ps=16, window=5),
    dict(B=2, T=3, H=6, KV=3, hd=32, ps=4, cap=20.0),
    dict(B=3, T=2, H=4, KV=2, hd=16, ps=8, zero_rows=2),
    dict(B=4, T=70, H=4, KV=2, hd=128, ps=16),       # T tiled (64 rows)
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
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.requires_cuda
@pytest.mark.parametrize("V", [199, 4096, 32000])
def test_verify_kernel_matches_plain(cuda, V):
    rng = np.random.default_rng(3)
    B, R = 4, 6
    lens = rng.integers(0, R + 1, size=B).astype(np.int32)
    lens[0] = R
    args = _dev([(3 * rng.normal(size=(B, R, V))).astype(np.float32),
                 (3 * rng.normal(size=(B, R, V))).astype(np.float32),
                 rng.integers(0, V, size=(B, R)).astype(np.int32), lens,
                 rng.random((B, R), dtype=np.float32),
                 rng.random((B, R), dtype=np.float32)], cuda)
    got = ops.verify_accept_batched(*args)
    want = ref.verify_accept_batched_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=0)
    assert (got[1] != want[1]).sum().item() <= 1
    for b in range(B):                        # masked positions are zeros
        assert (got[0][b, lens[b]:] == 0).all()
        assert (got[1][b, lens[b]:] == 0).all()


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
