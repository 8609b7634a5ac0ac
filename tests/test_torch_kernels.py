"""The port's kernels: plain PyTorch versions against the JAX kernels (run
in interpret mode on the CPU, as the reference's own tests run them), the
CPU routing of ``repro_torch.kernels.ops``, and the wrappers' refusal of
CPU tensors.  The CUDA kernels against their plain versions are in
``test_torch_cuda.py``.

Tolerances: paged attention f32 atol 1e-5 (the same math in another
summation order); verify ints equal and floats rtol 1e-6; gather equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import paged_attention as jpa
from repro.kernels import verify_accept as jva
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged as tpg
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import verify_accept as tva


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
