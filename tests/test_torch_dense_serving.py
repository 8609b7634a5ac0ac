"""Batched serving on the dense backend: the port against the reference
engines on ``attn_backend="dense"`` (same weights, same prompts), 3
requests x 24 new tokens at max_batch 2.  Batched SpecBranch and SpS at
temperature 0 and 1, SpecBranch under a pool small enough to preempt and
swap (the committed misaligned pair), and the jamba-shaped hybrid under
preemption, which on the dense backend recomputes the prefix at
re-admission.  Streams, GenStats, pool stats, timelines and the host
counters must be equal; the port's dense streams must equal its own
paged streams (the reference's equivalence oracle).  Also the swappable
matrix and one prefill forward per ladder rung, as the reference's
``tests/test_decode_state.py`` pins them."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import ZipfMarkov
from repro.runtime.engines import EngineConfig as JEngineConfig
from repro.serving import BatchedSpecBranchEngine as JSpecBranch
from repro.serving import BatchedSpSEngine as JSpS
from repro.serving import ContinuousBatchScheduler as JScheduler
from repro.serving import ServeRequest as JRequest
from repro.training import pairs as JP
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig, dense_pattern
from repro_torch.runtime.engines import EngineConfig
from repro_torch.serving import (BatchedSpecBranchEngine, BatchedSpSEngine,
                                 ContinuousBatchScheduler, ServeRequest)
from repro_torch.serving.decode_state import DecodeState
from repro_torch.serving.kv_pool import PagedKVPool
from repro_torch.training.checkpoint import from_numpy_params

# One intra-op thread: the tiny models gain nothing from more, and the
# test workers share the machine's cores.
torch.set_num_threads(1)

N_REQ, N_NEW = 3, 24
SWAP = dict(page_size=4, pool_pages=120, swap_pages=64)
RECOMPUTE = dict(page_size=4, pool_pages=110, swap_pages=64)
ENGINES = {"specbranch": (JSpecBranch, BatchedSpecBranchEngine),
           "sps": (JSpS, BatchedSpSEngine)}
# name: (pair, engine, temperature, engine kwargs)
CASES = {
    "sb-greedy": ("misaligned", "specbranch", 0.0, {}),
    "sb-temp1": ("misaligned", "specbranch", 1.0, {}),
    "sb-preempt-swap": ("misaligned", "specbranch", 0.0, SWAP),
    "sps-greedy": ("misaligned", "sps", 0.0, {}),
    "sps-temp1": ("misaligned", "sps", 1.0, {}),
    "jamba-preempt-recompute": ("jamba-shaped", "specbranch", 0.0,
                                RECOMPUTE),
}


def _port(jpair):
    dp, dcfg, tp, tcfg = jpair
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    tdc = ModelConfig(**dataclasses.asdict(dcfg))
    ttc = ModelConfig(**dataclasses.asdict(tcfg))
    return (from_numpy_params(to_np(dp), tdc, "cpu"), tdc,
            from_numpy_params(to_np(tp), ttc, "cpu"), ttc)


@pytest.fixture(scope="module")
def pairs():
    zm = ZipfMarkov(vocab=JP.VOCAB, seed=7)
    prompts = [list(map(int, p)) for p in zm.prompts(N_REQ, 16, seed=3)]
    out = {}
    for kind in ("misaligned", "jamba-shaped"):
        jpair = (JP.get_pair(kind) if kind == "misaligned"
                 else JP.hybrid_pair(kind))
        out[kind] = (jpair, _port(jpair))
    return out, prompts


def _stats(r):
    s = r.stats
    return (s.emitted, s.draft_tokens, s.target_calls, s.rollback_tokens,
            s.pruned_tokens, list(s.accept_runs))


def _serve_port(tpair, name, backend, prompts):
    kind, engine, temp, eng_kw = CASES[name]
    kw = dict(gamma=4, c=10.0, temperature=temp, max_len=512)
    te = ENGINES[engine][1](*tpair, EngineConfig(**kw), device="cpu",
                            debug_check=True, max_batch=2,
                            attn_backend=backend, **eng_kw)
    ts = ContinuousBatchScheduler(te)
    tres = ts.run([ServeRequest(rid=i, prompt=p, max_new_tokens=N_NEW)
                   for i, p in enumerate(prompts)])
    return te, ts, tres


@pytest.fixture(scope="module")
def runs(pairs):
    """Each case served by both engines on the dense backend once, and by
    the port on the paged backend (module-scoped: the reference engine
    compiles its jits per engine)."""
    by_kind, prompts = pairs
    out = {}
    for name, (kind, engine, temp, eng_kw) in CASES.items():
        jpair, tpair = by_kind[kind]
        kw = dict(gamma=4, c=10.0, temperature=temp, max_len=512)
        je = ENGINES[engine][0](*jpair, JEngineConfig(**kw),
                                attn_backend="dense", debug_check=True,
                                max_batch=2, **eng_kw)
        js = JScheduler(je)
        jres = js.run([JRequest(rid=i, prompt=p, max_new_tokens=N_NEW)
                       for i, p in enumerate(prompts)])
        te, ts, tres = _serve_port(tpair, name, "dense", prompts)
        paged = _serve_port(tpair, name, "paged", prompts)[2]
        out[name] = (je, js, jres, te, ts, tres, paged)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_streams_and_stats_equal_reference(runs, name):
    je, js, jres, te, ts, tres, _ = runs[name]
    assert te.attn_backend == "dense" and te.tgt_dec.state.paged is None
    assert sorted(tres) == sorted(jres) == list(range(N_REQ))
    for rid in range(N_REQ):
        assert tres[rid].tokens == jres[rid].tokens, rid
        assert len(tres[rid].tokens) == N_NEW
        assert _stats(tres[rid]) == _stats(jres[rid]), rid


@pytest.mark.parametrize("name", list(CASES))
def test_pool_rounds_and_host_counters_equal_reference(runs, name):
    """The port's swap store lives on the device: the reference's counters
    carry the attention half of each swap twice (its pack fetch and its
    readback staging) on top of the port's."""
    je, js, jres, te, ts, tres, _ = runs[name]
    assert te.pool.stats.as_dict() == je.pool.stats.as_dict()
    assert te.timeline == je.timeline
    jr, tr = js.report(), ts.report()
    for key in ("rounds", "preemptions", "total_tokens", "total_cost",
                "ttft_p50", "itl_p50"):
        assert tr[key] == jr[key], key
    n_swaps = je.tgt_dec.xfer_fetches
    assert je.host_fetches == te.host_fetches + 2 * n_swaps
    assert je.host_transfer_bytes == \
        te.host_transfer_bytes + 2 * je.tgt_dec.xfer_bytes
    assert te.pool.pages_in_use == 0
    te.pool.check()


@pytest.mark.parametrize("name", list(CASES))
def test_dense_streams_equal_paged_streams(runs, name):
    """The reference's own oracle: both backends serve the same streams
    (at temperature 1 too: the per-request uniforms see the same
    logits only if both backends are faithful through forks, adoptions
    and rollbacks)."""
    *_, tres, paged = runs[name]
    assert {i: r.tokens for i, r in tres.items()} == \
        {i: r.tokens for i, r in paged.items()}


def test_preemption_swaps_on_dense_and_recomputes_the_hybrid(runs):
    je, js, jres, te, ts, tres, _ = runs["sb-preempt-swap"]
    assert ts.report()["preemptions"] > 0
    assert te.swap is not None and je.tgt_dec.xfer_fetches > 0
    je, js, jres, te, ts, tres, _ = runs["jamba-preempt-recompute"]
    assert ts.report()["preemptions"] > 0
    # a dense hybrid row is not swappable: no store, no pack
    assert te.swap is None and je.swap is None
    assert je.tgt_dec.xfer_fetches == 0


def test_greedy_streams_equal_port_greedy_decode(pairs, runs):
    by_kind, prompts = pairs
    for name in ("sb-greedy", "sb-preempt-swap", "sps-greedy",
                 "jamba-preempt-recompute"):
        tpair = by_kind[CASES[name][0]][1]
        want = TM.greedy_reference(tpair[2], tpair[3], prompts, N_NEW)
        tres = runs[name][5]
        for rid in range(N_REQ):
            assert tres[rid].tokens == want[rid], (name, rid)


def _cfg(name="ds-dense", layers=2, d=32, window=0, pattern=None,
         family="dense", **kw):
    return ModelConfig(name=name, family=family, num_layers=layers,
                       d_model=d, num_heads=2, num_kv_heads=1, d_ff=2 * d,
                       vocab_size=61, sliding_window=window,
                       pattern=pattern or dense_pattern(0),
                       dtype="float32", **kw)


def test_swappable_matrix():
    """Which (backend, config) pairs may pack token rows for swap, as the
    reference's ``test_swappable_matrix`` pins them."""
    hyb = _cfg(layers=2, pattern=(("mamba", "dense"), ("attn", "dense")),
               family="hybrid", ssm_state=8, ssm_conv=4)
    ssm = _cfg(layers=1, pattern=(("mamba", "none"),), family="hybrid",
               ssm_state=8, ssm_conv=4)
    loc = _cfg(window=8, pattern=(("local", "dense"),))
    glb = _cfg()

    def state(cfg, paged=None, ring=0):
        return DecodeState(cfg, n_rows=2, max_len=64, paged=paged,
                           device="cpu", ssm_ring=ring)

    assert state(glb).swappable
    assert not state(loc).swappable
    assert not state(hyb, ring=8).swappable
    s = state(hyb, paged=PagedKVPool(32, 4), ring=8)
    assert s.swappable and s.has_ssm and s.swap_dim > 0
    assert state(loc, paged=PagedKVPool(32, 4)).swappable
    assert not state(ssm, paged=PagedKVPool(32, 4), ring=8).swappable
    with pytest.raises(ValueError, match="ring"):
        state(ssm, paged=PagedKVPool(32, 4), ring=0)


def test_dense_swap_roundtrip_and_fork():
    """pack_row / unpack_row rebuild a dense row exactly (positions past
    the packed length reset to empty), and a fork copies every row-axis
    leaf."""
    cfg = _cfg(layers=3)
    st = DecodeState(cfg, n_rows=3, max_len=32, paged=None, device="cpu")
    g = torch.Generator().manual_seed(0)
    for c in TM.iter_slots(st.cache):
        c["k"].copy_(torch.randn(c["k"].shape, generator=g))
        c["v"].copy_(torch.randn(c["v"].shape, generator=g))
        c["pos"].copy_(torch.arange(32, dtype=torch.int32)
                       .expand_as(c["pos"]))
    want = [{k: a[:, 1].clone() for k, a in c.items()}
            for c in TM.iter_slots(st.cache)]
    rows = st.pack_row(1, 20)
    assert rows.shape == (20, st.swap_dim) and rows.dtype == torch.float32
    st.unpack_row(2, rows)
    assert st.row_pos[2] == 20
    for c, w in zip(TM.iter_slots(st.cache), want):
        for k in ("k", "v", "pos"):
            assert torch.equal(c[k][:, 2, :20], w[k][:, :20]), k
        assert bool((c["pos"][:, 2, 20:] == -1).all())
        assert bool((c["k"][:, 2, 20:] == 0).all())
    st.row_pos[1] = 7
    st.fork(1, 0)
    assert st.row_pos[0] == 7
    for c, w in zip(TM.iter_slots(st.cache), want):
        for k in ("k", "v", "pos"):
            assert torch.equal(c[k][:, 0], w[k]), k


def test_prefill_one_forward_per_bucket_on_dense():
    """An admission round's prefills cost ONE decoder forward per
    (decoder, prefill-ladder rung) and one shape per rung, as the
    reference's ``test_prefill_one_forward_per_bucket`` pins them."""
    tcfg = _cfg("pf-t", layers=2, d=64)
    dcfg = _cfg("pf-d", layers=1, d=32)
    tp = TM.init_params(tcfg, 0, "cpu")
    dp = TM.init_params(dcfg, 1, "cpu")
    ecfg = EngineConfig(gamma=3, c=4.0, temperature=0.0, epsilon=0.4,
                        signal_temperature=0.5, k_max=2, max_len=128)
    eng = BatchedSpSEngine(dp, dcfg, tp, tcfg, ecfg, max_batch=4,
                           page_size=4, attn_backend="dense", device="cpu")
    rng = np.random.default_rng(7)
    q = eng.tgt_dec.prefill_quantum
    for rid, plen in enumerate((4, 6, 8)):
        eng.reserve(rid, list(map(int, rng.integers(0, 61, plen))), 4)
    t0, d0 = eng.tgt_dec.n_calls, eng.dft_dec.n_calls
    eng.commit_admissions()
    assert eng.tgt_dec.n_calls - t0 == 1
    assert eng.dft_dec.n_calls - d0 == 1
    assert eng.tgt_dec.prefill_shapes == {(4, q)}
    assert eng.dft_dec.prefill_shapes == {(4, q)}
    eng.reserve(3, list(map(int, rng.integers(0, 61, q + 3))), 4)
    t0 = eng.tgt_dec.n_calls
    eng.commit_admissions()
    assert eng.tgt_dec.n_calls - t0 == 1
    assert eng.tgt_dec.prefill_shapes == {(4, q), (4, 2 * q)}
    # the prefill wrote each admitted row at its own positions only
    for seq in eng.active:
        n = len(seq.prompt) - 1
        pos = eng.tgt_dec.cache["blocks"][0]["pos"][:, seq.tgt.row]
        assert bool((pos[:, :n] == torch.arange(n)).all())
        tail = pos[:, n:]
        assert bool(((tail < 0) | (tail >= n)).all())
