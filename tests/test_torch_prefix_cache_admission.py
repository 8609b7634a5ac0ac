"""Prefix-cache admission paths of the port against the reference, in the
same process: the hybrid join (a jamba-shaped hit restores the rings'
snapshot recorded at the published length, ``hits == snap_restores ==
2``), the suffix-only rungs of a cached admission (``[10, 10, 3, 3]``
prefill tokens, as the reference's test pins them), one seeded
interleaved trace under preemption pressure with swaps and LRU
evictions (greedy; the reference's Hypothesis property replaced by one
seed that exercises hits, preemptions and evictions together), and the
serve CLI's ``--prefix-cache on`` with the reference's two fail-fast
exits.  Each reference serve's streams, ``GenStats``, prefix and pool
stats, timeline and host counters must equal the port's; cache on must
equal cache off."""
import jax
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import dense_pattern
from repro.runtime.engines import EngineConfig as JEngineConfig
from repro.serving import BatchedSpecBranchEngine as JEngine
from repro.serving import ContinuousBatchScheduler as JScheduler
from repro.serving import ServeRequest as JRequest
from repro.training import pairs as JP
from repro_torch.launch import serve as SV
from repro_torch.obs import TraceRecorder
from repro_torch.runtime.engines import EngineConfig
from repro_torch.runtime.runner import greedy_reference
from repro_torch.serving import (BatchedSpecBranchEngine,
                                 ContinuousBatchScheduler, ServeRequest)
from repro_torch.serving import device_loop as DL
from torch_parity import gen_stats, port_pair, synchronous_reference_ticks

# One intra-op thread: the tiny models gain nothing from more, and the
# test workers share the machine's cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _steady_reference():
    """The reference's batched draft ticks run synchronously while this
    module's reference serves run (``torch_parity``: a race in the
    reference's rounds, not in the port)."""
    with synchronous_reference_ticks():
        yield


VOCAB = 64
# the interleaved trace: a seed whose cache-on serve hits 3 times,
# preempts 4 times (swapping) and evicts 3 runs
INTERLEAVED_SEED = 8


def _kw(**kw):
    base = dict(gamma=3, c=4.0, temperature=0.0, epsilon=0.4,
                signal_temperature=0.5, k_max=3, max_len=128)
    base.update(kw)
    return base


def _cfg(name, layers, d, heads):
    return JModelConfig(name=name, family="dense", num_layers=layers,
                        d_model=d, num_heads=heads,
                        num_kv_heads=max(1, heads // 2), d_ff=4 * d,
                        vocab_size=VOCAB, pattern=dense_pattern(0),
                        dtype="float32")


def _serve(cls, req_cls, sched_cls, pair, prompts, arrivals, n_new,
           eng_kw, **kw):
    eng = cls(*pair, **eng_kw, **kw)
    sched = sched_cls(eng)
    res = sched.run([req_cls(rid=i, prompt=p, max_new_tokens=n_new,
                             arrival=float(a))
                     for i, (p, a) in enumerate(zip(prompts, arrivals))])
    return eng, sched, res


def _both(jpair, tpair, prompts, arrivals, n_new, cache, eng_kw):
    """The same trace through the reference and the port, cache on or
    off: (reference, port), each (engine, scheduler, results)."""
    j = _serve(JEngine, JRequest, JScheduler, jpair, prompts, arrivals,
               n_new, dict(eng_kw, ecfg=JEngineConfig(**_kw())),
               prefix_cache=cache, attn_backend="paged", debug_check=True)
    t = _port(tpair, prompts, arrivals, n_new, cache, eng_kw)
    return j, t


def _port(tpair, prompts, arrivals, n_new, cache, eng_kw):
    return _serve(BatchedSpecBranchEngine, ServeRequest,
                  ContinuousBatchScheduler, tpair, prompts, arrivals, n_new,
                  dict(eng_kw, ecfg=EngineConfig(**_kw())),
                  prefix_cache=cache, attn_backend="paged",
                  debug_check=True, device="cpu")


def _assert_equal(j, t, swap=False):
    (je, js, jres), (te, ts, tres) = j, t
    assert {i: r.tokens for i, r in tres.items()} == \
        {i: r.tokens for i, r in jres.items()}
    for rid in jres:
        assert gen_stats(tres[rid]) == gen_stats(jres[rid]), rid
    assert te.prefix_cache.stats.as_dict() == je.prefix_cache.stats.as_dict()
    assert te.pool.stats.as_dict() == je.pool.stats.as_dict()
    assert te.timeline == je.timeline
    assert ts.metrics.preemptions == js.metrics.preemptions
    # the port's swap store lives on the device: the reference's counters
    # carry each swap's attention half twice (packed out, read back in)
    # on top of the port's
    pack = je.tgt_dec.xfer_bytes if swap else 0
    n_pack = je.tgt_dec.xfer_fetches if swap else 0
    assert je.host_transfer_bytes == te.host_transfer_bytes + 2 * pack
    assert je.host_fetches == te.host_fetches + 2 * n_pack
    assert len(te.prefix_cache) == len(je.prefix_cache)
    te.prefix_cache.check()


# --------------------------------------------------------- hybrid join
@pytest.fixture(scope="module")
def jamba():
    jpair = JP.hybrid_pair("jamba-shaped")
    tpair = port_pair(jpair)
    rng = np.random.default_rng(5)
    v = jpair[3].vocab_size
    shared = [int(x) for x in rng.integers(0, v, size=16)]
    prompts = [shared + [int(x) for x in rng.integers(0, v, size=3)]
               for _ in range(3)]
    arrivals = [300.0 * i for i in range(3)]
    eng_kw = dict(max_batch=3, page_size=8)
    j, t = _both(jpair, tpair, prompts, arrivals, 6, True, eng_kw)
    off = _port(tpair, prompts, arrivals, 6, False, eng_kw)
    return j, t, off


def test_hybrid_hit_restores_ring_snapshot(jamba):
    j, t, off = jamba
    _assert_equal(j, t)
    te, _, tres = t
    st = te.prefix_cache.stats
    assert st.hits == 2 and st.snap_restores == 2
    # the published run carries both decoders' ring snapshots
    (ent,) = te.prefix_cache.entries
    assert ent.depth == 16 and set(ent.snaps) == {"t", "d"}
    assert {i: r.tokens for i, r in tres.items()} == \
        {i: r.tokens for i, r in off[2].items()}


# ------------------------------------------------------ suffix rungs
def test_cached_admission_prefills_suffix_rungs_only():
    """A shared-prefix admission runs ONE suffix-rung forward per
    decoder, staging only its uncached tokens: the rung is the suffix
    length's ladder bucket, never the whole prompt's (the reference
    test's pins, on the port)."""
    tcfg, dcfg = _cfg("pc-t", 2, 64, 2), _cfg("pc-d", 1, 32, 2)
    tpair = port_pair((JM.init_params(jax.random.PRNGKey(1), dcfg), dcfg,
                       JM.init_params(jax.random.PRNGKey(0), tcfg), tcfg))
    rng = np.random.default_rng(9)
    a = [int(x) for x in rng.integers(0, VOCAB, size=11)]
    b = a[:8] + [int(x) for x in rng.integers(0, VOCAB, size=4)]
    eng = BatchedSpecBranchEngine(*tpair, EngineConfig(**_kw()),
                                  device="cpu", max_batch=2, page_size=4,
                                  attn_backend="paged", prefix_cache=True,
                                  debug_check=True)
    rec = TraceRecorder()
    eng.set_recorder(rec)
    res = ContinuousBatchScheduler(eng).run(
        [ServeRequest(rid=i, prompt=p, max_new_tokens=4, arrival=300.0 * i)
         for i, p in enumerate([a, b])])
    assert res[0].tokens == greedy_reference(tpair[2], tpair[3], a, 4,
                                             max_len=128)
    assert res[1].tokens == greedy_reference(tpair[2], tpair[3], b, 4,
                                             max_len=128)
    assert eng.prefix_cache.stats.hits == 1
    # prompt b: L = 11 ingested tokens, hit = 8 -> a 3-token suffix
    ev = [e for e in rec.events if e["kind"] == "prefill"]
    assert [e["tokens"] for e in ev] == [10, 10, 3, 3]
    q = eng.tgt_dec.prefill_quantum
    assert [e["width"] for e in ev] == (
        DL.prefill_rungs([10], q) * 2 + DL.prefill_rungs([3], q) * 2)
    lanes = eng.tgt_dec.prefill_lanes
    assert eng.tgt_dec.prefill_shapes == {(lanes, w) for w in
                                          DL.prefill_rungs([10, 3], q)}


# ------------------------------------------- interleaved under pressure
def _interleaved_trace(seed):
    """The reference property test's trace: five prompts over two shared
    6-token bases, random arrivals in [0, 40)."""
    rng = np.random.default_rng(seed)
    bases = [[int(x) for x in rng.integers(0, VOCAB, size=6)]
             for _ in range(2)]
    prompts = []
    for _ in range(5):
        p = list(bases[int(rng.integers(0, 2))])
        p += [int(x) for x in rng.integers(0, VOCAB, size=2)]
        prompts.append(p)
    return prompts, np.sort(rng.integers(0, 40, size=len(prompts)))


@pytest.fixture(scope="module")
def interleaved():
    tcfg, dcfg = _cfg("pcp-t", 2, 48, 2), _cfg("pcp-d", 1, 32, 2)
    jpair = (JM.init_params(jax.random.PRNGKey(11), dcfg), dcfg,
             JM.init_params(jax.random.PRNGKey(10), tcfg), tcfg)
    tpair = port_pair(jpair)
    prompts, arrivals = _interleaved_trace(INTERLEAVED_SEED)
    eng_kw = dict(max_batch=4, page_size=2, pool_pages=56, swap_pages=64)
    j, t = _both(jpair, tpair, prompts, arrivals, 6, True, eng_kw)
    off = _port(tpair, prompts, arrivals, 6, False, eng_kw)
    return j, t, off


def test_interleaved_greedy_under_preemption_pressure(interleaved):
    """Hits, preemption swaps (which publish at preemption and skip the
    lookup at re-admission) and LRU evictions, with the trie and pool
    invariants checked at every commit (``debug_check``): the port equals
    the reference, and cache on equals cache off.  Then eviction with
    nothing live frees every run and every page."""
    j, t, off = interleaved
    _assert_equal(j, t, swap=True)
    te, ts, tres = t
    st = te.prefix_cache.stats
    assert st.hits > 0 and st.evicted_runs > 0
    assert ts.metrics.preemptions > 0 and te.swap is not None
    assert {i: r.tokens for i, r in tres.items()} == \
        {i: r.tokens for i, r in off[2].items()}
    pc = te.prefix_cache
    while pc.evict_lru():
        pc.check()
    assert len(pc) == 0 and te.pool.pages_in_use == 0


# ------------------------------------------------------------------ CLI
def test_serve_cli_prefix_cache(tmp_path, capsys):
    out = tmp_path / "rep.json"
    SV.main(["--device", "cpu", "--requests", "2", "--new-tokens", "6",
             "--max-batch", "2", "--prefix-cache", "on", "--json",
             str(out)])
    text = capsys.readouterr().out
    assert "prefix cache: hits=0/2 saved_tokens=0" in text
    rep = __import__("json").loads(out.read_text())
    assert rep["prefix_cache"]["lookups"] == 2
    # the reference's two fail-fast exits
    with pytest.raises(SystemExit, match="requires --mode batched"):
        SV.main(["--device", "cpu", "--prefix-cache", "on", "--mode",
                 "sequential"])
    with pytest.raises(SystemExit, match="incompatible with --attn-backend"):
        SV.main(["--device", "cpu", "--prefix-cache", "on",
                 "--attn-backend", "dense"])
    # mesh serving is ported (tests/test_torch_sharded_serving.py): as in
    # the reference, --mesh needs batched mode
    with pytest.raises(SystemExit, match="requires --mode batched"):
        SV.main(["--device", "cpu", "--mesh", "1,1", "--mode",
                 "sequential"])


def test_serve_shared_prompts_hit_through_serve():
    """``launch.serve.serve`` with ``prefix_cache`` and explicit
    arrivals: followers that arrive after the first request retired hit
    its published prompt, and their streams equal the cache-off serve."""
    pair = SV.load_pair("misaligned", "cpu")
    sys_prompt = SV.make_prompts(1, length=16, seed=5)[0]
    prompts = [sys_prompt + p for p in SV.make_prompts(3, length=4, seed=9)]
    ecfg = EngineConfig(gamma=4, c=10.0, max_len=512)
    got = {}
    for cache in (False, True):
        res, rep, eng, _ = SV.serve(pair, ecfg, prompts, 6, device="cpu",
                                    max_batch=2, prefix_cache=cache,
                                    arrivals=[0.0, 1e4, 1e4])
        got[cache] = {i: r.tokens for i, r in res.items()}
    assert got[True] == got[False]
    pc = rep["prefix_cache"]
    assert pc["hits"] == 2 and pc["saved_tokens"] == 2 * 16
