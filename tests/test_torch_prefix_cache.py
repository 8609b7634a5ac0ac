"""The cross-request prefix cache (``serving.prefix_cache``, DESIGN.md
§7.13) against the reference, in the same process.

The ``PrefixCache`` op scripts (publish, nested runs, dedupe, lookup with
and without ``need_snaps``, LRU eviction, clear) leave the same stats,
entries and pool state as the reference's.  Both batched engines serve
the reference test's staggered shared-prompt trace (three prompts that
share 8 tokens, each arriving after the previous one retired) with the
cache on, at temperature 0 and 1, and with the cache off; every serve
prices admission (``CostModel.t_prefill > 0``), so the modeled clock
carries the prefill rounds.  Streams, ``GenStats``, prefix and pool
stats, timelines, clock, per-request TTFT, host-transfer counters,
decoder call counts and trace events (wall fields dropped) must equal
the reference's.  On the port alone: cache on == cache off == the dense
oracle, the unpriced cache-off serve is the cache-less path (no cache
object, no prefill round, the priced run's numbers otherwise), and the
admission rounds stage suffix rungs only."""
import jax
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import dense_pattern
from repro.obs import TraceRecorder as JRecorder
from repro.runtime.engines import EngineConfig as JEngineConfig
from repro.serving import BatchedSpecBranchEngine as JSpecBranch
from repro.serving import BatchedSpSEngine as JSpS
from repro.serving import ContinuousBatchScheduler as JScheduler
from repro.serving import ServeRequest as JRequest
from repro.serving.kv_pool import PagedKVPool as JPool
from repro.serving.prefix_cache import PrefixCache as JPrefixCache
from repro_torch.obs import TraceRecorder
from repro_torch.runtime.engines import EngineConfig
from repro_torch.runtime.runner import greedy_reference
from repro_torch.serving import (BatchedSpecBranchEngine, BatchedSpSEngine,
                                 ContinuousBatchScheduler, ServeRequest)
from repro_torch.serving import device_loop as DL
from repro_torch.serving.kv_pool import PagedKVPool
from repro_torch.serving.prefix_cache import PrefixCache
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


N_NEW = 8
VOCAB = 64
INTERVAL = 300.0
# admission priced on the modeled clock: per staged token and per forward
PRICE = dict(t_prefill=0.25, t_dispatch=0.5)
ENGINES = {"specbranch": (JSpecBranch, BatchedSpecBranchEngine),
           "sps": (JSpS, BatchedSpSEngine)}
# name: (engine, temperature, prefix cache)
CASES = {
    "specbranch-temp0-on": ("specbranch", 0.0, True),
    "specbranch-temp1-on": ("specbranch", 1.0, True),
    "sps-temp0-on": ("sps", 0.0, True),
    "sps-temp1-on": ("sps", 1.0, True),
    "specbranch-temp0-off": ("specbranch", 0.0, False),
    "sps-temp1-off": ("sps", 1.0, False),
}
WALL = {"wall", "wall0", "wall1"}


def _cfg(name, layers, d, heads):
    return JModelConfig(name=name, family="dense", num_layers=layers,
                        d_model=d, num_heads=heads,
                        num_kv_heads=max(1, heads // 2), d_ff=4 * d,
                        vocab_size=VOCAB, pattern=dense_pattern(0),
                        dtype="float32")


def _kw(temp):
    return dict(gamma=3, c=4.0, temperature=temp, epsilon=0.4,
                signal_temperature=0.5, k_max=3, max_len=128)


@pytest.fixture(scope="module")
def pair():
    """The reference test's pair (random init from jax keys 0 and 1) in
    both packages, and its three prompts sharing 8 tokens."""
    tcfg = _cfg("pc-t", 2, 64, 2)
    dcfg = _cfg("pc-d", 1, 32, 2)
    jpair = (JM.init_params(jax.random.PRNGKey(1), dcfg), dcfg,
             JM.init_params(jax.random.PRNGKey(0), tcfg), tcfg)
    rng = np.random.default_rng(3)
    shared = [int(x) for x in rng.integers(0, VOCAB, size=8)]
    prompts = [shared + [int(x) for x in rng.integers(0, VOCAB, size=3)]
               for _ in range(3)]
    return jpair, port_pair(jpair), prompts


def _requests(cls, prompts):
    return [cls(rid=i, prompt=p, max_new_tokens=N_NEW, arrival=i * INTERVAL)
            for i, p in enumerate(prompts)]


def _port_serve(tpair, prompts, engine, temp, cache, *, price=True,
                backend="paged", rec=None):
    eng = ENGINES[engine][1](*tpair, EngineConfig(**_kw(temp)),
                             device="cpu", max_batch=3, page_size=4,
                             attn_backend=backend, prefix_cache=cache,
                             debug_check=True)
    if price:
        for k, v in PRICE.items():
            setattr(eng.cost, k, v)
    if rec is not None:
        eng.set_recorder(rec)
    sched = ContinuousBatchScheduler(eng)
    return eng, sched, sched.run(_requests(ServeRequest, prompts))


@pytest.fixture(scope="module")
def runs(pair):
    """Each case served, priced and traced, by both packages once
    (module-scoped: the reference compiles its jits per engine)."""
    jpair, tpair, prompts = pair
    out = {}
    for name, (engine, temp, cache) in CASES.items():
        je = ENGINES[engine][0](*jpair, JEngineConfig(**_kw(temp)),
                                max_batch=3, page_size=4,
                                attn_backend="paged", prefix_cache=cache,
                                debug_check=True)
        for k, v in PRICE.items():
            setattr(je.cost, k, v)
        jrec = JRecorder()
        je.set_recorder(jrec)
        js = JScheduler(je)
        jres = js.run(_requests(JRequest, prompts))
        trec = TraceRecorder()
        te, ts, tres = _port_serve(tpair, prompts, engine, temp, cache,
                                   rec=trec)
        out[name] = dict(je=je, js=js, jres=jres, jrec=jrec, te=te, ts=ts,
                         tres=tres, trec=trec)
    return out


# ------------------------------------------------------------- op scripts
def _pools(cls, **kw):
    return {"t": cls(num_pages=16, page_size=4, **kw),
            "d": cls(num_pages=16, page_size=4, **kw)}


def _state(pc):
    """What the op scripts compare: the cache's stats and entries and
    every pool's tables, lengths, refcounts and stats."""
    ents = [(e.eid, e.key, e.depth, e.stamp, e.snaps)
            for e in sorted(pc.entries, key=lambda e: e.eid)]
    pools = {w: (dict(p._tables), dict(p._lens),
                 [p.refcount(i) for i in range(p.num_pages)],
                 p.stats.as_dict(), p.pages_in_use, p.shared_pages,
                 p.logical_pages)
             for w, p in pc.pools.items()}
    return pc.stats.as_dict(), ents, pools


def _script(pools, cache_cls):
    """The reference's unit script and more: publish (refcount bump),
    dedupe (adopting a snapshot), lookups (capped, missed, nested, with
    and without ``need_snaps``), reclaimable pages, LRU eviction down to
    nothing, then a re-publish and ``clear``.  Returns the state after
    every op and every op's result."""
    steps, results = [], []

    def op(value):
        results.append(value)
        pc.check()
        steps.append(_state(pc))

    for w in ("t", "d"):
        pools[w].open((w, 0))
        pools[w].extend((w, 0), 10)
    pc = cache_cls(pools)
    toks = list(range(10))
    src0 = {"t": ("t", 0), "d": ("d", 0)}
    op(pc.publish(toks, 8, src0))
    op(pc.publish(toks, 8, src0, snaps={"t": ["ring"]}))
    op(pc.publish(toks, 8, src0))
    ent, n = pc.lookup(toks + [99], 10)
    op((ent.eid, n))
    op(pc.lookup([toks[0] + 1] + toks[1:], 10))
    op(pc.lookup(toks, 3))
    for w in ("t", "d"):
        pools[w].open((w, 1))
        pools[w].extend((w, 1), 4)
    op(pc.publish(toks[:4], 4, {"t": ("t", 1), "d": ("d", 1)}))
    ent, n = pc.lookup(toks[:4] + [99], 10)
    op((ent.eid, n, ent.depth))
    # need_snaps: only a run that ENDS at the match with a snapshot
    ent, n = pc.lookup(toks + [99], 10, need_snaps=True)
    op((ent.eid, n, ent.snaps))
    op(pc.lookup(toks[:6] + [99], 10, need_snaps=True))
    op((pc.reclaimable("t"), pc.reclaimable("d"), pc.evict_lru()))
    for w in ("t", "d"):
        pools[w].close((w, 0), "retire")
        pools[w].close((w, 1), "retire")
    op((pc.reclaimable("t"), pc.reclaimable("d"),
        pc.would_free(pc.entries[0])))
    op(pc.evict_lru())
    op(pc.evict_lru())
    op(pc.evict_lru())
    for w in ("t", "d"):
        pools[w].open((w, 2))
        pools[w].extend((w, 2), 12)
    op(pc.publish(toks + [7, 7], 12, {"t": ("t", 2), "d": ("d", 2)}))
    op(pc.publish(toks + [7, 7], 8, {"t": ("t", 2), "d": ("d", 2)}))
    for w in ("t", "d"):
        pools[w].close((w, 2), "retire")
    op((len(pc), pc.clear(), len(pc), pools["t"].pages_in_use,
        pools["d"].pages_in_use))
    return steps, results


def test_prefix_cache_op_scripts_equal_reference():
    jsteps, jres = _script(_pools(JPool), JPrefixCache)
    tsteps, tres = _script(_pools(PagedKVPool), PrefixCache)
    assert tres == jres
    assert len(tsteps) == len(jsteps)
    for i, (t, j) in enumerate(zip(tsteps, jsteps)):
        assert t == j, i
    # the script ends with everything released
    assert tres[-1][2:] == (0, 0, 0)
    stats = tsteps[-1][0]
    assert stats["published_runs"] == 4 and stats["deduped_runs"] == 2
    assert stats["snap_restores"] == 1 and stats["evicted_runs"] >= 4


def test_dense_backend_rejected(pair):
    _, tpair, _ = pair
    with pytest.raises(ValueError, match="requires attn_backend='paged'"):
        BatchedSpecBranchEngine(*tpair, EngineConfig(**_kw(0.0)),
                                device="cpu", max_batch=2, page_size=4,
                                attn_backend="dense", prefix_cache=True)


# ------------------------------------------------- engines vs reference
@pytest.mark.parametrize("name", list(CASES))
def test_streams_stats_and_clock_equal_reference(runs, name):
    r = runs[name]
    je, js, jres, te, ts, tres = (r["je"], r["js"], r["jres"], r["te"],
                                  r["ts"], r["tres"])
    assert sorted(tres) == sorted(jres) == [0, 1, 2]
    for rid in jres:
        assert tres[rid].tokens == jres[rid].tokens, rid
        assert len(tres[rid].tokens) == N_NEW
        assert gen_stats(tres[rid]) == gen_stats(jres[rid]), rid
    assert te.pool.stats.as_dict() == je.pool.stats.as_dict()
    assert te.timeline == je.timeline
    assert te.clock == je.clock
    for rid in jres:
        assert ts.metrics.traces[rid].ttft == js.metrics.traces[rid].ttft
    jr, tr = js.report(), ts.report()
    for key in ("rounds", "preemptions", "total_tokens", "total_cost",
                "ttft_p50", "ttft_p95", "itl_p50", "prefix_cache",
                "pool_logical_occupancy_peak", "shared_pages_peak"):
        assert tr.get(key) == jr.get(key), key
    assert te.host_transfer_bytes == je.host_transfer_bytes
    assert te.host_fetches == je.host_fetches
    for tdec, jdec in ((te.tgt_dec, je.tgt_dec), (te.dft_dec, je.dft_dec)):
        assert tdec.n_calls == jdec.n_calls
        assert tdec.n_call_tokens == jdec.n_call_tokens
        assert tdec.prefill_shapes == jdec.prefill_shapes
    if CASES[name][2]:
        assert te.prefix_cache.stats.as_dict() == \
            je.prefix_cache.stats.as_dict()
        # every admission after the first hit the shared 8 tokens
        assert te.prefix_cache.stats.hits == 2
        assert te.prefix_cache.stats.saved_tokens == 16
        te.prefix_cache.check()
    else:
        assert te.prefix_cache is None and je.prefix_cache is None
    # after the drain only cache runs hold pages
    held = 0 if te.prefix_cache is None else sum(
        len({p for e in te.prefix_cache.entries for p in pool.table(e.stream)})
        for pool in te.pools.values())
    assert te.pool.pages_in_use == held
    te.pool.check()


@pytest.mark.parametrize("name", list(CASES))
def test_trace_events_equal_reference(runs, name):
    r = runs[name]

    def no_wall(events):
        return [{k: v for k, v in e.items() if k not in WALL}
                for e in events]

    assert no_wall(r["trec"].events) == no_wall(r["jrec"].events)
    ops_ = [e["op"] for e in r["trec"].events if e["kind"] == "prefix"]
    if CASES[name][2]:
        assert ops_.count("hit") == 2 and ops_.count("miss") == 1
        assert ops_.count("publish") == 3
    else:
        assert ops_ == []


@pytest.mark.parametrize("name", list(CASES))
def test_priced_admission_rounds(pair, runs, name):
    """The admission pricing of the reference, on the port's clock: one
    ("prefill", staged tokens, forwards) round per admission group, the
    frame of every forward staged whole; a hit's rounds stage its suffix
    rung only.  The first request's TTFT includes its own round."""
    _, _, prompts = pair
    te = runs[name]["te"]
    lanes = te.tgt_dec.prefill_lanes
    q = te.tgt_dec.prefill_quantum
    full = DL.prefill_bucket(len(prompts[0]) - 1, q)
    sfx = DL.prefill_bucket(len(prompts[0]) - 1 - 8, q)
    rounds = [r for r in te.timeline if r[0] == "prefill"]
    miss = ("prefill", 2 * lanes * full, 2)
    hit = ("prefill", 2 * lanes * sfx, 2)
    want = [miss, hit, hit] if CASES[name][2] else [miss] * 3
    assert rounds == want
    cost = te.cost.round_cost(miss)
    assert cost == 2 * lanes * full * PRICE["t_prefill"] \
        + 2 * PRICE["t_dispatch"]
    assert runs[name]["ts"].metrics.traces[0].ttft > cost


def test_cache_off_is_the_cacheless_path(pair, runs):
    """prefix_cache=False (the default) is the path without a cache:
    no cache object, no lookup or publish event, and unpriced no prefill
    round — the priced serve's streams, stats, pool and host counters
    with its prefill rounds taken out of the timeline."""
    _, tpair, prompts = pair
    priced = runs["specbranch-temp0-off"]
    eng, sched, res = _port_serve(tpair, prompts, "specbranch", 0.0, False,
                                  price=False)
    assert eng.prefix_cache is None
    assert all(r[0] != "prefill" for r in eng.timeline)
    assert eng.timeline == [r for r in priced["te"].timeline
                            if r[0] != "prefill"]
    for rid in res:
        assert res[rid].tokens == priced["tres"][rid].tokens
        assert gen_stats(res[rid]) == gen_stats(priced["tres"][rid])
        assert res[rid].tokens == greedy_reference(
            tpair[2], tpair[3], prompts[rid], N_NEW, max_len=128)
    assert eng.pool.stats.as_dict() == priced["te"].pool.stats.as_dict()
    assert eng.host_transfer_bytes == priced["te"].host_transfer_bytes
    assert "prefix_cache" not in sched.report()


@pytest.mark.parametrize("temp", [0.0, 1.0])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_cache_on_equals_off_and_dense_oracle(pair, runs, engine, temp):
    """Cache on changes nothing observable in the streams: the same
    tokens as cache off on the paged backend and as the dense oracle,
    greedy and sampled (temperature 1 pins the suffix prefill's logits,
    not just their argmax)."""
    _, tpair, prompts = pair
    on = runs[f"{engine}-temp{int(temp)}-on"]["tres"]
    for cache, backend in ((False, "paged"), (False, "dense")):
        _, _, res = _port_serve(tpair, prompts, engine, temp, cache,
                                backend=backend)
        assert {i: r.tokens for i, r in res.items()} == \
            {i: r.tokens for i, r in on.items()}, (cache, backend)
