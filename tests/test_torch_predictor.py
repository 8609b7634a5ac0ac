"""The history predictor: the port's ``runtime.predictor`` against the
reference's on the same outcome scripts (decisions, score and internals
bit for bit: ladder, saturation, PHT sharing, cold fallback, the oracle
EMA, drop), and the engines that consult it — sequential SpecBranch,
batched SpS and batched SpecBranch with ``spec_predictor`` "on" and
"oracle" at temperature 0 and 1 on the committed misaligned pair (3
requests x 24 new tokens at max_batch 2): streams, ``GenStats``,
timelines and every trace event (the ``pred`` fields included, wall
clocks dropped) equal the reference's.  With "off" an engine has no
predictor and runs the predictor-less path: its timeline and events
equal the reference's default engine's."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import ZipfMarkov
from repro.obs import TraceRecorder as JRecorder
from repro.runtime import predictor as JP_
from repro.runtime.engines import EngineConfig as JEngineConfig
from repro.runtime.scheduler import Request as JSeqRequest
from repro.runtime.scheduler import Scheduler as JSeqScheduler
from repro.runtime.specbranch import SpecBranchEngine as JSeqSpecBranch
from repro.serving import BatchedSpecBranchEngine as JSpecBranch
from repro.serving import BatchedSpSEngine as JSpS
from repro.serving import ContinuousBatchScheduler as JScheduler
from repro.serving import ServeRequest as JRequest
from repro.training import pairs as JP
from repro_torch.models.config import ModelConfig
from repro_torch.obs import TraceRecorder
from repro_torch.runtime import predictor as P
from repro_torch.runtime import prng
from repro_torch.runtime.engines import EngineConfig
from repro_torch.runtime.scheduler import Request, Scheduler
from repro_torch.runtime.specbranch import SpecBranchEngine
from repro_torch.serving import (BatchedSpecBranchEngine, BatchedSpSEngine,
                                 ContinuousBatchScheduler, ServeRequest)
from repro_torch.training.checkpoint import from_numpy_params
from torch_parity import synchronous_reference_ticks

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


N_REQ, N_NEW = 3, 24
WALL = {"wall", "wall0", "wall1"}
BATCHED = {"specbranch": (JSpecBranch, BatchedSpecBranchEngine),
           "sps": (JSpS, BatchedSpSEngine)}
# name: (mode, engine, backend, spec_predictor, temperature)
CASES = {
    "seq-specbranch-on": ("sequential", "specbranch", None, "on", 0.0),
    "seq-specbranch-oracle-temp1": ("sequential", "specbranch", None,
                                    "oracle", 1.0),
    "batched-specbranch-on": ("batched", "specbranch", "paged", "on", 0.0),
    "batched-specbranch-oracle-temp1": ("batched", "specbranch", "dense",
                                        "oracle", 1.0),
    "batched-specbranch-on-dense-temp1": ("batched", "specbranch", "dense",
                                          "on", 1.0),
    "batched-sps-on-temp1": ("batched", "sps", "paged", "on", 1.0),
    "batched-sps-oracle": ("batched", "sps", "dense", "oracle", 0.0),
    "batched-sps-off": ("batched", "sps", "paged", "off", 0.0),
}

# outcome scripts: (hit, frac) per update, for each of three requests
SCRIPTS = {
    "all-accept": [(True, 1.0)] * 12,
    "all-reject": [(False, 0.0)] * 12,
    "alternate": [(i % 2 == 0, 0.5 + 0.05 * i) for i in range(16)],
    "mixed": [(h, f) for h, f in zip(
        [True, False, False, True, True, True, False, True, False, False,
         True, True, False, True],
        [0.9, 0.2, 0.0, 1.0, 0.75, 0.8, 0.1, 1.0, 0.3, 0.25, 0.6, 1.0,
         0.0, 0.95])],
}


def _decision(d):
    return (d.gamma, d.k_cap, d.epsilon, d.score, d.cold, d.obs())


def _replay(mod, mode, script, gamma_max=8, k_max=6, eps=0.3):
    """Decisions and internals of one predictor over an outcome script
    interleaved across three requests (request r sees every third
    outcome, shifted by r)."""
    pred = mod.make_predictor(mode, gamma_max, k_max, eps)
    out = []
    for step, (hit, frac) in enumerate(script * 3):
        rid = step % 3
        out.append(_decision(pred.decide(rid)))
        pred.update(rid, hit, frac)
        out.append(pred.snapshot(rid))
    return out


@pytest.mark.parametrize("mode", ["on", "oracle"])
@pytest.mark.parametrize("script", list(SCRIPTS))
def test_decisions_equal_reference(mode, script):
    assert _replay(P, mode, SCRIPTS[script]) == \
        _replay(JP_, mode, SCRIPTS[script])


@pytest.mark.parametrize("gamma_max", [1, 2, 3, 4, 8, 9, 16])
def test_gamma_ladder_equals_reference(gamma_max):
    assert P.gamma_ladder(gamma_max) == JP_.gamma_ladder(gamma_max)
    pred = P.make_predictor("on", gamma_max, 6, 0.3)
    assert pred.ladder == P.gamma_ladder(gamma_max)
    for rid in range(3):
        assert pred.decide(rid).gamma in pred.ladder


def test_saturation_and_cold_fallback():
    """Counters saturate at 0 and 3; a request with fewer than ``warmup``
    rounds scores from the global counter, so its first decisions follow
    the fleet, then its own history."""
    for mod in (P, JP_):
        pred = mod.make_predictor("on", 8, 6, 0.3)
        for _ in range(10):
            pred.update(0, True, 1.0)
        st = pred.snapshot(0)
        assert st["counter"] == 3 and st["global"] == 3
        d_cold = pred.decide(1)             # no history: the global prior
        assert d_cold.cold and d_cold.score == 1.0 and d_cold.gamma == 8
        for _ in range(10):
            pred.update(1, False, 0.0)
        st = pred.snapshot(1)
        assert st["counter"] == 0 and st["global"] == 0
        d = pred.decide(1)
        assert not d.cold and d.gamma == 1 and d.k_cap == 6
        assert d.epsilon == pytest.approx(0.6)


def test_pht_is_shared_across_requests():
    """The pattern-history table is indexed by a request's own recent
    outcomes but shared: an entry trained by one request moves another's
    score at the same history."""
    for mod in (P, JP_):
        pred = mod.make_predictor("on", 8, 6, 0.3)
        for _ in range(6):
            pred.update(0, False, 0.0)      # history 0 trains PHT[0] down
        for _ in range(4):
            pred.update(1, False, 0.0)
        assert pred.snapshot(0)["pht"] == pred.snapshot(1)["pht"] == 0
        assert pred._pht[0] == 0


def test_oracle_ema_and_drop():
    for mod in (P, JP_):
        pred = mod.make_predictor("oracle", 8, 6, 0.3)
        for f in (1.0, 0.5, 0.0, 1.0):
            pred.update(7, f > 0.6, f)
        ema = 0.5
        for f in (1.0, 0.5, 0.0, 1.0):
            ema += 0.25 * (f - ema)
        assert pred.decide(7).score == pytest.approx(ema, abs=0)
        pred.drop(7)
        assert pred.snapshot(7)["rounds"] == 0      # fresh state
        pred.drop(7)
        pred.drop(99)                               # idempotent


def test_off_and_bad_modes():
    for mod in (P, JP_):
        assert mod.make_predictor("off", 8, 6, 0.3) is None
        assert mod.make_predictor("", 8, 6, 0.3) is None
        with pytest.raises(ValueError, match="bad predictor mode"):
            mod.SpeculationPredictor(
                8, 6, 0.3, mod.PredictorConfig(mode="sometimes"))


# ----------------------------------------------------------------- engines
@pytest.fixture(scope="module")
def pair():
    dp, dcfg, tp, tcfg = JP.get_pair("misaligned")
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    tdc = ModelConfig(**dataclasses.asdict(dcfg))
    ttc = ModelConfig(**dataclasses.asdict(tcfg))
    port = (from_numpy_params(to_np(dp), tdc, "cpu"), tdc,
            from_numpy_params(to_np(tp), ttc, "cpu"), ttc)
    zm = ZipfMarkov(vocab=JP.VOCAB, seed=7)
    prompts = [list(map(int, p)) for p in zm.prompts(N_REQ, 16, seed=3)]
    return (dp, dcfg, tp, tcfg), port, prompts


def _kw(pred, temp):
    return dict(gamma=4, c=10.0, temperature=temp, max_len=512,
                spec_predictor=pred)


@pytest.fixture(scope="module")
def runs(pair):
    """Each case served with a recorder by both packages once
    (module-scoped: the reference compiles its jits per engine)."""
    jpair, tpair, prompts = pair
    out = {}
    for name, (mode, engine, backend, pred, temp) in CASES.items():
        jrec, trec = JRecorder(), TraceRecorder()
        if mode == "batched":
            je = BATCHED[engine][0](*jpair, JEngineConfig(**_kw(pred, temp)),
                                    attn_backend=backend, max_batch=2,
                                    debug_check=True)
            je.set_recorder(jrec)
            jres = JScheduler(je).run(
                [JRequest(rid=i, prompt=p, max_new_tokens=N_NEW)
                 for i, p in enumerate(prompts)])
            te = BATCHED[engine][1](*tpair, EngineConfig(**_kw(pred, temp)),
                                    device="cpu", debug_check=True,
                                    max_batch=2, attn_backend=backend)
            te.set_recorder(trec)
            tres = ContinuousBatchScheduler(te).run(
                [ServeRequest(rid=i, prompt=p, max_new_tokens=N_NEW)
                 for i, p in enumerate(prompts)])
            jtl, ttl = je.timeline, te.timeline
        else:
            je = JSeqSpecBranch(*jpair, JEngineConfig(**_kw(pred, temp)))
            je.set_recorder(jrec)
            jdone = JSeqScheduler(je).run(
                [JSeqRequest(rid=i, prompt=p, max_new_tokens=N_NEW)
                 for i, p in enumerate(prompts[:2])],
                key=jax.random.PRNGKey(0))
            te = SpecBranchEngine(*tpair, EngineConfig(**_kw(pred, temp)))
            te.set_recorder(trec)
            tdone = Scheduler(te).run(
                [Request(rid=i, prompt=p, max_new_tokens=N_NEW)
                 for i, p in enumerate(prompts[:2])], key=prng.PRNGKey(0))
            jres = {r.rid: r.result for r in jdone}
            tres = {r.rid: r.result for r in tdone}
            jtl = [r.result.timeline for r in jdone]
            ttl = [r.result.timeline for r in tdone]
        out[name] = (jrec, jres, jtl, trec, tres, ttl, te)
    return out


def _stats(r):
    s = r.stats
    return (s.emitted, s.draft_tokens, s.target_calls, s.rollback_tokens,
            s.pruned_tokens, list(s.accept_runs), list(s.hrad_signals))


def _no_wall(events):
    return [{k: v for k, v in e.items() if k not in WALL} for e in events]


@pytest.mark.parametrize("name", list(CASES))
def test_engine_streams_and_stats_equal_reference(runs, name):
    jrec, jres, jtl, trec, tres, ttl, te = runs[name]
    assert sorted(tres) == sorted(jres)
    for rid in jres:
        assert tres[rid].tokens == jres[rid].tokens, rid
        assert _stats(tres[rid]) == _stats(jres[rid]), rid
    assert ttl == jtl


@pytest.mark.parametrize("name", list(CASES))
def test_engine_trace_events_equal_reference(runs, name):
    """Every event (spec, span, round, ...) minus its wall clocks: the
    ``pred`` fields carry each round's decision."""
    jrec, jres, jtl, trec, tres, ttl, te = runs[name]
    assert _no_wall(trec.events) == _no_wall(jrec.events)
    preds = [e["pred"] for e in trec.events if e["kind"] == "spec"]
    if CASES[name][3] == "off":
        assert te.predictor is None
        assert all(p is None for p in preds)
    else:
        assert te.predictor is not None
        decided = [p for p in preds if p is not None]
        assert decided and all(p["gamma"] in te.predictor.ladder
                               for p in decided)


def test_predictor_moves_gamma_below_the_static_knob(runs):
    """With the predictor on, the rejecting misaligned pair drives some
    rounds' gamma below ecfg.gamma (the knob it adapts)."""
    trec = runs["batched-sps-on-temp1"][3]
    gammas = {e["pred"]["gamma"] for e in trec.events
              if e["kind"] == "spec" and e["pred"] is not None}
    assert min(gammas) < 4
