"""The trace recorder and its export: the port's ``TraceRecorder`` events
equal the reference's, with the wall-clock fields dropped, for batched SpS
and SpecBranch on both attention backends (one of them under a pool that
preempts and swaps) and for the sequential SpS and SpecBranch engines, on
the committed misaligned pair.  The registry totals equal the
reference's and reconcile with ``GenStats`` (as the reference's
``tests/test_obs_trace.py`` pins it); the Perfetto export has the
reference's structure; a recorder adds no host fetch and no transfer
byte; the serve CLI writes ``--trace``, ``--metrics-out`` and a
``--profile-dir`` trace on the CPU."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import ZipfMarkov
from repro.obs import TraceRecorder as JRecorder
from repro.runtime.engines import EngineConfig as JEngineConfig
from repro.runtime.engines import SpSEngine as JSeqSpS
from repro.runtime.scheduler import Request as JSeqRequest
from repro.runtime.scheduler import Scheduler as JSeqScheduler
from repro.runtime.specbranch import SpecBranchEngine as JSeqSpecBranch
from repro.serving import BatchedSpecBranchEngine as JSpecBranch
from repro.serving import BatchedSpSEngine as JSpS
from repro.serving import ContinuousBatchScheduler as JScheduler
from repro.serving import ServeRequest as JRequest
from repro.training import pairs as JP
from repro_torch.launch import serve as SV
from repro_torch.models.config import ModelConfig
from repro_torch.obs import (NULL_RECORDER, NullRecorder, TraceRecorder,
                             perfetto_trace)
from repro_torch.runtime import prng
from repro_torch.runtime.engines import EngineConfig, SpSEngine
from repro_torch.runtime.scheduler import Request, Scheduler
from repro_torch.runtime.specbranch import SpecBranchEngine
from repro_torch.serving import (BatchedSpecBranchEngine, BatchedSpSEngine,
                                 ContinuousBatchScheduler, ServeRequest)
from repro_torch.serving import device_loop as DL
from repro_torch.training.checkpoint import from_numpy_params

# One intra-op thread: the tiny models gain nothing from more, and the
# test workers share the machine's cores.
torch.set_num_threads(1)

N_REQ, N_NEW = 3, 24
PREEMPT = dict(page_size=4, pool_pages=120, swap_pages=64)
BATCHED = {"specbranch": (JSpecBranch, BatchedSpecBranchEngine),
           "sps": (JSpS, BatchedSpSEngine)}
SEQUENTIAL = {"specbranch": (JSeqSpecBranch, SpecBranchEngine),
              "sps": (JSeqSpS, SpSEngine)}
# name: (mode, engine, backend, temperature, engine kwargs)
CASES = {
    "batched-specbranch-paged-preempt": ("batched", "specbranch", "paged",
                                         0.0, PREEMPT),
    "batched-specbranch-dense-temp1": ("batched", "specbranch", "dense",
                                       1.0, {}),
    "batched-sps-paged-temp1": ("batched", "sps", "paged", 1.0, {}),
    "batched-sps-dense": ("batched", "sps", "dense", 0.0, {}),
    "sequential-specbranch": ("sequential", "specbranch", None, 0.0, {}),
    "sequential-sps": ("sequential", "sps", None, 0.0, {}),
}
# wall-clock fields (host time differs between two runs of one program)
WALL = {"wall", "wall0", "wall1"}
WALL_HISTOGRAMS = {"round_wall_s", "serving_step_wall_s"}


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


def _kw(temp):
    return dict(gamma=4, c=10.0, temperature=temp, max_len=512)


def _port_batched(tpair, prompts, engine, backend, temp, eng_kw, rec):
    eng = BATCHED[engine][1](*tpair, EngineConfig(**_kw(temp)),
                             device="cpu", debug_check=True, max_batch=2,
                             attn_backend=backend, **eng_kw)
    eng.set_recorder(rec)
    res = ContinuousBatchScheduler(eng).run(
        [ServeRequest(rid=i, prompt=p, max_new_tokens=N_NEW)
         for i, p in enumerate(prompts)])
    return eng, res


def _port_sequential(tpair, prompts, engine, temp, rec):
    eng = SEQUENTIAL[engine][1](*tpair, EngineConfig(**_kw(temp)))
    eng.set_recorder(rec)
    done = Scheduler(eng).run(
        [Request(rid=i, prompt=p, max_new_tokens=N_NEW)
         for i, p in enumerate(prompts[:2])], key=prng.PRNGKey(0))
    return eng, {r.rid: r.result for r in done}


@pytest.fixture(scope="module")
def runs(pair):
    """Each case served with a recorder by both packages once
    (module-scoped: the reference compiles its jits per engine)."""
    jpair, tpair, prompts = pair
    out = {}
    for name, (mode, engine, backend, temp, eng_kw) in CASES.items():
        jrec, trec = JRecorder(), TraceRecorder()
        if mode == "batched":
            je = BATCHED[engine][0](*jpair, JEngineConfig(**_kw(temp)),
                                    attn_backend=backend, max_batch=2,
                                    **eng_kw)
            je.set_recorder(jrec)
            jres = JScheduler(je).run(
                [JRequest(rid=i, prompt=p, max_new_tokens=N_NEW)
                 for i, p in enumerate(prompts)])
            te, tres = _port_batched(tpair, prompts, engine, backend, temp,
                                     eng_kw, trec)
        else:
            je = SEQUENTIAL[engine][0](*jpair, JEngineConfig(**_kw(temp)))
            je.set_recorder(jrec)
            done = JSeqScheduler(je).run(
                [JSeqRequest(rid=i, prompt=p, max_new_tokens=N_NEW)
                 for i, p in enumerate(prompts[:2])],
                key=jax.random.PRNGKey(0))
            jres = {r.rid: r.result for r in done}
            te, tres = _port_sequential(tpair, prompts, engine, temp, trec)
        out[name] = (jrec, jres, trec, tres, te)
    return out


def _no_wall(events):
    return [{k: v for k, v in e.items() if k not in WALL} for e in events]


def _registry(rec):
    d = rec.registry.as_dict()
    d["histograms"] = {k: v for k, v in d["histograms"].items()
                       if k not in WALL_HISTOGRAMS}
    return d


@pytest.mark.parametrize("name", list(CASES))
def test_events_equal_reference(runs, name):
    jrec, jres, trec, tres, _ = runs[name]
    assert {i: r.tokens for i, r in tres.items()} == \
        {i: r.tokens for i, r in jres.items()}
    assert _no_wall(trec.events) == _no_wall(jrec.events)
    kinds = {e["kind"] for e in trec.events}
    if CASES[name][0] == "batched":
        assert {"arrival", "admit", "prefill", "spec", "span", "round",
                "finish", "sample"} <= kinds
    else:
        assert {"admit", "finish", "spec", "model_call"} <= kinds


def test_preempting_case_traces_preemption_and_swap(runs):
    trec = runs["batched-specbranch-paged-preempt"][2]
    kinds = [e["kind"] for e in trec.events]
    for k in ("preempt", "swap_out", "swap_in", "reclaim", "cow"):
        assert k in kinds, k


@pytest.mark.parametrize("name", list(CASES))
def test_registry_equals_reference_and_reconciles(runs, name):
    """Per-request trace sums == GenStats == registry totals, exactly;
    rollback causes partition the rollback total."""
    jrec, jres, trec, tres, _ = runs[name]
    assert _registry(trec) == _registry(jrec)
    tot = trec.request_totals()
    for rid, res in tres.items():
        t = tot.get(rid, {"committed": 0, "rolled_back": 0, "pruned": 0})
        assert t["committed"] == res.stats.emitted, rid
        assert t["rolled_back"] == res.stats.rollback_tokens, rid
        assert t["pruned"] == res.stats.pruned_tokens, rid
    c = trec.registry.as_dict()["counters"]
    assert c.get("tokens_committed_total", 0) == \
        sum(t["committed"] for t in tot.values())
    assert c.get("rollback_tokens_total", 0) == \
        sum(t["rolled_back"] for t in tot.values())
    assert c.get("pruned_tokens_total", 0) == \
        sum(t["pruned"] for t in tot.values())
    causes = sum(v for k, v in c.items()
                 if k.startswith("rollback_tokens_")
                 and k != "rollback_tokens_total")
    assert causes == c.get("rollback_tokens_total", 0)
    assert c["requests_finished_total"] == len(tres)
    if CASES[name][0] == "batched":
        assert c["serving_tokens_total"] == \
            sum(len(r.tokens) for r in tres.values())
        assert c["serving_rounds_total"] == c["rounds_total"]


@pytest.mark.parametrize("name", [n for n in CASES
                                  if CASES[n][0] == "batched"])
def test_recorder_adds_no_host_fetch(pair, runs, name):
    """The same serve without a recorder moves the same packets: every
    event field comes from host values the loop already fetched."""
    _, tpair, prompts = pair
    _, _, _, tres, te = runs[name]
    _, engine, backend, temp, eng_kw = CASES[name]
    bare, bres = _port_batched(tpair, prompts, engine, backend, temp,
                               eng_kw, NULL_RECORDER)
    assert bare.rec is NULL_RECORDER and NULL_RECORDER.events == []
    assert bare.host_fetches == te.host_fetches
    assert bare.host_transfer_bytes == te.host_transfer_bytes
    assert {i: r.tokens for i, r in bres.items()} == \
        {i: r.tokens for i, r in tres.items()}


def test_null_recorder_is_inert():
    rec = NullRecorder()
    assert not rec.enabled and rec.now() == 0.0
    rec.spec(rid=0, round=0, stage="sps", committed=3)
    rec.request("admit", 0)
    rec.finish(0, emitted=3, rollback_tokens=0)
    rec.span("draft", 0.0, 1.0)
    rec.model_call(role="draft", tokens=1)
    assert rec.events == [] and NULL_RECORDER.events == []


def test_perfetto_export_structure(runs):
    for name in ("batched-specbranch-paged-preempt",
                 "sequential-specbranch"):
        trec = runs[name][2]
        ev = json.loads(json.dumps(perfetto_trace(trec)))["traceEvents"]
        assert ev, "empty trace"
        names = {e["args"]["name"] for e in ev
                 if e["ph"] == "M" and e["name"] == "thread_name"}
        assert {"draft", "verify", "commit"} <= names
        assert {e["pid"] for e in ev if e["ph"] != "M"} <= {1, 2, 3}
        for e in ev:
            if e["ph"] == "X":
                assert e["ts"] >= 0 and e["dur"] >= 1
    # the batched trace has the round spans and the engine lanes
    ev = perfetto_trace(runs["batched-specbranch-paged-preempt"][2])
    xs = {(e["pid"], e["name"]) for e in ev["traceEvents"]
          if e["ph"] == "X"}
    assert (2, "draft") in xs and (2, "verify") in xs
    assert any(p == 1 and n.startswith("round[") for p, n in xs)


def test_annotate_is_free_when_off_and_a_range_when_on():
    assert not DL._ANNOTATE
    ctx = DL.annotate("sps_verify", "cpu")
    with ctx:
        pass
    DL.set_trace_annotations(True)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with DL.annotate("branch_verify", "cpu"):
                torch.ones(3).sum()
    finally:
        DL.set_trace_annotations(False)
    assert "branch_verify" in {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("mode", ["batched", "sequential"])
def test_serve_cli_writes_trace_metrics_and_profile(tmp_path, capsys, mode):
    trace, metrics = tmp_path / "trace.json", tmp_path / "m.json"
    prof = tmp_path / "prof"
    SV.main(["--device", "cpu", "--mode", mode, "--requests", "2",
             "--new-tokens", "6", "--max-batch", "2", "--attn-backend",
             "dense", "--trace", str(trace), "--metrics-out", str(metrics),
             "--profile-dir", str(prof)])
    text = capsys.readouterr().out
    assert f"trace written to {trace}" in text
    assert f"metrics written to {metrics}" in text
    assert not DL._ANNOTATE                 # the CLI turns them off again
    doc = json.loads(trace.read_text())
    assert doc["traceEvents"]
    m = json.loads(metrics.read_text())
    assert m["counters"]["requests_finished_total"] == 2
    assert m["counters"]["tokens_committed_total"] >= 12
    files = list(prof.glob("trace.*.json"))
    assert len(files) == 1 and json.loads(files[0].read_text())
    # a plain-text metrics dump for any other suffix
    txt = tmp_path / "m.txt"
    SV.main(["--device", "cpu", "--mode", mode, "--requests", "1",
             "--new-tokens", "4", "--metrics-out", str(txt)])
    assert "requests_finished_total 1" in txt.read_text()
