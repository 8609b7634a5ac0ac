"""Batched paged SpecBranch serving: the port against the reference engine
on the committed misaligned pair (same weights, same prompts), 3 requests
x 24 new tokens at max_batch 2 — greedy, temperature 1, and a small pool
that preempts and swaps.  Per-request streams, GenStats, pool stats and
round counts must be equal; the port's greedy streams must equal its own
autoregressive greedy decode."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import ZipfMarkov
from repro.runtime.engines import EngineConfig as JEngineConfig
from repro.serving import BatchedSpecBranchEngine as JEngine
from repro.serving import ContinuousBatchScheduler as JScheduler
from repro.serving import ServeRequest as JRequest
from repro.serving.kv_pool import PagedStore as JPagedStore
from repro.training import pairs as JP
from repro_torch import resolve_device
from repro_torch.launch import serve as SV
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.engines import EngineConfig
from repro_torch.serving import (BatchedSpecBranchEngine,
                                 ContinuousBatchScheduler, ServeRequest)
from repro_torch.serving.kv_pool import PagedStore
from repro_torch.training.checkpoint import from_numpy_params

N_REQ, N_NEW = 3, 24
CASES = {
    "greedy": dict(temperature=0.0, engine={}),
    "temp1": dict(temperature=1.0, engine={}),
    "preempt-swap": dict(temperature=0.0,
                         engine=dict(page_size=4, pool_pages=120,
                                     swap_pages=64)),
}


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


def _stats(r):
    s = r.stats
    return (s.emitted, s.draft_tokens, s.target_calls, s.rollback_tokens,
            s.pruned_tokens, list(s.accept_runs))


@pytest.fixture(scope="module")
def runs(pair):
    """Each case served by both engines once (module-scoped: the reference
    engine compiles its jits per case)."""
    jpair, tpair, prompts = pair
    out = {}
    for name, case in CASES.items():
        kw = dict(gamma=4, c=10.0, temperature=case["temperature"],
                  max_len=512)
        eng_kw = dict(max_batch=2, **case["engine"])
        je = JEngine(*jpair, JEngineConfig(**kw), attn_backend="paged",
                     debug_check=True, **eng_kw)
        js = JScheduler(je)
        jres = js.run([JRequest(rid=i, prompt=p, max_new_tokens=N_NEW)
                       for i, p in enumerate(prompts)])
        te = BatchedSpecBranchEngine(*tpair, EngineConfig(**kw),
                                     device="cpu", debug_check=True,
                                     **eng_kw)
        ts = ContinuousBatchScheduler(te)
        tres = ts.run([ServeRequest(rid=i, prompt=p, max_new_tokens=N_NEW)
                       for i, p in enumerate(prompts)])
        out[name] = (je, js, jres, te, ts, tres)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_streams_and_stats_equal_reference(runs, name):
    je, js, jres, te, ts, tres = runs[name]
    assert sorted(tres) == sorted(jres) == list(range(N_REQ))
    for rid in range(N_REQ):
        assert tres[rid].tokens == jres[rid].tokens, rid
        assert len(tres[rid].tokens) == N_NEW
        assert _stats(tres[rid]) == _stats(jres[rid]), rid


@pytest.mark.parametrize("name", list(CASES))
def test_pool_and_round_accounting_equal_reference(runs, name):
    je, js, jres, te, ts, tres = runs[name]
    assert te.pool.stats.as_dict() == je.pool.stats.as_dict()
    assert te.timeline == je.timeline
    jr, tr = js.report(), ts.report()
    for key in ("rounds", "preemptions", "total_tokens", "total_cost",
                "ttft_p50", "itl_p50"):
        assert tr[key] == jr[key], key
    assert te.pool.pages_in_use == 0
    te.pool.check()


def test_preemption_case_really_swaps(runs):
    je, js, jres, te, ts, tres = runs["preempt-swap"]
    assert ts.report()["preemptions"] > 0
    assert te.pool.stats.reclaimed_preempt_pages > 0
    assert te.swap is not None and te.swap.pool.pages_in_use == 0


@pytest.mark.parametrize("name", ["greedy", "preempt-swap"])
def test_greedy_streams_equal_port_ar_decode(pair, runs, name):
    _, tpair, prompts = pair
    ref = TM.greedy_reference(tpair[2], tpair[3], prompts, N_NEW)
    tres = runs[name][5]
    assert [tres[i].tokens for i in range(N_REQ)] == ref


def test_paged_store_roundtrip_matches_reference():
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(11, 6)).astype(np.float32)
    js, ts = JPagedStore(8, 4, 6), PagedStore(8, 4, 6, device="cpu")
    for store in (js, ts):
        store.put("junk", np.ones((8, 6), np.float32)
                  if store is js else torch.ones(8, 6))
        store.drop("junk")             # leaves stale rows in freed pages
        store.put("s", rows if store is js else torch.from_numpy(rows))
    np.testing.assert_array_equal(ts.get("s").numpy(), js.get("s"))
    assert ts.pool.table("s") == js.pool.table("s")


def test_later_slice_options_raise(pair):
    _, tpair, _ = pair
    for kw in (dict(attn_backend="dense"), dict(prefix_cache=True),
               dict(hrad_params={}), dict(mesh=object())):
        with pytest.raises(NotImplementedError):
            BatchedSpecBranchEngine(*tpair, EngineConfig(max_len=128),
                                    device="cpu", **kw)
    for ecfg in (EngineConfig(max_len=128, draft_mode="parallel"),
                 EngineConfig(max_len=128, spec_predictor="on")):
        with pytest.raises(NotImplementedError):
            BatchedSpecBranchEngine(*tpair, ecfg, device="cpu")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_serve_cli_on_cpu_and_unsupported_flags(tmp_path, capsys):
    out = tmp_path / "rep.json"
    SV.main(["--device", "cpu", "--requests", "2", "--new-tokens", "6",
             "--max-batch", "2", "--json", str(out)])
    text = capsys.readouterr().out
    assert "batched specbranch on misaligned pair (cpu)" in text
    rep = __import__("json").loads(out.read_text())
    assert rep["total_tokens"] == 12 and rep["device"] == "cpu"
    for flags in (["--mode", "sequential"], ["--engine", "sps"],
                  ["--attn-backend", "dense"], ["--draft-mode", "parallel"]):
        with pytest.raises(SystemExit, match="not in this slice"):
            SV.main(["--device", "cpu"] + flags)
