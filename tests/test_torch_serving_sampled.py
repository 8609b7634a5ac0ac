"""Batched paged SpecBranch serving at temperature 1: the port against the
reference engine on the committed misaligned pair (same weights, same
prompts), 3 requests x 24 new tokens at max_batch 2; per-request
streams, GenStats, pool stats and round counts must be equal.  Also the
swap store, the options of later slices, the device rule and the serve
CLI.  (Greedy and preemption are in ``test_torch_serving.py``: each file
runs its own reference serves, so the two run on two workers.)"""
import dataclasses
import types

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
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.engines import EngineConfig
from repro_torch.serving import (BatchedSpecBranchEngine,
                                 ContinuousBatchScheduler, ServeRequest)
from repro_torch.serving.kv_pool import PagedStore
from repro_torch.training import pairs as TP
from repro_torch.training.checkpoint import from_numpy_params
from torch_parity import stub_head_trainer, synchronous_reference_ticks

# One intra-op thread: the tiny models gain nothing from more, and the
# test workers share the machine's cores (eight threads in each of six
# workers slow every small op here many times over).
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _steady_reference():
    """The reference's batched draft ticks run synchronously while this
    module's reference serves run (``torch_parity``: a race in the
    reference's rounds, not in the port)."""
    with synchronous_reference_ticks():
        yield


N_REQ, N_NEW = 3, 24
CASES = {
    "temp1": dict(temperature=1.0, engine={}),
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
                                     attn_backend="paged", **eng_kw)
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
    # mesh serving is ported (tests/test_torch_sharded_serving.py): the
    # rank's device comes with its mesh, and another device is refused
    other = types.SimpleNamespace(device=torch.device("meta"))
    for kw in (dict(prefix_cache=True, attn_backend="paged", mesh=other),
               dict(mesh=other)):
        with pytest.raises(ValueError, match="the mesh binds"):
            BatchedSpecBranchEngine(*tpair, EngineConfig(max_len=128),
                                    device="cpu", **kw)
    # the prefix cache is ported (tests/test_torch_prefix_cache*.py): on
    # the paged backend it builds
    assert BatchedSpecBranchEngine(*tpair, EngineConfig(max_len=128),
                                   device="cpu", attn_backend="paged",
                                   prefix_cache=True).prefix_cache \
        is not None
    # as in the reference: the prefix cache needs page runs
    with pytest.raises(ValueError, match="requires attn_backend='paged'"):
        BatchedSpecBranchEngine(*tpair, EngineConfig(max_len=128),
                                device="cpu", prefix_cache=True)
    # parallel drafting and the predictor are ported
    # (tests/test_torch_parallel_draft.py, tests/test_torch_predictor.py)
    with pytest.raises(ValueError, match="needs draft_heads"):
        BatchedSpecBranchEngine(*tpair, EngineConfig(
            max_len=128, draft_mode="parallel"), device="cpu")
    assert BatchedSpecBranchEngine(*tpair, EngineConfig(
        max_len=128, spec_predictor="on"), device="cpu").predictor \
        is not None


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_serve_cli_on_cpu_and_unsupported_flags(tmp_path, capsys,
                                                monkeypatch):
    out = tmp_path / "rep.json"
    SV.main(["--device", "cpu", "--requests", "2", "--new-tokens", "6",
             "--max-batch", "2", "--json", str(out)])
    text = capsys.readouterr().out
    assert "batched specbranch on misaligned pair (cpu)" in text
    rep = __import__("json").loads(out.read_text())
    assert rep["total_tokens"] == 12 and rep["device"] == "cpu"
    # --prefix-cache on and --mesh are ported (tests/test_torch_prefix_
    # cache_admission.py, tests/test_torch_sharded_serving.py): --mesh
    # 1,1 is the unmeshed serve, and as in the reference --mesh needs
    # batched mode
    SV.main(["--device", "cpu", "--requests", "2", "--new-tokens", "6",
             "--max-batch", "2", "--mesh", "1,1"])
    assert "batched specbranch on misaligned pair (cpu)" in \
        capsys.readouterr().out
    with pytest.raises(SystemExit, match="requires --mode batched"):
        SV.main(["--device", "cpu", "--mode", "sequential", "--mesh",
                 "1,1"])
    # --spec-predictor and --draft-mode parallel are ported
    # (tests/test_torch_parallel_draft.py): without the trained heads'
    # cache file, parallel drafting trains them into the port's own cache
    # first (a stub trainer here)
    monkeypatch.setattr(TP, "CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(TP, "TORCH_CACHE_DIR", str(tmp_path / "torch"))
    calls = []
    stub_head_trainer(monkeypatch, calls)
    SV.main(["--device", "cpu", "--draft-mode", "parallel", "--requests",
             "1", "--new-tokens", "4"])
    assert len(calls) == 1 and "batched specbranch" in \
        capsys.readouterr().out
    # as in the reference: only SpS and SpecBranch have a batched form
    with pytest.raises(SystemExit, match="--mode batched supports"):
        SV.main(["--device", "cpu", "--mode", "batched", "--engine",
                 "pearl"])
