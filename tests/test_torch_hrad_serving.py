"""Batched serving of this slice against the reference on the committed
misaligned pair (same weights, same prompts), 3 requests x 16 new tokens
at max_batch 2: SpecBranch with an H-RAD MLP (greedy under a 100-page
pool of page size 4 that preempts and swaps, and temperature 1) and the
batched SpS engine (greedy and temperature 1).  Streams, GenStats (H-RAD
signals included), pool stats, timelines and host counters must be
equal; the port keeps its swap store on the device, so the reference's
counters carry exactly one pack and one readback per swap more.  Greedy
streams must equal the port's own greedy decode.  Also the serve CLI's
``--mode batched --engine sps``.

The MLP is the reference's ``init_mlp`` under key 0, carried over as
numpy; each H-RAD case asserts that the reference's signals cover 0, 1
and 2, so every s_t path runs."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.core import hrad as JH
from repro.data.synthetic import ZipfMarkov
from repro.runtime.engines import EngineConfig as JEngineConfig
from repro.serving import BatchedSpecBranchEngine as JSpecBranch
from repro.serving import BatchedSpSEngine as JSpS
from repro.serving import ContinuousBatchScheduler as JScheduler
from repro.serving import ServeRequest as JRequest
from repro.training import pairs as JP
from repro_torch.launch import serve as SV
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.engines import EngineConfig
from repro_torch.serving import (BatchedSpecBranchEngine, BatchedSpSEngine,
                                 ContinuousBatchScheduler, ServeRequest)
from repro_torch.training import pairs as TP
from repro_torch.training.checkpoint import (from_numpy_hrad,
                                             from_numpy_params)
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


N_REQ, N_NEW = 3, 16
PREEMPT = dict(page_size=4, pool_pages=100, swap_pages=64)
# name: (engine, temperature, H-RAD, engine options)
CASES = {
    "hrad-preempt-swap": ("specbranch", 0.0, True, PREEMPT),
    "hrad-temp1": ("specbranch", 1.0, True, {}),
    "sps-greedy": ("sps", 0.0, False, {}),
    "sps-temp1": ("sps", 1.0, False, {}),
}
ENGINES = {"specbranch": (JSpecBranch, BatchedSpecBranchEngine),
           "sps": (JSpS, BatchedSpSEngine)}


@pytest.fixture(scope="module")
def pair():
    dp, dcfg, tp, tcfg = JP.get_pair("misaligned")
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    tdc = ModelConfig(**dataclasses.asdict(dcfg))
    ttc = ModelConfig(**dataclasses.asdict(tcfg))
    port = (from_numpy_params(to_np(dp), tdc, "cpu"), tdc,
            from_numpy_params(to_np(tp), ttc, "cpu"), ttc)
    jh = JH.init_mlp(jax.random.PRNGKey(0),
                     (EngineConfig().hrad_k_layers + 1) * tcfg.d_model)
    th = from_numpy_hrad(to_np(jh), "cpu")
    zm = ZipfMarkov(vocab=JP.VOCAB, seed=7)
    prompts = [list(map(int, p)) for p in zm.prompts(N_REQ, 16, seed=3)]
    return (dp, dcfg, tp, tcfg), port, (jh, th), prompts


def _stats(r):
    s = r.stats
    return (s.emitted, s.draft_tokens, s.target_calls, s.rollback_tokens,
            s.pruned_tokens, list(s.accept_runs), list(s.hrad_signals))


def _port_serve(tpair, engine, ecfg, hrad, prompts, **eng_kw):
    te = ENGINES[engine][1](*tpair, ecfg, device="cpu", debug_check=True,
                            max_batch=2, hrad_params=hrad,
                            attn_backend="paged", **eng_kw)
    ts = ContinuousBatchScheduler(te)
    tres = ts.run([ServeRequest(rid=i, prompt=p, max_new_tokens=N_NEW)
                   for i, p in enumerate(prompts)])
    return te, ts, tres


@pytest.fixture(scope="module")
def runs(pair):
    """Each case served by both engines once (module-scoped: the reference
    engine compiles its jits per engine)."""
    jpair, tpair, (jh, th), prompts = pair
    out = {}
    for name, (engine, temp, hrad, eng_kw) in CASES.items():
        kw = dict(gamma=4, c=10.0, temperature=temp, max_len=512)
        je = ENGINES[engine][0](*jpair, JEngineConfig(**kw),
                                attn_backend="paged", debug_check=True,
                                max_batch=2, hrad_params=jh if hrad else None,
                                **eng_kw)
        js = JScheduler(je)
        jres = js.run([JRequest(rid=i, prompt=p, max_new_tokens=N_NEW)
                       for i, p in enumerate(prompts)])
        out[name] = (je, js, jres) + _port_serve(
            tpair, engine, EngineConfig(**kw), th if hrad else None,
            prompts, **eng_kw)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_streams_and_stats_equal_reference(runs, name):
    je, js, jres, te, ts, tres = runs[name]
    assert sorted(tres) == sorted(jres) == list(range(N_REQ))
    for rid in range(N_REQ):
        assert tres[rid].tokens == jres[rid].tokens, rid
        assert len(tres[rid].tokens) == N_NEW
        assert _stats(tres[rid]) == _stats(jres[rid]), rid
    signals = {s for rid in jres for s in jres[rid].stats.hrad_signals}
    assert signals == ({0, 1, 2} if CASES[name][2] else set())


@pytest.mark.parametrize("name", list(CASES))
def test_pool_rounds_and_host_counters_equal_reference(runs, name):
    je, js, jres, te, ts, tres = runs[name]
    assert te.pool.stats.as_dict() == je.pool.stats.as_dict()
    assert te.timeline == je.timeline
    jr, tr = js.report(), ts.report()
    for key in ("rounds", "preemptions", "total_tokens", "total_cost",
                "ttft_p50", "itl_p50"):
        assert tr[key] == jr[key], key
    assert te.pool.pages_in_use == 0
    te.pool.check()
    # the reference packs each swapped row to the host and reads it back
    # (one fetch each, on its target decoder and engine tallies); the
    # port's swap store lives on the device
    n_swaps = je.tgt_dec.xfer_fetches
    assert (n_swaps > 0) == (name == "hrad-preempt-swap")
    assert je.host_fetches == te.host_fetches + 2 * n_swaps
    assert je.host_transfer_bytes == \
        te.host_transfer_bytes + 2 * je.tgt_dec.xfer_bytes


def test_hrad_preemption_swaps_and_keeps_the_streams(pair, runs):
    """Preemption with swap leaves every H-RAD stream as an unpreempted
    serve gives it, and that is the target's greedy decode."""
    _, tpair, (_, th), prompts = pair
    je, js, jres, te, ts, tres = runs["hrad-preempt-swap"]
    assert ts.report()["preemptions"] > 0
    assert te.swap is not None and te.swap.pool.pages_in_use == 0
    assert te.pool.stats.reclaimed_preempt_pages > 0
    _, ps, plain = _port_serve(
        tpair, "specbranch",
        EngineConfig(gamma=4, c=10.0, temperature=0.0, max_len=512), th,
        prompts)
    assert ps.report()["preemptions"] == 0
    streams = [tres[i].tokens for i in range(N_REQ)]
    assert streams == [plain[i].tokens for i in range(N_REQ)]
    assert streams == TM.greedy_reference(tpair[2], tpair[3], prompts,
                                          N_NEW)


def test_sps_greedy_equals_port_greedy_decode(pair, runs):
    _, tpair, _, prompts = pair
    tres = runs["sps-greedy"][5]
    assert [tres[i].tokens for i in range(N_REQ)] == \
        TM.greedy_reference(tpair[2], tpair[3], prompts, N_NEW)


def test_serve_cli_batched_sps_on_cpu(tmp_path, capsys, monkeypatch):
    out = tmp_path / "rep.json"
    SV.main(["--device", "cpu", "--mode", "batched", "--engine", "sps",
             "--requests", "2", "--new-tokens", "6", "--max-batch", "2",
             "--json", str(out)])
    text = capsys.readouterr().out
    assert "batched sps on misaligned pair (cpu): 2 requests" in text
    assert "aggregate tokens/s (modeled, t=1)" in text
    rep = json.loads(out.read_text())
    assert rep["total_tokens"] == 12 and rep["device"] == "cpu"
    # the engine default: sps has a batched form, as in the reference
    SV.main(["--device", "cpu", "--engine", "sps", "--requests", "1",
             "--new-tokens", "4"])
    assert "batched sps" in capsys.readouterr().out
    # parallel drafting is ported (tests/test_torch_parallel_draft.py):
    # without the trained heads' cache file it trains them into the
    # port's own cache first (a stub trainer here)
    monkeypatch.setattr(TP, "CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(TP, "TORCH_CACHE_DIR", str(tmp_path / "torch"))
    calls = []
    stub_head_trainer(monkeypatch, calls)
    SV.main(["--device", "cpu", "--engine", "sps", "--draft-mode",
             "parallel", "--requests", "1", "--new-tokens", "4"])
    assert len(calls) == 1 and "batched sps" in capsys.readouterr().out
