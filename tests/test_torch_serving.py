"""Batched paged SpecBranch serving: the port against the reference engine
on the committed misaligned pair (same weights, same prompts), 3 requests
x 24 new tokens at max_batch 2 — greedy, and a small pool that preempts
and swaps (temperature 1 and the CLI are in
``test_torch_serving_sampled.py``, so that the two reference fixtures run
on two workers).  Per-request streams, GenStats, pool stats and round
counts must be equal; the port's greedy streams must equal its own
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
from repro.training import pairs as JP
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.engines import EngineConfig
from repro_torch.serving import (BatchedSpecBranchEngine,
                                 ContinuousBatchScheduler, ServeRequest)
from repro_torch.training.checkpoint import from_numpy_params
from torch_parity import synchronous_reference_ticks

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
    "greedy": dict(temperature=0.0, engine={}),
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


