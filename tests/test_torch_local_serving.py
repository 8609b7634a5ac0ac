"""Batched serving of the gemma3-shaped local-attention pair
(``training.pairs.local_pair``) in the port, on the reference's weights
(``tests/test_local_serving.py`` in the port).

The window (8) is smaller than prompt + generation, so every request's
local-layer ring wraps while speculation overshoots and rolls back around
it: the port's batched SpS and SpecBranch greedy streams, on the dense
ring cache and on the paged backend, must equal the reference's greedy
streams and the port's sequential engines; at temperature 1 a request
served alone equals it served in the batch, and the streams and GenStats
equal one reference batched SpecBranch run."""
import numpy as np
import pytest
import torch

from repro.runtime.engines import EngineConfig as JEngineConfig
from repro.runtime.runner import greedy_reference as j_greedy
from repro.serving import BatchedSpecBranchEngine as JBatchedSpecBranch
from repro.serving import ContinuousBatchScheduler as JScheduler
from repro.serving import ServeRequest as JRequest
from repro.training.pairs import local_pair as j_local_pair
from repro_torch.runtime import prng
from repro_torch.runtime.engines import EngineConfig, SpSEngine
from repro_torch.runtime.specbranch import SpecBranchEngine
from repro_torch.serving import (BatchedSpecBranchEngine, BatchedSpSEngine,
                                 ContinuousBatchScheduler, ServeRequest)
from repro_torch.training import pairs as TP
from torch_parity import gen_stats, port_pair, synchronous_reference_ticks

torch.set_num_threads(1)

N_NEW = 16          # > window: the sliding ring wraps during generation
N_REQ = 3


@pytest.fixture(scope="module", autouse=True)
def _steady_reference():
    """The reference's batched draft ticks run synchronously while this
    module's reference serve runs (``torch_parity``)."""
    with synchronous_reference_ticks():
        yield


def _ecfg_kw(**kw):
    kw.setdefault("gamma", 3)
    kw.setdefault("c", 4.0)
    kw.setdefault("temperature", 0.0)
    kw.setdefault("epsilon", 0.4)
    kw.setdefault("signal_temperature", 0.5)
    kw.setdefault("k_max", 2)
    kw.setdefault("max_len", 128)
    return kw


@pytest.fixture(scope="module")
def pair():
    jpair = j_local_pair("gemma3-shaped")
    tpair = port_pair(jpair)
    tcfg = tpair[3]
    assert tcfg.sliding_window < 6 + N_NEW      # the ring must wrap
    rng = np.random.default_rng(9)
    prompts = [list(map(int, rng.integers(0, tcfg.vocab_size, size=6)))
               for _ in range(N_REQ)]
    refs = [j_greedy(jpair[2], jpair[3], p, N_NEW, max_len=128)
            for p in prompts]
    return jpair, tpair, prompts, refs


def _serve(pair_, cls, rids=range(N_REQ), ecfg=None, **ekw):
    _, tpair, prompts, _ = pair_
    eng = cls(*tpair, EngineConfig(**_ecfg_kw(**(ecfg or {}))),
              max_batch=N_REQ, page_size=4, debug_check=True, device="cpu",
              **ekw)
    res = ContinuousBatchScheduler(eng).run(
        [ServeRequest(rid=i, prompt=prompts[i], max_new_tokens=N_NEW)
         for i in rids])
    return eng, res


def test_local_configs_equal_reference(pair):
    jpair, tpair, _, _ = pair
    dcfg, tcfg = TP.local_configs("gemma3-shaped")
    assert (dcfg, tcfg) == (tpair[1], tpair[3])
    assert TP.LOCAL_KINDS == ("gemma3-shaped",)
    dp, _, tp, _ = TP.local_pair(device="cpu")
    for a, b in ((dp, tpair[0]), (tp, tpair[2])):
        assert a["embed"].shape == b["embed"].shape
        assert [x["mixer"]["wq"].shape for x in a["blocks"]] == \
            [x["mixer"]["wq"].shape for x in b["blocks"]]


@pytest.mark.parametrize("backend", ["dense", "paged"])
@pytest.mark.parametrize("cls", [BatchedSpSEngine, BatchedSpecBranchEngine])
def test_local_batched_greedy_lossless(pair, cls, backend):
    """Sliding-window ring end to end: batched serving == the reference's
    greedy decode even after the ring wraps, on both storage backends."""
    refs = pair[3]
    eng, res = _serve(pair, cls, attn_backend=backend)
    for i, want in enumerate(refs):
        assert res[i].tokens == want, (cls.name, backend, i)
    assert eng.pool.pages_in_use == 0
    eng.pool.check()


def test_local_batched_equals_sequential_engines(pair):
    """Token for token against the port's sequential engines: the batched
    ring (positional rollback + ring slack) and the sequential runner
    agree on windowed attention."""
    _, tpair, prompts, refs = pair
    _, res = _serve(pair, BatchedSpSEngine)
    ecfg = EngineConfig(**_ecfg_kw())
    for cls in (SpSEngine, SpecBranchEngine):
        eng = cls(*tpair, ecfg)
        for i, p in enumerate(prompts):
            r = eng.generate(p, N_NEW, prng.PRNGKey(i))
            assert r.tokens == res[i].tokens == refs[i], (cls.name, i)


@pytest.fixture(scope="module")
def temp1(pair):
    """Batched SpecBranch at temperature 1 (dense, the engines' default
    backend): the port's serve and one reference serve."""
    jpair, _, prompts, _ = pair
    eng, res = _serve(pair, BatchedSpecBranchEngine,
                      ecfg={"temperature": 1.0})
    je = JBatchedSpecBranch(*jpair, JEngineConfig(**_ecfg_kw(
        temperature=1.0)), max_batch=N_REQ, page_size=4, debug_check=True)
    jres = JScheduler(je).run(
        [JRequest(rid=i, prompt=prompts[i], max_new_tokens=N_NEW)
         for i in range(N_REQ)])
    return res, jres


def test_local_temp1_equals_reference(temp1):
    res, jres = temp1
    for i in range(N_REQ):
        assert res[i].tokens == jres[i].tokens, i
        assert gen_stats(res[i]) == gen_stats(jres[i]), i


def test_local_temp1_solo_equals_batched(pair, temp1):
    """Sampled (temperature-1) streams are batch-composition independent
    over the wrapped ring: idle-row parking never evicts in-window keys."""
    batch = temp1[0]
    for i in range(N_REQ):
        _, solo = _serve(pair, BatchedSpecBranchEngine, rids=[i],
                         ecfg={"temperature": 1.0})
        assert solo[i].tokens == batch[i].tokens, i
