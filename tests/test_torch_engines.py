"""The port's sequential engines against the reference's on the committed
Zipf-Markov pair (both packages read the same checkpoints): at
temperature 0 every engine's stream equals the reference engine's and
plain AR greedy decoding; at temperature 1 the SpS, PEARL and SpecBranch
streams, GenStats and timelines equal the reference's through the
sequential scheduler (the threefry keys are bit-exact, the float64 verify
cores identical).  Also the serve CLI's ``--mode sequential`` on the
CPU and the options a later slice brings."""
import json

import jax
import pytest
import torch

from repro.launch import serve as JSV
from repro.runtime import engines as JE
from repro.runtime import scheduler as JS
from repro.training import pairs as JP
from repro_torch.launch import serve as TSV
from repro_torch.runtime import engines as TE
from repro_torch.runtime import prng
from repro_torch.runtime import runner as TR
from repro_torch.runtime import scheduler as TS
from repro_torch.runtime.cost_model import CostModel
from repro_torch.runtime.specbranch import SpecBranchEngine
from repro_torch.training import pairs as TP

# One intra-op thread: the tiny models gain nothing from more, and the
# test workers share the machine's cores (eight threads in each of six
# workers slow every small op here many times over).
torch.set_num_threads(1)

N_NEW = 16
PROMPTS = TSV.make_prompts(2)
ENGINES = ["autoregressive", "sps", "adaedl", "confidence-sd", "lookahead",
           "pearl", "specbranch"]


def _ecfg(mod, temperature):
    return mod.EngineConfig(gamma=4, c=10.0, temperature=temperature,
                            max_len=128)


def _build(name, mod_engines, sb_cls, pair, ecfg):
    dp, dcfg, tp, tcfg = pair
    cls = {"autoregressive": mod_engines.AutoregressiveEngine,
           "sps": mod_engines.SpSEngine, "adaedl": mod_engines.AdaEDLEngine,
           "confidence-sd": mod_engines.ConfidenceSDEngine,
           "lookahead": mod_engines.LookaheadEngine,
           "pearl": mod_engines.PEARLEngine, "specbranch": sb_cls}[name]
    if name in ("autoregressive", "lookahead"):
        return cls(tp, tcfg, ecfg)
    return cls(dp, dcfg, tp, tcfg, ecfg)


@pytest.fixture(scope="module")
def pairs():
    return JP.get_pair("misaligned"), TP.get_pair("misaligned",
                                                  device="cpu")


@pytest.fixture(scope="module")
def greedy(pairs):
    """Every engine once per package, and plain AR greedy decoding by the
    port's runner (held against the reference's in
    test_torch_runner.py), which costs no second reference run."""
    jpair, tpair = pairs
    from repro.runtime.specbranch import SpecBranchEngine as JSB
    ref = TR.greedy_reference(tpair[2], tpair[3], PROMPTS[0], N_NEW,
                              max_len=128)
    out = {}
    for name in ENGINES:
        j = _build(name, JE, JSB, jpair, _ecfg(JE, 0.0)).generate(
            PROMPTS[0], N_NEW, jax.random.PRNGKey(1))
        t = _build(name, TE, SpecBranchEngine, tpair,
                   _ecfg(TE, 0.0)).generate(PROMPTS[0], N_NEW,
                                            prng.PRNGKey(1))
        out[name] = (j, t)
    return ref, out


@pytest.mark.parametrize("name", ENGINES)
def test_greedy_stream_equals_reference_and_ar(greedy, name):
    ref, out = greedy
    j, t = out[name]
    assert t.tokens == j.tokens == ref
    assert vars(t.stats) == vars(j.stats)
    assert t.timeline == j.timeline


@pytest.fixture(scope="module")
def temp1(pairs):
    jpair, tpair = pairs
    from repro.runtime.specbranch import SpecBranchEngine as JSB
    out = {}
    for name in ("sps", "pearl", "specbranch"):
        jreqs = [JS.Request(rid=i, prompt=p, max_new_tokens=N_NEW)
                 for i, p in enumerate(PROMPTS)]
        treqs = [TS.Request(rid=i, prompt=p, max_new_tokens=N_NEW)
                 for i, p in enumerate(PROMPTS)]
        JS.Scheduler(_build(name, JE, JSB, jpair, _ecfg(JE, 1.0))).run(
            jreqs, key=jax.random.PRNGKey(0))
        TS.Scheduler(_build(name, TE, SpecBranchEngine, tpair,
                            _ecfg(TE, 1.0))).run(treqs,
                                                 key=prng.PRNGKey(0))
        out[name] = (jreqs, treqs)
    return out


@pytest.mark.parametrize("name", ["sps", "pearl", "specbranch"])
def test_temperature1_streams_and_stats_equal_reference(temp1, name):
    jreqs, treqs = temp1[name]
    for jr, tr in zip(jreqs, treqs):
        assert tr.result.tokens == jr.result.tokens
        assert vars(tr.result.stats) == vars(jr.result.stats)
        assert tr.result.timeline == jr.result.timeline
    cost = CostModel(c=10.0)
    tagg = TS.Scheduler(None).aggregate(treqs, cost)
    jagg = JS.Scheduler(None).aggregate(jreqs, cost)
    for key in ("M", "speedup", "rollback_rate", "total_tokens",
                "total_cost", "tokens_per_cost"):
        assert tagg[key] == pytest.approx(jagg[key], rel=1e-12), key
    tl = [r.result.timeline for r in treqs]
    assert TS.sequential_arrival_cost(tl, cost, 5.0) == pytest.approx(
        JS.sequential_arrival_cost(tl, cost, 5.0), rel=1e-12)


def test_serve_cli_sequential_on_cpu(tmp_path, capsys):
    out = tmp_path / "rep.json"
    TSV.main(["--device", "cpu", "--mode", "sequential", "--engine", "sps",
              "--requests", "2", "--new-tokens", "6", "--json", str(out)])
    text = capsys.readouterr().out
    assert "sequential sps on misaligned pair (cpu): 2 requests" in text
    assert "aggregate tokens/s (modeled, t=1)" in text
    rep = json.loads(out.read_text())
    assert rep["total_tokens"] == 12 and rep["device"] == "cpu"
    # engines without a batched form default to sequential, as in the
    # reference's launch.serve
    TSV.main(["--device", "cpu", "--engine", "lookahead", "--requests", "1",
              "--new-tokens", "4"])
    assert "sequential lookahead" in capsys.readouterr().out
    assert set(TSV.ENGINES) == set(JSV.ENGINES)
    assert set(TSV.BATCHED_ENGINES) == set(JSV.BATCHED_ENGINES)


def test_later_slice_engine_options_raise(pairs):
    _, (dp, dcfg, tp, tcfg) = pairs
    eng = TE.SpSEngine(dp, dcfg, tp, tcfg, TE.EngineConfig(max_len=64))
    # stub-frontend embeddings are ported (tests/test_torch_arch_serving):
    # the draft of another width takes its own through a (target, draft)
    # pair, and the stream starts after them
    emb = (torch.zeros(1, 2, tcfg.d_model), torch.zeros(1, 2, dcfg.d_model))
    assert len(eng.generate([1, 2, 3], 2, prng.PRNGKey(0),
                            embeds=emb).tokens) == 2
    # parallel drafting and the predictor are ported
    # (tests/test_torch_parallel_draft.py, tests/test_torch_predictor.py):
    # parallel mode now asks for heads, the predictor is built, and heads
    # are inert in sequential mode
    with pytest.raises(ValueError, match="needs draft_heads"):
        SpecBranchEngine(dp, dcfg, tp, tcfg,
                         TE.EngineConfig(draft_mode="parallel"))
    assert SpecBranchEngine(dp, dcfg, tp, tcfg, TE.EngineConfig(
        spec_predictor="on")).predictor is not None
    assert SpecBranchEngine(dp, dcfg, tp, tcfg, TE.EngineConfig(),
                            draft_heads={}).predictor is None
