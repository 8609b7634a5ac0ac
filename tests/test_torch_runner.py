"""The port's dense ring cache and ``ModelRunner`` against the reference on
the same weights and state: the ring branch of ``layers.attention``
(wrapped rings, chunks longer than the ring, stale slots after a
rollback, windowed and global layers, "fresh" and "append"), the cache
layout, and the runner's forward / fork / select / sync_lineage /
reset_to / unfork on the committed Zipf-Markov pair.

Tolerances: f32 throughout; attention outputs and logits atol 1e-5 (the
same math in another summation order), cache positions equal, cached K/V
atol 1e-6 (the projections before the write)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import model as JM
from repro.models.config import ModelConfig as JCfg
from repro.models.config import dense_pattern as j_dense_pattern
from repro.runtime import runner as JR
from repro.training import pairs as JP
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import prng
from repro_torch.runtime import runner as TR
from repro_torch.runtime.engines import EngineConfig
from repro_torch.runtime.specbranch import SpecBranchEngine
from repro_torch.training import checkpoint as TC
from repro_torch.training import pairs as TP

# One intra-op thread: the tiny models gain nothing from more, and the
# test workers share the machine's cores (eight threads in each of six
# workers slow every small op here many times over).
torch.set_num_threads(1)

ATOL = 1e-5
# the reference layer jitted per call shape (eager JAX recompiles its
# scan on every call, several times slower)
J_ATTENTION = jax.jit(JL.attention,
                      static_argnames=("cfg", "window", "kv_chunk",
                                       "cache_mode"))


def _tcfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def pair():
    """(jax pair, port pair) on identical weights: the committed
    checkpoints read by each package's own loader."""
    return JP.get_pair("misaligned"), TP.get_pair("misaligned",
                                                  device="cpu")


LAYER_CFG = JCfg(name="ring", family="dense", num_layers=1, d_model=32,
                 num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=50,
                 pattern=j_dense_pattern(0), dtype="float32",
                 sliding_window=6)

# (window, ring_slack, max_len, calls); a call is (start position, T,
# cache_mode).  A start below the previous end is a rollback: the slots
# past it keep stale keys.
RING_CASES = {
    "global-append-rollback": (0, 0, 32, [(0, 7, "append"), (7, 3, "append"),
                                          (8, 4, "append"),
                                          (12, 1, "append")]),
    "global-fresh-prefill": (0, 0, 32, [(0, 9, "fresh"), (9, 2, "append")]),
    "window-wraps-with-stale": (6, 0, 64, [(0, 5, "append"),
                                           (5, 4, "append"),
                                           (7, 4, "append"),
                                           (11, 3, "append"),
                                           (13, 1, "append")]),
    "window-chunk-longer-than-ring": (6, 2, 64, [(0, 13, "fresh"),
                                                 (13, 11, "append"),
                                                 (20, 2, "append")]),
}


@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_ring_attention_matches_reference(name):
    window, slack, max_len, calls = RING_CASES[name]
    jcfg = LAYER_CFG
    tcfg = _tcfg(jcfg)
    jp = JL.init_attention(jax.random.PRNGKey(3), jcfg)
    tp = TC.from_numpy_params(dict(_np_tree(jp), embed=np.zeros(
        (50, 32), np.float32)), tcfg, "cpu")
    B = 2
    jc = JL.init_attn_cache(jcfg, B, max_len, window, ring_slack=slack)
    tc = {k: v[0] for k, v in TL.init_attn_cache(
        tcfg, B, max_len, window, "cpu", ring_slack=slack).items()}
    assert jc["k"].shape == tuple(tc["k"].shape)
    rng = np.random.default_rng(7)
    for start, T, mode in calls:
        x = rng.normal(size=(B, T, 32)).astype(np.float32)
        pos = np.broadcast_to(np.arange(start, start + T, dtype=np.int32),
                              (B, T)).copy()
        pos[1] += 3                      # rows at different positions
        jo, jc = J_ATTENTION(jp, jnp.asarray(x), cfg=jcfg,
                             positions=jnp.asarray(pos), cache=jc,
                             window=window, kv_chunk=8, cache_mode=mode)
        to = TL.attention(tp, torch.from_numpy(x), tcfg,
                          positions=torch.from_numpy(pos), cache=tc,
                          window=window, kv_chunk=8, cache_mode=mode)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                                   atol=ATOL)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))
        for n in ("k", "v"):
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("window", [0, 8])
def test_cache_layout_and_bytes_match_reference(window):
    jcfg = LAYER_CFG.replace(num_layers=5, sliding_window=window,
                             pattern=j_dense_pattern(2 if window else 0))
    tcfg = _tcfg(jcfg)
    jc = JM.init_cache(jcfg, 3, 40, ssm_ring=4)
    tc = TM.init_cache(tcfg, 3, 40, "cpu", ssm_ring=4)
    for js, ts in zip(jc["blocks"] + jc["rem"], tc["blocks"] + tc["rem"]):
        assert {k: v.shape for k, v in js.items()} == \
            {k: tuple(v.shape) for k, v in ts.items()}
        assert (ts["pos"] == -1).all()
    assert TM.cache_bytes(tcfg, 3, 40) == JM.cache_bytes(jcfg, 3, 40)
    assert len(TM.map_slot_caches(tc, lambda c: 0)["blocks"]) == jcfg.period


def test_prefill_and_decode_step_match_reference(pair):
    (_, _, jtp, jtcfg), (_, _, ttp, ttcfg) = pair
    toks = np.asarray([PROMPT, PROMPT[::-1]], np.int32)
    jc = JM.init_cache(jtcfg, 2, 24)
    tc = TM.init_cache(ttcfg, 2, 24, "cpu")
    jl, jc, _ = JM.prefill(jtp, jtcfg, jnp.asarray(toks), cache=jc)
    tl, _ = TM.prefill(ttp, ttcfg, torch.from_numpy(toks), cache=tc)
    _close(tl, jl)
    nxt = np.asarray([[3, 4], [5, 6]], np.int32)
    pos = np.asarray([10, 10], np.int32)
    jl, _, _ = JM.decode_step(jtp, jtcfg, jnp.asarray(nxt), cache=jc,
                              pos=jnp.asarray(pos))
    tl, _ = TM.decode_step(ttp, ttcfg, torch.from_numpy(nxt), cache=tc,
                           pos=torch.from_numpy(pos))
    _close(tl, jl)


def _close(t_logits, j_logits):
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=0, atol=ATOL)


def _drive(jr, tr, script):
    """Run the same step script on both runners, comparing the last
    logits after every step and the bookkeeping at the end."""
    for op, arg in script:
        if op == "forward":
            _close(tr.forward(arg), jr.forward(arg))
        elif op == "batched":
            _close(tr.forward_batched(np.asarray(arg)),
                   jr.forward_batched(np.asarray(arg)))
        else:
            getattr(jr, op)(*arg)
            getattr(tr, op)(*arg)
        assert (tr.pos, tr.tokens, tr.pending, tr.batch) == \
            (jr.pos, jr.tokens, jr.pending, jr.batch), op
        if jr.last_logits is None:
            assert tr.last_logits is None
        else:
            _close(tr.last_logits, jr.last_logits)
    assert (tr.n_calls, tr.n_call_tokens) == (jr.n_calls, jr.n_call_tokens)


PROMPT = [5, 17, 3, 99, 42, 8, 150, 23, 7, 61]
SCRIPT = [
    ("prefill", (PROMPT,)),
    ("forward", [12, 40]),                       # pending + 2 drafts
    ("fork", (3,)),
    ("batched", [[4], [9], [33]]),
    ("batched", [[1], [2], [3]]),
    ("select", (1,)),
    ("sync_lineage", ([9, 2],)),
    ("forward", [77]),
    ("reset_to", (len(PROMPT) + 2,)),            # rollback: stale slots
    ("forward", [18, 19, 20]),
    ("fork", (2,)),
    ("batched", [[6, 7], [8, 9]]),
    ("unfork", ()),
    ("forward", [31]),
]


@pytest.mark.parametrize("which", ["draft", "target"])
def test_runner_matches_reference(pair, which):
    (jdp, jdcfg, jtp, jtcfg), (tdp, tdcfg, ttp, ttcfg) = pair
    jparams, jcfg, tparams, tcfg = ((jdp, jdcfg, tdp, tdcfg)
                                    if which == "draft" else
                                    (jtp, jtcfg, ttp, ttcfg))
    jr = JR.ModelRunner(jparams, jcfg, max_len=64)
    tr = TR.ModelRunner(tparams, tcfg, max_len=64)
    _drive(jr, tr, SCRIPT)


def test_runner_continues_from_a_reference_cache(pair):
    """Carry the reference runner's mid-stream dense cache into the port
    (``from_numpy_cache``) and continue both from the same state."""
    (_, _, jtp, jtcfg), (_, _, ttp, ttcfg) = pair
    jr = JR.ModelRunner(jtp, jtcfg, max_len=32)
    jr.prefill(PROMPT + list(range(30, 45)))     # 24 ingested of 32 slots
    jr.forward([50, 51, 52])
    jr.reset_to(20)                              # stale slots 20..26
    tr = TR.ModelRunner(ttp, ttcfg, max_len=32)
    tr.cache = TC.from_numpy_cache(_np_tree(jr.cache), ttcfg, "cpu")
    tr.pos, tr.tokens = jr.pos, list(jr.tokens)
    tr.n_calls, tr.n_call_tokens = jr.n_calls, jr.n_call_tokens
    _drive(jr, tr, [("forward", [60, 61, 62, 63]), ("forward", [64]),
                    ("fork", (2,)), ("batched", [[1], [2]]),
                    ("select", (0,)), ("sync_lineage", ([1],)),
                    ("forward", [65, 66])])


def test_greedy_reference_matches(pair):
    (_, _, jtp, jtcfg), (_, _, ttp, ttcfg) = pair
    want = JR.greedy_reference(jtp, jtcfg, PROMPT, 12, max_len=64)
    assert TR.greedy_reference(ttp, ttcfg, PROMPT, 12, max_len=64) == want
    assert TM.greedy_reference(ttp, ttcfg, [PROMPT], 12)[0] == want


def test_runner_queries_always_see_a_key(pair, monkeypatch):
    """Every attention call of a SpecBranch serve (prefill, drafts,
    forks, rollbacks) gives each query at least one visible key, so the
    kernel's and the plain version's different no-key outputs never
    meet on this path."""
    _, tpair = pair
    plain = ops.flash_attention
    seen = {"calls": 0}

    def checked(q, k, v, q_pos, k_pos, *, causal=True, window=0,
                q_ctx=None, **kw):
        ctx = q_pos if q_ctx is None else q_ctx
        kp = k_pos[:, None, :].long()
        vis = (kp >= 0) & (kp <= ctx[:, :, None].long())
        if window > 0:
            vis &= (q_pos[:, :, None].long() - kp) < window
        assert bool(vis.any(-1).all()), "a query sees no key"
        seen["calls"] += 1
        return plain(q, k, v, q_pos, k_pos, causal=causal, window=window,
                     q_ctx=q_ctx, **kw)

    monkeypatch.setattr(ops, "flash_attention", checked)
    eng = SpecBranchEngine(*tpair, EngineConfig(gamma=4, c=6.0,
                                                temperature=1.0,
                                                max_len=64))
    eng.generate(PROMPT, 12, prng.PRNGKey(4))
    assert seen["calls"] > 0


def test_later_slice_paths_raise(pair):
    _, (tdp, tdcfg, _, _) = pair
    r = TR.ModelRunner(tdp, tdcfg, max_len=16)
    assert not r.has_ssm          # mamba runners: tests/test_torch_ssm.py
    # stub-frontend embeddings are ported (tests/test_torch_arch_serving):
    # placeholder ids, as in the reference
    re_ = TR.ModelRunner(tdp, tdcfg, max_len=16)
    re_.forward_embeds(torch.zeros(1, 2, tdcfg.d_model))
    assert (re_.pos, re_.tokens, re_.n_calls) == (2, [-1, -1], 1)
    # the parallel draft forward is ported (tests/test_torch_parallel_draft)
    heads = TM.init_draft_heads(tdcfg, 3, torch.Generator().manual_seed(0),
                                "cpu")
    r.prefill([1, 2, 3])
    assert r.forward_parallel(2, heads).shape == (1, 3, tdcfg.vocab_size)
