"""Single-pass parallel drafting (DESIGN.md §7.12): the port against the
reference on the same weights and draft heads (the reference's
``init_draft_heads`` carried over with ``from_numpy_draft_heads``).

Pieces: ``attend`` with a ``q_ctx`` clamp; ``forward(pdraft=)`` logits
and features on the dense ring cache, the paged cache and cache-less,
and ``draft_head_logits``, to ``ATOL`` (f32); ``draft_chunk`` tokens
(exact), q-stack (``ATOL``) and packet; ``sps_verify`` with per-row
``glens``; the runner's ``forward_parallel`` through fork, select and
rollback.  Engines, on the committed misaligned pair: sequential SpS and
SpecBranch and batched SpS and SpecBranch x {paged, dense} x temperature
{0, 1} in parallel draft mode, one run that preempts and swaps, one with
the history predictor — streams, ``GenStats`` and timelines equal the
reference's.  Also pinned: batched SpS takes exactly 2 dispatches every
round; greedy parallel streams equal the target's greedy decode; heads
change nothing in sequential mode; the validation messages; the heads
cache key and file; the CLI."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import ZipfMarkov
from repro.models import layers as JL
from repro.models import model as JM
from repro.runtime import runner as JR
from repro.runtime.engines import EngineConfig as JEngineConfig
from repro.runtime.engines import SpSEngine as JSeqSpS
from repro.runtime.specbranch import SpecBranchEngine as JSeqSpecBranch
from repro.serving import BatchedSpecBranchEngine as JSpecBranch
from repro.serving import BatchedSpSEngine as JSpS
from repro.serving import ContinuousBatchScheduler as JScheduler
from repro.serving import ServeRequest as JRequest
from repro.serving import device_loop as JDL
from repro.training import checkpoint as JCK
from repro.training import pairs as JP
from repro_torch.launch import serve as SV
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import prng
from repro_torch.runtime import runner as TR
from repro_torch.runtime.engines import (EngineConfig, PEARLEngine,
                                         SpSEngine)
from repro_torch.runtime.specbranch import SpecBranchEngine
from repro_torch.serving import (BatchedSpecBranchEngine, BatchedSpSEngine,
                                 ContinuousBatchScheduler, ServeRequest)
from repro_torch.serving import device_loop as TDL
from repro_torch.training import pairs as TP
from repro_torch.training.checkpoint import (from_numpy_draft_heads,
                                             from_numpy_params)
from torch_parity import stub_head_trainer, synchronous_reference_ticks

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


ATOL = 1e-5           # f32 logits, features and probabilities
N_REQ, N_NEW = 3, 16
K_HEADS = 9           # max(gamma 4, gamma_branch 9)
SWAP = dict(page_size=4, pool_pages=120, swap_pages=64)
BATCHED = {"specbranch": (JSpecBranch, BatchedSpecBranchEngine),
           "sps": (JSpS, BatchedSpSEngine)}
SEQUENTIAL = {"specbranch": (JSeqSpecBranch, SpecBranchEngine),
              "sps": (JSeqSpS, SpSEngine)}
# name: (mode, engine, backend, temperature, epsilon, engine kwargs,
#        spec_predictor); epsilon 0 makes SpecBranch draft whole chunks
#        from the heads (at 0.3 the misaligned draft mostly stops at once)
CASES = {
    "seq-sps": ("sequential", "sps", None, 0.0, 0.3, {}, "off"),
    "seq-sps-temp1": ("sequential", "sps", None, 1.0, 0.3, {}, "off"),
    "seq-specbranch": ("sequential", "specbranch", None, 0.0, 0.3, {},
                       "off"),
    "seq-specbranch-temp1-eps0": ("sequential", "specbranch", None, 1.0,
                                  0.0, {}, "off"),
    "sps-paged": ("batched", "sps", "paged", 0.0, 0.3, {}, "off"),
    "sps-paged-temp1": ("batched", "sps", "paged", 1.0, 0.3, {}, "off"),
    "sps-dense": ("batched", "sps", "dense", 0.0, 0.3, {}, "off"),
    "sps-dense-temp1": ("batched", "sps", "dense", 1.0, 0.3, {}, "off"),
    "specbranch-paged": ("batched", "specbranch", "paged", 0.0, 0.3, {},
                         "off"),
    "specbranch-paged-temp1-eps0": ("batched", "specbranch", "paged", 1.0,
                                    0.0, {}, "off"),
    "specbranch-dense-eps0": ("batched", "specbranch", "dense", 0.0, 0.0,
                              {}, "off"),
    "specbranch-dense-temp1": ("batched", "specbranch", "dense", 1.0, 0.3,
                               {}, "off"),
    "specbranch-paged-preempt-swap": ("batched", "specbranch", "paged", 0.0,
                                      0.0, SWAP, "off"),
    "specbranch-paged-predictor": ("batched", "specbranch", "paged", 1.0,
                                   0.3, {}, "on"),
}


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_cfg(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def pair():
    dp, dcfg, tp, tcfg = JP.get_pair("misaligned")
    tdc, ttc = _port_cfg(dcfg), _port_cfg(tcfg)
    jheads = JM.init_draft_heads(jax.random.PRNGKey(7), dcfg, K_HEADS)
    port = (from_numpy_params(_to_np(dp), tdc, "cpu"), tdc,
            from_numpy_params(_to_np(tp), ttc, "cpu"), ttc)
    theads = from_numpy_draft_heads(_to_np(jheads), tdc, "cpu")
    zm = ZipfMarkov(vocab=JP.VOCAB, seed=7)
    prompts = [list(map(int, p)) for p in zm.prompts(N_REQ, 16, seed=3)]
    return (dp, dcfg, tp, tcfg), jheads, port, theads, prompts


def _kw(temp, eps, pred="off", mode="parallel"):
    return dict(gamma=4, c=10.0, temperature=temp, epsilon=eps,
                max_len=512, draft_mode=mode, spec_predictor=pred)


@pytest.fixture(scope="module")
def runs(pair):
    """Each case served by both packages once (module-scoped: the
    reference compiles its jits per engine)."""
    jpair, jheads, tpair, theads, prompts = pair
    out = {}
    for name, (mode, engine, backend, temp, eps, eng_kw, pred) \
            in CASES.items():
        kw = _kw(temp, eps, pred)
        if mode == "batched":
            je = BATCHED[engine][0](*jpair, JEngineConfig(**kw),
                                    attn_backend=backend, max_batch=2,
                                    debug_check=True, draft_heads=jheads,
                                    **eng_kw)
            jsched = JScheduler(je)
            jres = jsched.run([JRequest(rid=i, prompt=p,
                                        max_new_tokens=N_NEW)
                               for i, p in enumerate(prompts)])
            te = BATCHED[engine][1](*tpair, EngineConfig(**kw),
                                    device="cpu", debug_check=True,
                                    max_batch=2, attn_backend=backend,
                                    draft_heads=theads, **eng_kw)
            tsched = ContinuousBatchScheduler(te)
            tres = tsched.run([ServeRequest(rid=i, prompt=p,
                                            max_new_tokens=N_NEW)
                               for i, p in enumerate(prompts)])
            out[name] = (je, jres, je.timeline, te, tres, te.timeline,
                         tsched.report(), jsched.report())
        else:
            je = SEQUENTIAL[engine][0](*jpair, JEngineConfig(**kw),
                                       draft_heads=jheads)
            te = SEQUENTIAL[engine][1](*tpair, EngineConfig(**kw),
                                       draft_heads=theads)
            jres, tres = {}, {}
            for i, p in enumerate(prompts[:2]):
                jres[i] = je.generate(p, N_NEW, jax.random.PRNGKey(i))
                tres[i] = te.generate(p, N_NEW, prng.PRNGKey(i))
            out[name] = (je, jres, [r.timeline for r in jres.values()],
                         te, tres, [r.timeline for r in tres.values()],
                         None, None)
    return out


def _stats(r):
    s = r.stats
    return (s.emitted, s.draft_tokens, s.target_calls, s.rollback_tokens,
            s.pruned_tokens, list(s.accept_runs))


# ------------------------------------------------------------------ pieces
def test_attend_q_ctx_clamps_visibility():
    """A query at a future position with q_ctx = h attends exactly the
    keys a query AT h would, in both packages."""
    rng = np.random.default_rng(0)
    B, S, H, hd, h = 2, 12, 4, 16, 5
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, 3, H, hd), (B, S, 2, hd), (B, S, 2, hd)))
    kpos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kpos[1, 7:] = -1
    q_far = np.full((B, 3), S + 3, np.int32)
    q_at = np.full((B, 3), h, np.int32)
    ctx = np.array([[h, h, 2], [h, 9, h]], np.int32)
    t = torch.from_numpy
    got = TL.attend(t(q), t(k), t(v), t(q_far), t(kpos), q_ctx=t(ctx))
    want = JL.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(q_far), jnp.asarray(kpos),
                     q_ctx=jnp.asarray(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    at = TL.attend(t(q), t(k), t(v), t(q_at), t(kpos))
    np.testing.assert_allclose(got[0, :2].numpy(), at[0, :2].numpy(),
                               atol=ATOL)
    far = TL.attend(t(q), t(k), t(v), t(q_far), t(kpos))
    assert not np.allclose(far.numpy(), got.numpy())


def _pdraft_frame(pos, nreal, T):
    """The batched engines' parallel frame: per-row pending count
    ``nreal`` then slots, as numpy arrays."""
    t = np.arange(T, dtype=np.int32)[None]
    pos = np.asarray(pos, np.int32)[:, None]
    nr = np.asarray(nreal, np.int32)[:, None]
    positions = pos + t
    cols = t >= nr
    ctx = np.where(cols, pos + np.maximum(nr, 1) - 1, positions)
    return positions, cols, ctx, np.maximum(t - nr, 0)


def _pd(cols, ctx, sidx, embed, lib):
    return {"cols": lib(cols), "ctx": lib(ctx), "sidx": lib(sidx),
            "embed": embed}


@pytest.mark.parametrize("which", ["draft", "target"])
@pytest.mark.parametrize("cache", ["dense", "paged", "none"])
def test_forward_pdraft_equals_reference(pair, which, cache):
    """A prompt, then one parallel frame (ragged pending 2 and 1, 4
    slots): logits and every feature point equal the reference's, and the
    head logits over the last point's slot columns."""
    (dp, dcfg, tp, tcfg), jheads, tpair, theads, _ = pair
    jparams, jcfg = (dp, dcfg) if which == "draft" else (tp, tcfg)
    tparams, tcfg_ = ((tpair[0], tpair[1]) if which == "draft"
                      else (tpair[2], tpair[3]))
    if which == "target":
        jheads = JM.init_draft_heads(jax.random.PRNGKey(3), jcfg, 4)
        theads = from_numpy_draft_heads(_to_np(jheads), tcfg_, "cpu")
    rng = np.random.default_rng(1)
    B, L0, T, g = 2, 10, 6, 4
    prompt = rng.integers(0, JP.VOCAB, size=(B, L0)).astype(np.int32)
    toks = rng.integers(0, JP.VOCAB, size=(B, T)).astype(np.int32)
    positions, cols, ctx, sidx = _pdraft_frame([L0, L0], [2, 1], T)
    p0 = np.tile(np.arange(L0, dtype=np.int32), (B, 1))
    jkw, tkw = {}, {}
    jc = tc = None
    if cache == "dense":
        jc = JM.init_cache(jcfg, B, 64)
        tc = TM.init_cache(tcfg_, B, 64, "cpu")
    elif cache == "paged":
        ps, n_pages = 4, 12
        table = np.arange(B * 6, dtype=np.int32).reshape(B, 6)
        jc = JM.init_paged_cache(jcfg, n_pages + 1, ps)
        tc = TM.init_paged_cache(tcfg_, n_pages + 1, ps, "cpu")
        lens0 = np.full(B, L0, np.int32)
        lens1 = L0 + np.array([2, 1], np.int32)
        jkw = [dict(paged=(jnp.asarray(table), jnp.asarray(lens0))),
               dict(paged=(jnp.asarray(table), jnp.asarray(lens1)))]
        tkw = [dict(paged=(torch.from_numpy(table),
                           torch.from_numpy(lens0))),
               dict(paged=(torch.from_numpy(table),
                           torch.from_numpy(lens1)))]
    if jc is not None:
        _, jc, _ = JM.forward(jparams, jcfg, jnp.asarray(prompt), cache=jc,
                              positions=jnp.asarray(p0),
                              **(jkw[0] if jkw else {}))
        TM.forward(tparams, tcfg_, torch.from_numpy(prompt), cache=tc,
                   positions=torch.from_numpy(p0),
                   **(tkw[0] if tkw else {}))
    jl, _, jaux = JM.forward(
        jparams, jcfg, jnp.asarray(toks), cache=jc,
        positions=jnp.asarray(positions), feature_mode="all",
        pdraft=_pd(cols, ctx, sidx, jheads["mask_embed"], jnp.asarray),
        **(jkw[1] if jkw else {}))
    tl, taux = TM.forward(
        tparams, tcfg_, torch.from_numpy(toks), cache=tc,
        positions=torch.from_numpy(positions), feature_mode="all",
        pdraft=_pd(cols, ctx, sidx, theads["mask_embed"], torch.from_numpy),
        **(tkw[1] if tkw else {}))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(taux["features"].numpy(),
                               np.asarray(jaux["features"]), atol=ATOL)
    jh = JM.draft_head_logits(jparams, jcfg, jheads,
                              jaux["features"][-1][:, 2:])
    th = TM.draft_head_logits(tparams, tcfg_, theads,
                              taux["features"][-1][:, 2:])
    assert th.shape == (B, g, jcfg.vocab_size) and th.dtype == torch.float32
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)


def test_draft_head_logits_softcap_and_offset(pair):
    """A softcapped config and a head offset j0."""
    (dp, dcfg, _, _), jheads, tpair, theads, _ = pair
    capped = dataclasses.replace(dcfg, final_softcap=5.0)
    hid = np.random.default_rng(2).normal(size=(3, 4, dcfg.d_model)) \
        .astype(np.float32) * 3
    jh = JM.draft_head_logits(dp, capped, jheads, jnp.asarray(hid), j0=2)
    th = TM.draft_head_logits(tpair[0], _port_cfg(capped), theads,
                              torch.from_numpy(hid), j0=2)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    assert float(th.abs().max()) <= 5.0


def test_draft_chunk_equals_reference(pair):
    (dp, dcfg, _, _), jheads, tpair, theads, _ = pair
    rng = np.random.default_rng(3)
    n, T, V, D, g = 6, 8, dcfg.vocab_size, dcfg.d_model, 4
    lg = (rng.normal(size=(n, T, V)) * 3).astype(np.float32)
    feats = rng.normal(size=(n, T, D)).astype(np.float32)
    last = np.array([0, 1, 3, 0, 2, 1], np.int32)
    rids = np.array([5, 1, 2, 0, 9, 3], np.int32)
    ctrs = np.array([0, 7, 40, 0, 3, 11], np.int32)
    jt, jq, jp = JDL.draft_chunk(
        jnp.asarray(lg), jnp.asarray(feats), dp["final_norm"],
        jheads["heads"], jnp.asarray(last), jnp.asarray(rids),
        jnp.asarray(ctrs), jax.random.PRNGKey(4), g=g, dtemp=1.0,
        stemp=0.5, eps=dcfg.norm_eps)
    tt, tq, tp = TDL.draft_chunk(
        torch.from_numpy(lg), torch.from_numpy(feats),
        tpair[0]["final_norm"], theads["heads"], last, rids, ctrs,
        prng.PRNGKey(4), g=g, dtemp=1.0, stemp=0.5, eps=dcfg.norm_eps)
    assert tt.shape == (g, n) and tq.shape == (g + 1, n, V)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=ATOL)
    np.testing.assert_array_equal(tp[..., 0].numpy(), np.asarray(jp)[..., 0])
    np.testing.assert_allclose(tp[..., 1].numpy(), np.asarray(jp)[..., 1],
                               atol=1e-6)


def test_sps_verify_glens_equals_reference():
    """Per-row chain lengths: each row verifies its own glens[s] tokens,
    takes its bonus at glens[s], and its final uniform at that offset."""
    rng = np.random.default_rng(5)
    n_rows, Tb, V, g = 4, 8, 37, 4
    tlg = (rng.normal(size=(n_rows, Tb, V)) * 2).astype(np.float32)
    q = (rng.normal(size=(g, n_rows, V)) * 2).astype(np.float32)
    toks = rng.integers(0, V, size=(g, n_rows)).astype(np.int32)
    # draft tokens near the target's argmax, so some chains run long
    toks[:, 1] = tlg[1, 1:1 + g].argmax(-1)
    q[:, 1] = tlg[1, 1:1 + g]
    trows = np.array([1, 0, 3, 4], np.int32)        # 4: a pad lane
    drows = np.array([1, 2, 0, 3], np.int32)
    npend = np.array([2, 1, 1, 0], np.int32)
    rids = np.array([3, 8, 1, 0], np.int32)
    ctrs = np.array([10, 0, 5, 0], np.int32)
    glens = np.array([4, 1, 2, 0], np.int32)
    for temp in (0.0, 1.0):
        want = JDL.sps_verify(
            jnp.asarray(tlg), jnp.asarray(q), jnp.asarray(toks),
            jnp.asarray(trows), jnp.asarray(drows), jnp.asarray(npend),
            jnp.asarray(rids), jnp.asarray(ctrs), jax.random.PRNGKey(2),
            jnp.asarray(glens), g=g, ttemp=temp, dtemp=1.0)
        got = TDL.sps_verify(
            torch.from_numpy(tlg), torch.from_numpy(q),
            torch.from_numpy(toks), trows, drows, npend, rids, ctrs,
            prng.PRNGKey(2), glens, g=g, ttemp=temp, dtemp=1.0)
        np.testing.assert_array_equal(got[:3].numpy(),
                                      np.asarray(want)[:3])


def test_runner_forward_parallel_through_fork_select_rollback(pair):
    """The runner's parallel draft forward, then a fork, a branch step,
    a select, a rollback and another parallel forward: q_all and the
    last logits equal the reference's at every step."""
    (dp, dcfg, _, _), jheads, tpair, theads, prompts = pair
    jr = JR.ModelRunner(dp, dcfg, max_len=128)
    tr = TR.ModelRunner(tpair[0], tpair[1], max_len=128)
    p = prompts[0]

    def check(a, b):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)

    for r in (jr, tr):
        r.prefill(p)
        r.pending = r.pending + [5, 9]
    check(jr.forward_parallel(4, jheads), tr.forward_parallel(4, theads))
    check(jr.last_logits, tr.last_logits)
    assert tr.pos == jr.pos == len(p) + 2
    rows = np.array([[3], [17], [42]])
    for r in (jr, tr):
        r.fork(3)
    check(jr.forward_batched(rows), tr.forward_batched(rows))
    for r in (jr, tr):
        r.select(1)
        r.sync_lineage([17])
        r.reset_to(len(p) + 1)
        r.pending = [11]
    check(jr.forward_parallel(3, jheads), tr.forward_parallel(3, theads))
    check(jr.forward([7, 8]), tr.forward([7, 8]))
    assert tr.tokens == jr.tokens and tr.pos == jr.pos


# ----------------------------------------------------------------- engines
@pytest.mark.parametrize("name", list(CASES))
def test_engine_streams_and_stats_equal_reference(runs, name):
    je, jres, jtl, te, tres, ttl, _, _ = runs[name]
    assert sorted(tres) == sorted(jres)
    for rid in jres:
        assert tres[rid].tokens == jres[rid].tokens, rid
        assert len(tres[rid].tokens) == N_NEW
        assert _stats(tres[rid]) == _stats(jres[rid]), rid
    assert ttl == jtl
    if CASES[name][0] == "batched":
        assert te.pool.stats.as_dict() == je.pool.stats.as_dict()
        assert te.pool.pages_in_use == 0


def test_greedy_parallel_streams_equal_the_targets_greedy_decode(pair,
                                                                 runs):
    _, _, tpair, _, prompts = pair
    want = TM.greedy_reference(tpair[2], tpair[3], prompts, N_NEW)
    greedy = [n for n, c in CASES.items() if c[3] == 0.0]
    assert len(greedy) >= 6
    for name in greedy:
        tres = runs[name][4]
        for rid, r in tres.items():
            assert r.tokens == want[rid], (name, rid)


def test_batched_sps_takes_two_dispatches_every_round(runs):
    for name in ("sps-paged", "sps-paged-temp1", "sps-dense",
                 "sps-dense-temp1"):
        te, ttl, rep = runs[name][3], runs[name][5], runs[name][6]
        assert ttl and all(len(r) == 4 and r[3] == 2 for r in ttl), name
        assert rep["dispatches_per_round"] == 2.0
        assert rep["dispatches_per_round"] == runs[name][7][
            "dispatches_per_round"]


def test_specbranch_parallel_rounds_record_dispatches(runs):
    """Every parallel-mode SpecBranch round carries its measured
    dispatches: one draft forward (plus the verify in a verify round)."""
    ttl = runs["specbranch-paged-temp1-eps0"][5]
    assert all(len(r) == 4 for r in ttl)
    assert {r[3] for r in ttl} <= {1, 2}
    assert any(r[0] == "parallel" and r[3] == 2 for r in ttl)


def test_preempting_case_preempts_and_swaps(runs):
    te, rep = runs["specbranch-paged-preempt-swap"][3], \
        runs["specbranch-paged-preempt-swap"][6]
    assert rep["preemptions"] > 0
    assert rep["preemptions"] == runs["specbranch-paged-preempt-swap"][7][
        "preemptions"]
    assert te.swap is not None


@pytest.mark.parametrize("engine", ["sps", "specbranch"])
def test_sequential_mode_ignores_heads(pair, engine):
    """draft_mode 'sequential' with heads supplied runs exactly as
    without them: the heads are inert outside parallel mode."""
    _, _, tpair, theads, prompts = pair
    out = []
    for heads in (None, theads):
        te = BATCHED[engine][1](*tpair, EngineConfig(**_kw(
            1.0, 0.3, mode="sequential")), device="cpu", max_batch=2,
            attn_backend="paged", draft_heads=heads)
        res = ContinuousBatchScheduler(te).run(
            [ServeRequest(rid=i, prompt=p, max_new_tokens=12)
             for i, p in enumerate(prompts)])
        out.append(({i: r.tokens for i, r in res.items()}, te.timeline))
    assert out[0] == out[1]
    assert all(len(r) == 3 for r in out[0][1])


def test_validation_messages(pair):
    _, _, tpair, theads, _ = pair
    dp, dcfg, tp, tcfg = tpair
    par = EngineConfig(**_kw(0.0, 0.3))
    few = TM.init_draft_heads(dcfg, 2, torch.Generator().manual_seed(0),
                              "cpu")
    for make in (lambda h: SpSEngine(dp, dcfg, tp, tcfg, par,
                                     draft_heads=h),
                 lambda h: BatchedSpSEngine(dp, dcfg, tp, tcfg, par,
                                            device="cpu", draft_heads=h)):
        with pytest.raises(ValueError, match="needs draft_heads"):
            make(None)
        with pytest.raises(ValueError, match=r"max\(gamma, gamma_branch\)"):
            make(few)
    fdp, fdcfg, ftp, ftcfg = TP.hybrid_pair("falcon-shaped", device="cpu")
    fheads = TM.init_draft_heads(fdcfg, K_HEADS,
                                 torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="attention-only"):
        SpSEngine(fdp, fdcfg, ftp, ftcfg, par, draft_heads=fheads)
    with pytest.raises(ValueError, match="attention-only"):
        BatchedSpecBranchEngine(fdp, fdcfg, ftp, ftcfg, par, device="cpu",
                                draft_heads=fheads)
    with pytest.raises(ValueError, match="unknown draft_mode"):
        SpSEngine(dp, dcfg, tp, tcfg,
                  EngineConfig(**_kw(0.0, 0.3, mode="eager")))
    pearl = PEARLEngine(dp, dcfg, tp, tcfg, par, draft_heads=theads)
    with pytest.raises(NotImplementedError, match="PEARL"):
        pearl.generate([1, 2, 3], 4, prng.PRNGKey(0))


def test_heads_cache_key_and_file(tmp_path, monkeypatch):
    """The heads cache key equals the reference's; a file the reference
    writes loads into the port; a missing one is trained into the port's
    own cache (never the reference's) and read back from there."""
    for cfg in (JP.DRAFT_MIS_CFG, JP.DRAFT_ALI_CFG, JP.TARGET_CFG):
        for K, steps, seed in ((4, 200, 11), (9, 200, 11), (4, 50, 3)):
            assert TP._head_cache_key(_port_cfg(cfg), K, steps, seed) == \
                JP._head_cache_key(cfg, K, steps, seed)
    jheads = JM.init_draft_heads(jax.random.PRNGKey(1), JP.DRAFT_MIS_CFG, 9)
    key = JP._head_cache_key(JP.DRAFT_MIS_CFG, 9, 200, 11)
    JCK.save(str(tmp_path / f"heads-{key}.npz"), jheads)
    got = TP.draft_heads_for("misaligned", K=9, device="cpu",
                             cache_dir=str(tmp_path))
    for k in ("mask_embed", "heads"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jheads[k]))
    monkeypatch.setattr(TP, "CACHE_DIR", str(tmp_path / "empty"))
    port = tmp_path / "torch"
    monkeypatch.setattr(TP, "TORCH_CACHE_DIR", str(port))
    calls = []
    stub_head_trainer(monkeypatch, calls)
    got = TP.draft_heads_for("misaligned", K=4, device="cpu")
    key4 = JP._head_cache_key(JP.DRAFT_MIS_CFG, 4, 200, 11)
    assert calls == [(4, 200, 11)]
    assert sorted(p.name for p in port.iterdir()) == [f"heads-{key4}.npz"]
    assert not (tmp_path / "empty").exists()
    again = TP.draft_heads_for("misaligned", K=4, device="cpu")
    assert len(calls) == 1
    assert torch.equal(again["heads"], got["heads"])


def test_cli_parallel_without_heads_exits_naming_training(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """Without trained heads in either cache a parallel-draft serve
    trains them into the port's own cache first (a stub trainer here),
    then serves; an SSM pair and a non-drafting engine exit naming why."""
    monkeypatch.setattr(TP, "CACHE_DIR", str(tmp_path / "ref"))
    monkeypatch.setattr(TP, "TORCH_CACHE_DIR", str(tmp_path / "torch"))
    calls = []
    stub_head_trainer(monkeypatch, calls)
    SV.main(["--device", "cpu", "--draft-mode", "parallel",
             "--requests", "1", "--new-tokens", "4"])
    assert len(calls) == 1
    assert len(list((tmp_path / "torch").iterdir())) == 1
    assert "aggregate tokens/s" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="attention-only"):
        SV.main(["--device", "cpu", "--draft-mode", "parallel",
                 "--pair", "falcon-shaped"])
    with pytest.raises(SystemExit, match="drafting engine"):
        SV.main(["--device", "cpu", "--draft-mode", "parallel",
                 "--engine", "lookahead"])


@pytest.mark.parametrize("mode", ["batched", "sequential"])
def test_cli_spec_predictor_runs_on_the_cpu(mode, capsys):
    SV.main(["--device", "cpu", "--spec-predictor", "on", "--mode", mode,
             "--requests", "2", "--new-tokens", "8"])
    out = capsys.readouterr().out
    assert "aggregate tokens/s" in out
    if mode == "batched":
        assert "dispatches/round" in out
