"""The port's sampling and device-loop functions against the reference's
(``repro.runtime.sampling`` device twins, ``repro.serving.device_loop``)
on the same numpy inputs: sampled tokens, verdict packets and bucket
ladders equal, distributions within f32 rounding."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import sampling as JS
from repro.serving import device_loop as JDL
from repro_torch.runtime import prng
from repro_torch.runtime import sampling as TS
from repro_torch.serving import device_loop as TDL

KEY_SEED = 3


def _t(a):
    return torch.from_numpy(np.array(a))


def _logits(rng, *shape):
    return (2.5 * rng.normal(size=shape)).astype(np.float32)


@pytest.mark.parametrize("temp", [0.0, 0.7, 1.0])
def test_probs_and_categorical(temp):
    rng = np.random.default_rng(0)
    lg = _logits(rng, 5, 40)
    u = rng.random(5, dtype=np.float32)
    jp = np.asarray(JS.probs_from_logits(jnp.asarray(lg), temp))
    tp = TS.probs_from_logits(_t(lg), temp)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        TS.categorical_from_uniform(tp, _t(u)).numpy(),
        np.asarray(JS.categorical_from_uniform(jnp.asarray(jp),
                                               jnp.asarray(u))))


def test_adaptive_k_and_ladders():
    for conf in (0.0, 0.2, 0.55, 0.99, 1.0):
        assert TS.adaptive_k(conf, 6) == JS.adaptive_k(conf, 6)
    for n in range(0, 40):
        assert TDL.bucket(n) == JDL.bucket(n)
        if n:
            assert TDL.prefill_bucket(n, 8) == JDL.prefill_bucket(n, 8)
    assert TDL.prefill_rungs([3, 9, 16, 17, 0], 8) == \
        JDL.prefill_rungs([3, 9, 16, 17, 0], 8)
    assert not TDL.kernel_route(1.0, 1.0, "cpu")
    assert not TDL.kernel_route(0.0, 1.0, "cuda")


@pytest.mark.parametrize("bonus", [False, True])
def test_verify_chain_device(bonus):
    rng = np.random.default_rng(1)
    S_, R, V = 6, 5, 30
    p = np.asarray(JS.probs_from_logits(jnp.asarray(_logits(rng, S_, R, V)),
                                        1.0))
    q = np.asarray(JS.probs_from_logits(jnp.asarray(_logits(rng, S_, R, V)),
                                        1.0))
    # drafted tokens from q so that some chains accept
    toks = np.argmax(q, -1).astype(np.int32)
    lens = np.asarray([5, 3, 0, 5, 1, 4], np.int32)
    ug = rng.random((S_, R + 1), dtype=np.float32)
    bp = p[:, 0] if bonus else None
    want = JS.verify_chain_device(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(toks), jnp.asarray(lens),
        jnp.asarray(ug), None if bp is None else jnp.asarray(bp))
    got = TS.verify_chain_device(_t(p), _t(q), _t(toks), _t(lens), _t(ug),
                                 None if bp is None else _t(bp))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_branch_verdict_device():
    rng = np.random.default_rng(2)
    S_, K, V = 7, 4, 25
    pb = np.asarray(JS.probs_from_logits(jnp.asarray(_logits(rng, S_, V)),
                                         1.0))
    qb = np.asarray(JS.probs_from_logits(jnp.asarray(_logits(rng, S_, V)),
                                         1.0))
    cands = rng.integers(0, V, size=(S_, K)).astype(np.int32)
    cands[:, 0] = np.argmax(pb, -1)
    ks = np.asarray([1, 2, 4, 3, 1, 4, 2], np.int32)
    ug = rng.random((S_, K + 1), dtype=np.float32)
    want = JS.branch_verdict_device(*map(jnp.asarray,
                                         (pb, qb, cands, ks, ug)))
    got = TS.branch_verdict_device(*map(_t, (pb, qb, cands, ks, ug)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtemp,stemp", [(1.0, 1.0), (0.0, 0.5)])
def test_tick_sample(dtemp, stemp):
    rng = np.random.default_rng(3)
    lg = _logits(rng, 6, 4, 50)
    last = np.asarray([0, 3, 1, 0, 2, 0], np.int32)
    rids = np.asarray([4, 0, 9, 2, 0, 7], np.int32)
    ctrs = np.asarray([0, 0, 13, 5, 0, 120], np.int32)
    jt, jsl, jpk = JDL.tick_sample(
        jnp.asarray(lg), jnp.asarray(last), jnp.asarray(rids),
        jnp.asarray(ctrs), jax.random.PRNGKey(KEY_SEED), dtemp=dtemp,
        stemp=stemp)
    tt, tsl, tpk = TDL.tick_sample(_t(lg), last, rids, ctrs,
                                   prng.PRNGKey(KEY_SEED), dtemp=dtemp,
                                   stemp=stemp)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tsl.numpy(), np.asarray(jsl))
    np.testing.assert_allclose(tpk.numpy(), np.asarray(jpk), rtol=1e-6)


def test_masked_column_and_compose_verify_tokens():
    tokens = np.asarray([5, 6, 7, 8], np.int32)
    mask = np.asarray([True, False, True, False])
    np.testing.assert_array_equal(
        TDL.masked_token_column(_t(tokens), mask).numpy(),
        np.asarray(JDL.masked_token_column(jnp.asarray(tokens),
                                           jnp.asarray(mask))))
    rng = np.random.default_rng(4)
    pend = rng.integers(0, 90, size=(3, 2)).astype(np.int32)
    npend = np.asarray([1, 2, 1], np.int32)
    tok_stack = rng.integers(0, 90, size=(4, 6)).astype(np.int32)
    drows = np.asarray([2, 0, 5], np.int32)
    trows = np.asarray([1, 3, 4], np.int32)     # 4 = out-of-range pad lane
    want = JDL.compose_verify_tokens(
        jnp.asarray(pend), jnp.asarray(npend), jnp.asarray(tok_stack),
        jnp.asarray(drows), jnp.asarray(trows), n_rows=4, Tb=8)
    got = TDL.compose_verify_tokens(pend, npend, _t(tok_stack), drows,
                                    trows, n_rows=4, Tb=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_draw_cands():
    rng = np.random.default_rng(5)
    qb = _logits(rng, 4, 60)
    rids = np.asarray([1, 2, 0, 0], np.int32)
    ctrs = np.asarray([10, 0, 0, 0], np.int32)
    for mode in ("sample", "topk"):
        want = JDL.draw_cands(jnp.asarray(qb), jnp.asarray(rids),
                              jnp.asarray(ctrs),
                              jax.random.PRNGKey(KEY_SEED), K=3, stemp=1.0,
                              mode=mode)
        got = TDL.draw_cands(_t(qb), rids, ctrs, prng.PRNGKey(KEY_SEED),
                             K=3, stemp=1.0, mode=mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _branch_inputs(seed, CH=4, K=3, V=40, n_rows=5):
    rng = np.random.default_rng(seed)
    S_ = 4
    tlg = _logits(rng, n_rows, 8, V)
    trows = np.asarray([2, 0, 3, n_rows], np.int32)      # last: pad lane
    npend = np.asarray([1, 2, 1, 0], np.int32)
    gch = np.asarray([4, 2, 0, 0], np.int32)
    chunk_q = _logits(rng, S_, CH, V)
    chunk_toks = rng.integers(0, V, size=(S_, CH)).astype(np.int32)
    # make the first chunk accept-prone: draft tokens at the target argmax
    chunk_toks[0] = np.argmax(tlg[2, :CH], -1)
    cands = rng.integers(0, V, size=(S_, K)).astype(np.int32)
    ks = np.asarray([3, 1, 2, 1], np.int32)
    qb = _logits(rng, S_, V)
    rids = np.asarray([3, 8, 1, 0], np.int32)
    ctrs = np.asarray([40, 2, 0, 0], np.int32)
    return (tlg, trows, npend, gch, chunk_q, chunk_toks, cands, ks, qb,
            rids, ctrs)


@pytest.mark.parametrize("ttemp,kernel", [(0.0, False), (1.0, False),
                                           (1.0, True)])
def test_branch_verify_packet(ttemp, kernel):
    """The fused verdict packet; kernel=True (temperature > 0 only) routes
    the chain through the batched verify kernel: its plain version on the
    CPU, the Pallas kernel in interpret mode in the reference."""
    args = _branch_inputs(6)
    kw = dict(CH=4, K=3, ttemp=ttemp, dtemp=1.0, stemp=1.0)
    want = JDL.branch_verify(*map(jnp.asarray, args),
                             jax.random.PRNGKey(KEY_SEED), kernel=kernel,
                             interpret=True, **kw)
    tlg, trows, npend, gch, cq, ct, cands, ks, qb, rids, ctrs = args
    got = TDL.branch_verify(_t(tlg), trows, npend, gch, _t(cq), ct, cands,
                            ks, _t(qb), rids, ctrs, prng.PRNGKey(KEY_SEED),
                            kernel=kernel, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
