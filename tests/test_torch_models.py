"""The port's model stack against ``repro.models.model.forward`` on the
committed Zipf-Markov pair (same weights, carried over as numpy): logits
and features cache-less and through a paged cache with fragmented page
tables, f32, atol 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_pairs as JPP
from repro.models import layers as JL
from repro.models import model as JM
from repro.runtime.runner import greedy_reference as j_greedy
from repro.training import pairs as JP
from repro_torch.configs import paper_pairs as TPP
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig
from repro_torch.training import checkpoint as TC
from repro_torch.training import pairs as TP

ATOL = 1e-4


def _tcfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def pair():
    dp, dcfg, tp, tcfg = JP.get_pair("misaligned")
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {
        "draft": (dp, dcfg, TC.from_numpy_params(to_np(dp), _tcfg(dcfg),
                                                 "cpu")),
        "target": (tp, tcfg, TC.from_numpy_params(to_np(tp), _tcfg(tcfg),
                                                  "cpu")),
    }


def test_port_loader_reads_the_committed_checkpoints(pair):
    dp, dcfg, tp, tcfg = TP.get_pair("misaligned", device="cpu")
    assert (dcfg, tcfg) == (TP.DRAFT_MIS_CFG, TP.TARGET_CFG)
    for name, got in (("draft", dp), ("target", tp)):
        want = pair[name][2]
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_w) == len(flat_g)
        for path, w in flat_w:
            assert torch.equal(flat_g[path], w), path


@pytest.mark.parametrize("which", ["draft", "target"])
@pytest.mark.parametrize("feature_mode", ["last", "all"])
def test_cacheless_forward_matches(pair, which, feature_mode):
    jparams, jcfg, tparams = pair[which]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, size=(3, 11)).astype(np.int32)
    jlg, _, jaux = JM.forward(jparams, jcfg, jnp.asarray(toks),
                              feature_mode=feature_mode)
    tlg, taux = TM.forward(tparams, _tcfg(jcfg), torch.from_numpy(toks),
                           feature_mode=feature_mode)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(taux["features"].numpy(),
                               np.asarray(jaux["features"]), rtol=0,
                               atol=ATOL)
    jl, _, _ = JM.forward(jparams, jcfg, jnp.asarray(toks),
                          logits_mode="last")
    tl, _ = TM.forward(tparams, _tcfg(jcfg), torch.from_numpy(toks),
                       logits_mode="last")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("which", ["draft", "target"])
def test_paged_forward_matches_on_fragmented_tables(pair, which):
    """Prefill then a verify-sized chunk through a paged cache whose page
    tables are scattered; row 1 is shorter, so its tail writes go to the
    trash page."""
    jparams, jcfg, tparams = pair[which]
    tcfg = _tcfg(jcfg)
    ps, n_pages = 4, 12
    rng = np.random.default_rng(2)
    perm = rng.permutation(n_pages)
    table = np.full((2, 4), n_pages, np.int32)
    table[0, :4] = perm[:4]
    table[1, :3] = perm[4:7]
    jcache = JM.init_paged_cache(jcfg, n_pages, ps)
    tcache = TM.init_paged_cache(tcfg, n_pages, ps, "cpu")
    steps = [(np.arange(10)[None].repeat(2, 0), [10, 7]),
             (np.asarray([[10, 11, 12], [7, 8, 9]]), [13, 10])]
    for positions, lens in steps:
        positions = positions.astype(np.int32)
        toks = rng.integers(0, jcfg.vocab_size,
                            size=positions.shape).astype(np.int32)
        lens = np.asarray(lens, np.int32)
        jlg, jcache, _ = JM.forward(
            jparams, jcfg, jnp.asarray(toks), cache=jcache,
            positions=jnp.asarray(positions),
            paged=(jnp.asarray(table), jnp.asarray(lens)))
        tlg, _ = TM.forward(tparams, tcfg, torch.from_numpy(toks),
                            cache=tcache,
                            positions=torch.from_numpy(positions),
                            paged=(torch.from_numpy(table),
                                   torch.from_numpy(lens)))
        # compare only the real (non-pad) positions of each row
        for b in range(2):
            n_real = int(lens[b] - positions[b, 0])
            np.testing.assert_allclose(tlg[b, :n_real].numpy(),
                                       np.asarray(jlg)[b, :n_real], rtol=0,
                                       atol=ATOL)
    # the written pages agree too (trash page excluded)
    for jc, tc in zip(jcache["blocks"], tcache["blocks"]):
        for k in ("k_pages", "v_pages"):
            np.testing.assert_allclose(tc[k][:, :n_pages].numpy(),
                                       np.asarray(jc[k])[:, :n_pages],
                                       rtol=0, atol=ATOL)


def test_primitives_match():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 4, 8)).astype(np.float32)
    s = rng.normal(size=(8,)).astype(np.float32)
    pos = rng.integers(0, 100, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        TL.rms_norm(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(s))),
        rtol=0, atol=1e-6)
    js, jc = JL.rope_sin_cos(jnp.asarray(pos), 8, 10_000.0)
    ts, tc = TL.rope_sin_cos(torch.from_numpy(pos), 8, 10_000.0)
    np.testing.assert_allclose(
        TL.apply_rope(torch.from_numpy(x), ts, tc).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), js, jc)), rtol=0,
        atol=1e-5)
    np.testing.assert_allclose(
        TL.softcap(torch.from_numpy(x), 3.0).numpy(),
        np.asarray(JL.softcap(jnp.asarray(x), 3.0)), rtol=0, atol=1e-6)


def test_attend_q_ctx_horizon_and_chunks_match():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 6, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 9, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 9, 2, 8)).astype(np.float32)
    qp = np.asarray([[3, 4, 5, 6, 7, 8]] * 2, np.int32)
    kp = np.asarray([list(range(9)), [0, 1, 2, 3, -1, 5, 6, 7, 8]],
                    np.int32)
    ctx = np.minimum(qp, 5).astype(np.int32)
    for kw in ({}, {"window": 3}, {"cap": 5.0}):
        want = JL.attend(*map(jnp.asarray, (q, k, v, qp, kp)), kv_chunk=4,
                         q_ctx=jnp.asarray(ctx), **kw)
        got = TL.attend(*map(torch.from_numpy, (q, k, v, qp, kp)),
                        kv_chunk=4, q_ctx=torch.from_numpy(ctx), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("name", ["llama", "vicuna"])
def test_paper_pair_configs_and_param_shapes(name):
    jd, jt, jc = JPP.PAPER_PAIRS[name]
    td, tt, tc = TPP.PAPER_PAIRS[name]
    assert (dataclasses.asdict(td), dataclasses.asdict(tt), tc) == \
        (dataclasses.asdict(jd), dataclasses.asdict(jt), jc)
    # shapes of the random init, checked on a narrowed copy of the draft
    small = dict(num_layers=3, d_model=32, num_heads=4, num_kv_heads=2,
                 d_ff=48, vocab_size=50, dtype="float32")
    jcfg, tcfg = jd.replace(**small), td.replace(**small)
    want = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    got = TM.init_params(tcfg, seed=0, device="cpu")
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = dict(jax.tree_util.tree_leaves_with_path(got))
    assert {p for p, _ in wl} == set(gl)
    for path, w in wl:
        assert tuple(gl[path].shape) == w.shape, path
    assert tcfg.param_count() == jcfg.param_count()


def test_greedy_reference_matches(pair):
    jparams, jcfg, tparams = pair["target"]
    prompts = [[5, 17, 3, 99, 40], [7, 7, 1, 150]]
    want = [j_greedy(jparams, jcfg, p, 8, max_len=64) for p in prompts]
    assert TM.greedy_reference(tparams, _tcfg(jcfg), prompts, 8) == want
