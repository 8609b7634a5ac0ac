"""The port's AdamW (``repro_torch.training.optim``) against the
reference's (``repro.training.optim``) on the same numpy trees, float32:
the warmup-cosine schedule at every regime boundary (rtol 1e-6: both
compute it in float32), three ``apply`` steps with the global-norm clip
active and inactive (params, m and v within rtol 1e-4, atol 1e-5), the
leaf order of the gradient norm, and the in-place update's contract."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optim as JO
from repro_torch.training import optim as TO

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _tree(rng, scale=1.0):
    f = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa
    return {"wq": f(3, 4), "blocks": [{"mixer": {"w": f(2, 3), "b": f(3)}},
                                      {"mixer": {"w": f(2, 3), "b": f(3)}}],
            "embed": f(5, 2)}


def _np_tree(tree):
    return TO.tree_map(lambda t: t.numpy().copy(), tree)


def _close_trees(got, want):
    gl = TO.tree_leaves(got)
    wl = jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=RTOL, atol=ATOL)


def test_schedule_matches_reference():
    cfg = JO.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=100,
                         min_lr_ratio=0.1)
    tcfg = TO.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=100,
                          min_lr_ratio=0.1)
    for step in (0, 1, 5, 18, 19, 20, 21, 50, 99, 100, 150):
        want = float(JO.schedule(cfg, jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(TO.schedule(tcfg, step), want, rtol=1e-6)


def test_tree_leaves_follow_jax_order():
    tree = _tree(np.random.default_rng(0))
    got = [x.shape for x in TO.tree_leaves(TO.tree_map(torch.from_numpy,
                                                       tree))]
    assert got == [x.shape for x in jax.tree.leaves(tree)]
    back = TO.tree_unflatten(tree, TO.tree_leaves(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["unclipped",
                                                          "clipped"])
def test_apply_three_steps_match_reference(grad_scale):
    rng = np.random.default_rng(1)
    params = _tree(rng)
    grads = [_tree(rng, grad_scale) for _ in range(3)]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              clip_norm=1.0)
    jcfg, tcfg = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    jst = JO.init(jp)
    tp = TO.tree_map(lambda a: torch.from_numpy(a.copy()), params)
    tst = TO.init(tp)
    for g in grads:
        gn = float(TO.global_norm(TO.tree_map(torch.from_numpy, g)))
        jgn = float(jnp.sqrt(sum(jnp.sum(jnp.square(x))
                                 for x in jax.tree.leaves(g))))
        np.testing.assert_allclose(gn, jgn, rtol=1e-6)
        jp, jst = JO.apply(jcfg, jp, jax.tree.map(jnp.asarray, g), jst)
        tp, tst = TO.apply(tcfg, tp, TO.tree_map(torch.from_numpy, g), tst)
        _close_trees(tp, jp)
        _close_trees(tst.m, jst.m)
        _close_trees(tst.v, jst.v)
        assert tst.step == int(jst.step)


def test_apply_updates_in_place_and_keeps_dtypes():
    p = {"w": torch.ones(3, dtype=torch.bfloat16),
         "A_log": torch.ones(2, dtype=torch.float32)}
    g = {"w": torch.full((3,), 0.5, dtype=torch.bfloat16),
         "A_log": torch.full((2,), 0.5)}
    st = TO.init(p)
    w_before = p["w"]
    p2, st2 = TO.apply(TO.AdamWConfig(lr=0.1, warmup_steps=0), p, g, st)
    assert p2["w"] is w_before and p2["w"].dtype == torch.bfloat16
    assert st2.m["w"].dtype == torch.bfloat16
    assert st2.v["A_log"].dtype == torch.float32
    assert (p2["w"].float() < 1).all() and st2.step == 1


def test_apply_in_slices_equals_whole_leaves(monkeypatch):
    """A leaf updated in layer-axis slices (here of 6 elements) gets the
    same parameters and moments as one updated whole."""
    rng = np.random.default_rng(2)
    p = {"w": rng.standard_normal((4, 3, 2)).astype(np.float32)}
    g = {"w": rng.standard_normal((4, 3, 2)).astype(np.float32)}
    # no clipping: the gradient norm's sum order follows the slices
    cfg = TO.AdamWConfig(lr=1e-2, warmup_steps=0, clip_norm=1e9)
    runs = []
    for chunk in (1 << 26, 6):
        monkeypatch.setattr(TO, "CHUNK", chunk)
        tp = TO.tree_map(lambda a: torch.from_numpy(a.copy()), p)
        st = TO.init(tp)
        tp, st = TO.apply(cfg, tp, TO.tree_map(torch.from_numpy, g), st)
        runs.append((tp["w"], st.m["w"], st.v["w"]))
    assert len(TO._slices(torch.zeros(4, 3, 2))) == 4
    for a, b in zip(*runs):
        assert torch.equal(a, b)
