"""The port's training path (``repro_torch.training``, ``launch.steps``,
``launch.train``) against the reference's (``repro.training``,
``repro.launch.steps``) in the same process, on the reference's weights
carried over with ``from_numpy_params``, float32 on the CPU:

* ``lm_loss``'s value and every gradient leaf against
  ``jax.value_and_grad`` on the tiny target config and the reduced
  gemma2-27b (softcap, window), gemma3-4b (qk-norm, 5:1 local), granite
  MoE (the load-balance term), falcon-mamba (the scan), jamba (hybrid)
  and hubert (``causal=False``): rtol 1e-4, atol 1e-5;
* no detach: after one backward every leaf whose reference gradient is
  non-zero has a non-zero gradient (a port layer that cut the graph with
  ``.detach()``, ``.data`` or ``no_grad`` would leave it None or zero);
* three ``make_train_step`` steps and two gradient-accumulated remat
  steps of ``launch.steps`` against the reference's params (rtol 1e-4,
  atol 1e-5);
* ``draft_head_loss`` and its gradients (the parallel-draft frame: slot
  keys invisible, slot queries clamped);
* ``checkpoint.save`` read by the reference's ``load`` and the reverse,
  remainder layers and bf16 leaves included; ``token_stream``;
* a pair member, draft heads and the H-RAD MLP missing from every cache
  are trained into the port's own cache, never the reference's;
  ``measure_alpha`` equals the reference's on the committed pair.
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import synthetic as JS
from repro.launch import steps as JLS
from repro.models import model as JM
from repro.training import checkpoint as JCK
from repro.training import optim as JO
from repro.training import pairs as JP
from repro.training import train as JT
from repro_torch.data import synthetic as TS
from repro_torch.launch import steps as TLS
from repro_torch.launch import train as TLT
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig
from repro_torch.training import checkpoint as TCK
from repro_torch.training import optim as TO
from repro_torch.training import pairs as TP
from repro_torch.training import train as TT

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
LM_CONFIGS = ["zm-target", "gemma2-27b", "gemma3-4b", "granite-moe-3b-a800m",
              "falcon-mamba-7b", "jamba-1.5-large-398b", "hubert-xlarge"]


def _jcfg(name):
    return JP.TARGET_CFG if name == "zm-target" else \
        j_get_config(name).reduced()


def _port(jcfg, jparams):
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    return cfg, TCK.from_numpy_params(jax.tree.map(np.asarray, jparams),
                                      cfg, "cpu")


def _flat_port(tree):
    return TCK._flatten(TCK._reference_layout(tree))


def _close_flat(got, want, rtol=RTOL, atol=ATOL):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.fixture(scope="module")
def lm_cases():
    """Each config with the reference's weights, one batch, and the
    reference's loss, metrics and gradients (one evaluation each)."""
    out = {}
    vg = jax.jit(jax.value_and_grad(JT.lm_loss, has_aux=True),
                 static_argnums=1)
    for i, name in enumerate(LM_CONFIGS):
        jcfg = _jcfg(name)
        jp = JM.init_params(jax.random.PRNGKey(i), jcfg)
        toks = np.random.default_rng(i).integers(
            0, jcfg.vocab_size, size=(2, 13)).astype(np.int32)
        (jl, jm), jg = vg(jp, jcfg, jnp.asarray(toks))
        out[name] = (jcfg, jp, toks, float(jl), float(jm["moe_aux"]),
                     JCK._flatten(jg))
    return out


@pytest.mark.parametrize("name", LM_CONFIGS)
def test_lm_loss_and_grads_match_reference(name, lm_cases):
    jcfg, jp, toks, jl, jaux, jg = lm_cases[name]
    cfg, params = _port(jcfg, jp)
    loss, metrics, grads = TT.value_and_grad(TT.lm_loss, params, cfg,
                                             torch.from_numpy(toks))
    np.testing.assert_allclose(float(loss), jl, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(metrics["moe_aux"]), jaux, rtol=RTOL,
                               atol=ATOL)
    _close_flat(_flat_port(grads), jg)


@pytest.mark.parametrize("name", LM_CONFIGS)
def test_backward_reaches_every_leaf(name, lm_cases):
    """No port layer detaches: ``loss.backward()`` on leaves that require
    grad leaves a non-zero gradient on every leaf (and every element)
    whose reference gradient is non-zero."""
    jcfg, jp, toks, _jl, _jaux, jg = lm_cases[name]
    cfg, params = _port(jcfg, jp)
    leaves = TO.tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    loss, _ = TT.lm_loss(params, cfg, torch.from_numpy(toks))
    loss.backward()
    grads = TO.tree_unflatten(params, [
        torch.zeros_like(x) if x.grad is None else x.grad for x in leaves])
    got = _flat_port(grads)
    for k, want in jg.items():
        live = np.abs(want) > 1e-6
        if live.any():
            assert (got[k][live] != 0).all(), k


def test_train_step_three_steps_match_reference():
    jcfg = JP.DRAFT_MIS_CFG
    jp = JM.init_params(jax.random.PRNGKey(3), jcfg)
    cfg, params = _port(jcfg, jp)
    data = JS.ZipfMarkov(vocab=jcfg.vocab_size, seed=7).batch_iter(4, 16, 1)
    batches = [next(data) for _ in range(3)]
    ocfg = dict(lr=1e-4, total_steps=3, warmup_steps=1)
    jstep = JT.make_train_step(jcfg, JT.TrainConfig(
        optim=JO.AdamWConfig(**ocfg)))
    tstep = TT.make_train_step(cfg, TT.TrainConfig(
        optim=TO.AdamWConfig(**ocfg)))
    jst, tst = JO.init(jp), TO.init(params)
    for b in batches:
        jp, jst, jl, _ = jstep(jp, jst, jnp.asarray(b))
        params, tst, tl, _ = tstep(params, tst, torch.from_numpy(b))
        np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL,
                                   atol=ATOL)
    _close_flat(_flat_port(params), JCK._flatten(jp))
    _close_flat(_flat_port(tst.m), JCK._flatten(jst.m))


def test_accumulated_remat_steps_match_reference():
    """``launch.steps.make_train_step``: 2 micro-batches, remat, on the
    tiny jamba-shaped target (Mamba, attention and MoE layers under
    checkpointing).  lr 1e-4: Adam moves an element whose gradient is
    float noise by ~lr either way in both frameworks."""
    jcfg = JP.hybrid_pair("jamba-shaped")[3]
    jp = JM.init_params(jax.random.PRNGKey(4), jcfg)
    cfg, params = _port(jcfg, jp)
    ocfg = dict(lr=1e-4, total_steps=2, warmup_steps=1)
    jstep = jax.jit(JLS.make_train_step(jcfg, 2, JO.AdamWConfig(**ocfg)))
    tstep = TLS.make_train_step(cfg, 2, TO.AdamWConfig(**ocfg))
    jst, tst = JO.init(jp), TO.init(params)
    rng = np.random.default_rng(4)
    for _ in range(2):
        b = rng.integers(0, jcfg.vocab_size, size=(4, 11)).astype(np.int32)
        jp, jst, jl = jstep(jp, jst, jnp.asarray(b))
        params, tst, tl = tstep(params, tst, torch.from_numpy(b))
        np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL,
                                   atol=ATOL)
    _close_flat(_flat_port(params), JCK._flatten(jp))


def test_draft_head_loss_and_grads_match_reference():
    jdp, jdcfg, _, _ = JP.get_pair("misaligned")
    cfg, dp = _port(jdcfg, jdp)
    K, L = 4, 20
    jheads = JM.init_draft_heads(jax.random.PRNGKey(5), jdcfg, K)
    theads = TCK.from_numpy_draft_heads(jax.tree.map(np.asarray, jheads),
                                        cfg, "cpu")
    anchors = TT.head_anchors(L, K)
    hi = L - K - 2
    n = min(8, hi)
    assert anchors == tuple(int(round(1 + i * (hi - 1) / max(n - 1, 1)))
                            for i in range(n))
    toks = np.random.default_rng(5).integers(
        0, jdcfg.vocab_size, size=(3, L)).astype(np.int32)
    (jl, _), jg = jax.jit(
        jax.value_and_grad(JT.draft_head_loss, has_aux=True),
        static_argnums=(2, 4, 5))(jheads, jdp, jdcfg, jnp.asarray(toks),
                                  anchors, K)
    tl, _, tg = TT.value_and_grad(TT.draft_head_loss, theads, dp, cfg,
                                  torch.from_numpy(toks), anchors, K)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL, atol=ATOL)
    _close_flat(TCK._flatten(tg), JCK._flatten(jg))
    # the base stays frozen: a step moves only the heads
    st = TO.init(theads)
    before = [x.clone() for x in TO.tree_leaves(dp)]
    TO.apply(TO.AdamWConfig(), theads, tg, st)
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                  TO.tree_leaves(dp)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_save_load_both_ways(tmp_path, dtype):
    """The port's ``save`` is read by the reference's ``load`` (remainder
    layers without the stack axis, bf16 written as f32) and the
    reference's ``save`` by the port's ``load``; heads and an H-RAD MLP
    keep the reference's keys."""
    jcfg = j_get_config("gemma3-4b").reduced().replace(num_layers=8,
                                                       dtype=dtype)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    tparams = TM.init_params(cfg, 1, "cpu")
    path = str(tmp_path / "port.npz")
    TCK.save(path, tparams)
    template = JM.init_params(jax.random.PRNGKey(0), jcfg)
    back = JCK.load(path, template)
    assert jax.tree.structure(back) == jax.tree.structure(template)
    _close_flat(JCK._flatten(back), _flat_port(tparams), rtol=0, atol=0)
    jparams = JM.init_params(jax.random.PRNGKey(2), jcfg)
    JCK.save(str(tmp_path / "ref.npz"), jparams)
    got = TCK.load(str(tmp_path / "ref.npz"), cfg, "cpu")
    assert got["blocks"][0]["mixer"]["wq"].dtype == cfg.tdtype
    _close_flat(_flat_port(got), JCK._flatten(jparams), rtol=0, atol=0)
    heads = TM.init_draft_heads(cfg, 3, torch.Generator().manual_seed(0),
                                "cpu")
    TCK.save(str(tmp_path / "heads"), heads)
    jh = JCK.load(str(tmp_path / "heads.npz"),
                  JM.init_draft_heads(jax.random.PRNGKey(0), jcfg, 3))
    _close_flat(JCK._flatten(jh), TCK._flatten(heads), rtol=0, atol=0)


def test_token_stream_matches_reference():
    a, b = TS.token_stream(50, 2, 8, seed=3), JS.token_stream(50, 2, 8, 3)
    for _ in range(2):
        np.testing.assert_array_equal(next(a), next(b))


def _reference_copies(tmp_path):
    """The committed pairs in a directory of their own (nothing else the
    reference may have cached beside them)."""
    ref = tmp_path / "ref"
    ref.mkdir()
    for name in ("zm-target.npz", "zm-draft-mis.npz"):
        shutil.copy(os.path.join(TP.CACHE_DIR, name), ref / name)
    return str(ref)


def test_missing_files_train_into_the_port_cache(tmp_path, monkeypatch):
    ref = _reference_copies(tmp_path)
    port = tmp_path / "torch"
    monkeypatch.setattr(TP, "TORCH_CACHE_DIR", str(port))
    monkeypatch.setattr(TP, "ALI_STEPS", 2)
    before = sorted(os.listdir(ref))
    dp, dcfg, tp, _ = TP.get_pair("aligned", device="cpu", cache_dir=ref)
    assert dcfg.name == "zm-draft-ali"
    assert sorted(os.listdir(port)) == ["zm-draft-ali.npz"]
    assert sorted(os.listdir(ref)) == before
    # the port's file is read back, and the reference's loader reads it
    again, _, _, _ = TP.get_pair("aligned", device="cpu", cache_dir=ref)
    _close_flat(_flat_port(again), _flat_port(dp), rtol=0, atol=0)
    JCK.load(str(port / "zm-draft-ali.npz"),
             JM.init_params(jax.random.PRNGKey(0), JP.DRAFT_ALI_CFG))
    # draft heads (2 steps) and the H-RAD MLP, trained on a miss
    monkeypatch.setattr(TP, "CACHE_DIR", ref)
    heads = TP.draft_heads_for("misaligned", K=4, steps=2, device="cpu")
    assert heads["heads"].shape == (4, 32, TP.VOCAB)
    mlp = TP.hrad_for_pair("misaligned", device="cpu")
    assert mlp["w0"].shape == (5 * 128, 256)
    names = sorted(os.listdir(port))
    assert "hrad-misaligned-K4.npz" in names
    assert any(n.startswith("heads-") for n in names)
    assert sorted(os.listdir(ref)) == before
    again = TP.hrad_for_pair("misaligned", device="cpu")
    assert all(torch.equal(again[k], mlp[k]) for k in mlp)


def test_measure_alpha_matches_reference():
    jpair = JP.get_pair("misaligned")
    tpair = TP.get_pair("misaligned", device="cpu")
    want = JP.measure_alpha(*jpair, n_prompts=1, n_new=12)
    assert TP.measure_alpha(*tpair, n_prompts=1, n_new=12) == want
    # greedy drafts: the argmax agreement the training budgets aim at
    greedy = TP.measure_alpha(*tpair, n_prompts=1, n_new=12,
                              draft_temperature=0.0)
    assert want < greedy <= 1.0


def test_train_cli_on_the_cpu(capsys):
    TLT.main(["--device", "cpu", "--arch", "qwen3-8b", "--reduced",
              "--steps", "2", "--batch", "4", "--seq", "8", "--micro",
              "2"])
    out = capsys.readouterr().out
    assert "training qwen3-8b-reduced" in out and "done." in out
    with pytest.raises(SystemExit, match="needs 256 GPUs"):
        TLT.main(["--device", "cpu", "--production-mesh"])
