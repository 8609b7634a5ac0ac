"""H-RAD offline training in the port (``core.hrad``: ``_smote``,
``clip_by_global_norm``, the dropout forward, ``train_mlp``;
``runtime.hrad_data.collect``) against the reference's, on the CPU:

* SMOTE's oversampling equals the reference's bit for bit (numpy both);
* the clipped gradient and the dropout forward under one threefry key
  equal the reference's within 1e-6 (the masks bit for bit);
* one ``mlp_step`` under one dropout key: its Adam moments (0.1 g and
  0.001 g^2 of the clipped gradient) equal those of the reference's loss
  differentiated by ``jax.grad`` within 1e-6;
* ``train_mlp`` from the reference's initial MLP (carried over), two
  whole epochs: the reference's parameters within 1e-6 and its metrics
  exactly (same splits, SMOTE rows, batch order and dropout keys);
* ``collect`` over the committed pair gives the reference's labels and
  its features within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import hrad as JH
from repro.runtime import hrad_data as JD
from repro.runtime.engines import EngineConfig as JEngineConfig
from repro.training import pairs as JP
from repro_torch.core import hrad as TH
from repro_torch.runtime import hrad_data as TD
from repro_torch.runtime import prng
from repro_torch.runtime.engines import EngineConfig
from repro_torch.training.checkpoint import from_numpy_hrad
from torch_parity import port_pair

torch.set_num_threads(1)

TOL = 1e-6


def _data(n, d_in, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, d_in)).astype(np.float32)
    y = rng.choice(3, size=n, p=[0.6, 0.3, 0.1]).astype(np.int32)
    return z, y


def test_smote_matches_reference():
    z, y = _data(50, 12)
    jx, jy = JH._smote(z, y, seed=3)
    tx, ty = TH._smote(z, y, seed=3)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    assert np.bincount(ty).min() == np.bincount(ty).max()


def test_clip_and_dropout_forward_match_reference():
    d_in = 24
    jp = JH.init_mlp(jax.random.PRNGKey(1), d_in)
    tp = from_numpy_hrad(jax.tree.map(np.asarray, jp), "cpu")
    for scale in (1e-3, 50.0):
        g = {k: np.asarray(v) * scale for k, v in jp.items()}
        jg = JH.clip_by_global_norm(jax.tree.map(jnp.asarray, g))
        tg = TH.clip_by_global_norm({k: torch.from_numpy(v)
                                     for k, v in g.items()})
        for k in g:
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                       rtol=TOL, atol=TOL)
    z, _ = _data(7, d_in)
    key = jax.random.PRNGKey(9)
    jl = JH.apply_mlp(jp, jnp.asarray(z), train=True, key=key)
    tl = TH.apply_mlp_train(tp, torch.from_numpy(z), prng.PRNGKey(9))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=TOL, atol=TOL)


def test_mlp_step_matches_reference():
    d_in = 24
    jp = JH.init_mlp(jax.random.PRNGKey(2), d_in)
    tp = from_numpy_hrad(jax.tree.map(np.asarray, jp), "cpu")
    z, y = _data(16, d_in, seed=5)
    key = jax.random.PRNGKey(7)

    def jloss(p):       # the reference's train_mlp loss_fn
        logp = jax.nn.log_softmax(JH.apply_mlp(p, jnp.asarray(z),
                                               train=True, key=key))
        onehot = jax.nn.one_hot(jnp.asarray(y), JH.N_CLASSES)
        smoothed = onehot * 0.9 + 0.1 / JH.N_CLASSES
        return -jnp.mean(jnp.sum(smoothed * logp, axis=-1))
    jg = JH.clip_by_global_norm(jax.grad(jloss)(jp))
    zeros = {k: torch.zeros_like(v) for k, v in tp.items()}
    _, tm, tv = TH.mlp_step(tp, zeros, zeros, torch.from_numpy(z),
                            torch.from_numpy(y), prng.PRNGKey(7), 1, 1e-3,
                            TH.HRADConfig(label_smoothing=0.1))
    for k in jp:
        g = np.asarray(jg[k])
        np.testing.assert_allclose(tm[k].numpy(), 0.1 * g, rtol=TOL,
                                   atol=TOL, err_msg=k)
        np.testing.assert_allclose(tv[k].numpy(), 0.001 * g * g, rtol=TOL,
                                   atol=TOL, err_msg=k)


def test_train_mlp_matches_reference():
    k_layers, d_model, n, epochs = 2, 8, 90, 2
    cfg = dict(k_layers=k_layers, d_model=d_model, epochs=epochs, seed=4,
               lr=1e-3)
    z, y = _data(n, (k_layers + 1) * d_model, seed=n)
    jparams, jmetrics = JH.train_mlp(z, y, JH.HRADConfig(**cfg))
    init = from_numpy_hrad(jax.tree.map(np.asarray, JH.init_mlp(
        jax.random.PRNGKey(cfg["seed"]), z.shape[1])), "cpu")
    tparams, tmetrics = TH.train_mlp(z, y, TH.HRADConfig(**cfg),
                                     device="cpu", init=init)
    for k in jparams:
        np.testing.assert_allclose(tparams[k].numpy(),
                                   np.asarray(jparams[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    assert tmetrics.keys() == jmetrics.keys()
    for k in jmetrics:
        np.testing.assert_equal(tmetrics[k], jmetrics[k])


def test_collect_matches_reference():
    jpair = JP.get_pair("misaligned")
    tpair = port_pair(jpair)
    prompts = [[5, 9, 17, 3, 22, 8, 1, 40], [7, 7, 19, 2, 11, 60]]
    kw = dict(gamma=4, temperature=0.0, draft_temperature=0.0,
              hrad_k_layers=4, max_len=256)
    jz, jy = JD.collect(*jpair, prompts, 16, JEngineConfig(**kw), seed=1)
    tz, ty = TD.collect(*tpair, prompts, 16, EngineConfig(**kw), seed=1)
    np.testing.assert_array_equal(ty, jy)
    assert tz.shape == jz.shape == (len(jy), 5 * 128)
    np.testing.assert_allclose(tz, jz, rtol=1e-5, atol=1e-5)
