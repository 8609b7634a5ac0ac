"""The port's model stack on every assigned architecture's ``reduced()``
config, against ``repro.models.model`` on the reference's weights
(carried over with ``from_numpy_params``), f32 on the CPU:

* cache-less logits and last-position features within atol 1e-4, with
  stub embeddings first for the configs with a frontend (internvl2's
  vision patches, hubert's audio frames; hubert bidirectional);
* for the configs that decode, prefill then single-token decode equals
  the full forward (``tests/test_models.py::test_cache_consistency``),
  and a gamma-token decode equals gamma single ones;
* the sliding ring of gemma2 and gemma3 after it wraps
  (``test_sliding_window_ring_cache``), and a gemma3 stack with remainder
  layers (8 = 6 + 2), whose reference weights carry no stack axis;
* a prefill with embeddings (``models.model.prefill(embeds=)``) then
  decode equals the reference's full forward over embeddings + tokens;
* MoE drops no token at the reduced capacity (batch composition
  independent, ``test_moe_no_token_drop_at_eval_capacity``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig
from repro_torch.training.checkpoint import from_numpy_params

torch.set_num_threads(1)

ATOL = 1e-4
B, T, N_EMB = 2, 12, 6
DECODERS = [a for a in ARCH_IDS if j_get_config(a).supports_decode()]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(jcfg, jparams):
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    return cfg, from_numpy_params(_np(jparams), cfg, "cpu")


def _inputs(cfg, seed=0, T_=T):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, T_)).astype(np.int32)
    emb = (rng.standard_normal((B, N_EMB, cfg.d_model)).astype(np.float32)
           if cfg.frontend else None)
    return toks, emb


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


@pytest.fixture(scope="module")
def built():
    """Each reduced config with the reference's weights, in both
    packages, and the reference's cache-less forward on one input."""
    out = {}
    for a in ARCH_IDS:
        jcfg = j_get_config(a).reduced()
        jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
        cfg, tp = _port(jcfg, jp)
        toks, emb = _inputs(cfg)
        jl, _, jaux = JM.forward(
            jp, jcfg, None if a == "hubert-xlarge" else jnp.asarray(toks),
            embeds=None if emb is None else jnp.asarray(emb))
        out[a] = (jcfg, jp, cfg, tp, toks, emb, np.asarray(jl),
                  np.asarray(jaux["features"]))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_logits_and_features_equal_reference(arch, built):
    _, _, cfg, tp, toks, emb, jl, jf = built[arch]
    tokens = None if arch == "hubert-xlarge" else torch.from_numpy(toks)
    with torch.no_grad():
        lg, aux = TM.forward(tp, cfg, tokens,
                             embeds=None if emb is None
                             else torch.from_numpy(emb),
                             feature_mode="last")
    t_tot = (0 if tokens is None else T) + (0 if emb is None else N_EMB)
    assert lg.shape == (B, t_tot, cfg.vocab_size) == jl.shape
    assert aux["features"].shape == (cfg.n_periods + cfg.n_rem, B,
                                     cfg.d_model) == jf.shape
    _close(lg, jl)
    _close(aux["features"], jf)


def test_hubert_is_bidirectional(built):
    """A hubert logit at position 0 moves when a later frame does; a
    causal model's would not."""
    _, _, cfg, tp, _, emb, _, _ = built["hubert-xlarge"]
    e = torch.from_numpy(emb)
    e2 = e.clone()
    e2[:, -1] += 1.0
    with torch.no_grad():
        a, _ = TM.forward(tp, cfg, embeds=e)
        b, _ = TM.forward(tp, cfg, embeds=e2)
    assert (a[:, 0] - b[:, 0]).abs().max() > 1e-3


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_then_decode_equals_full_forward(arch, built):
    _, _, cfg, tp, _, _, _, _ = built[arch]
    Tt, split = 20, 14
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(B, Tt)))
    with torch.no_grad():
        full, _ = TM.forward(tp, cfg, toks)
        cache = TM.init_cache(cfg, B, 64, "cpu")
        lg, _ = TM.prefill(tp, cfg, toks[:, :split], cache=cache)
        _close(lg, full[:, :split].numpy())
        outs = []
        for t in range(split, Tt):
            lg, _ = TM.decode_step(tp, cfg, toks[:, t:t + 1], cache=cache,
                                   pos=torch.full((B,), t))
            outs.append(lg[:, 0])
    _close(torch.stack(outs, 1), full[:, split:].numpy())


def test_multi_token_decode_equals_single(built):
    _, _, cfg, tp, _, _, _, _ = built["qwen3-8b"]
    Tt = 10
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(1, Tt + 4)))
    with torch.no_grad():
        c1 = TM.init_cache(cfg, 1, 64, "cpu")
        TM.prefill(tp, cfg, toks[:, :Tt], cache=c1)
        multi, _ = TM.decode_step(tp, cfg, toks[:, Tt:], cache=c1,
                                  pos=torch.full((1,), Tt))
        c2 = TM.init_cache(cfg, 1, 64, "cpu")
        TM.prefill(tp, cfg, toks[:, :Tt], cache=c2)
        singles = [TM.decode_step(tp, cfg, toks[:, Tt + i:Tt + i + 1],
                                  cache=c2, pos=torch.full((1,), Tt + i))[0]
                   for i in range(4)]
    _close(multi, torch.cat(singles, 1).numpy())


@pytest.mark.parametrize("arch", ["gemma2-27b", "gemma3-4b"])
def test_sliding_window_ring_cache(arch, built):
    """Local layers keep only window (+ slack) KV slots, the ring wraps,
    and the decoded logits equal the reference's full forward."""
    jcfg, jp, cfg, tp, _, _, _, _ = built[arch]
    w = cfg.sliding_window
    assert w > 0
    Tt = w + 24
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             size=(1, Tt)).astype(np.int32)
    jfull, _, _ = JM.forward(jp, jcfg, jnp.asarray(toks))
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        cache = TM.init_cache(cfg, 1, Tt, "cpu")
        TM.prefill(tp, cfg, tt[:, :Tt - 4], cache=cache)
        for t in range(Tt - 4, Tt):
            lg, _ = TM.decode_step(tp, cfg, tt[:, t:t + 1], cache=cache,
                                   pos=torch.full((1,), t))
    local = [c for c, (m, _) in zip(cache["blocks"], cfg.pattern)
             if m == "local"]
    assert local and all(c["k"].shape[2] == w for c in local)
    _close(lg[:, 0], np.asarray(jfull)[:, -1])


def test_remainder_layers_equal_reference():
    """gemma3's 5:1 period with 8 layers: one scanned period and two
    remainder layers, whose reference weights have no stack axis."""
    jcfg = j_get_config("gemma3-4b").reduced().replace(num_layers=8)
    assert jcfg.n_rem == 2
    jp = JM.init_params(jax.random.PRNGKey(4), jcfg)
    cfg, tp = _port(jcfg, jp)
    assert tp["rem"][0]["mixer"]["wq"].shape[0] == 1
    toks, _ = _inputs(cfg, seed=5)
    jl, _, jaux = JM.forward(jp, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        lg, aux = TM.forward(tp, cfg, torch.from_numpy(toks),
                             feature_mode="last")
    _close(lg, jl)
    _close(aux["features"], jaux["features"])


def test_prefill_with_embeds_then_decode_equals_reference(built):
    """internvl2: stub patches then prompt prefilled into the cache, the
    next tokens decoded one by one, against the reference's cache-less
    forward over the same embeddings + tokens."""
    jcfg, jp, cfg, tp, toks, emb, _, _ = built["internvl2-2b"]
    split = 8
    jl, _, _ = JM.forward(jp, jcfg, jnp.asarray(toks),
                          embeds=jnp.asarray(emb))
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        cache = TM.init_cache(cfg, B, 64, "cpu")
        lg, _ = TM.prefill(tp, cfg, tt[:, :split], cache=cache,
                           embeds=torch.from_numpy(emb))
        _close(lg, np.asarray(jl)[:, :N_EMB + split])
        outs = []
        for t in range(split, T):
            lg, _ = TM.decode_step(tp, cfg, tt[:, t:t + 1], cache=cache,
                                   pos=torch.full((B,), N_EMB + t))
            outs.append(lg[:, 0])
    _close(torch.stack(outs, 1), np.asarray(jl)[:, N_EMB + split:])


def test_moe_no_token_drop_at_eval_capacity(built):
    _, _, cfg, tp, _, _, _, _ = built["granite-moe-3b-a800m"]
    rng = np.random.default_rng(9)
    t1, t2 = (torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 16)))
              for _ in range(2))
    with torch.no_grad():
        solo, _ = TM.forward(tp, cfg, t1)
        pair, _ = TM.forward(tp, cfg, torch.cat([t1, t2]))
    _close(solo[0], pair[0].numpy())
