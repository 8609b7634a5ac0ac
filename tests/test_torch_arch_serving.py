"""Sequential speculative serving across architecture families
(``tests/test_arch_serving.py`` in the port): one ``reduced()`` target
per family with the reference test's same-family draft, on the
reference's weights.  The port's SpS and SpecBranch must be greedy-
lossless (equal the port's own greedy decode), and that greedy stream
must be the reference's: each token is the argmax of one teacher-forced
reference forward over prompt + stream (cheaper than a reference engine
per family, and the same proof at temperature 0).  Exercises SSM state
rollback, hybrid mixed caches, MoE routing in verification and VLM
embedding prefixes: ``forward_embeds`` then ``forward`` against the
reference's logits, and every sequential engine with ``embeds=`` (the
reference's one tensor for a same-width draft, the port's (target,
draft) pair for the family draft)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import prng
from repro_torch.runtime.engines import (AutoregressiveEngine, EngineConfig,
                                         LookaheadEngine, PEARLEngine,
                                         SpSEngine)
from repro_torch.runtime.runner import ModelRunner, greedy_reference
from repro_torch.runtime.specbranch import SpecBranchEngine
from repro_torch.training.checkpoint import from_numpy_params

torch.set_num_threads(1)

FAMILY_ARCHS = [
    "falcon-mamba-7b",        # ssm
    "jamba-1.5-large-398b",   # hybrid (mamba + attn + moe)
    "qwen3-8b",               # dense
    "granite-moe-3b-a800m",   # moe
    "internvl2-2b",           # vlm
]
N_NEW = 12
N_EMB = 8


def _ecfg():
    return EngineConfig(gamma=3, c=4.0, temperature=0.0, epsilon=0.4,
                        signal_temperature=0.5, max_len=256)


def _family_draft(tcfg):
    """The reference test's same-family draft of a reduced target."""
    return tcfg.replace(name=tcfg.name + "-draft",
                        num_layers=tcfg.period, d_model=128,
                        num_heads=2, num_kv_heads=1, head_dim=64,
                        d_ff=min(tcfg.d_ff, 256) if tcfg.d_ff else 0,
                        moe_d_ff=128 if tcfg.num_experts else 0,
                        num_experts=min(tcfg.num_experts, 2) or 0,
                        num_experts_per_tok=min(tcfg.num_experts_per_tok,
                                                2) or 0)


def _port(jcfg, jparams):
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    return cfg, from_numpy_params(jax.tree.map(np.asarray, jparams), cfg,
                                  "cpu")


def _build(arch):
    jt = j_get_config(arch).reduced()
    jd = _family_draft(jt)
    jtp = JM.init_params(jax.random.PRNGKey(0), jt)
    jdp = JM.init_params(jax.random.PRNGKey(1), jd)
    tcfg, tp = _port(jt, jtp)
    dcfg, dp = _port(jd, jdp)
    prompt = [int(t) for t in np.random.default_rng(3).integers(
        0, tcfg.vocab_size, size=6)]
    return dict(jt=jt, jtp=jtp, jd=jd, jdp=jdp, tcfg=tcfg, tp=tp,
                dcfg=dcfg, dp=dp, prompt=prompt)


def _teacher_forced_argmax(jp, jcfg, prompt, stream, embeds=None):
    """The reference's greedy choice at every served position: argmax of
    one cache-less reference forward over (embeds +) prompt + stream."""
    toks = jnp.asarray([list(prompt) + list(stream)], jnp.int32)
    lg, _, _ = JM.forward(jp, jcfg, toks,
                          embeds=None if embeds is None
                          else jnp.asarray(embeds))
    off = 0 if embeds is None else embeds.shape[1]
    lg = np.asarray(lg)[0, off + len(prompt) - 1:-1]
    return [int(i) for i in lg.argmax(-1)]


@pytest.fixture(scope="module", params=FAMILY_ARCHS)
def family(request):
    arch = request.param
    f = _build(arch)
    f["greedy"] = greedy_reference(f["tp"], f["tcfg"], f["prompt"], N_NEW,
                                   max_len=256)
    f["runs"] = {}
    for cls in (SpSEngine, SpecBranchEngine):
        eng = cls(f["dp"], f["dcfg"], f["tp"], f["tcfg"], _ecfg())
        f["runs"][cls.name] = eng.generate(f["prompt"], N_NEW,
                                           prng.PRNGKey(7))
    return arch, f


def test_family_specbranch_lossless(family):
    arch, f = family
    for name, r in f["runs"].items():
        assert r.tokens == f["greedy"], (arch, name)


def test_family_greedy_equals_reference(family):
    arch, f = family
    want = _teacher_forced_argmax(f["jtp"], f["jt"], f["prompt"],
                                  f["greedy"])
    assert f["greedy"] == want, arch


@pytest.fixture(scope="module")
def vlm():
    return _build("internvl2-2b")


def test_vlm_embeds_prefix(vlm):
    """Stub patch embeddings prefix the prompt: the runner's position,
    placeholder ids, call counters and logits (the reference's within
    1e-4)."""
    tcfg, tp = vlm["tcfg"], vlm["tp"]
    embeds = np.random.default_rng(5).standard_normal(
        (1, N_EMB, tcfg.d_model)).astype(np.float32)
    r = ModelRunner(tp, tcfg, max_len=256)
    lg0 = r.forward_embeds(torch.from_numpy(embeds))
    assert lg0.shape == (1, N_EMB, tcfg.vocab_size)
    r.forward([1, 2, 3])
    assert r.pos == 11
    assert r.tokens == [-1] * N_EMB + [1, 2, 3]
    assert (r.n_calls, r.n_call_tokens) == (2, 11)
    jl, _, _ = JM.forward(vlm["jtp"], vlm["jt"],
                          jnp.asarray([[1, 2, 3]], jnp.int32),
                          embeds=jnp.asarray(embeds))
    np.testing.assert_allclose(r.last_logits.numpy(), np.asarray(jl)[:, -1],
                               rtol=0, atol=1e-4)


def _greedy_with_embeds(tp, cfg, prompt, embeds, n_new):
    """Greedy decoding by cache-less forwards over embeds + stream."""
    seq = list(prompt)
    with torch.no_grad():
        for _ in range(n_new):
            lg, _ = TM.forward(tp, cfg, torch.tensor([seq]), embeds=embeds,
                               logits_mode="last")
            seq.append(int(lg[0, -1].argmax()))
    return seq[len(prompt):]


def test_vlm_engines_with_embeds(vlm):
    """Every sequential engine with ``embeds=``: the family draft (d 128)
    takes its own embeddings through the (target, draft) pair; a draft of
    the target's own width takes the one tensor, as in the reference.
    Greedy streams equal greedy decoding over embeds + prompt, which is
    the reference's (teacher-forced argmax of its forward)."""
    tcfg, tp, dcfg, dp = vlm["tcfg"], vlm["tp"], vlm["dcfg"], vlm["dp"]
    prompt = vlm["prompt"]
    rng = np.random.default_rng(6)
    t_emb = torch.from_numpy(rng.standard_normal(
        (1, N_EMB, tcfg.d_model)).astype(np.float32))
    d_emb = torch.from_numpy(rng.standard_normal(
        (1, N_EMB, dcfg.d_model)).astype(np.float32))
    want = _greedy_with_embeds(tp, tcfg, prompt, t_emb, N_NEW)
    assert want == _teacher_forced_argmax(vlm["jtp"], vlm["jt"], prompt,
                                          want, embeds=t_emb.numpy())
    ecfg = _ecfg()
    engines = [AutoregressiveEngine(tp, tcfg, ecfg),
               LookaheadEngine(tp, tcfg, ecfg)]
    for cls in (SpSEngine, SpecBranchEngine, PEARLEngine):
        engines.append(cls(dp, dcfg, tp, tcfg, ecfg))
    for eng in engines:
        emb = t_emb if eng.dcfg is None else (t_emb, d_emb)
        r = eng.generate(prompt, N_NEW, prng.PRNGKey(7), embeds=emb)
        assert r.tokens == want, eng.name
    # the reference's form: one tensor for both runners (a self-draft)
    for cls in (SpSEngine, SpecBranchEngine):
        r = cls(tp, tcfg, tp, tcfg, ecfg).generate(
            prompt, N_NEW, prng.PRNGKey(7), embeds=t_emb)
        assert r.tokens == want, cls.name
    with pytest.raises(ValueError, match="differ in length"):
        SpSEngine(dp, dcfg, tp, tcfg, ecfg).generate(
            prompt, 2, prng.PRNGKey(7), embeds=(t_emb, d_emb[:, :3]))
