"""H-RAD inference in the port against the reference: the MLP and its
feature vector (``core.hrad``), the runner's captured features through
prefill / fork / select / rollback, and sequential SpecBranch with an
H-RAD MLP on the committed Zipf-Markov pair at temperature 0 and 1.

The MLP is the reference's ``init_mlp`` under a fixed key, carried to the
port as numpy (no trained H-RAD checkpoint is committed); with key 0 the
reference's signals on these prompts cover all three classes, which the
fixture asserts, so the s = 0 and s = 2 paths run.

Tolerances: MLP logits and features f32 atol 1e-5 (the same math in
another summation order); signals, streams, GenStats and timelines
equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hrad as JH
from repro.runtime import engines as JE
from repro.runtime import runner as JR
from repro.runtime.specbranch import SpecBranchEngine as JSpecBranch
from repro.training import pairs as JP
from repro_torch.core import hrad as TH
from repro_torch.launch import serve as TSV
from repro_torch.runtime import engines as TE
from repro_torch.runtime import prng
from repro_torch.runtime import runner as TR
from repro_torch.runtime.specbranch import SpecBranchEngine as TSpecBranch
from repro_torch.training import pairs as TP
from repro_torch.training.checkpoint import from_numpy_hrad

# One intra-op thread: the tiny models gain nothing from more, and the
# test workers share the machine's cores (eight threads in each of six
# workers slow every small op here many times over).
torch.set_num_threads(1)

ATOL = 1e-5
N_NEW = 16
PROMPT = TSV.make_prompts(1)[0]
HRAD_KEY = 0


def _mlps(d_in):
    jp = JH.init_mlp(jax.random.PRNGKey(HRAD_KEY), d_in)
    return jp, from_numpy_hrad({k: np.asarray(v) for k, v in jp.items()},
                               "cpu")


@pytest.mark.parametrize("k_layers", [2, 4, 6])
def test_feature_mlp_and_signal_match_reference(k_layers):
    """build_feature (6 > n_points pads with the deepest point),
    apply_mlp and predict on seeded inputs."""
    rng = np.random.default_rng(k_layers)
    n_points, B, D = 4, 5, 24
    feats = rng.normal(size=(n_points, B, D)).astype(np.float32)
    emb = rng.normal(size=(B, D)).astype(np.float32)
    jz = JH.build_feature(jnp.asarray(feats), jnp.asarray(emb), k_layers)
    tz = TH.build_feature(torch.from_numpy(feats), torch.from_numpy(emb),
                          k_layers)
    assert tz.dtype == torch.float32
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    jp, tp = _mlps((k_layers + 1) * D)
    jl = JH.apply_mlp(jp, jz)
    tl = TH.apply_mlp(tp, tz)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(TH.predict(tp, tz).numpy(),
                                  np.asarray(JH.predict(jp, jz)))
    assert TH.predict(tp, tz).dtype == torch.int32


def test_init_embedding_labels_and_config():
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a = TH.init_mlp(40, generator=g(), device="cpu")
    b = TH.init_mlp(40, generator=g(), device="cpu")
    shapes = {k: tuple(v.shape) for k, v in a.items()}
    jshapes = {k: v.shape for k, v in
               JH.init_mlp(jax.random.PRNGKey(0), 40).items()}
    assert shapes == jshapes
    assert all(torch.equal(a[k], b[k]) and a[k].dtype == torch.float32
               for k in a)
    assert all((a[f"b{i}"] == 0).all() for i in range(3))
    w0 = a["w0"].std().item()
    assert abs(w0 - np.sqrt(2.0 / 40)) < 0.05
    params = {"embed": torch.arange(12.0).reshape(4, 3).bfloat16()}
    e = TH.token_embedding(params, torch.tensor([2, 0]))
    assert e.dtype == torch.float32 and e.tolist() == [[6, 7, 8], [0, 1, 2]]
    for n in range(-1, 6):
        assert TH.label_from_outcome(n, 4) == JH.label_from_outcome(n, 4)
    assert TH.HRADConfig(k_layers=4, d_model=8).d_in == \
        JH.HRADConfig(k_layers=4, d_model=8).d_in == 40


@pytest.fixture(scope="module")
def pairs():
    return JP.get_pair("misaligned"), TP.get_pair("misaligned",
                                                  device="cpu")


K_RUNNER = 3
SCRIPT = [
    ("prefill", (PROMPT,)),
    ("forward", [12, 40]),
    ("fork", (3,)),
    ("batched", [[4], [9], [33]]),
    ("select", (1,)),
    ("sync_lineage", ([9],)),
    ("forward", [77]),
    ("reset_to", (len(PROMPT) + 2,)),
    ("forward", [18, 19]),
    ("fork", (2,)),
    ("batched", [[6, 7], [8, 9]]),
    ("unfork", ()),
    ("forward", [31]),
]


def test_runner_features_follow_reference(pairs):
    """The port keeps the last K points at the last position, (K, B, D);
    the reference keeps every point at every position.  After every step
    the port's equal the reference's last K there, or both are None."""
    (_, _, jtp, jtcfg), (_, _, ttp, ttcfg) = pairs
    jr = JR.ModelRunner(jtp, jtcfg, max_len=64)
    tr = TR.ModelRunner(ttp, ttcfg, max_len=64, feature_points=K_RUNNER)
    plain = TR.ModelRunner(ttp, ttcfg, max_len=64)
    for op, arg in SCRIPT:
        for r in (jr, tr, plain):
            if op == "forward":
                r.forward(arg)
            elif op == "batched":
                r.forward_batched(np.asarray(arg))
            else:
                getattr(r, op)(*arg)
        assert plain.last_features is None
        if jr.last_features is None:
            assert tr.last_features is None, op
            continue
        want = np.asarray(jr.last_features)[-K_RUNNER:, :, -1, :]
        assert tuple(tr.last_features.shape) == want.shape, op
        np.testing.assert_allclose(tr.last_features.numpy(), want, rtol=0,
                                   atol=ATOL)


@pytest.fixture(scope="module")
def runs(pairs):
    """Sequential SpecBranch with the same H-RAD MLP in both packages,
    one serve per temperature (the reference compiles its runners per
    request, so each case is one request)."""
    jpair, tpair = pairs
    jp, tp = _mlps((TE.EngineConfig().hrad_k_layers + 1)
                   * jpair[3].d_model)
    out = {}
    for temp in (0.0, 1.0):
        kw = dict(gamma=4, c=10.0, temperature=temp, max_len=128)
        j = JSpecBranch(*jpair, JE.EngineConfig(**kw),
                        hrad_params=jp).generate(
            PROMPT, N_NEW, jax.random.PRNGKey(0))
        t = TSpecBranch(*tpair, TE.EngineConfig(**kw),
                        hrad_params=tp).generate(
            PROMPT, N_NEW, prng.PRNGKey(0))
        out[temp] = (j, t)
    return out


@pytest.mark.parametrize("temp", [0.0, 1.0])
def test_sequential_hrad_specbranch_equals_reference(runs, temp):
    j, t = runs[temp]
    assert set(j.stats.hrad_signals) == {0, 1, 2}     # every s_t path ran
    if temp:
        assert j.stats.pruned_tokens > 0      # an adopted branch was cut
    assert t.tokens == j.tokens
    assert vars(t.stats) == vars(j.stats)
    assert t.timeline == j.timeline


def test_sequential_hrad_greedy_is_lossless(pairs, runs):
    _, (_, _, tp, tcfg) = pairs
    assert runs[0.0][1].tokens == TR.greedy_reference(tp, tcfg, PROMPT,
                                                      N_NEW, max_len=128)


def test_hrad_off_or_absent_gives_the_confidence_signal(pairs):
    """use_hrad False ignores the MLP (and captures nothing), exactly as
    serving without one does."""
    _, tpair = pairs
    _, tp = _mlps(5 * tpair[3].d_model)
    kw = dict(gamma=4, c=10.0, max_len=128)
    off = TSpecBranch(*tpair, TE.EngineConfig(use_hrad=False, **kw),
                      hrad_params=tp)
    assert off._new_runners()[1].feature_points == 0
    a = off.generate(PROMPT, 8, prng.PRNGKey(0))
    b = TSpecBranch(*tpair, TE.EngineConfig(**kw)).generate(
        PROMPT, 8, prng.PRNGKey(0))
    assert a.tokens == b.tokens and vars(a.stats) == vars(b.stats)
    assert a.stats.hrad_signals == []
