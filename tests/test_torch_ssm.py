"""The port's Mamba / MoE stack against the reference on the CPU: the
plain selective scan against the Pallas kernel in interpret mode, the
Mamba layer in carry, ring and cache-less form, the MoE FFN and whole
hybrid forwards on carried weights (f32, rtol = atol = 2e-5, the
reference's own Pallas-vs-oracle tolerance), the checkpoint ring's
positional rollback and lap (within tolerance: the reference's bitwise
versions fail, ROADMAP queue C), the runner's checkpoint + replay
rollback through fork / select / unfork, sequential SpecBranch on both
SSM-bearing pairs (streams, GenStats and replay calls equal), the
per-leaf parameter dtypes at bf16, and the configs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import falcon_mamba_7b as JF
from repro.configs import jamba_1_5_large_398b as JJ
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.config import ModelConfig as JModelConfig
from repro.runtime import engines as JE
from repro.runtime import runner as JR
from repro.runtime.specbranch import SpecBranchEngine as JSpecBranch
from repro.training import pairs as JP
from repro_torch.configs import falcon_mamba_7b as TF
from repro_torch.launch import serve as TSV
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_scan as tss
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.config import (ModelConfig, NoDecodeError,
                                       check_decodes, check_supported)
from repro_torch.runtime import engines as TE
from repro_torch.runtime import prng
from repro_torch.runtime import runner as TR
from repro_torch.runtime.specbranch import SpecBranchEngine as TSpecBranch
from repro_torch.training import checkpoint as TC
from repro_torch.training import pairs as TP

# One intra-op thread: the tiny models gain nothing from more, and the
# test workers share the machine's cores (eight threads in each of six
# workers slow every small op here many times over).
torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
VOCAB = 61
# the reference layers jitted per call shape (eager JAX dispatches and
# compiles every primitive of the scan and the sort on its own)
J_MAMBA = jax.jit(JL.mamba, static_argnames=("cfg",))
J_MOE = jax.jit(JL.moe_ffn, static_argnames=("cfg",))


def _tcfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _scan_inputs(B, T, E, N, seed=17):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = f(B, T, E)
    dt = np.log1p(np.exp(f(B, T, E))).astype(np.float32)      # softplus
    return (x, dt, f(B, T, N), f(B, T, N),
            -np.exp(f(E, N) * 0.2).astype(np.float32),
            np.ones(E, np.float32), f(B, E, N))


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("states", [True, False])
@pytest.mark.parametrize("B,T,E,N,bT", [
    (1, 7, 16, 4, 16), (2, 40, 24, 8, 16), (1, 130, 32, 8, 64)])
def test_plain_scan_matches_pallas_kernel(B, T, E, N, bT, states):
    args = _scan_inputs(B, T, E, N)
    want = jops.ssm_scan(*map(jnp.asarray, args), bT=bT, bE=16,
                         return_states=states)
    got = ops.ssm_scan(*map(torch.from_numpy, args), return_states=states)
    assert len(got) == len(want) == (3 if states else 2)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)
    if states:
        assert torch.equal(got[2][:, -1], got[1])


def test_scan_wrapper_refuses_cpu_tensors_and_unknown_sizes():
    args = [torch.from_numpy(a) for a in _scan_inputs(1, 3, 8, 4)]
    with pytest.raises(ValueError, match="is on cpu"):
        tss.ssm_scan(*args)
    bad = [torch.from_numpy(a) for a in _scan_inputs(1, 3, 8, 5)]
    with pytest.raises(ValueError, match="N=5"):
        tss.ssm_scan(*bad)
    x16 = args[0].to(torch.float16)
    with pytest.raises(ValueError, match="float16"):
        tss.ssm_scan(x16, *args[1:])


def _jax_ring_scan(args, ring, p0, rows, bT):
    """The reference's checkpoint-ring step around its Pallas scan: the
    gather of ``repro.models.layers.mamba`` (each lane's state from slot
    p0 % Rg of its row, zeros at position 0), the scan with every
    post-step state, and the scatter of the trailing min(T, Rg) states
    to slots (p0 + t + 1) % Rg; lanes map to ``rows`` and a pad lane
    (row < 0) starts from zeros and writes nothing.  Returns (y, ring)."""
    x, dt, Bm, Cm, A, D = (jnp.asarray(a) for a in args)
    B, T, _E = x.shape
    Rg = ring.shape[1]
    live = rows >= 0
    fresh = (p0 == 0) | ~live
    h0 = jnp.where(jnp.asarray(fresh)[:, None, None], 0.0,
                   jnp.asarray(ring)[np.maximum(rows, 0), p0 % Rg])
    y, _hT, hs = jops.ssm_scan(x, dt, Bm, Cm, A, D, h0, bT=bT, bE=16,
                               return_states=True)
    Tr = min(T, Rg)
    t_idx = np.arange(T - Tr, T)
    slots = (p0[:, None] + t_idx[None] + 1) % Rg                # (B, Tr)
    new = jnp.asarray(ring).at[rows[live][:, None], slots[live]].set(
        hs[live][:, T - Tr:])
    written = np.zeros(ring.shape[:2], bool)
    written[rows[live][:, None], slots[live]] = True
    return y, new, written


# (B, T, E, N, Rg, rows of the ring, lane rows or None, start positions):
# a fresh lane, a wrap past slot Rg - 1 and a pad lane that is not at
# position 0; a lap (T > Rg); lanes mapped to rows one to one
RING_CASES = {
    "fresh-wrap-pad": (4, 3, 16, 8, 5, 5, [3, 0, -1, 1], [0, 4, 7, 2]),
    "lap": (2, 7, 16, 4, 5, 3, [1, 0], [3, 0]),
    "identity": (3, 2, 24, 16, 4, 3, None, [0, 3, 6]),
}


@pytest.mark.parametrize("case", RING_CASES, ids=list(RING_CASES))
def test_plain_ring_scan_matches_reference(case):
    """The ring scan's plain version (the CPU route of
    ``ops.ssm_scan_ring``) against the reference's gather, Pallas scan
    (interpret mode) and scatter: y and the written slots within 2e-5,
    every other slot of the ring bit for bit untouched."""
    B, T, E, N, Rg, n_rows, rows, p0 = RING_CASES[case]
    args = _scan_inputs(B, T, E, N, seed=23)[:6]
    ring = np.random.default_rng(24).standard_normal(
        (n_rows, Rg, E, N)).astype(np.float32)
    p0 = np.asarray(p0, np.int32)
    rmap = (np.arange(B, dtype=np.int32) if rows is None
            else np.asarray(rows, np.int32))
    want_y, want_ring, written = _jax_ring_scan(args, ring, p0, rmap, bT=4)
    got_ring = torch.from_numpy(ring.copy())
    y = ops.ssm_scan_ring(*map(torch.from_numpy, args), got_ring,
                          torch.from_numpy(p0),
                          None if rows is None else torch.from_numpy(rmap))
    assert y.dtype == torch.float32 and y.shape == (B, T, E)
    _close(y, want_y)
    _close(got_ring[torch.from_numpy(written)],
           np.asarray(want_ring)[written])
    assert torch.equal(got_ring[torch.from_numpy(~written)],
                       torch.from_numpy(ring[~written]))
    assert written.sum() == (rmap >= 0).sum() * min(T, Rg)


def test_ring_scan_wrapper_refuses_cpu_dtypes_layouts_and_sizes():
    args = [torch.from_numpy(a) for a in _scan_inputs(2, 3, 8, 4)[:6]]
    ring = torch.zeros((3, 5, 8, 4))
    p0 = torch.tensor([0, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="is on cpu"):
        tss.ssm_scan_ring(*args, ring, p0)
    with pytest.raises(ValueError, match="h_ring must be float32"):
        tss.ssm_scan_ring(*args, ring.double(), p0)
    with pytest.raises(ValueError, match="p0 must be int32"):
        tss.ssm_scan_ring(*args, ring, p0.long())
    with pytest.raises(ValueError, match="rows must be int32"):
        tss.ssm_scan_ring(*args, ring, p0, torch.tensor([0, 1]))
    with pytest.raises(ValueError, match="h_ring is not contiguous"):
        tss.ssm_scan_ring(*args, torch.zeros((3, 5, 4, 8)).transpose(2, 3),
                          p0)
    bad = [torch.from_numpy(a) for a in _scan_inputs(2, 3, 8, 5)[:6]]
    with pytest.raises(ValueError, match="N=5"):
        tss.ssm_scan_ring(*bad, torch.zeros((3, 5, 8, 5)), p0)


# ---------------------------------------------------------------------------
# the Mamba layer, the MoE FFN and whole forwards
# ---------------------------------------------------------------------------

def _hybrid_cfg(pattern, d=32, N=8, Cv=4, **kw):
    return JModelConfig(name="ckpt", family="hybrid",
                        num_layers=len(pattern), d_model=d, num_heads=2,
                        num_kv_heads=1, d_ff=2 * d, vocab_size=VOCAB,
                        pattern=pattern, ssm_state=N, ssm_conv=Cv,
                        dtype="float32", **kw)


@pytest.fixture(scope="module")
def mamba_layer():
    jcfg = _hybrid_cfg((("mamba", "none"),))
    jp = JL.init_mamba(jax.random.PRNGKey(4), jcfg)
    return jcfg, jp, TC.from_numpy_params(
        {"embed": np.zeros((VOCAB, jcfg.d_model), np.float32), "p": _np(jp)},
        _tcfg(jcfg), "cpu")["p"]


def test_mamba_layer_matches_reference_carry_and_cacheless(mamba_layer):
    jcfg, jp, tp = mamba_layer
    tcfg = _tcfg(jcfg)
    x = np.random.default_rng(5).standard_normal(
        (2, 9, jcfg.d_model)).astype(np.float32)
    jo, _ = J_MAMBA(jp, jnp.asarray(x), jcfg)
    _close(TL.mamba(tp, torch.from_numpy(x), tcfg), jo)
    # carry mode: two calls threading the carried state
    jc = JL.init_mamba_cache(jcfg, 2)
    tc = TM._index(TL.init_mamba_cache(tcfg, 2, "cpu"), 0)
    for lo, hi in ((0, 5), (5, 9)):
        jo, jc = J_MAMBA(jp, jnp.asarray(x[:, lo:hi]), jcfg, cache=jc)
        to = TL.mamba(tp, torch.from_numpy(x[:, lo:hi]), tcfg, cache=tc)
        _close(to, jo)
        _close(tc["ssm"], jc["ssm"])
        _close(tc["conv"], jc["conv"])


def test_mamba_layer_matches_reference_ring(mamba_layer):
    """Ring mode with rows at different start positions, a rollback of
    row 1, and lane-to-row mapping with a pad lane."""
    jcfg, jp, tp = mamba_layer
    tcfg = _tcfg(jcfg)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    jc = JL.init_mamba_cache(jcfg, 2, ring=8)
    tc = TM._index(TL.init_mamba_cache(tcfg, 2, "cpu", ring=8), 0)
    calls = [((0, 0), 6), ((6, 3), 3), ((9, 6), 3)]   # row 1 rolls back
    for (p0, p1), T in calls:
        pos = np.stack([np.arange(p0, p0 + T), np.arange(p1, p1 + T)]
                       ).astype(np.int32)
        xs = np.stack([x[0, p0:p0 + T], x[1, p1:p1 + T]])
        jo, jc = J_MAMBA(jp, jnp.asarray(xs), jcfg, cache=jc,
                         positions=jnp.asarray(pos))
        to = TL.mamba(tp, torch.from_numpy(xs), tcfg, cache=tc,
                      positions=torch.from_numpy(pos))
        _close(to, jo)
        _close(tc["h_ring"], jc["h_ring"])
        _close(tc["conv_ring"], jc["conv_ring"])
    # a prefill lane mapped to row 1, next to a pad lane (row -1)
    before = tc["h_ring"][0].clone()
    pos = np.tile(np.arange(4, dtype=np.int32), (2, 1))
    TL.mamba(tp, torch.from_numpy(x[:, :4]), tcfg, cache=tc,
             positions=torch.from_numpy(pos),
             ring_rows=torch.tensor([1, -1]))
    assert torch.equal(tc["h_ring"][0], before)
    jc1 = JL.init_mamba_cache(jcfg, 1, ring=8)
    _, jc1 = J_MAMBA(jp, jnp.asarray(x[:1, :4]), jcfg, cache=jc1,
                     positions=jnp.asarray(pos[:1]))
    for s in range(1, 5):
        _close(tc["h_ring"][1, s], jc1["h_ring"][0, s])


def test_moe_ffn_matches_reference(hybrid_pairs):
    jcfg = hybrid_pairs["jamba-shaped"][0][3]
    jp = JL.init_moe(jax.random.PRNGKey(8), jcfg)
    tp = TC.from_numpy_params(
        {"embed": np.zeros((jcfg.vocab_size, jcfg.d_model), np.float32),
         "p": _np(jp)}, _tcfg(jcfg), "cpu")["p"]
    x = np.random.default_rng(9).standard_normal(
        (3, 5, jcfg.d_model)).astype(np.float32)
    jy, jaux = J_MOE(jp, jnp.asarray(x), jcfg)
    ty, taux = TL.moe_ffn(tp, torch.from_numpy(x), _tcfg(jcfg))
    _close(ty, jy)
    _close(taux, jaux)            # the load-balance loss, too
    # a capacity that drops tokens takes the same ones as the reference
    small = jcfg.replace(capacity_factor=0.5)
    assert JL.moe_capacity(small, 15) == TL.moe_capacity(_tcfg(small), 15)
    jy, jaux = J_MOE(jp, jnp.asarray(x), small)
    ty, taux = TL.moe_ffn(tp, torch.from_numpy(x), _tcfg(small))
    _close(ty, jy)
    _close(taux, jaux)


@pytest.fixture(scope="module")
def hybrid_pairs():
    out = {}
    for kind in TP.HYBRID_KINDS:
        dp, dcfg, tp, tcfg = JP.hybrid_pair(kind)
        out[kind] = ((dp, dcfg, tp, tcfg),
                     (TC.from_numpy_params(_np(dp), _tcfg(dcfg), "cpu"),
                      _tcfg(dcfg),
                      TC.from_numpy_params(_np(tp), _tcfg(tcfg), "cpu"),
                      _tcfg(tcfg)))
    return out


@pytest.mark.parametrize("kind", ["falcon-shaped", "jamba-shaped"])
def test_hybrid_forward_matches_reference(hybrid_pairs, kind):
    (jdp, jdcfg, jtp, jtcfg), (tdp, tdcfg, ttp, ttcfg) = hybrid_pairs[kind]
    assert (tdcfg, ttcfg) == TP.hybrid_configs(kind)
    toks = np.random.default_rng(10).integers(0, JP.VOCAB, (2, 11))
    for jp, jc, tp, tc in ((jtp, jtcfg, ttp, ttcfg),
                           (jdp, jdcfg, tdp, tdcfg)):
        jl, _, _ = JM.forward(jp, jc, jnp.asarray(toks, jnp.int32))
        tl, _ = TM.forward(tp, tc, torch.from_numpy(toks))
        _close(tl, jl)


def _fwd(params, cfg, cache, toks, p0):
    arr = torch.tensor([toks])
    pos = (p0 + torch.arange(arr.shape[1], dtype=torch.int32))[None]
    logits, _ = TM.forward(params, cfg, arr, cache=cache, positions=pos)
    return logits[0]


@pytest.fixture(scope="module")
def ring_model():
    jcfg = _hybrid_cfg((("mamba", "dense"), ("attn", "dense")))
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, _tcfg(jcfg), TC.from_numpy_params(_np(jp), _tcfg(jcfg),
                                                       "cpu")


def test_ring_rollback_is_positional(ring_model):
    """Speculate junk past the accept point, then restart the forward at
    the accept position: the ring resumes from that position's
    checkpoint (no replay), equal to one-shot forwards of the port and
    of the reference within tolerance."""
    jcfg, jp, cfg, params = ring_model
    rng = np.random.default_rng(1)
    seq = list(map(int, rng.integers(0, VOCAB, 14)))
    lg_ref = _fwd(params, cfg, TM.init_cache(cfg, 1, 64, "cpu"), seq, 0)
    c = TM.init_cache(cfg, 1, 64, "cpu", ssm_ring=16)
    _fwd(params, cfg, c, seq[:6], 0)
    junk = list(map(int, rng.integers(0, VOCAB, 5)))
    _fwd(params, cfg, c, seq[6:9] + junk, 6)          # 3 accepted + 5 junk
    lg = _fwd(params, cfg, c, seq[9:], 9)             # rollback to 9
    torch.testing.assert_close(lg[-1], lg_ref[-1], **TOL)
    jl, _, _ = JM.forward(jp, jcfg, jnp.asarray([seq], jnp.int32))
    _close(lg[-1], jl[0, -1])


def test_ring_laps_on_long_prefill():
    jcfg = _hybrid_cfg((("mamba", "none"),))
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = _tcfg(jcfg)
    params = TC.from_numpy_params(_np(jp), cfg, "cpu")
    rng = np.random.default_rng(2)
    seq = list(map(int, rng.integers(0, VOCAB, 37)))
    c = TM.init_cache(cfg, 1, 64, "cpu", ssm_ring=8)  # 37 >> 8: many laps
    _fwd(params, cfg, c, seq, 0)
    lg = _fwd(params, cfg, c, [5], 37)
    lg_ref = _fwd(params, cfg, TM.init_cache(cfg, 1, 64, "cpu"),
                  seq + [5], 0)
    torch.testing.assert_close(lg[-1], lg_ref[-1], **TOL)
    jl, _, _ = JM.forward(jp, jcfg, jnp.asarray([seq + [5]], jnp.int32))
    _close(lg[-1], jl[0, -1])


def test_cache_layouts_and_from_numpy_cache_match_reference(ring_model):
    jcfg, _, cfg, _ = ring_model
    for ring in (0, 8):
        jc = JM.init_cache(jcfg, 3, 40, ssm_ring=ring)
        tc = TM.init_cache(cfg, 3, 40, "cpu", ssm_ring=ring)
        for js, ts in zip(jc["blocks"] + jc["rem"],
                          tc["blocks"] + tc["rem"]):
            assert {k: (v.shape, str(v.dtype)) for k, v in js.items()} == \
                {k: (tuple(v.shape), str(v.dtype).split(".")[1])
                 for k, v in ts.items()}
        back = TC.from_numpy_cache(_np(jc), cfg, "cpu")
        for bs, ts in zip(back["blocks"] + back["rem"],
                          tc["blocks"] + tc["rem"]):
            assert {k: v.dtype for k, v in bs.items()} == \
                {k: v.dtype for k, v in ts.items()}
    assert TM.cache_bytes(cfg, 3, 40) == JM.cache_bytes(jcfg, 3, 40)
    jp = JM.init_paged_cache(jcfg, 9, 4, n_rows=3, ssm_ring=8)
    tp = TM.init_paged_cache(cfg, 9, 4, "cpu", n_rows=3, ssm_ring=8)
    for js, ts in zip(jp["blocks"] + jp["rem"], tp["blocks"] + tp["rem"]):
        assert {k: v.shape for k, v in js.items()} == \
            {k: tuple(v.shape) for k, v in ts.items()}
    with pytest.raises(ValueError, match="checkpoint rings"):
        TM.init_paged_cache(cfg, 9, 4, "cpu")


# ---------------------------------------------------------------------------
# sequential rollback: checkpoint + replay
# ---------------------------------------------------------------------------

def test_runner_checkpoint_replay_matches_reference(hybrid_pairs):
    """The jamba-shaped target through both runners: round checkpoints, a
    branch fork that is selected, one that is abandoned, and rollbacks
    that restore a checkpoint and replay.  The port copies only the Mamba
    carries into a checkpoint and shares the attention leaves; the logits
    after every step equal the reference's, whose checkpoints hold the
    whole (immutable) cache."""
    (_, _, jtp, jtcfg), (_, _, ttp, ttcfg) = hybrid_pairs["jamba-shaped"]
    rng = np.random.default_rng(11)
    seq = list(map(int, rng.integers(0, JP.VOCAB, 30)))
    jr = JR.ModelRunner(jtp, jtcfg, max_len=64)
    tr = TR.ModelRunner(ttp, ttcfg, max_len=64)
    rows = rng.integers(0, JP.VOCAB, (3, 3))

    def both(fn):
        _close(fn(tr), fn(jr))

    both(lambda r: r.prefill(seq[:8]) or r.forward(seq[8:12]))
    for r in (jr, tr):
        r.checkpoint()                                     # at 12
        r.fork(3)
    both(lambda r: r.forward_batched(rows))
    for r in (jr, tr):
        r.select(1)
        r.sync_lineage(rows[1])
    both(lambda r: r.forward([seq[15], seq[16]]))
    both(lambda r: r.reset_to(13) or r.forward([seq[20]]))  # replay 1
    for r in (jr, tr):
        r.checkpoint()                                     # at 14
        r.fork(2)
    both(lambda r: r.forward_batched(rows[:2, :2]))
    for r in (jr, tr):
        r.unfork()
    both(lambda r: r.forward([seq[21]]))
    both(lambda r: r.reset_to(9) or r.forward(seq[22:25]))  # from the prefill
    assert tr.replay_calls == jr.replay_calls == 2
    assert tr.tokens == jr.tokens and tr.pos == jr.pos


N_SEQ = 16


@pytest.fixture(scope="module")
def seq_runs(hybrid_pairs):
    """Sequential SpecBranch, 1 prompt x 16 new tokens: falcon-shaped
    greedy and jamba-shaped at temperature 1, each engine's runners
    captured for their replay counts."""
    prompts = TSV.make_prompts(1)
    out = {}
    for kind, temp in (("falcon-shaped", 0.0), ("jamba-shaped", 1.0)):
        jpair, tpair = hybrid_pairs[kind]
        got = {}
        for side, cls, mod, pair, key in (
                ("ref", JSpecBranch, JE, jpair, jax.random.PRNGKey),
                ("port", TSpecBranch, TE, tpair, prng.PRNGKey)):
            eng = cls(*pair, mod.EngineConfig(gamma=4, c=10.0,
                                              temperature=temp,
                                              max_len=128))
            runners = []
            new = eng._new_runners

            def capture(new=new, runners=runners):
                d, t = new()
                runners.append((d, t))
                return d, t
            eng._new_runners = capture
            res = [eng.generate(p, N_SEQ, key(i))
                   for i, p in enumerate(prompts)]
            got[side] = (res, [(d.replay_calls, t.replay_calls)
                               for d, t in runners])
        out[kind] = got
    return out


@pytest.mark.parametrize("kind", ["falcon-shaped", "jamba-shaped"])
def test_sequential_specbranch_matches_reference(seq_runs, kind):
    (jres, jrep), (tres, trep) = seq_runs[kind]["ref"], seq_runs[kind]["port"]
    for j, t in zip(jres, tres):
        assert t.tokens == j.tokens and len(t.tokens) == N_SEQ
        assert vars(t.stats) == vars(j.stats)
        assert t.timeline == j.timeline
    assert trep == jrep
    assert sum(d + t for d, t in trep) > 0          # rollbacks replayed


# ---------------------------------------------------------------------------
# per-leaf dtypes at bf16, configs
# ---------------------------------------------------------------------------

def test_bf16_params_keep_the_reference_leaf_dtypes(hybrid_pairs):
    """A bf16 Mamba / MoE tree carried across keeps A_log, Dskip and the
    router in float32, every other leaf bf16, with equal values leaf by
    leaf; the port's own init gives the same dtypes."""
    jcfg = hybrid_pairs["jamba-shaped"][0][3].replace(dtype="bfloat16")
    jp = JM.init_params(jax.random.PRNGKey(2), jcfg)
    tp = TC.from_numpy_params(_np(jp), _tcfg(jcfg), "cpu")
    own = TM.init_params(_tcfg(jcfg), 0, "cpu")
    want = jax.tree_util.tree_leaves_with_path(jp)
    got = dict(jax.tree_util.tree_leaves_with_path(tp))
    mine = dict(jax.tree_util.tree_leaves_with_path(own))
    assert len(want) == len(got) == len(mine)
    f32 = 0
    for path, w in want:
        name = path[-1].key
        expect = torch.float32 if w.dtype == jnp.float32 else torch.bfloat16
        assert got[path].dtype == mine[path].dtype == expect, path
        assert tuple(mine[path].shape) == w.shape, path
        f32 += expect == torch.float32
        assert (expect == torch.float32) == (name in TM.F32_LEAVES), path
        np.testing.assert_array_equal(
            got[path].float().numpy(), np.asarray(w, np.float32))
    assert f32 == 3       # A_log, Dskip, router


def test_configs_match_reference():
    jcfg, tcfg = JF.CONFIG, TF.CONFIG
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for j, t in ((jcfg, tcfg), (jcfg.draft(), tcfg.draft()),
                 (JJ.CONFIG, _tcfg(JJ.CONFIG)),
                 (JJ.CONFIG.draft(), _tcfg(JJ.CONFIG).draft())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.d_inner, t.dtr, t.expert_ff) == (j.d_inner, j.dtr,
                                                   j.expert_ff)
        assert t.param_count() == j.param_count()
    assert tcfg.draft().num_layers == 2 and tcfg.draft().d_model == 512
    check_supported(_tcfg(JJ.CONFIG))
    # an encoder-only stack builds and runs its cache-less forward; it has
    # no decode path (tests/test_torch_configs.py)
    check_supported(tcfg.replace(causal=False))
    with pytest.raises(NoDecodeError, match="encoder"):
        check_decodes(tcfg.replace(causal=False))
