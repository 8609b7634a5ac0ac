"""The production programs of the port (``repro_torch.launch.steps``)
against the reference's (``repro.launch.steps``):

* ``applicable``: 33 runnable (arch, shape) pairs and 7 skips, pair for
  pair the reference's;
* ``params_shape`` / ``cache_shape`` / ``opt_shape``: meta trees whose
  leaf shapes and dtypes equal the reference's ``eval_shape`` for all ten
  configs (the port's remainder params carry a size-1 stack axis);
* ``input_specs``' spec trees equal the reference's rules on the
  production meshes for all 33 pairs;
* the prefill, serve and embeddings-prefill steps equal the reference's
  (``mesh=None``) on reduced configs within fp32 tolerance;
* ``step_costs``' FLOPs equal ``FlopCounterMode`` of the executed steps
  exactly, and the reference's HLO ``dot_flops`` of the same steps:
  exactly for the serve step, within 3% for the train step (see
  ``test_flops_match_reference_dot_flops``);
* in gloo processes at 1x2 and 2x1 every rank's logits and cache blocks
  equal its blocks of the one-device step (including the long-context
  split of the cache's slots over "data" at batch 1), and its census and
  FLOPs equal ``step_costs``' formulas."""
import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCH_IDS, get_config
from repro.launch import steps as JS
from repro.models import model as JM
from repro.sharding import rules as JR
from repro.sharding.hlo_analysis import dot_flops
from repro.training import optim as JO
from repro_torch.configs import get_config as port_config
from repro_torch.launch import mesh as MESH
from repro_torch.launch import steps as S
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig, NoDecodeError
from repro_torch.sharding import rules as R
from repro_torch.training import optim as TO
from repro_torch.training.checkpoint import from_numpy_params

torch.set_num_threads(1)

JOIN_S = 240.0
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def _flat(tree, path=()):
    if isinstance(tree, (R.P, PartitionSpec)):
        return {path: tuple(tree)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, path + (str(k),)))
    return out


def _same(port_tree, ref_tree, rem_lead=False):
    port, ref = _flat(port_tree), _flat(ref_tree)
    assert port.keys() == ref.keys()
    for path, spec in ref.items():
        got = port[path]
        if rem_lead and "rem" in path:      # the port's params stack axis
            assert got[0] is None, (path, got)
            got = got[1:]
        assert got == spec, (path, got, spec)


PAIRS = [(a, s) for a in ARCH_IDS for s in JS.SHAPES
         if JS.applicable(get_config(a), s)[0]]


def test_applicable_matches_reference():
    runnable = skipped = 0
    for a in ARCH_IDS:
        for s in S.SHAPES:
            got = S.applicable(port_config(a), s)
            assert got == JS.applicable(get_config(a), s), (a, s)
            runnable += got[0]
            skipped += not got[0]
    assert (runnable, skipped) == (33, 7) and len(PAIRS) == 33
    assert S.SHAPES.keys() == JS.SHAPES.keys()
    for k, v in S.SHAPES.items():
        assert dataclasses.astuple(v) == dataclasses.astuple(JS.SHAPES[k])
    assert S.MICROBATCHES == JS.MICROBATCHES
    assert S.GAMMA_VERIFY == JS.GAMMA_VERIFY


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, path + (k,)))
        return out
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, path + (str(i),)))
        return out
    return {path: tree}


def _same_shapes(port, ref, rem_lead):
    p, r = _leaves(port), _leaves(ref)
    assert p.keys() == r.keys()
    for path, leaf in r.items():
        got = p[path]
        assert got.device.type == "meta", path
        shape = tuple(got.shape)
        if rem_lead and path[0] == "rem":
            assert shape[0] == 1
            shape = shape[1:]
        assert shape == tuple(leaf.shape), path
        assert str(got.dtype).split(".")[-1] == str(leaf.dtype), path


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return JS.params_shape(get_config(arch))


@functools.lru_cache(maxsize=None)
def _jcache(arch, batch, seq):
    return JS.cache_shape(get_config(arch), batch, seq)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_equal_reference_eval_shape(arch):
    """Leaf for leaf, shapes and dtypes, nothing allocated (meta)."""
    jcfg, cfg = get_config(arch), port_config(arch)
    jp = _jparams(arch)
    pp = S.params_shape(cfg)
    _same_shapes(pp, jp, rem_lead=True)
    jo, po = JS.opt_shape(jp), S.opt_shape(pp)
    _same_shapes(po.m, jo.m, rem_lead=True)
    _same_shapes(po.v, jo.v, rem_lead=True)
    if not cfg.supports_decode():
        with pytest.raises(NoDecodeError):
            S.cache_shape(cfg, 8, 64)
        return
    _same_shapes(S.cache_shape(cfg, 8, 64), JS.cache_shape(jcfg, 8, 64),
                 rem_lead=False)


def _ref_specs(arch, shape, m):
    """The reference's ``input_specs`` shardings (its default knobs) as
    specs, from its rules on a duck-typed mesh."""
    jcfg = get_config(arch)
    ss = JS.SHAPES[shape]
    pshape = _jparams(arch)
    cshape = (_jcache(arch, ss.batch, ss.seq_len)
              if ss.kind != "train" and jcfg.frontend != "audio" else None)
    pspec = JR.params_specs(m, jcfg, pshape)
    ba = JR.batch_axes(m)
    btok = JR.tokens_spec(m, ss.batch)
    bax = JR._fit(m, ss.batch, ba, "data")
    vocab = JR._fit(m, jcfg.vocab_size, "model")
    if ss.kind == "train":
        ospec = [pspec, pspec, PartitionSpec()]
        return (pspec, ospec, btok), (pspec, ospec, PartitionSpec())
    if ss.kind == "prefill" and jcfg.frontend == "audio":
        return ((pspec, PartitionSpec(bax, None, None)),
                PartitionSpec(bax, None, vocab))
    if ss.kind == "prefill":
        cspec = JR.cache_specs(m, jcfg, cshape)
        return (pspec, btok, cspec), (PartitionSpec(bax, vocab), cspec)
    cspec = JR.cache_specs(m, jcfg, cshape, shard_seq=shape == "long_500k")
    return ((pspec, PartitionSpec(bax, None), cspec, PartitionSpec(bax)),
            (PartitionSpec(bax, None, vocab), cspec))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_input_specs_equal_reference_rules(mesh):
    """Params (and AdamW's m, v), tokens, caches (with the long-context
    ``shard_seq``) and logits, for all 33 pairs; the stand-ins are meta
    tensors.  Params trees carry the port's remainder stack axis."""
    m = FakeMesh(MESHES[mesh])
    for arch, shape in PAIRS:
        got = S.input_specs(port_config(arch), shape, m)
        want_in, want_out = _ref_specs(arch, shape, m)
        gin, gout = list(got["in_specs"]), got["out_specs"]
        train = JS.SHAPES[shape].kind == "train"
        if train:                           # OptState(m, v, step)
            gin[1] = [gin[1].m, gin[1].v, gin[1].step]
            gout = [gout[0], [gout[1].m, gout[1].v, gout[1].step], gout[2]]
            _same(gout, want_out, rem_lead=True)
        else:
            _same(gout, want_out)
        assert len(gin) == len(want_in)
        for i, (g, w) in enumerate(zip(gin, want_in)):
            _same(g, w, rem_lead=i == 0 or (train and i == 1))
        for leaf in TO.tree_leaves(list(got["args"])):
            assert not torch.is_tensor(leaf) or leaf.device.type == "meta"


# ---------------------------------------------------------------------------
# the steps on one device against the reference's, and their FLOPs
# ---------------------------------------------------------------------------

B, T, L = 4, 24, 40           # rows, prompt, cache slots


def _reduced(arch, **kw):
    """A reduced config of one period (two layers when the period is one),
    the reference's and the port's, with the reference's weights; jamba
    and gemma3-4b keep one layer of each kind (Mamba + MoE then attention
    + MLP; a windowed layer then a global one)."""
    jcfg = get_config(arch).reduced()
    pattern = {"jamba-1.5-large-398b": (("mamba", "moe"), ("attn", "dense")),
               "gemma3-4b": (("local", "dense"), ("attn", "dense"))}
    if arch in pattern:
        kw.setdefault("pattern", pattern[arch])
        kw.setdefault("num_layers", 2)
    kw.setdefault("num_layers",
                  jcfg.period * (2 if jcfg.period == 1 else 1))
    jcfg = dataclasses.replace(jcfg, **kw)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, from_numpy_params(jax.tree.map(np.asarray, jp),
                                            cfg, "cpu")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return dict(toks=rng.integers(0, 512, (B, T)).astype(np.int32),
                draft=rng.integers(0, 512, (B, 4)).astype(np.int32),
                pos=np.array([T, T - 3, T - 1, T], np.int32),
                batch=rng.integers(0, 512, (4, 17)).astype(np.int32))


def _host():
    return MESH.make_host_mesh(), {}


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "gemma3-4b"])
def test_steps_equal_reference_and_count_flops(arch, inputs):
    """prefill then serve (the cache the prefill wrote) against the
    reference's steps; each step's FLOPs under ``FlopCounterMode`` equal
    ``step_costs``, and so do a two-micro-batch train step's."""
    jcfg, cfg, jp, tp = _reduced(arch)
    toks, draft, pos = inputs["toks"], inputs["draft"], inputs["pos"]
    jl, jc = JS.make_prefill_step(jcfg)(jp, jnp.asarray(toks),
                                        JM.init_cache(jcfg, B, L))
    cache = TM.init_cache(cfg, B, L, "cpu")
    with FlopCounterMode(display=False) as fc:
        pl, cache = S.make_prefill_step(cfg)(tp, torch.from_numpy(toks),
                                             cache)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)
    assert fc.get_total_flops() == S.step_costs(cfg, "prefill", B, T,
                                                *_host())["flops"]
    jl, _ = JS.make_serve_step(jcfg)(jp, jnp.asarray(draft), jc,
                                     jnp.asarray(pos))
    with FlopCounterMode(display=False) as fc:
        pl, _ = S.make_serve_step(cfg)(tp, torch.from_numpy(draft), cache,
                                       torch.from_numpy(pos))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)
    assert fc.get_total_flops() == S.step_costs(cfg, "decode", B, L,
                                                *_host())["flops"]
    step = S.make_train_step(cfg, 2)
    with FlopCounterMode(display=False) as fc:
        step(tp, TO.init(tp), torch.from_numpy(inputs["batch"]).long())
    assert fc.get_total_flops() == S.step_costs(
        cfg, "train", 4, 16, *_host(), n_micro=2)["flops"]


def test_embeds_prefill_equals_reference():
    """hubert's encoder prefill (embeddings in, every position's logits
    out, bidirectional) and its FLOPs."""
    jcfg, cfg, jp, tp = _reduced("hubert-xlarge")
    emb = np.random.default_rng(1).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    jl = JS.make_prefill_step_embeds(jcfg)(jp, jnp.asarray(emb))
    with FlopCounterMode(display=False) as fc:
        pl = S.make_prefill_step_embeds(cfg)(tp, torch.from_numpy(emb))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)
    assert fc.get_total_flops() == S.step_costs(
        cfg, "prefill_embeds", 2, 16, *_host())["flops"]


def test_flops_match_reference_dot_flops():
    """``step_costs``' FLOPs beside the reference's ``dot_flops`` of the
    same reduced serve and train steps, compiled on one host device.  The
    serve step agrees exactly: both attend over every key chunk (padded
    to kv_chunk, masked or not) and run the same products.  The train step
    agrees within 3%: the reference's cross entropy contracts a one-hot
    (2 B T V FLOPs more), and XLA drops the remat recompute of products
    whose outputs the backward does not read, where the port recomputes
    each layer whole."""
    jcfg, cfg, _, _ = _reduced("jamba-1.5-large-398b")
    jp = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), jcfg))
    sds = jax.ShapeDtypeStruct
    cache = jax.eval_shape(lambda: JM.init_cache(jcfg, B, L))

    def hlo(fn, *args):
        return dot_flops(jax.jit(fn).lower(*args).compile().as_text())
    got = hlo(JS.make_serve_step(jcfg), jp, sds((B, 4), jnp.int32), cache,
              sds((B,), jnp.int32))
    assert got == S.step_costs(cfg, "decode", B, L, *_host())["flops"]
    got = hlo(JS.make_train_step(jcfg, 2), jp, jax.eval_shape(JO.init, jp),
              sds((4, 17), jnp.int32))
    want = S.step_costs(cfg, "train", 4, 16, *_host(), n_micro=2)["flops"]
    assert abs(got - want) <= 0.03 * want


# ---------------------------------------------------------------------------
# the steps on meshes: gloo processes at 1x2 and 2x1
# ---------------------------------------------------------------------------

MESH_ARCHS = ("gemma3-4b", "jamba-1.5-large-398b")


def _single(cfg, tp, inputs):
    """The one-device steps' outputs (logits, cache after) and the caches
    they started from."""
    toks, draft, pos = inputs["toks"], inputs["draft"], inputs["pos"]
    c0 = TM.init_cache(cfg, B, L, "cpu")
    lg1, c1 = S.make_prefill_step(cfg)(tp, torch.from_numpy(toks),
                                       TO.tree_map(torch.clone, c0))
    lg2, c2 = S.make_serve_step(cfg)(tp, torch.from_numpy(draft),
                                     TO.tree_map(torch.clone, c1),
                                     torch.from_numpy(pos))
    s0 = TM.init_cache(cfg, 1, L, "cpu")
    _, s1 = S.make_prefill_step(cfg)(tp, torch.from_numpy(toks[:1]), s0)
    lg3, s2 = S.make_serve_step(cfg)(tp, torch.from_numpy(draft[:1]),
                                     TO.tree_map(torch.clone, s1),
                                     torch.from_numpy(pos[:1]))
    jobs = [dict(name="prefill", kind="prefill", inputs=(toks,), cache=c0),
            dict(name="decode", kind="decode", inputs=(draft, pos),
                 cache=c1),
            dict(name="long", kind="decode", inputs=(draft[:1], pos[:1]),
                 cache=s1, shard_seq=True)]
    return jobs, {"prefill": (lg1, c1), "decode": (lg2, c2),
                  "long": (lg3, s2)}


@pytest.fixture(scope="module")
def reduced_pairs():
    return {a: _reduced(a)[1:4:2] for a in MESH_ARCHS}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, reduced_pairs, inputs):
    """The 1x2 and 2x1 spawns, at once, each with its own join timeout:
    {dims: (jobs, the one-device results by job, the ranks' results)}."""
    jobs, want = [], {}
    for arch, (cfg, tp) in reduced_pairs.items():
        js, ws = _single(cfg, tp, inputs)
        for j in js:
            j.update(name=f"{arch} {j['name']}", cfg=cfg, params=tp)
            jobs.append(j)
        want.update({f"{arch} {k}": v for k, v in ws.items()})

    def spawn(dims, path):
        return MESH.spawn(*dims, "repro_torch.launch.steps:step_jobs", jobs,
                          backend="gloo",
                          devices=["cpu"] * (dims[0] * dims[1]),
                          init_method=f"file://{path}", timeout_s=JOIN_S)
    dims_all = ((1, 2), (2, 1))
    paths = {d: tmp_path_factory.mktemp(f"steps{d[0]}x{d[1]}") / "store"
             for d in dims_all}
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        futs = {d: ex.submit(spawn, d, paths[d]) for d in dims_all}
        return {d: (jobs, want, f.result()) for d, f in futs.items()}


@pytest.fixture(scope="module")
def mesh12(spawned):
    return spawned[(1, 2)]


@pytest.fixture(scope="module")
def mesh21(spawned):
    return spawned[(2, 1)]


@pytest.mark.parametrize("dims", ["mesh12", "mesh21"])
def test_mesh_steps_equal_unsharded(request, dims):
    """Every rank's logits and cache blocks equal its blocks of the
    one-device step; census and FLOPs equal ``step_costs``."""
    jobs, want, ranks = request.getfixturevalue(dims)
    dp, tp = (1, 2) if dims == "mesh12" else (2, 1)
    m = MESH.ShapeMesh({"data": dp, "model": tp})
    for r, res in enumerate(ranks):
        coords = {"data": r // tp, "model": r % tp}
        for job, out in zip(jobs, res):
            cfg, ss = job["cfg"], job.get("shard_seq", False)
            lg, cache = want[job["name"]]
            b = lg.shape[0]
            bax = None if ss else R._fit(m, b, ("data",), "data")
            vax = R._fit(m, cfg.vocab_size, "model")
            spec = R.P(bax, vax) if lg.dim() == 2 else R.P(bax, None, vax)
            np.testing.assert_allclose(
                out["logits"], R.rank_block(lg, spec, m, coords).numpy(),
                rtol=1e-4, atol=1e-5, err_msg=job["name"])
            cshape = TO.tree_map(lambda t: t.to("meta"), cache)
            cspec = R.override_cache_specs(m, cfg, cshape, R.cache_specs(
                m, cfg, cshape, shard_seq=ss))
            blocks = R.shard_tree(cache, cspec, m, coords, "cpu")
            for a, w in zip(TO.tree_leaves(out["cache"]),
                            TO.tree_leaves(blocks)):
                np.testing.assert_allclose(a, w.float().numpy(), rtol=1e-4,
                                           atol=1e-5, err_msg=job["name"])
            kind = job["kind"]
            seq = T if kind == "prefill" else L
            cost = S.step_costs(cfg, kind, b, seq, m, coords, shard_seq=ss)
            assert out["census"] == S.events_by_key(cost["events"]), \
                job["name"]
            assert out["flops"] == cost["flops"], job["name"]
        if dims == "mesh21":        # the long-context split gathers K/V/pos
            long = [o for j, o in zip(jobs, res) if j.get("shard_seq")]
            assert all(any(k.startswith("all-gather@2") for k in o["census"])
                       for o in long)
