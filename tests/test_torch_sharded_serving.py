"""Mesh-sharded serving of the port (DESIGN.md §7.10): tensor-parallel
verify and the sharded KV pool, as ``torch.distributed`` ranks.

The reference's contracts, on the reference test's own pair (a 2-layer
target with 2 heads and 1 KV head, a 1-layer draft, vocabulary 64)
carried across to the port:

  * a 1x1 mesh is LOSSLESS BITWISE: temperature-1 streams equal the
    unmeshed engine's, both engines x both backends, and it issues no
    collective;
  * a larger mesh is LOSSLESS GREEDY: at 1x2, 2x1 and 2x2 every stream
    equals the reference's single-device greedy oracle, on every rank;
  * the COLLECTIVE CONTRACT is pinned: the collectives one target verify
    forward issues, per backend and mesh, and zero for ``copy_page`` and
    for a paged forward with dp only;
  * a tp that divides the query heads but neither divides the KV heads
    nor is a multiple of them serves: a 6-head / 2-KV pair at 1x3, each
    rank holding the KV heads its query heads read (one or two; the
    middle rank's queries padded to whole groups), greedy-equal to the
    oracle on every rank, on both backends.

The port's ranks are processes (gloo on the CPU), so its multi-rank
cases run here, where the reference's skip without simulated devices.
Each mesh shape is spawned once for the module, every case of that shape
runs inside the spawn (``launch.serve.serve_jobs``), and the tests read
the ranks' results.  Also here: the sharded pool's COW and rollback
invariants, a dense preemption + swap and H-RAD at 2x2, the
jamba-shaped hybrid pair and a reduced MoE config at 1x2 against the
port's unmeshed greedy serve, and the CLI's ``--mesh 1,2``."""
import concurrent.futures

import jax
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import dense_pattern
from repro.runtime.runner import greedy_reference
from repro_torch.configs import get_config
from repro_torch.core import hrad as H
from repro_torch.launch import mesh as MESH
from repro_torch.launch import serve as SV
from repro_torch.models import model as TM
from repro_torch.runtime.engines import EngineConfig
from repro_torch.training.pairs import hybrid_pair
from torch_parity import port_pair

torch.set_num_threads(1)

N_NEW = 8
N_REQ = 4
VOCAB = 64
ENGINES = ("sps", "specbranch")
BACKENDS = ("dense", "paged")
JOIN_S = 240.0          # each spawn's own limit: a hung rank fails here


def _cfg(name, layers, d, heads, kv=0):
    return JModelConfig(name=name, family="dense", num_layers=layers,
                        d_model=d, num_heads=heads,
                        num_kv_heads=kv or max(1, heads // 2), d_ff=4 * d,
                        vocab_size=VOCAB, pattern=dense_pattern(0),
                        dtype="float32")


def _ecfg(temp=0.0):
    return EngineConfig(gamma=3, c=4.0, temperature=temp, epsilon=0.4,
                        signal_temperature=0.5, k_max=3, max_len=128)


@pytest.fixture(scope="module")
def pair():
    tcfg = _cfg("shard-t", 2, 64, 2)
    dcfg = _cfg("shard-d", 1, 32, 2)
    tp = JM.init_params(jax.random.PRNGKey(0), tcfg)
    dp = JM.init_params(jax.random.PRNGKey(1), dcfg)
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(0, VOCAB, size=6)))
               for _ in range(N_REQ)]
    refs = [greedy_reference(tp, tcfg, p, N_NEW, max_len=128)
            for p in prompts]
    return port_pair((dp, dcfg, tp, tcfg)), prompts, refs


@pytest.fixture(scope="module")
def pair62():
    """A pair whose 6 query heads read 2 KV heads (groups of 3), the
    draft's too; random weights; the oracle's streams."""
    tcfg = _cfg("shard62-t", 2, 96, 6, kv=2)
    dcfg = _cfg("shard62-d", 1, 48, 6, kv=2)
    tp = JM.init_params(jax.random.PRNGKey(4), tcfg)
    dp = JM.init_params(jax.random.PRNGKey(5), dcfg)
    rng = np.random.default_rng(6)
    prompts = [list(map(int, rng.integers(0, VOCAB, size=6)))
               for _ in range(N_REQ)]
    refs = [greedy_reference(tp, tcfg, p, N_NEW, max_len=128)
            for p in prompts]
    return port_pair((dp, dcfg, tp, tcfg)), prompts, refs


def _job(name, pair, prompts, engine, backend, temp=0.0, **kw):
    kw.setdefault("max_batch", N_REQ)
    kw.setdefault("page_size", 4)
    return dict(name=name, pair=pair, prompts=prompts, new_tokens=N_NEW,
                engine=engine, attn_backend=backend, ecfg=_ecfg(temp), **kw)


def _moe_pair():
    """A reduced MoE config (granite-moe-3b-a800m: 4 heads, 2 KV, 4
    experts) as target, one layer of it as draft, random weights."""
    tcfg = get_config("granite-moe-3b-a800m").reduced()
    dcfg = tcfg.replace(name="granite-moe-draft", num_layers=1)
    return (TM.init_params(dcfg, 1, "cpu"), dcfg,
            TM.init_params(tcfg, 0, "cpu"), tcfg)


def _small(n=3, vocab=199):
    rng = np.random.default_rng(5)
    return [list(map(int, rng.integers(0, vocab, size=7))) for _ in range(n)]


def _spawn(path, dims, jobs):
    return MESH.spawn(*dims, "repro_torch.launch.serve:serve_jobs", jobs,
                      backend="gloo", devices=["cpu"] * (dims[0] * dims[1]),
                      init_method=f"file://{path}", timeout_s=JOIN_S)


def _by_name(ranks):
    """{job name: [rank 0's result, rank 1's, ...]}"""
    out = {}
    for rank_results in ranks:
        for r in rank_results:
            out.setdefault(r["name"], []).append(r)
    return out


def _plans(pair, pair62):
    """Each mesh shape's jobs."""
    jpair, prompts, _ = pair
    base = [_job(f"{e}-{b}", jpair, prompts, e, b, census=True)
            for e in ENGINES for b in BACKENDS]
    jobs11 = [_job(f"{e}-{b}", jpair, prompts, e, b, temp=1.0, census=True)
              for e in ENGINES for b in BACKENDS]
    jobs12 = base + [
        _job("jamba", hybrid_pair("jamba-shaped", device="cpu"), _small(),
             "specbranch", "paged", max_batch=2),
        _job("moe", _moe_pair(), _small(vocab=512), "specbranch", "paged",
             max_batch=2)]
    # 2x2: COW under pages of 2; rows over "data" under preemption (swap
    # packs cross in a broadcast); H-RAD (its features come back over
    # "data", its token embedding joins the vocabulary blocks over
    # "model")
    hrad = H.init_mlp((EngineConfig().hrad_k_layers + 1)
                      * jpair[3].d_model,
                      generator=torch.Generator().manual_seed(0),
                      device="cpu")
    jobs22 = base + [
        _job("cow", jpair, prompts, "specbranch", "paged", page_size=2),
        _job("swap", jpair, prompts, "sps", "dense", pool_pages=20,
             swap_pages=64)] + [
        _job(f"hrad-{b}", jpair, prompts, "specbranch", b, hrad_params=hrad)
        for b in BACKENDS]
    jpair62, prompts62, _ = pair62
    jobs13 = [_job(f"specbranch-{b}", jpair62, prompts62, "specbranch", b)
              for b in BACKENDS]
    return {(1, 1): jobs11, (1, 2): jobs12, (2, 1): base, (2, 2): jobs22,
            (1, 3): jobs13}


@pytest.fixture(scope="module")
def spawned(pair, pair62, tmp_path_factory):
    """Each mesh shape spawned once for the module, all at once, each
    spawn with its own join timeout."""
    plans = _plans(pair, pair62)
    paths = {d: tmp_path_factory.mktemp(f"mesh{d[0]}x{d[1]}") / "store"
             for d in plans}
    with concurrent.futures.ThreadPoolExecutor(len(plans)) as ex:
        futs = {d: ex.submit(_spawn, paths[d], d, jobs)
                for d, jobs in plans.items()}
        return {d: _by_name(f.result()) for d, f in futs.items()}


@pytest.fixture(scope="module")
def mesh11(spawned):
    return spawned[(1, 1)]


@pytest.fixture(scope="module")
def mesh12(spawned):
    return spawned[(1, 2)]


@pytest.fixture(scope="module")
def mesh21(spawned):
    return spawned[(2, 1)]


@pytest.fixture(scope="module")
def mesh22(spawned):
    return spawned[(2, 2)]


@pytest.fixture(scope="module")
def mesh13(spawned):
    return spawned[(1, 3)]


def _unmeshed(pair, prompts, engine, backend, temp=0.0, **kw):
    kw.setdefault("page_size", 4)
    res, _, eng, _ = SV.serve(pair, _ecfg(temp), prompts, N_NEW,
                              device="cpu", max_batch=kw.pop("max_batch",
                                                             N_REQ),
                              engine=engine, attn_backend=backend, **kw)
    assert eng.pool.pages_in_use == 0
    return {rid: list(r.tokens) for rid, r in res.items()}


# ---------------------------------------------------------------------------
# 1x1: bitwise against the unmeshed engine, no collective
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_mesh1_bitwise_vs_unmeshed(pair, mesh11, engine, backend):
    """A 1x1 mesh is today's engine, token for token, at temperature 1.0
    (any drift in logits or uniforms would change the stream), and it
    issues no collective, in the forward or anywhere in the serve."""
    jpair, prompts, _ = pair
    base = _unmeshed(jpair, prompts, engine, backend, temp=1.0)
    (got,) = mesh11[f"{engine}-{backend}"]
    assert got["tokens"] == base
    assert got["pages_in_use"] == 0
    assert got["census"] == {"forward": {}, "copy_page": {},
                             "forward_bytes": {}}
    assert got["collectives"] == {}


# ---------------------------------------------------------------------------
# 1x2, 2x1, 2x2: greedy == the reference's single-device oracle
# ---------------------------------------------------------------------------

MESHES = {"1x2": "mesh12", "2x1": "mesh21", "2x2": "mesh22"}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dims", sorted(MESHES))
def test_meshN_greedy_equals_oracle(pair, request, dims, engine, backend):
    _, _, refs = pair
    ranks = request.getfixturevalue(MESHES[dims])[f"{engine}-{backend}"]
    for r in ranks:                 # every rank committed the same stream
        for i, ref in enumerate(refs):
            assert r["tokens"][i] == ref, (r["name"], i)
        assert r["pages_in_use"] == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_mesh13_kv_head_ranges_greedy_equals_oracle(pair62, mesh13,
                                                    backend):
    """tp = 3 over 6 query heads and 2 KV heads: rank 0 holds KV head 0,
    rank 1 both (its query heads 2 and 3 straddle the groups, padded to
    6 rows), rank 2 KV head 1; every rank commits the oracle's
    streams."""
    _, _, refs = pair62
    ranks = mesh13[f"specbranch-{backend}"]
    assert len(ranks) == 3
    for r in ranks:
        for i, ref in enumerate(refs):
            assert r["tokens"][i] == ref, (backend, i)
        assert r["pages_in_use"] == 0


def test_meshN_sharded_pool_cow_and_rollback(mesh22):
    """The sharded paged pool keeps its invariants: branch forks
    COW-share, the draft's rejections reclaim with reason tags, and
    retirement drains the pool (host state; page ids name per-rank shard
    families), the same on every rank."""
    ranks = mesh22["cow"]
    st = ranks[0]["pool"]
    assert st["reclaimed_speculative_pages"] > 0
    assert st["cow_copies"] > 0
    for r in ranks:
        assert r["pool"] == st
        assert r["pages_in_use"] == 0


def test_dense_rows_over_data_preempt_and_swap(pair, mesh22):
    """Dense rows split over "data" under a pool small enough to preempt:
    the swap packs cross between data ranks, the streams stay the
    oracle's."""
    _, _, refs = pair
    for r in mesh22["swap"]:
        assert r["pool"]["reclaimed_preempt_pages"] > 0
        assert r["collectives"].get("broadcast@2", 0) > 0
        for i, ref in enumerate(refs):
            assert r["tokens"][i] == ref


@pytest.mark.parametrize("backend", BACKENDS)
def test_hrad_2x2_greedy_equals_oracle(pair, mesh22, backend):
    """Batched SpecBranch with an (untrained) H-RAD MLP at 2x2: the
    target's features and the signal's token embedding cross the mesh;
    greedy streams stay the oracle's on every rank."""
    _, _, refs = pair
    for r in mesh22[f"hrad-{backend}"]:
        for i, ref in enumerate(refs):
            assert r["tokens"][i] == ref, (backend, i)


# ---------------------------------------------------------------------------
# the collective contract
# ---------------------------------------------------------------------------

# collectives one target verify forward issues, by kind@group size: per
# layer one all-reduce after wo and one after wd, one for the
# vocabulary-split embedding, one all-gather of the logits to the full
# vocabulary; on the dense backend at dp 2 one more all-gather brings
# every data rank's rows back; a dp-only paged forward is replicated.
# (The reference's GSPMD census of the same forward: all-reduce@2 x 4,
# all-gather@2 x 6-13, plus collective-permutes and an all-to-all.)
_FWD_CENSUS = {
    ("dense", "1x2"): {"all-reduce@2": 5, "all-gather@2": 1},
    ("paged", "1x2"): {"all-reduce@2": 5, "all-gather@2": 1},
    ("dense", "2x2"): {"all-reduce@2": 5, "all-gather@2": 2},
    ("paged", "2x2"): {"all-reduce@2": 5, "all-gather@2": 1},
    ("dense", "2x1"): {"all-gather@2": 1},
    ("paged", "2x1"): {},
}


# the bytes they record (operands; an all-gather's result): 16 tokens x
# d 64 x f32 a layer's all-reduce and the embedding's, 16 x vocabulary
# 64 x f32 the logits' all-gather over "model"; at dp 2 the dense
# backend's ranks forward 8 tokens each, whose logits then cross "data"
_FWD_BYTES = {
    ("dense", "1x2"): {"all-reduce@2": 20480, "all-gather@2": 4096},
    ("paged", "1x2"): {"all-reduce@2": 20480, "all-gather@2": 4096},
    ("dense", "2x2"): {"all-reduce@2": 10240, "all-gather@2": 6144},
    ("paged", "2x2"): {"all-reduce@2": 20480, "all-gather@2": 4096},
    ("dense", "2x1"): {"all-gather@2": 4096},
    ("paged", "2x1"): {},
}


@pytest.mark.parametrize("backend,dims", sorted(_FWD_CENSUS))
def test_collective_census_pinned(request, backend, dims):
    """The partitioning contract: the exact collective set of the target
    verify forward per mesh, and the bytes it records.  A change here
    means the layout changed."""
    for eng in ENGINES:
        for r in request.getfixturevalue(MESHES[dims])[f"{eng}-{backend}"]:
            assert r["census"]["forward"] == _FWD_CENSUS[(backend, dims)]
            assert r["census"]["forward_bytes"] == \
                _FWD_BYTES[(backend, dims)]


@pytest.mark.parametrize("dims", ["1x2", "2x1", "2x2"])
def test_copy_page_zero_collectives(request, dims):
    """Physical COW stays rank-local: every rank copies its own head
    shard of the page."""
    for r in request.getfixturevalue(MESHES[dims])["specbranch-paged"]:
        assert r["census"]["copy_page"] == {}


def test_dp_only_paged_serve_issues_only_the_round_check(mesh21):
    """dp only on the paged backend: the whole serve is replicated; the
    one collective per round is ``debug_check``'s cross-rank agreement."""
    for eng in ENGINES:
        for r in mesh21[f"{eng}-paged"]:
            assert set(r["collectives"]) == {"all-reduce@2"}
            assert r["collectives"]["all-reduce@2"] == r["rounds"]


# ---------------------------------------------------------------------------
# hybrid and MoE
# ---------------------------------------------------------------------------

def test_jamba_shaped_tp2_equals_unmeshed(mesh12):
    """The jamba-shaped pair (Mamba + attention + MoE target, Mamba
    draft) at 1x2: each rank's scan runs its E/2 channels and ring; greedy
    streams equal the port's unmeshed serve."""
    base = _unmeshed(hybrid_pair("jamba-shaped", device="cpu"), _small(),
                     "specbranch", "paged", max_batch=2)
    for r in mesh12["jamba"]:
        assert r["tokens"] == base


def test_moe_tp2_equals_unmeshed(mesh12):
    """A reduced MoE config at 1x2, each expert's hidden split over the
    two ranks: greedy streams equal the port's unmeshed serve."""
    base = _unmeshed(_moe_pair(), _small(vocab=512), "specbranch", "paged",
                     max_batch=2)
    for r in mesh12["moe"]:
        assert r["tokens"] == base


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_serve_cli_mesh_1x2_equals_unmeshed(capfd):
    """``--device cpu --mode batched --mesh 1,2`` serves on two gloo
    ranks; rank 0 prints the report, whose per-request lines, rounds and
    pool lines equal the unmeshed serve's."""
    argv = ["--device", "cpu", "--mode", "batched", "--requests", "2",
            "--new-tokens", "8", "--max-batch", "2"]
    SV.main(argv)
    base = capfd.readouterr().out
    SV.main(argv + ["--mesh", "1,2"])
    got = capfd.readouterr().out
    assert "mesh 1x2 (gloo)" in got

    def lines(out):
        return [ln for ln in out.splitlines()
                if ln.startswith(("req ", "rounds:", "reclaimed pages:",
                                  "aggregate tokens/s"))]
    assert lines(got) == lines(base) and len(lines(base)) == 5
