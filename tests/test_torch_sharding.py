"""The port's partition rules, serving-mesh CLI surface and collective
census (``repro_torch.sharding``, ``repro_torch.launch.mesh``).

The rules must equal the reference's ``PartitionSpec``s leaf for leaf —
params (tp_only true and false), decode caches (with and without
sequence sharding), serving caches (dense and paged) and token specs —
for every assigned architecture on the production meshes and the small
serving meshes, with the reference's own duck-typed mesh (no devices).
The port's trees carry a size-1 stack axis on their remainder layers, so
a remainder leaf's port spec is the reference's behind one more None."""
import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import ARCH_IDS, get_config
from repro.launch import steps
from repro.models import model as JM
from repro.sharding import rules as JR
from repro_torch.configs import get_config as port_config
from repro_torch.launch import mesh as MESH
from repro_torch.launch import serve as SV
from repro_torch.sharding import hlo_analysis as HA
from repro_torch.sharding import rules as R

torch.set_num_threads(1)


class FakeMesh:
    """Duck-typed mesh: rules only use ``mesh.shape`` membership/sizes."""

    def __init__(self, shape):
        self.shape = dict(shape)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "1x2": {"data": 1, "model": 2},
          "2x2": {"data": 2, "model": 2},
          "1x4": {"data": 1, "model": 4}}


def _meta(tree, rem_lead=False):
    """A shape tree of the reference (ShapeDtypeStructs) as the port lays
    it out: meta tensors, remainder leaves behind a size-1 stack axis
    when ``rem_lead`` (params; caches carry it in both packages)."""
    def go(node, lead):
        if isinstance(node, dict):
            return {k: go(v, lead or (rem_lead and k == "rem"))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [go(v, lead) for v in node]
        shape = ((1,) if lead else ()) + tuple(node.shape)
        return torch.empty(shape, device="meta")
    return go(tree, False)


def _flat(tree, path=()):
    """{path: spec} of a spec tree (a port ``P`` or a reference
    ``PartitionSpec`` at each leaf)."""
    if isinstance(tree, (R.P, PartitionSpec)):
        return {path: tuple(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    out = {}
    for i, v in enumerate(tree):
        out.update(_flat(v, path + (str(i),)))
    return out


def _same(port_tree, ref_tree, rem_lead=False):
    port, ref = _flat(port_tree), _flat(ref_tree)
    assert port.keys() == ref.keys()
    for path, spec in ref.items():
        got = port[path]
        if rem_lead and path[0] == "rem":
            assert got[0] is None, (path, got)
            got = got[1:]
        assert got == spec, (path, got, spec)


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    cfg = get_config(arch)
    return (steps.params_shape(cfg), steps.cache_shape(cfg, 128, 32768),
            jax.eval_shape(lambda: JM.init_cache(cfg, 8, 2048, ssm_ring=32)),
            jax.eval_shape(lambda: JM.init_paged_cache(
                cfg, 64, 16, n_rows=8, ssm_ring=32)))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_specs_equal_reference(mesh, arch):
    m = FakeMesh(MESHES[mesh])
    pshape = _shapes(arch)[0]
    mine = _meta(pshape, rem_lead=True)
    for tp_only in (False, True):
        _same(R.params_specs(m, port_config(arch), mine, tp_only=tp_only),
              JR.params_specs(m, get_config(arch), pshape, tp_only=tp_only),
              rem_lead=True)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(mesh, arch):
    m = FakeMesh(MESHES[mesh])
    cshape = _shapes(arch)[1]
    for shard_seq in (False, True):
        _same(R.cache_specs(m, port_config(arch), _meta(cshape),
                            shard_seq=shard_seq),
              JR.cache_specs(m, get_config(arch), cshape,
                             shard_seq=shard_seq))
    _same(R.cache_specs(m, port_config(arch), _meta(cshape),
                        batch_axis="data"),
          JR.cache_specs(m, get_config(arch), cshape, batch_axis="data"))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serving_cache_specs_equal_reference(mesh, arch):
    m = FakeMesh(MESHES[mesh])
    _, _, dense, paged = _shapes(arch)
    for shape, ax in ((dense, "data"), (dense, ""), (paged, "")):
        _same(R.serving_cache_specs(m, port_config(arch), _meta(shape),
                                    batch_axis=ax),
              JR.serving_cache_specs(m, get_config(arch), shape,
                                     batch_axis=ax))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tokens_spec_and_axes_equal_reference(mesh):
    m = FakeMesh(MESHES[mesh])
    for batch in (1, 2, 4, 8, 32, 128, 512, 3):
        assert tuple(R.tokens_spec(m, batch)) == \
            tuple(JR.tokens_spec(m, batch))
    assert R.fsdp_axes(m) == JR.fsdp_axes(m)
    assert R.batch_axes(m) == JR.batch_axes(m)
    for dim in (1, 2, 4, 6, 16, 32, 512):
        for cands in (("model",), ("pod", "data"), (("pod", "data"), "data")):
            assert R._fit(m, dim, *cands) == JR._fit(m, dim, *cands)


# ---------------------------------------------------------------------------
# the tensor-parallel layout: exceptions (a) and (b), rank blocks
# ---------------------------------------------------------------------------

def test_tp_overrides_kv_heads_and_moe():
    """(a) KV heads "model" does not divide are whole per rank (the rule
    would split their head dim); (b) MoE experts split on F."""
    from repro_torch.models import model as TM
    m = FakeMesh({"data": 1, "model": 2})
    cfg = port_config("granite-moe-3b-a800m").reduced().replace(
        num_kv_heads=1)
    p = TM.init_params(cfg, 0, "cpu")
    spec = R.tp_params_specs(m, cfg, p)["blocks"][0]
    assert spec["mixer"]["wk"] == (None, None, R.HeadRange("model", 4, 1))
    assert spec["mixer"]["wq"] == (None, None, "model")
    assert spec["ffn"]["wg"] == (None, None, None, "model")
    assert spec["ffn"]["wd"] == (None, None, "model", None)
    assert spec["ffn"]["router"] == (None, None, None)
    # the rule itself splits wk's columns (its head dim) and MoE on D
    rule = R.params_specs(m, cfg, p, tp_only=True)["blocks"][0]
    assert rule["mixer"]["wk"] == (None, None, "model")
    assert rule["ffn"]["wg"] == (None, None, "model", "data")
    cache = TM.init_paged_cache(cfg, 8, 4, "meta")
    kp = R.tp_cache_specs(m, cfg, cache)["blocks"][0]["k_pages"]
    assert kp == (None, None, None, R.HeadRange("model", 4, 1), None)
    with pytest.raises(ValueError, match="KV heads"):
        R.kv_split(FakeMesh({"model": 4}), cfg.replace(num_kv_heads=6))


def test_rank_block_and_shard_shape():
    m = FakeMesh({"data": 2, "model": 4})
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    spec = R.P("data", "model")
    assert R.shard_shape(x.shape, spec, m) == (4, 3)
    blk = R.rank_block(x, spec, m, {"data": 1, "model": 2})
    assert torch.equal(blk, x[4:8, 6:9])
    # whole KV heads (2 of them here, 6 columns each) replicated over tp /
    # KV consecutive ranks: 8 query heads, 2 per rank, 4 per KV head
    s = R.P(None, R.HeadRange("model", 8, 2))
    assert R.shard_shape(x.shape, s, m, {"model": 1}) == (8, 6)
    with pytest.raises(ValueError, match="coordinates"):
        R.shard_shape(x.shape, s, m)
    assert torch.equal(R.rank_block(x, s, m, {"model": 1}), x[:, :6])
    assert torch.equal(R.rank_block(x, s, m, {"model": 2}), x[:, 6:])
    assert R.rank_block(x, R.P(None, None), m, {"model": 3}) is x


def test_tp_shard_params_splits_in_proj_per_half():
    """in_proj's columns are [x | z]: each rank takes its E/tp columns of
    each half, and the shards of every leaf tile the full tensor."""
    cfg = port_config("falcon-mamba-7b").reduced()
    from repro_torch.models import model as TM
    params = TM.init_params(cfg, 0, "cpu")
    m = FakeMesh({"data": 1, "model": 2})
    shards = [R.tp_shard_params(params, cfg, m, {"data": 0, "model": t},
                                "cpu") for t in range(2)]
    E = cfg.d_inner
    full = params["blocks"][0]["mixer"]["in_proj"]
    got = [s["blocks"][0]["mixer"]["in_proj"] for s in shards]
    assert torch.equal(got[0], torch.cat([full[..., :E // 2],
                                          full[..., E:E + E // 2]], -1))
    assert torch.equal(got[1], torch.cat([full[..., E // 2:E],
                                          full[..., E + E // 2:]], -1))
    for name, dim in (("out_proj", 1), ("x_db", 1), ("A_log", 1),
                      ("conv_w", 2), ("dt_w", 2)):
        parts = [s["blocks"][0]["mixer"][name] for s in shards]
        assert torch.equal(torch.cat(parts, dim),
                           params["blocks"][0]["mixer"][name]), name


# ---------------------------------------------------------------------------
# CLI surface (launch.mesh validation + serve --mesh)
# ---------------------------------------------------------------------------

def test_parse_mesh_arg():
    assert MESH.parse_mesh_arg("2,4") == (2, 4)
    assert MESH.parse_mesh_arg(" 1 , 1 ") == (1, 1)
    assert MESH.parse_mesh_arg("4") == (1, 4)       # bare tp shorthand
    for bad in ("", "a,b", "2,", "1,2,3", "0,4", "-1,2"):
        with pytest.raises(ValueError, match="--mesh"):
            MESH.parse_mesh_arg(bad)


def test_validate_serving_mesh_devices():
    MESH.validate_serving_mesh(1, 2, n_devices=2)
    with pytest.raises(ValueError, match="needs 8 devices but only 4"):
        MESH.validate_serving_mesh(2, 4, n_devices=4)
    # CPU ranks are processes: no device count bounds them
    MESH.validate_serving_mesh(4, 4, device="cpu")
    with pytest.raises(ValueError, match="--device cpu"):
        MESH.validate_serving_mesh(1, 1024, device="cuda")


def test_validate_serving_mesh_heads():
    """Only a tp that does not divide the query heads is refused, as in
    the reference: a tp that neither divides the KV heads nor is a
    multiple of them takes whole KV-head ranges (exception (a))."""
    cfg = port_config("gemma3-4b")                  # 8 heads, 4 KV
    MESH.validate_serving_mesh(1, 2, configs=(cfg,), n_devices=8)
    MESH.validate_serving_mesh(1, 8, configs=(cfg,), n_devices=8)
    with pytest.raises(ValueError, match=r"pick tp in \[1, 2, 4, 8\]"):
        MESH.validate_serving_mesh(1, 3, configs=(cfg,), n_devices=8)
    MESH.validate_serving_mesh(
        1, 4, configs=(cfg.replace(num_kv_heads=6, num_heads=12),),
        n_devices=8)
    for arch in ("grok-1-314b", "granite-moe-3b-a800m"):
        for tp in (3, 6, 12):
            MESH.validate_serving_mesh(1, tp, configs=(port_config(arch),),
                                       device="cpu")
        with pytest.raises(ValueError, match="does not divide"):
            MESH.validate_serving_mesh(1, 5, configs=(port_config(arch),),
                                       device="cpu")


def test_serve_cli_rejects_oversized_mesh():
    """--mesh validation fails fast (before any model loads) with the
    device-count message naming the CPU escape hatch."""
    with pytest.raises(SystemExit) as e:
        SV.main(["--mode", "batched", "--mesh", "9,9"])
    assert "needs 81 devices" in str(e.value)
    assert "--device cpu" in str(e.value)


def test_serve_cli_rejects_mesh_outside_batched():
    with pytest.raises(SystemExit, match="batched"):
        SV.main(["--mode", "sequential", "--mesh", "1,2", "--device",
                 "cpu"])
    with pytest.raises(SystemExit, match="--mesh"):
        SV.main(["--mode", "batched", "--mesh", "0,2", "--device", "cpu"])


# ---------------------------------------------------------------------------
# census
# ---------------------------------------------------------------------------

def test_census_counts_by_group():
    c = HA.Census()
    assert HA.collective_counts(c) == {}
    c.record("all-reduce", 2)
    c.record("all-reduce", 2)
    c.record("all-gather", 2)
    c.record("all-reduce", 4)
    assert HA.collective_counts(c) == {"all-reduce@2": 2, "all-gather@2": 1,
                                       "all-reduce@4": 1}
    c.reset()
    assert HA.collective_counts(c) == {}


def test_axis_of_one_issues_nothing():
    """A mesh axis of size 1 is the identity: no collective, no count."""
    c = HA.Census()
    ax = MESH.MeshAxis("model", 1, 0, [0], None, c)
    x = torch.ones(3)
    assert ax.all_reduce(x) is x
    assert ax.all_gather(x, 0) is x
    assert ax.broadcast(x, 0) is x
    assert HA.collective_counts(c) == {}


# ---------------------------------------------------------------------------
# KV-head ranges (exception (a)) and the FSDP layout (exceptions (c), (d))
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,sizes", [
    ("grok-1-314b", {3: {3, 4}, 6: {2}, 12: {1, 2}}),
    ("granite-moe-3b-a800m", {3: {3, 4}, 6: {2}, 12: {1, 2}})])
def test_kv_head_ranges_for_every_tp(arch, sizes):
    """Each rank holds exactly the KV heads its query block reads (one
    or two at grok's tp = 12, three or four at granite's tp = 3); the
    ranges cover every KV head; shard shapes follow the rank."""
    cfg = port_config(arch)
    H, KV = cfg.num_heads, cfg.num_kv_heads
    G = H // KV
    for tp, want in sizes.items():
        m = FakeMesh({"data": 1, "model": tp})
        kv = R.kv_split(m, cfg)
        assert isinstance(kv, R.HeadRange)
        seen, got = set(), set()
        for t in range(tp):
            lo, hi = kv.heads(t, tp)
            q = range(t * H // tp, (t + 1) * H // tp)
            assert {h // G for h in q} == set(range(lo, hi))
            seen.update(range(lo, hi))
            got.add(hi - lo)
            c = {"model": t}
            spec = R._tp_override(m, cfg, "wk", (cfg.d_model, KV * cfg.hd),
                                  R.P(None, "model"))
            assert R.shard_shape((cfg.d_model, KV * cfg.hd), spec, m, c) \
                == (cfg.d_model, (hi - lo) * cfg.hd)
        assert seen == set(range(KV)) and got == want


def _tiles(cfg, mesh_shape):
    """Every leaf's blocks over all ranks: each element held by as many
    ranks as ``holders`` says (sum over ranks of 1 / holders is 1)."""
    m = FakeMesh(mesh_shape)
    from repro_torch.models import model as TM
    from repro_torch.training import optim as TO
    params = TM.init_params(cfg, 0, "meta")
    specs = R.fsdp_params_specs(m, cfg, params)
    names = list(m.shape)
    coords_all = [dict(zip(names, idx)) for idx in
                  __import__("itertools").product(
                      *(range(m.shape[a]) for a in names))]
    for leaf, sp in zip(TO.tree_leaves(params), _spec_leaves(specs)):
        shape = tuple(leaf.shape)
        ids = torch.arange(leaf.numel(), dtype=torch.float64).reshape(shape)
        total = torch.zeros(leaf.numel(), dtype=torch.float64)
        for c in coords_all:
            blk = R.shard_tree({"x": ids}, {"x": sp}, m, c, "cpu")["x"]
            w = R.holders(sp, shape, m, c)
            w = (torch.ones_like(blk) / w).to(torch.float64)
            total.index_add_(0, blk.reshape(-1).long(), w.reshape(-1))
        assert torch.allclose(total, torch.ones_like(total)), (sp, shape)
    return specs


def _spec_leaves(specs):
    from repro_torch.launch.steps import spec_leaves
    return spec_leaves(specs)


@pytest.mark.parametrize("arch,mesh", [
    ("granite-moe-3b-a800m", {"data": 2, "model": 2}),
    ("falcon-mamba-7b", {"data": 2, "model": 2}),
    ("jamba-1.5-large-398b", {"data": 2, "model": 4}),
    ("gemma3-4b", {"data": 1, "model": 3})])
def test_fsdp_layout_tiles_every_leaf(arch, mesh):
    """The training layout's blocks tile each leaf: FSDP over "data", TP
    over "model", replicated where the layout says (a leaf without
    "data" on every data rank; KV heads on the ranks whose queries read
    them).  MoE experts keep "model" on F and put "data" on D
    (exception (c))."""
    cfg = port_config(arch).reduced().replace(name=arch)
    if arch == "gemma3-4b":                 # 6 heads / 2 KV over tp = 3
        cfg = cfg.replace(num_heads=6, num_kv_heads=2, head_dim=16,
                          d_model=96)
    specs = _tiles(cfg, mesh)
    if cfg.num_experts:
        ffn = specs["blocks"][0]["ffn"]
        assert ffn["wg"] == (None, None, "data", "model")
        assert ffn["wd"] == (None, None, "model", "data")
        assert ffn["router"] == (None, None, None)


def test_more_ranks_than_query_heads():
    """Exception (d): gemma3-4b's 8 query heads over the production
    mesh's 16 "model" ranks: whole heads on two ranks each (wq), one KV
    head each (wk), wo's rule rows (an hd slice) per rank."""
    cfg = port_config("gemma3-4b")
    m = FakeMesh({"data": 16, "model": 16})
    spec = R.fsdp_params_specs(m, cfg, TM_meta(cfg))["blocks"][0]["mixer"]
    assert spec["wq"] == (None, "data", R.HeadRange("model", 8, 8))
    assert spec["wk"] == (None, "data", R.HeadRange("model", 8, 4))
    assert spec["wo"] == (None, "model", "data")
    rng = R.HeadRange("model", 8, 8)
    assert [rng.heads(t, 16) for t in (0, 1, 2, 15)] == [
        (0, 1), (0, 1), (1, 2), (7, 8)]
    # the serving mesh refuses such a tp, as the reference does
    with pytest.raises(ValueError, match="does not divide"):
        MESH.validate_serving_mesh(1, 16, configs=(cfg,), device="cpu")


def TM_meta(cfg):
    from repro_torch.models import model as TM
    return TM.init_params(cfg, 0, "meta")
