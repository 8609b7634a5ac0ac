"""The port's shape-only dry run (``repro_torch.launch.dryrun``), its
production meshes, the H100 constants and the collective-bytes
accounting (``sharding.hlo_analysis``):

* ``--all --both-meshes`` gives 66 ok, 14 skipped (the reference's
  documented skips) and 0 failed, one JSON per (arch, shape, mesh),
  every stand-in a meta tensor;
* the ring factors equal the reference's HLO parser on the reference's
  own test module (the same collectives, as events);
* the roofline's arithmetic and the links a group crosses;
* ``launch/dryrun.py`` imports nothing of JAX (``test_torch_isolation``
  lists it)."""
import json
import os

import pytest
import torch

from repro.sharding.hlo_analysis import collective_bytes as ref_bytes
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as MESH
from repro_torch.launch import steps as S
from repro_torch.configs import get_config
from repro_torch.sharding import hlo_analysis as HA

torch.set_num_threads(1)


def test_all_pairs_on_both_meshes(tmp_path, capsys):
    DR.main(["--all", "--both-meshes", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "== dry-run summary: 66 ok, 14 skipped (documented), 0 FAILED" \
        in out
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 80
    ok = [json.load(open(tmp_path / f)) for f in files]
    ok = [r for r in ok if r["status"] == "ok"]
    assert len(ok) == 66
    for r in ok:
        rl = r["roofline"]
        assert rl["dominant"] in ("compute", "memory", "collective")
        assert rl["flops"] > 0 and r["model_flops"] > 0
        assert r["per_device_total_gb"] > 0
        assert set(r["per_device_bytes"]) >= {"parameters", "inputs",
                                              "temp_estimate"}
        assert r["n_chips"] == (512 if r["mesh"] == "2x16x16" else 256)


def test_skips_are_the_references():
    from repro.configs import get_config as jget
    from repro.launch import steps as JS
    for arch in DR.ARCH_IDS:
        for shape in S.SHAPES:
            r = DR.run_one(arch, shape, multi_pod=False, verbose=False)
            ok, why = JS.applicable(jget(arch), shape)
            assert (r["status"] == "skipped") == (not ok)
            if not ok:
                assert r["reason"] == why


def test_production_meshes_and_constants():
    assert MESH.make_production_mesh().shape == {"data": 16, "model": 16}
    assert MESH.make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    assert MESH.make_host_mesh().shape == {"data": 1, "model": 1}
    assert MESH.make_production_mesh(multi_pod=True).size == 512
    assert (MESH.PEAK_FLOPS_BF16, MESH.HBM_BW, MESH.NVLINK_BW,
            MESH.IB_BW) == (989e12, 3.35e12, 450e9, 50e9)
    m = MESH.make_production_mesh()
    # a 16-wide "model" group spans two 8-GPU nodes; "data" strides 16
    assert MESH.group_link_bw(m, "model") == MESH.IB_BW
    assert MESH.group_link_bw(m, "data") == MESH.IB_BW
    assert MESH.group_link_bw(MESH.ShapeMesh({"data": 32, "model": 8}),
                              "model") == MESH.NVLINK_BW
    assert MESH.group_link_bw(MESH.ShapeMesh({"data": 2, "model": 4}),
                              "world") == MESH.NVLINK_BW


HLO = """
HloModule test

%cond.1 (p: (s32[], f32[128,64])) -> pred[] {
  %gte = s32[] get-tuple-element(%p), index=0
  ROOT %lt = pred[] compare(%gte, s32[] constant(9)), direction=LT
}

%body.1 (p: (s32[], f32[128,64])) -> (s32[], f32[128,64]) {
  %x = f32[128,64]{1,0} get-tuple-element(%p), index=1
  %ag = f32[128,1024]{1,0} all-gather(f32[128,64]{1,0} %x), replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, dimensions={1}
  ROOT %t = (s32[], f32[128,64]) tuple(%gte2, %x)
}

ENTRY %main (a: f32[256,256]) -> f32[256,256] {
  %ar = f32[256,256]{1,0} all-reduce(f32[256,256]{1,0} %a), replica_groups={{0,1,2,3}}
  %w = (s32[], f32[128,64]) while(%init), condition=%cond.1, body=%body.1
  ROOT %r = f32[256,256]{1,0} copy(%ar)
}
"""


def test_ring_factors_equal_reference_parser():
    """The reference's HLO test module as issued collectives: one
    all-reduce of 256x256 f32 over 4, nine all-gathers to 128x1024 f32
    over 16 (the loop's trips)."""
    ref = ref_bytes(HLO, default_group=16)
    c = HA.Census()
    c.record("all-reduce", 4, 256 * 256 * 4)
    for _ in range(9):
        c.record("all-gather", 16, 128 * 1024 * 4)
    got = HA.collective_bytes(c)
    for k in ("all-gather", "all-reduce", "reduce-scatter", "total"):
        assert got[k] == pytest.approx(ref[k])
    assert HA.ring_bytes("reduce-scatter", 4, 400) == 300
    assert HA.ring_bytes("broadcast", 4, 400) == 400
    assert HA.collective_counts(c) == {"all-reduce@4": 1, "all-gather@16": 9}


def test_roofline_terms():
    m = MESH.make_production_mesh()
    events = [("all-reduce", 16, 1e9, "model"),
              ("all-gather", 2, 4e8, ("data",))]
    rl = DR.roofline_terms(989e12, 3.35e12, events, MESH.ShapeMesh(
        {"data": 2, "model": 16}), 32)
    assert rl["t_compute"] == pytest.approx(1.0)
    assert rl["t_memory"] == pytest.approx(1.0)
    coll = 2 * 15 / 16 * 1e9 / MESH.IB_BW + 0.5 * 4e8 / MESH.IB_BW
    assert rl["t_collective"] == pytest.approx(coll)
    assert rl["dominant"] == "compute" and rl["flops"] == 989e12 * 32
    assert m.size == 256


def test_kv_ranges_make_ranks_differ():
    """granite-moe-3b-a800m at 16x16: 24 query heads over 16 ranks
    (exception (d): 8 blocks of 3, each on two ranks) and 8 KV heads
    (one per block); the dry run reports the rank with the most bytes."""
    r = DR.run_one("granite-moe-3b-a800m", "decode_32k", multi_pod=False,
                   verbose=False)
    assert r["status"] == "ok" and 0 <= r["rank"]["model"] < 16
    cfg = get_config("granite-moe-3b-a800m")
    spec = S.input_specs(cfg, "decode_32k", MESH.make_production_mesh())
    wq = spec["layout"][0]["blocks"][0]["mixer"]["wq"]
    assert wq[-1].q_heads == 24 and wq[-1].kv_heads == 24
