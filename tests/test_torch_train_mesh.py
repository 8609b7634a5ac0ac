"""The FSDP x TP training mesh (``launch.steps.make_mesh_train_step``
through the rank target ``launch.train.train_jobs``) in gloo processes on
the CPU, against the one-device step (``launch.steps.make_train_step``,
which ``tests/test_torch_train.py`` holds equal to the reference's):

* at 1x2, 2x1 and 2x2, after 2 steps of 4 x 17 tokens in 2
  micro-batches, every rank's losses equal the one-device step's (rtol
  1e-5) and its blocks of every parameter equal its blocks of the
  one-device parameters (atol 1e-5: float32 sums in another order,
  through AdamW), for a reduced attention + MoE config (granite, with a
  capacity factor of 1.0, so tokens are dropped and the global capacity,
  token ranks and load-balance fractions matter) and a reduced Mamba
  config (falcon-mamba);
* at 1x3 and 1x4 a 6-head / 2-KV config: KV-head ranges whose query
  blocks are padded to whole groups (exception (a), tp = 3) and query
  blocks replicated over two ranks (exception (d), tp = 4);
* the first step's gradient blocks equal the one-device step's
  gradients (rtol 1e-4, atol 1e-6: AdamW's update hides a gradient's
  scale, so the gradients are held directly), and every step's global
  norm the one-device step's (rtol 1e-5);
* every step's census equals ``launch.steps.step_costs``' formula;
* the rank target's ``compare_to`` reads a saved one-device result;
* ``launch/train.py --production-mesh`` exits naming the GPU count.
"""
import concurrent.futures

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import mesh as MESH
from repro_torch.launch import steps as S
from repro_torch.launch import train as TR
from repro_torch.models import model as TM
from repro_torch.sharding import rules as R
from repro_torch.training import optim as TO
from repro_torch.training.train import lm_loss, value_and_grad

torch.set_num_threads(1)

JOIN_S = 240.0
N_MICRO, B, SEQ = 2, 4, 16
RTOL_LOSS, ATOL_PARAM = 1e-5, 1e-5


def _cfg(name):
    if name == "heads6":
        cfg = get_config("qwen3-8b").reduced().replace(
            name="heads6", num_heads=6, num_kv_heads=2, d_model=96,
            head_dim=16)
    else:
        cfg = get_config(name).reduced()
    if cfg.num_experts:
        cfg = cfg.replace(capacity_factor=1.0)
    return cfg.replace(num_layers=2 * cfg.period)


def _first_grads(cfg, params, batch):
    """The one-device step's summed gradients of its first batch."""
    gsum = None
    for mb in torch.from_numpy(batch).reshape(N_MICRO, B // N_MICRO, -1):
        _, _, g = value_and_grad(
            lambda p, b: lm_loss(p, cfg, b, remat=True), params, mb)
        gsum = g if gsum is None else TO.tree_map(torch.add, gsum, g)
    return TO.tree_map(lambda t: t / N_MICRO, gsum)


@pytest.fixture(scope="module")
def cases():
    """{name: (cfg, full params, batches, one-device losses, params,
    first-step gradients, global norms)}"""
    rng = np.random.default_rng(0)
    out = {}
    for name in ("granite-moe-3b-a800m", "falcon-mamba-7b", "heads6"):
        cfg = _cfg(name)
        params = TM.init_params(cfg, 0, "cpu")
        batches = [rng.integers(0, cfg.vocab_size, (B, SEQ + 1))
                   for _ in range(2)]
        grads = _first_grads(cfg, params, batches[0])
        p1 = TO.tree_map(torch.clone, params)
        st, step = TO.init(p1), S.make_train_step(cfg, N_MICRO)
        losses = []
        for b in batches:
            p1, st, loss = step(p1, st, torch.from_numpy(b))
            losses.append(float(loss))
        out[name] = (cfg, params, batches, losses, p1, grads,
                     [float(g) for g in step.gnorms])
    return out


def _spawn(path, dims, jobs):
    return MESH.spawn(*dims, "repro_torch.launch.train:train_jobs", jobs,
                      backend="gloo", devices=["cpu"] * (dims[0] * dims[1]),
                      init_method=f"file://{path}", timeout_s=JOIN_S)


def _jobs(cases, names, **kw):
    return [dict(name=n, cfg=cases[n][0], params=cases[n][1],
                 batches=cases[n][2], n_micro=N_MICRO, return_params=True,
                 return_grads=True, **kw) for n in names]


PLANS = {(1, 2): ("granite-moe-3b-a800m", "falcon-mamba-7b"),
         (2, 1): ("granite-moe-3b-a800m", "falcon-mamba-7b"),
         (2, 2): ("granite-moe-3b-a800m", "falcon-mamba-7b"),
         (1, 3): ("heads6",), (1, 4): ("heads6",)}


@pytest.fixture(scope="module")
def meshes(cases, tmp_path_factory):
    """Each mesh shape spawned once, all at once, each spawn with its own
    join timeout; the 1x2 spawn also compares its blocks against a saved
    one-device result (``compare_to``)."""
    saved = tmp_path_factory.mktemp("ref") / "granite.pt"
    torch.save(cases["granite-moe-3b-a800m"][4], saved)
    plans = {}
    for dims, names in PLANS.items():
        jobs = _jobs(cases, names)
        if dims == (1, 2):
            jobs.append(dict(jobs[0], name="compare", return_params=False,
                             compare_to=str(saved)))
        path = tmp_path_factory.mktemp(f"train{dims[0]}x{dims[1]}") / "store"
        plans[dims] = (path, jobs)
    with concurrent.futures.ThreadPoolExecutor(len(plans)) as ex:
        futs = {d: ex.submit(_spawn, path, d, jobs)
                for d, (path, jobs) in plans.items()}
        return {d: f.result() for d, f in futs.items()}


@pytest.mark.parametrize("dims", sorted(PLANS))
def test_mesh_step_equals_single_device(cases, meshes, dims):
    ranks = meshes[dims]
    m = MESH.ShapeMesh({"data": dims[0], "model": dims[1]})
    for r, res in enumerate(ranks):
        coords = {"data": r // dims[1], "model": r % dims[1]}
        for out in res:
            if out["name"] == "compare":
                continue
            cfg, _, _, losses, p1, g1, gnorms = cases[out["name"]]
            np.testing.assert_allclose(out["losses"], losses,
                                       rtol=RTOL_LOSS, err_msg=out["name"])
            np.testing.assert_allclose(out["gnorms"], gnorms, rtol=1e-5,
                                       err_msg=out["name"])
            layout = R.fsdp_params_specs(m, cfg, S.params_shape(cfg))
            want = R.shard_tree(p1, layout, m, coords, "cpu")
            for a, w, nm in zip(TO.tree_leaves(out["params"]),
                                TO.tree_leaves(want), S._leaf_names(want)):
                np.testing.assert_allclose(a, w.numpy(), rtol=0,
                                           atol=ATOL_PARAM,
                                           err_msg=f"{out['name']} {nm}")
            want = R.shard_tree(g1, layout, m, coords, "cpu")
            for a, w, nm in zip(TO.tree_leaves(out["grads"][0]),
                                TO.tree_leaves(want), S._leaf_names(want)):
                np.testing.assert_allclose(a, w.numpy(), rtol=1e-4,
                                           atol=1e-6,
                                           err_msg=f"{out['name']} {nm}")


@pytest.mark.parametrize("dims", sorted(PLANS))
def test_mesh_step_census_equals_formula(cases, meshes, dims):
    """Every collective the step issues, forward and backward (FSDP
    gathers and reduce-scatters, the TP all-reduces and their
    gradients, MoE statistics over "data", the gradient sums, the global
    norm, the loss), by kind, group and bytes."""
    m = MESH.ShapeMesh({"data": dims[0], "model": dims[1]})
    for r, res in enumerate(ranks := meshes[dims]):
        coords = {"data": r // dims[1], "model": r % dims[1]}
        for out in res:
            cfg = cases[out["name"] if out["name"] != "compare"
                        else "granite-moe-3b-a800m"][0]
            want = S.events_by_key(S.step_costs(
                cfg, "train", B, SEQ, m, coords, n_micro=N_MICRO)["events"])
            for step_census in out["census"]:
                assert step_census == want, (out["name"], r)
    assert len(ranks) == dims[0] * dims[1]


def test_compare_to_reads_the_saved_result(meshes):
    for res in meshes[(1, 2)]:
        (cmp,) = [o for o in res if o["name"] == "compare"]
        assert cmp["errors"] and all(
            err <= ATOL_PARAM and cos > 0.999
            for err, _, cos in cmp["errors"].values())


def test_production_mesh_needs_256_gpus():
    with pytest.raises(SystemExit, match="needs 256 GPUs"):
        TR.main(["--production-mesh", "--device", "cpu"])
