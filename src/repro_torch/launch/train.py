"""The training CLI (port of ``repro.launch.train``).

Trains one assigned architecture (``--arch``, default gemma3-4b; its
``reduced()`` config with ``--reduced``) from random weights on
Zipf-Markov batches, with the gradient-accumulated remat train step
(``launch.steps``) and AdamW (lr 1e-3, cosine over ``--steps``), on one
device: ``--device cuda`` (the default; raises without a GPU) or
``--device cpu``.  ``--production-mesh`` trains on the reference's 16 x 16
FSDP x TP mesh over NCCL, one GPU per rank (``launch.mesh.spawn`` of 256
processes on this host, each running ``launch.steps.make_mesh_train_step``),
and exits with a message when fewer than 256 GPUs are visible.  Smaller
meshes run through the rank target ``train_jobs``
(``launch.mesh.spawn(dp, tp, "repro_torch.launch.train:train_jobs",
jobs, ...)``): gloo processes on the CPU in the tests, ranks sharing one
card in ``chip_smoke.py --mesh``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen3-8b --reduced --steps 20 --batch 8 --seq 64
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.synthetic import ZipfMarkov, token_stream
from repro_torch.kernels import ops
from repro_torch.launch import mesh as MESH
from repro_torch.launch import steps as S
from repro_torch import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import rules
from repro_torch.training import optim

PRODUCTION_GPUS = 256


def run(cfg: ModelConfig, steps: int, batch: int, seq: int, micro: int,
        device, log: Callable[[str], None] = print,
        on_step: Optional[Callable] = None) -> Dict[str, List[float]]:
    """Train ``cfg`` from ``init_params(cfg, 0)`` for ``steps`` steps of
    ``batch`` x (``seq`` + 1) tokens in ``micro`` micro-batches.  Returns
    {"loss": per-step mean losses, "seconds": per-step wall time (each
    step synchronised on a GPU)}.  ``on_step(i, params, opt_state)``, if
    given, runs after every step."""
    dev = torch.device(device)
    params = M.init_params(cfg, 0, dev)
    opt_state = optim.init(params)
    step_fn = S.make_train_step(
        cfg, micro, optim.AdamWConfig(lr=1e-3, total_steps=steps))
    data = _data(cfg, batch, seq)
    out: Dict[str, List[float]] = {"loss": [], "seconds": []}
    t0 = time.time()
    for i in range(steps):
        toks = torch.from_numpy(next(data) % cfg.vocab_size).to(dev)
        ts = time.time()
        params, opt_state, loss = step_fn(params, opt_state, toks)
        lv = float(loss)                      # synchronises the step
        out["loss"].append(lv)
        out["seconds"].append(time.time() - ts)
        if on_step is not None:
            on_step(i, params, opt_state)
        if i % max(1, steps // 10) == 0 or i == steps - 1:
            log(f"step {i:4d}  loss={lv:.4f}  ({time.time() - t0:.1f}s)")
    return out


def _data(cfg: ModelConfig, batch: int, seq: int):
    zm = ZipfMarkov(vocab=min(cfg.vocab_size, 499), seed=7)
    return (zm.batch_iter(batch, seq, seed=0) if cfg.vocab_size >= 64 else
            token_stream(cfg.vocab_size, batch, seq))


# ---------------------------------------------------------------------------
# the FSDP x TP training mesh
# ---------------------------------------------------------------------------

def train_jobs(mesh, jobs) -> List[Dict]:
    """Rank target (``launch.mesh.spawn``): train on this rank's blocks of
    a ``(dp, tp)`` mesh with ``launch.steps.make_mesh_train_step``.  A
    job: ``cfg``, ``n_micro``, ``batches`` (numpy (B, T+1) global
    batches, one a step), the weights (``params``, a full CPU tree, or
    ``seed`` for ``init_params`` on the rank's device), optionally
    ``ocfg``, ``return_params`` (the rank's blocks after the steps, as
    numpy), ``return_grads`` (each step's gradient blocks, as numpy)
    and ``compare_to`` (a ``torch.save``d full tree of the same steps in
    one process: per leaf, the rank's largest absolute difference from
    its block of it, the block's largest magnitude, and the cosine of
    the rank's update (its block after the steps less before) with the
    saved tree's).  Returns per job: the losses, each step's global
    gradient norm and census ``{"kind@n": (count, bytes)}``, kernel
    launches and peak device memory (CUDA) of the steps, and what the
    job asked for."""
    out = []
    for job in jobs:
        cfg, dev = job["cfg"], mesh.device
        layout = rules.fsdp_params_specs(mesh, cfg, S.params_shape(cfg))
        full = job.get("params")
        if full is None:
            full = M.init_params(cfg, job["seed"], dev)
        # own storage: a block may be a view of ``full``, which the parent
        # process shares when it passed the tree
        params = optim.tree_map(torch.clone, rules.shard_tree(
            full, layout, mesh, mesh.coords, dev))
        del full
        opt_state = optim.init(params)
        p0 = (optim.tree_map(torch.clone, params) if job.get("compare_to")
              else None)
        step = S.make_mesh_train_step(cfg, job["n_micro"], mesh,
                                      job.get("ocfg"),
                                      keep_grads=job.get("return_grads",
                                                         False))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        res: Dict = {"name": job.get("name"), "losses": [], "census": [],
                     "seconds": []}
        for b in job["batches"]:
            mesh.census.reset()
            t0 = time.time()
            params, opt_state, loss = step(params, opt_state,
                                           torch.from_numpy(b).to(dev))
            res["losses"].append(float(loss))
            res["seconds"].append(time.time() - t0)
            res["census"].append(S.census_by_key(mesh.census))
        res["launches"] = dict(ops.LAUNCHES)
        res["gnorms"] = [float(g) for g in step.gnorms]
        if job.get("return_grads"):
            res["grads"] = [optim.tree_map(
                lambda t: t.detach().cpu().float().numpy(), g)
                for g in step.grads]
        res["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else 0)
        if job.get("return_params"):
            res["params"] = optim.tree_map(
                lambda t: t.detach().cpu().float().numpy(), params)
        if job.get("compare_to"):
            ref = torch.load(job["compare_to"], mmap=True)
            errs = {}
            starts = _pairs(p0, p0, layout, mesh)
            for path, (a, b) in _pairs(params, ref, layout, mesh).items():
                a0 = starts[path][0].float()
                da, db = a.float() - a0, b.float() - a0
                cos = float((da * db).sum() / (da.norm() * db.norm())
                            .clamp_min(1e-30))
                errs[path] = (float((a.float() - b.float()).abs().max()),
                              float(b.float().abs().max()), cos)
            res["errors"] = errs
        out.append(res)
    return out


def _pairs(params, ref, layout, mesh, path=""):
    """{leaf path: (the rank's block, its block of ``ref``)}."""
    if isinstance(params, dict):
        out = {}
        for k in params:
            out.update(_pairs(params[k], ref[k], layout[k], mesh,
                              f"{path}.{k}" if path else k))
        return out
    if isinstance(params, list):
        out = {}
        for i, (a, b, c) in enumerate(zip(params, ref, layout)):
            out.update(_pairs(a, b, c, mesh, f"{path}.{i}"))
        return out
    name = path.split(".")[-1]      # shard_tree splits in_proj by name
    return {path: (params, rules.shard_tree({name: ref}, {name: layout},
                                            mesh, mesh.coords,
                                            params.device)[name])}


def _cli_rank(mesh, args) -> List[float]:
    """Rank target of ``--production-mesh``: the CLI's run on this rank's
    blocks; rank 0 logs."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    data = _data(cfg, args.batch, args.seq)
    batches = [next(data) % cfg.vocab_size for _ in range(args.steps)]
    res = train_jobs(mesh, [dict(cfg=cfg, n_micro=args.micro, seed=0,
                                 batches=batches, ocfg=optim.AdamWConfig(
                                     lr=1e-3, total_steps=args.steps))])[0]
    if mesh.rank == 0:
        for i, lv in enumerate(res["losses"]):
            print(f"step {i:4d}  loss={lv:.4f}")
    return res["losses"]


def production_mesh(args) -> None:
    """``--production-mesh``: the 16 x 16 mesh over NCCL, one GPU a rank;
    exits when fewer than 256 GPUs are visible."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < PRODUCTION_GPUS:
        raise SystemExit(
            f"--production-mesh: the 16x16 FSDP x TP mesh needs "
            f"{PRODUCTION_GPUS} GPUs, one a rank, and {n} are visible; "
            "smaller meshes run through launch.mesh.spawn(dp, tp, "
            "'repro_torch.launch.train:train_jobs', jobs, ...)")
    mesh = MESH.make_production_mesh()
    MESH.spawn(mesh.shape["data"], mesh.shape["model"],
               "repro_torch.launch.train:_cli_rank", args, backend="nccl",
               devices=[f"cuda:{i}" for i in range(PRODUCTION_GPUS)],
               timeout_s=24 * 3600.0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (requires 256 devices)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.production_mesh:
        production_mesh(args)
        return
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"device {device}")
    run(cfg, args.steps, args.batch, args.seq, args.micro, device)
    print("done.")


if __name__ == "__main__":
    main()
