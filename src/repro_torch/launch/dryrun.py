"""Shape-only dry run of the production programs (port of
``repro.launch.dryrun``): every (architecture x input shape) on the
production mesh, its per-rank memory and its roofline terms, from shapes
alone on the CPU.

The reference lowers and compiles each program for 512 placeholder TPU
devices and reads XLA's memory and cost analysis and the HLO.  The port
has no compiler to ask: it lays the program out with the port's layout
(``sharding.rules.fsdp_params_specs`` and the cache specs with
exception (a)) on a shape-only mesh (``launch.mesh.make_production_mesh``)
and costs it with closed-form per-layer formulas
(``launch.steps.step_costs``: the dot FLOPs and the collectives the
rank's part issues, held equal to ``FlopCounterMode`` and to the census
of executed steps by the tests).  Every tensor is a meta tensor: nothing
is allocated and no device is used.  The constants are the H100's
(``launch.mesh``); no TPU figure remains.

Per (arch, shape, mesh), for the rank that holds the most (the ranks
differ where exception (a) gives them KV-head ranges of different sizes):
  * bytes: parameters, AdamW moments (train), cache and inputs of the
    rank's blocks, read from the layout; ``temp_estimate``, an ESTIMATE
    (no compiler reports it here): the largest layer's gathered weights,
    the widest layer's activations, one attention key chunk's f32
    scores and the rank's logits block; a train step adds its remat
    checkpoints (one (rows, T, D) activation a layer), its gradient
    accumulators and three times the layer activations for the backward;
  * ``roofline_terms``: compute = FLOPs / 989 TFLOP/s, memory = HBM bytes
    / 3.35 TB/s, collective = each collective's ring bytes over the
    slowest link its group spans (NVLink 450 GB/s inside an 8-GPU node,
    InfiniBand 50 GB/s across nodes).  HBM bytes are an ESTIMATE too:
    each gathered weight read once a forward (a train micro-batch reads
    it three times and writes its gradient once), the cache block read
    once and the logits written once; a train step's optimizer reads
    parameters, gradients and both moments and writes three of them;
  * ``model_flops`` (6 N D tokens for training, 2 N D for inference, N
    the active parameters) and ``useful_flops_ratio`` (model FLOPs over
    the step's FLOPs on every rank).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
      [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import steps
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16, group_link_bw,
                                     make_production_mesh)
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import rules
from repro_torch.sharding.hlo_analysis import bytes_by_kind, ring_bytes
from repro_torch.training import optim

DEFAULT_OUT = "experiments/dryrun_torch"


def _tree_bytes(tree: Any, specs: Any, mesh, coords) -> int:
    """Bytes of the rank's blocks of a tree of meta tensors."""
    total = 0
    for leaf, sp in zip(optim.tree_leaves(tree), steps.spec_leaves(specs)):
        n = 1
        for d in rules.shard_shape(tuple(leaf.shape), sp, mesh, coords):
            n *= d
        total += n * leaf.dtype.itemsize
    return total


def roofline_terms(flops: float, hbm_bytes: float, events, mesh,
                   n_chips: int) -> Dict[str, Any]:
    """Three-term roofline of one rank's part (per-device quantities):
    ``events`` are ``step_costs``' collectives, each timed over the
    slowest link of its group."""
    coll = bytes_by_kind(events)
    t_coll = 0.0
    for kind, n, nbytes, axis in events:
        t_coll += ring_bytes(kind, n, nbytes) / group_link_bw(mesh, axis)
    t_compute = flops / PEAK_FLOPS_BF16
    t_memory = hbm_bytes / HBM_BW
    dominant = max([("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)], key=lambda kv: kv[1])[0]
    return dict(flops=flops * n_chips, flops_per_device=flops,
                hbm_bytes=hbm_bytes * n_chips,
                hbm_bytes_per_device=hbm_bytes,
                collective_bytes=coll["total"], collectives=coll,
                t_compute=t_compute, t_memory=t_memory,
                t_collective=t_coll, dominant=dominant)


def _rank_figures(cfg: ModelConfig, shape: str, mesh, coords, spec
                  ) -> Dict[str, Any]:
    """One rank's bytes, FLOPs, collectives and the two estimates."""
    ss = steps.SHAPES[shape]
    kind = ("prefill_embeds" if ss.kind == "prefill"
            and cfg.frontend == "audio" else ss.kind)
    n_micro = steps.MICROBATCHES.get(cfg.name, 1) if kind == "train" else 1
    shard_seq = shape == "long_500k"
    cost = steps.step_costs(cfg, kind, ss.batch, ss.seq_len, mesh, coords,
                            n_micro=n_micro, shard_seq=shard_seq)
    args, layout = spec["args"], spec["layout"]
    pbytes = _tree_bytes(args[0], layout[0], mesh, coords)
    elt = cfg.tdtype.itemsize
    # the weights as the layers compute with them: FSDP axes gathered
    tp_layout = steps._map_specs(lambda sp: steps._strip_fsdp(sp, mesh),
                                 layout[0])
    wbytes = _tree_bytes(args[0], tp_layout, mesh, coords)
    layer_w = max([_tree_bytes(p, s, mesh, coords) // cfg.n_periods
                   for p, s in zip(args[0]["blocks"], tp_layout["blocks"])]
                  + [_tree_bytes(p, s, mesh, coords)
                     for p, s in zip(args[0]["rem"], tp_layout["rem"])])
    rows_ax = steps._rows_axis(mesh, ss.batch // n_micro)
    rows = (ss.batch // n_micro) // (rules._axis_size(mesh, rows_ax)
                                     if rows_ax and not shard_seq else 1)
    T = steps.GAMMA_VERIFY if kind == "decode" else ss.seq_len
    N = rows * T
    vocab_ax = rules._fit(mesh, cfg.vocab_size, "model")
    Vl = cfg.vocab_size // rules._axis_size(mesh, vocab_ax) \
        if vocab_ax else cfg.vocab_size
    n_log = rows if kind == "prefill" else N
    logits = n_log * Vl * 4
    wide = max(cfg.d_model, cfg.d_ff or 0, 2 * cfg.d_inner,
               cfg.num_heads * cfg.hd) * elt
    chunk = rows * cfg.num_heads * T * min(steps.KV_CHUNK, T if kind !=
                                           "decode" else ss.seq_len) * 4
    temp = layer_w + N * (cfg.d_model * elt + wide) + chunk + logits
    out: Dict[str, Any] = {"parameters": pbytes}
    if kind == "train":
        out["optimizer"] = 2 * pbytes
        ckpt = cfg.num_layers * N * cfg.d_model * elt
        temp += ckpt + pbytes + 3 * N * (cfg.d_model * elt + wide)
        hbm = n_micro * 4 * wbytes + 7 * pbytes
        out["inputs"] = _tree_bytes(
            {"b": args[2]}, {"b": layout[2]}, mesh, coords)
    else:
        cache = (_tree_bytes(args[2], layout[2], mesh, coords)
                 if kind != "prefill_embeds" else 0)
        out["cache"] = cache
        inputs = [a for a in args[1:] if not isinstance(a, dict)]
        in_specs = [s for a, s in zip(args[1:], layout[1:])
                    if not isinstance(a, dict)]
        out["inputs"] = _tree_bytes(inputs, in_specs, mesh, coords)
        hbm = wbytes + cache + logits
    out["temp_estimate"] = temp
    return dict(bytes=out, flops=cost["flops"], events=cost["events"],
                hbm=hbm)


def run_one(arch: str, shape: str, *, multi_pod: bool, verbose: bool = True,
            cfg_override: Optional[ModelConfig] = None) -> Dict[str, Any]:
    cfg = cfg_override or get_config(arch)
    ok, why = steps.applicable(cfg, shape)
    if not ok:
        return dict(arch=arch, shape=shape, status="skipped", reason=why)
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size
    t0 = time.time()
    try:
        spec = steps.input_specs(cfg, shape, mesh)
        # the ranks along "model" differ (exception (a)); every other
        # coordinate holds the same sizes: cost each model index, keep the
        # rank with the most bytes
        best = None
        for t in range(mesh.shape["model"]):
            coords = {a: 0 for a in mesh.shape}
            coords["model"] = t
            fig = _rank_figures(cfg, shape, mesh, coords, spec)
            total = sum(fig["bytes"].values())
            if best is None or total > best[0]:
                best = (total, fig, t)
        total, fig, t_rank = best
        rl = roofline_terms(fig["flops"], fig["hbm"], fig["events"], mesh,
                            n_chips)
        ss = steps.SHAPES[shape]
        tokens = ss.batch * (ss.seq_len if ss.kind != "decode"
                             else steps.GAMMA_VERIFY)
        model_flops = (6 if ss.kind == "train" else 2) \
            * cfg.active_param_count() * tokens
        result = dict(
            arch=arch, shape=shape, status="ok",
            mesh="2x16x16" if multi_pod else "16x16", n_chips=n_chips,
            hardware="NVIDIA H100 SXM5 80GB (datasheet constants)",
            rank={"model": t_rank}, seconds=round(time.time() - t0, 3),
            per_device_bytes=fig["bytes"],
            per_device_total_gb=round(total / 2**30, 3),
            roofline=rl, model_flops=model_flops,
            useful_flops_ratio=(model_flops / rl["flops"]
                                if rl["flops"] else None),
            estimates=["temp_estimate", "hbm_bytes"])
        if verbose:
            print(f"[OK] {arch} x {shape} ({result['mesh']}): "
                  f"{result['per_device_total_gb']} GiB/dev, "
                  f"compute {rl['t_compute']*1e3:.2f} ms, "
                  f"memory {rl['t_memory']*1e3:.2f} ms, "
                  f"collective {rl['t_collective']*1e3:.2f} ms "
                  f"-> {rl['dominant']}-bound "
                  f"({result['seconds']:.1f}s)")
        return result
    except Exception as e:  # noqa: BLE001 — a dry-run failure IS the signal
        if verbose:
            print(f"[FAIL] {arch} x {shape}: {e}")
            traceback.print_exc()
        return dict(arch=arch, shape=shape, status="failed", error=str(e))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(steps.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    runs = []
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(steps.SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}"
                r = run_one(arch, shape, multi_pod=mp)
                runs.append(r)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(r, f, indent=1, default=str)
    n_ok = sum(r["status"] == "ok" for r in runs)
    n_skip = sum(r["status"] == "skipped" for r in runs)
    n_fail = sum(r["status"] == "failed" for r in runs)
    print(f"\n== dry-run summary: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_fail} FAILED ==")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
