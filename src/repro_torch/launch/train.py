"""The training CLI (port of ``repro.launch.train``).

Trains one assigned architecture (``--arch``, default gemma3-4b; its
``reduced()`` config with ``--reduced``) from random weights on
Zipf-Markov batches, with the gradient-accumulated remat train step
(``launch.steps``) and AdamW (lr 1e-3, cosine over ``--steps``), on one
device: ``--device cuda`` (the default; raises without a GPU) or
``--device cpu``.  ``--production-mesh`` (the reference's 16 x 16 FSDP x
TP mesh) is multi-GPU work and exits naming ROADMAP.md queue A item 5b.

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
from repro_torch.launch import steps as S
from repro_torch import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.training import optim


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
    zm = ZipfMarkov(vocab=min(cfg.vocab_size, 499), seed=7)
    data = (zm.batch_iter(batch, seq, seed=0) if cfg.vocab_size >= 64 else
            token_stream(cfg.vocab_size, batch, seq))
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
        raise SystemExit("--production-mesh: the FSDP training mesh is "
                         "not in this slice (ROADMAP.md queue A item 5b; "
                         "the serving mesh is launch.serve --mesh)")
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
