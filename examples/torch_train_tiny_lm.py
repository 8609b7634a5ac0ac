"""Train a reduced architecture from scratch with the PyTorch port (the
port of ``train_tiny_lm.py``): model zoo config, AdamW with warmup and
cosine decay, the train step, checkpointing, then a greedy sample.

By default trains the reduced gemma3-4b config; ``--arch`` picks any
assigned architecture (its reduced variant).  The checkpoint is written
in the reference's npz layout (``training.checkpoint.save``), so the
reference's ``load`` reads it too.

  PYTHONPATH=src python examples/torch_train_tiny_lm.py --arch qwen3-8b \\
      --steps 200 [--device cpu]

Runs on the GPU unless ``--device cpu`` is given; a missing GPU is an
error, never a fallback.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.data.synthetic import ZipfMarkov  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training.optim import AdamWConfig  # noqa: E402
from repro_torch.training.train import TrainConfig, train_lm  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--out", default=".cache/torch_tiny_lm.npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"{args.steps} steps on {device}")
    zm = ZipfMarkov(vocab=min(cfg.vocab_size, 499), seed=7)
    data = (b % cfg.vocab_size
            for b in zm.batch_iter(args.batch, args.seq, seed=0))
    tcfg = TrainConfig(steps=args.steps, batch=args.batch, seq_len=args.seq,
                       log_every=max(1, args.steps // 4),
                       optim=AdamWConfig(lr=1e-3, total_steps=args.steps))
    t0 = time.time()
    params, metrics = train_lm(cfg, data, tcfg, verbose=True, device=device)
    print(f"final loss {metrics['final_loss']:.4f} "
          f"({time.time()-t0:.0f}s)")
    ckpt.save(args.out, params)
    print(f"checkpoint written to {args.out}")
    if cfg.supports_decode():
        prompt = [t % cfg.vocab_size for t in zm.prompts(1, 8, seed=9)[0]]
        out = M.greedy_reference(params, cfg, [prompt], 16)[0]
        print(f"greedy sample after prompt {prompt}: {out}")


if __name__ == "__main__":
    main()
