"""The H-RAD offline pipeline with the PyTorch port, end to end (the
port of ``train_hrad.py``; Sec. 5.1 / E.4):

  1. run vanilla-SD rounds over a prompt corpus, recording
     (z_t = target features + token embedding, s_t = round outcome) pairs
     (``runtime.hrad_data.collect``);
  2. train the 3-class MLP (``core.hrad.train_mlp``: Adam with decoupled
     decay, label smoothing, SMOTE balancing, dropout);
  3. deploy it inside SpecBranch and compare against the no-H-RAD
     ablation on the modeled clock.

  PYTHONPATH=src python examples/torch_train_hrad.py [--device cpu]

Runs on the GPU unless ``--device cpu`` is given; a missing GPU is an
error, never a fallback.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.core import hrad as H  # noqa: E402
from repro_torch.data.synthetic import ZipfMarkov  # noqa: E402
from repro_torch.runtime import hrad_data, prng  # noqa: E402
from repro_torch.runtime.cost_model import CostModel  # noqa: E402
from repro_torch.runtime.specbranch import SpecBranchEngine  # noqa: E402
from repro_torch.training.pairs import (PAIR_C, VOCAB,  # noqa: E402
                                        default_ecfg, get_pair)


def run_engine(engine, kind: str, n_prompts: int, n_new: int) -> dict:
    """Mean report over the reference benchmarks' prompts (12 tokens,
    seed 11), on the pair's modeled clock."""
    cost = CostModel(c=PAIR_C[kind])
    zm = ZipfMarkov(vocab=VOCAB, seed=7)
    reps = [engine.generate(p, n_new, prng.PRNGKey(i)).report(cost)
            for i, p in enumerate(zm.prompts(n_prompts, 12, seed=11))]
    return {k: float(np.mean([r[k] for r in reps])) for k in reps[0]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--prompts", type=int, default=6,
                    help="collection prompts (the reference uses 6)")
    ap.add_argument("--new-tokens", type=int, default=48)
    ap.add_argument("--epochs", type=int, default=12)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    kind = "misaligned"
    dp, dcfg, tp, tcfg = get_pair(kind, device=device)
    ecfg = default_ecfg(kind)
    zm = ZipfMarkov(vocab=VOCAB, seed=7)

    print("1) collecting H-RAD training data from vanilla-SD rounds ...")
    z, labels = hrad_data.collect(dp, dcfg, tp, tcfg,
                                  zm.prompts(args.prompts, 12, seed=5),
                                  args.new_tokens, ecfg)
    dist = np.bincount(labels, minlength=3) / len(labels)
    print(f"   {len(labels)} rounds; class distribution "
          f"(reject/partial/accept) = {np.round(dist, 2)}")

    print("2) training the 3-class MLP ...")
    hcfg = H.HRADConfig(k_layers=ecfg.hrad_k_layers, d_model=tcfg.d_model,
                        epochs=args.epochs, lr=1e-3)
    params, metrics = H.train_mlp(z, labels, hcfg, verbose=True,
                                  device=device)
    print(f"   metrics: { {k: round(v, 3) for k, v in metrics.items()} }")

    print("3) deploying inside SpecBranch ...")
    n_eval = max(1, args.prompts // 2)
    with_h = run_engine(SpecBranchEngine(dp, dcfg, tp, tcfg, ecfg,
                                         hrad_params=params), kind, n_eval,
                        args.new_tokens)
    without = run_engine(SpecBranchEngine(dp, dcfg, tp, tcfg, ecfg), kind,
                         n_eval, args.new_tokens)
    print(f"   with H-RAD:    speedup={with_h['speedup']:.2f} "
          f"RB={with_h['rollback_rate']:.2f}")
    print(f"   without H-RAD: speedup={without['speedup']:.2f} "
          f"RB={without['rollback_rate']:.2f}")


if __name__ == "__main__":
    main()
