"""Quickstart of the PyTorch port: SpecBranch vs vanilla speculative
decoding on the committed tiny pair (the port of ``quickstart.py``).

Loads the misaligned Zipf-Markov pair from ``.cache/pairs``, generates
48 tokens with both engines, checks each stream against the target's own
greedy decode and prints the paper's metrics.  Runs on the GPU unless
``--device cpu`` is given (every kernel's plain PyTorch version then).

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.data.synthetic import ZipfMarkov  # noqa: E402
from repro_torch.runtime import prng  # noqa: E402
from repro_torch.runtime.cost_model import CostModel  # noqa: E402
from repro_torch.runtime.engines import EngineConfig, SpSEngine  # noqa: E402
from repro_torch.runtime.runner import greedy_reference  # noqa: E402
from repro_torch.runtime.specbranch import SpecBranchEngine  # noqa: E402
from repro_torch.training.pairs import VOCAB, get_pair  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    ap.add_argument("--new-tokens", type=int, default=48)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"loading the misaligned tiny pair onto {device} ...")
    dp, dcfg, tp, tcfg = get_pair("misaligned", device=device)

    ecfg = EngineConfig(gamma=4, k_max=6, epsilon=0.5, c=10.0,
                        temperature=0.0, draft_temperature=0.0,
                        signal_temperature=0.3, branch_mode="topk",
                        max_len=1024)
    cost = CostModel(c=ecfg.c)
    prompt = [int(t) for t in
              ZipfMarkov(vocab=VOCAB, seed=7).prompts(1, 12, seed=3)[0]]

    ref = greedy_reference(tp, tcfg, prompt, args.new_tokens, max_len=1024)
    for engine in (SpSEngine(dp, dcfg, tp, tcfg, ecfg),
                   SpecBranchEngine(dp, dcfg, tp, tcfg, ecfg)):
        result = engine.generate(prompt, args.new_tokens, prng.PRNGKey(0))
        rep = result.report(cost)
        assert result.tokens == ref, "lossless guarantee violated!"
        print(f"{engine.name:11s}: M={rep['M']:.2f} "
              f"speedup={rep['speedup']:.2f}x "
              f"rollback={rep['rollback_rate']:.2f} "
              f"(output identical to target greedy decoding)")


if __name__ == "__main__":
    main()
