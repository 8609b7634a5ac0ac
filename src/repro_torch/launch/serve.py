"""Serving driver of the PyTorch port: batched SpecBranch over paged KV
(port of ``repro.launch.serve``'s default path).

Same flags and JSON report as the reference driver, plus ``--device``
(default ``cuda``; ``cpu`` runs every kernel's plain PyTorch version).
The slice of the port covers what the reference runs with no flags:
``--engine specbranch``, batched mode, the paged backend, the sequential
draft loop.  Other values of those flags exit with a message naming the
later slice.  ``--pair`` also takes ``paper-llama``: the paper's
LLaMA-68M draft / LLaMA-7B target at full width, bf16, with random
weights from fixed seeds (no checkpoint is needed).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \\
      --requests 8 --new-tokens 32 --pair paper-llama
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs.paper_pairs import PAPER_PAIRS
from repro_torch.data.synthetic import ZipfMarkov
from repro_torch.models import model as M
from repro_torch.runtime.engines import EngineConfig
from repro_torch.serving import (BatchedSpecBranchEngine,
                                 ContinuousBatchScheduler, ServeRequest)
from repro_torch.training.pairs import VOCAB, get_pair

PAIRS = ("misaligned", "aligned", "paper-llama")


def load_pair(kind: str, device):
    """(draft_params, draft_cfg, target_params, target_cfg): the committed
    Zipf-Markov pairs, or the paper's LLaMA 68M/7B pair with random
    weights drawn on ``device`` (target seed 0, draft seed 1)."""
    if kind == "paper-llama":
        dcfg, tcfg, _c = PAPER_PAIRS["llama"]
        return (M.init_params(dcfg, 1, device), dcfg,
                M.init_params(tcfg, 0, device), tcfg)
    return get_pair(kind, device=device)


def make_prompts(n: int, length: int = 16, seed: int = 3
                 ) -> List[List[int]]:
    """The reference driver's prompts: Zipf-Markov samples over the
    199-token language (valid ids for every pair)."""
    zm = ZipfMarkov(vocab=VOCAB, seed=7)
    return [list(map(int, p)) for p in zm.prompts(n, length, seed=seed)]


def auto_max_len(prompts: Sequence[Sequence[int]], new_tokens: int,
                 gamma: int, c: float) -> int:
    need = (max(len(p) for p in prompts) + new_tokens
            + 4 * (gamma + int(c)))
    return max(512, 1 << (need - 1).bit_length())


def serve(pair, ecfg: EngineConfig, prompts, new_tokens: int, *,
          device, max_batch: int = 8, page_size: int = 16,
          pool_pages: Optional[int] = None, swap_pages: int = 256,
          arrival_interval: float = 0.0):
    """Build the engine and scheduler and serve ``prompts``.  Returns
    (results by rid, scheduler report, engine, wall seconds)."""
    dp, dcfg, tp, tcfg = pair
    eng = BatchedSpecBranchEngine(
        dp, dcfg, tp, tcfg, ecfg, max_batch=max_batch,
        page_size=page_size, pool_pages=pool_pages, swap_pages=swap_pages,
        device=device)
    sched = ContinuousBatchScheduler(eng)
    reqs = [ServeRequest(rid=i, prompt=p, max_new_tokens=new_tokens,
                         arrival=i * arrival_interval)
            for i, p in enumerate(prompts)]
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    results = sched.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return results, sched.report(), eng, time.time() - t0


def _unsupported(args) -> Optional[str]:
    checks = [
        (args.mode not in (None, "batched"),
         "--mode sequential (the sequential engines)"),
        (args.engine != "specbranch",
         f"--engine {args.engine} (only batched SpecBranch is ported)"),
        (args.spec_predictor != "off", "--spec-predictor"),
        (args.draft_mode != "sequential", "--draft-mode parallel"),
        (args.attn_backend != "paged", "--attn-backend dense"),
        (args.prefix_cache != "off", "--prefix-cache on"),
        (args.mesh is not None, "--mesh"),
        (bool(args.trace or args.metrics_out or args.profile_dir),
         "--trace / --metrics-out / --profile-dir (tracing)"),
    ]
    for bad, what in checks:
        if bad:
            return (f"{what} is not in this slice of the PyTorch port; "
                    "see ROADMAP.md queue A, or run the reference: "
                    "python -m repro.launch.serve")
    return None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="specbranch",
                    choices=["autoregressive", "sps", "adaedl", "lookahead",
                             "pearl", "specbranch"])
    ap.add_argument("--mode", default=None,
                    choices=["sequential", "batched"])
    ap.add_argument("--pair", default="misaligned", choices=PAIRS,
                    help="misaligned/aligned: the reference's trained "
                    "pairs (cached checkpoints); paper-llama: LLaMA "
                    "68M/7B at full width, bf16, random weights")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=48)
    ap.add_argument("--gamma", type=int, default=4)
    ap.add_argument("--c", type=float, default=10.0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--spec-predictor", default="off",
                    choices=["off", "on", "oracle"])
    ap.add_argument("--draft-mode", default="sequential",
                    choices=["sequential", "parallel"])
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pool-pages", type=int, default=None)
    ap.add_argument("--swap-pages", type=int, default=256)
    ap.add_argument("--attn-backend", default="paged",
                    choices=["dense", "paged"])
    ap.add_argument("--prefix-cache", default="off", choices=["off", "on"])
    ap.add_argument("--mesh", default=None, metavar="DP,TP")
    ap.add_argument("--arrival-interval", type=float, default=0.0)
    ap.add_argument("--max-len", type=int, default=0)
    ap.add_argument("--json", default=None)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--profile-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; a CUDA device without a "
                    "visible card is an error, never a CPU fallback")
    args = ap.parse_args(argv)
    msg = _unsupported(args)
    if msg:
        raise SystemExit(msg)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))

    prompts = make_prompts(args.requests)
    max_len = args.max_len or auto_max_len(prompts, args.new_tokens,
                                           args.gamma, args.c)
    ecfg = EngineConfig(gamma=args.gamma, c=args.c,
                        temperature=args.temperature, max_len=max_len)
    try:
        pair = load_pair(args.pair, device)
    except FileNotFoundError as e:
        raise SystemExit(str(e))
    results, rep, eng, wall = serve(
        pair, ecfg, prompts, args.new_tokens, device=device,
        max_batch=args.max_batch, page_size=args.page_size,
        pool_pages=args.pool_pages, swap_pages=args.swap_pages,
        arrival_interval=args.arrival_interval)
    rep["device"] = (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu")
    print(f"\n== batched specbranch on {args.pair} pair ({rep['device']}): "
          f"{len(results)} requests, max_batch={args.max_batch}, "
          f"{wall:.1f}s wall ==")
    for rid in sorted(results):
        r = results[rid]
        print(f"req {rid}: {len(r.tokens)} tok  M={r.stats.mean_accepted:.2f}"
              f"  RB={r.stats.rollback_rate:.2f}")
    pool = rep["pool"]
    print(f"rounds: {rep['rounds']}  preemptions: {rep['preemptions']}")
    print(f"TTFT p50/p95 (modeled): {rep['ttft_p50']:.1f}/"
          f"{rep['ttft_p95']:.1f}   ITL p50/p95: {rep['itl_p50']:.1f}/"
          f"{rep['itl_p95']:.1f}")
    print(f"pool occupancy: mean={rep['pool_occupancy_mean']:.2f} "
          f"peak={rep['pool_occupancy_peak']:.2f}  "
          f"(pages={eng.pool.num_pages} x {eng.pool.page_size} tok)")
    print(f"reclaimed pages: rollback={pool['reclaimed_rollback_pages']} "
          f"branch={pool['reclaimed_branch_pages']} "
          f"prune={pool['reclaimed_prune_pages']} "
          f"preempt={pool['reclaimed_preempt_pages']} "
          f"retire={pool['reclaimed_retire_pages']}  "
          f"(cow_copies={pool['cow_copies']})")
    print(f"aggregate tokens/s (modeled, t=1): "
          f"{rep['tokens_per_cost']:.4f}")
    print(f"wall tokens/s ({rep['device']}): "
          f"{rep['total_tokens'] / max(wall, 1e-9):.1f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=2, default=float)
        print(f"report written to {args.json}")


if __name__ == "__main__":
    main()
