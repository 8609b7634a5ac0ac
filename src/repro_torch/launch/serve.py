"""Serving entry point of the PyTorch port (port of
``repro.launch.serve``).

Two modes, with the reference's default rule (batched for the engines
that have a batched implementation, sequential otherwise):

  * ``--mode batched`` — batched SpS or SpecBranch
    (``repro_torch.serving``), over paged
    KV (``--attn-backend paged``, the default, as in the reference) or
    the dense N-row caches (``--attn-backend dense``, the reference's
    equivalence oracle);
  * ``--mode sequential`` — each request runs its engine
    (``autoregressive``, ``sps``, ``adaedl``, ``lookahead``, ``pearl`` or
    ``specbranch``) to completion in arrival order over the dense ring
    cache (``runtime.scheduler``), with the reference's report.

Same flags and reports as the reference's, plus ``--device``
(default ``cuda``; ``cpu`` runs every kernel's plain PyTorch version).
``--trace PATH`` writes a Perfetto trace.json of the run, ``--metrics-out
PATH`` the metrics registry, and ``--profile-dir DIR`` a
``torch.profiler`` Chrome trace (with the loop's named ranges) into DIR,
in both modes.  ``--spec-predictor on|oracle`` installs the history
predictor; ``--draft-mode parallel`` drafts each chunk in one masked
forward through multi-position draft heads (``load_draft_heads``: the
reference's trained heads for the tiny pairs, read from its cache, or an
exit naming training when they are missing; seeded random heads for
``paper-llama``).  ``--prefix-cache on`` and ``--mesh`` exit with a
message naming the later slice.
``--pair`` takes the reference's pairs — the committed Zipf-Markov
``misaligned`` / ``aligned`` pairs and the tiny random-init SSM-bearing
``falcon-shaped`` / ``jamba-shaped`` pairs (their mamba state rides the
checkpoint ring in batched mode, checkpoint + replay in sequential
mode) — and two configs the reference defines, served at full width with
random weights from fixed seeds (target 0, draft 1; no checkpoint is
needed): ``paper-llama``, the paper's LLaMA-68M draft / LLaMA-7B target,
and ``falcon-mamba-7b`` with its ``draft()`` (2 Mamba layers, d 512),
both bf16 (``paper-llama``'s draft heads from seed 2).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \\
      --requests 8 --new-tokens 32 --pair paper-llama
  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \\
      --requests 8 --new-tokens 32 --pair falcon-mamba-7b
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --mode sequential --engine specbranch
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --mode batched --engine sps
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --attn-backend dense --trace trace.json --metrics-out m.json

H-RAD has no flag, as in the reference: it is reached through the
engines' ``hrad_params`` (``serve(..., hrad_params=...)`` here).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs import falcon_mamba_7b
from repro_torch.configs.paper_pairs import PAPER_PAIRS
from repro_torch.data.synthetic import ZipfMarkov
from repro_torch.models import model as M
from repro_torch.obs import (NULL_RECORDER, TraceRecorder, profiler_session,
                             write_metrics, write_trace)
from repro_torch.runtime import prng
from repro_torch.runtime.cost_model import CostModel
from repro_torch.runtime.engines import (AdaEDLEngine, AutoregressiveEngine,
                                         EngineConfig, LookaheadEngine,
                                         PEARLEngine, SpSEngine)
from repro_torch.runtime.scheduler import (Request, Scheduler,
                                           sequential_arrival_cost)
from repro_torch.runtime.specbranch import SpecBranchEngine
from repro_torch.serving import (BatchedSpecBranchEngine, BatchedSpSEngine,
                                 ContinuousBatchScheduler, ServeRequest)
from repro_torch.serving import device_loop as DL
from repro_torch.training.pairs import (HYBRID_KINDS, VOCAB,
                                        draft_heads_for, get_pair,
                                        hybrid_pair)

FULL_WIDTH = ("paper-llama", "falcon-mamba-7b")
PAIRS = ("misaligned", "aligned") + HYBRID_KINDS + FULL_WIDTH
SSM_PAIRS = HYBRID_KINDS + ("falcon-mamba-7b",)
HEADS_SEED = 2      # paper-llama's random draft heads (target 0, draft 1)

ENGINES = {
    "autoregressive": AutoregressiveEngine,
    "sps": SpSEngine,
    "adaedl": AdaEDLEngine,
    "lookahead": LookaheadEngine,
    "pearl": PEARLEngine,
    "specbranch": SpecBranchEngine,
}
# engines that also run batched (the default mode for them)
BATCHED_ENGINES = {
    "sps": BatchedSpSEngine,
    "specbranch": BatchedSpecBranchEngine,
}


def load_pair(kind: str, device):
    """(draft_params, draft_cfg, target_params, target_cfg): the committed
    Zipf-Markov pairs, the tiny random-init SSM-bearing pairs, or a
    full-width pair with random weights drawn on ``device`` (target seed
    0, draft seed 1): the paper's LLaMA 68M/7B, or falcon-mamba-7b with
    its ``draft()``."""
    if kind in FULL_WIDTH:
        if kind == "paper-llama":
            dcfg, tcfg, _c = PAPER_PAIRS["llama"]
        else:
            tcfg = falcon_mamba_7b.CONFIG
            dcfg = tcfg.draft()
        return (M.init_params(dcfg, 1, device), dcfg,
                M.init_params(tcfg, 0, device), tcfg)
    if kind in HYBRID_KINDS:
        return hybrid_pair(kind, device=device)
    return get_pair(kind, device=device)


def heads_k(ecfg: EngineConfig) -> int:
    """Draft heads a parallel-draft serve loads: enough for the longest
    chunk either stage drafts, at least 4 (the reference's rule)."""
    return max(ecfg.gamma, ecfg.gamma_branch, 4)


def load_draft_heads(pair_kind: str, ecfg: EngineConfig, pair, device):
    """Multi-position draft heads for ``draft_mode="parallel"``
    (DESIGN.md §7.12); None in sequential mode, where heads are inert.
    The tiny pairs' trained heads come from the reference's cache
    (``training.pairs.draft_heads_for``); ``paper-llama`` draws random
    heads from a seeded generator, as its weights are (``main`` has
    refused SSM-bearing pairs and non-drafting engines)."""
    if ecfg.draft_mode != "parallel":
        return None
    K = heads_k(ecfg)
    if pair_kind in FULL_WIDTH:
        gen = torch.Generator(device=device)
        gen.manual_seed(HEADS_SEED)
        return M.init_draft_heads(pair[1], K, gen, device)
    try:
        return draft_heads_for(pair_kind, K=K, device=device)
    except FileNotFoundError as e:
        raise SystemExit(str(e))


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
          arrival_interval: float = 0.0, engine: str = "specbranch",
          hrad_params=None, attn_backend: str = "paged",
          draft_heads=None, rec=NULL_RECORDER):
    """Build the batched ``engine`` (a name in ``BATCHED_ENGINES``; with
    an H-RAD MLP for SpecBranch, draft heads for parallel drafting) on
    ``attn_backend`` with the recorder ``rec`` and its scheduler, and
    serve ``prompts``.  Returns (results by rid, scheduler report,
    engine, wall seconds)."""
    dp, dcfg, tp, tcfg = pair
    eng = BATCHED_ENGINES[engine](
        dp, dcfg, tp, tcfg, ecfg, max_batch=max_batch,
        page_size=page_size, pool_pages=pool_pages, swap_pages=swap_pages,
        hrad_params=hrad_params, attn_backend=attn_backend,
        draft_heads=draft_heads, device=device)
    eng.set_recorder(rec)        # before the scheduler picks up eng.rec
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


def build_engine(engine, pair, ecfg: EngineConfig, hrad_params=None,
                 draft_heads=None):
    """A sequential engine from its name in ``ENGINES`` or its class
    (SpecBranch with the H-RAD MLP ``hrad_params``, if given; the
    drafting engines with ``draft_heads``)."""
    cls = ENGINES[engine] if isinstance(engine, str) else engine
    dp, dcfg, tp, tcfg = pair
    if cls in (AutoregressiveEngine, LookaheadEngine):   # target only
        return cls(tp, tcfg, ecfg)
    if cls is SpecBranchEngine:
        return cls(dp, dcfg, tp, tcfg, ecfg, hrad_params=hrad_params,
                   draft_heads=draft_heads)
    return cls(dp, dcfg, tp, tcfg, ecfg, draft_heads=draft_heads)


def serve_sequential(pair, ecfg: EngineConfig, engine, prompts,
                     new_tokens: int, *, seed: int = 0, hrad_params=None,
                     draft_heads=None, rec=NULL_RECORDER):
    """Run ``prompts`` one after another through the sequential
    ``engine`` (a name in ``ENGINES`` or an engine class) with the
    recorder ``rec``; request keys split from ``PRNGKey(seed)`` as the
    reference's ``launch.serve`` does.  Returns (requests, scheduler,
    wall s)."""
    eng = build_engine(engine, pair, ecfg, hrad_params, draft_heads)
    eng.set_recorder(rec)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    sched = Scheduler(eng)
    t0 = time.time()
    done = sched.run(reqs, key=prng.PRNGKey(seed))
    return done, sched, time.time() - t0


def run_sequential(args, ecfg: EngineConfig, prompts, pair, device,
                   rec=NULL_RECORDER) -> dict:
    done, sched, wall = serve_sequential(
        pair, ecfg, args.engine, prompts, args.new_tokens, rec=rec,
        draft_heads=load_draft_heads(args.pair, ecfg, pair, device))
    cost = CostModel(c=args.c)
    agg = sched.aggregate(done, cost)
    if args.arrival_interval > 0:
        clock = sequential_arrival_cost(
            [r.result.timeline for r in done], cost, args.arrival_interval)
        agg["total_cost"] = clock
        agg["tokens_per_cost"] = agg["total_tokens"] / max(clock, 1e-9)
    agg["device"] = _device_name(device)
    print(f"\n== sequential {args.engine} on {args.pair} pair "
          f"({agg['device']}): {len(done)} requests, {wall:.1f}s wall ==")
    for r in done:
        rep = r.result.report(cost)
        print(f"req {r.rid}: {rep['tokens']} tok  M={rep['M']:.2f} "
              f"speedup={rep['speedup']:.2f}x  RB={rep['rollback_rate']:.2f}")
    print(f"wall per request: p50={agg['wall_p50']:.2f}s "
          f"p95={agg['wall_p95']:.2f}s")
    print(f"aggregate tokens/s (modeled, t=1): "
          f"{agg['tokens_per_cost']:.4f}")
    print(f"wall tokens/s ({agg['device']}): "
          f"{agg['total_tokens'] / max(wall, 1e-9):.1f}")
    return agg


def _device_name(device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _unsupported(args) -> Optional[str]:
    checks = [
        (args.prefix_cache != "off", "--prefix-cache on"),
        (args.mesh is not None, "--mesh"),
    ]
    for bad, what in checks:
        if bad:
            return (f"{what} is not in this slice of the PyTorch port; "
                    "see ROADMAP.md queue A, or run the reference: "
                    "python -m repro.launch.serve")
    return None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="specbranch", choices=list(ENGINES))
    ap.add_argument("--mode", default=None,
                    choices=["sequential", "batched"])
    ap.add_argument("--pair", default="misaligned", choices=PAIRS,
                    help="misaligned/aligned: the reference's trained "
                    "pairs (cached checkpoints); falcon-shaped/"
                    "jamba-shaped: tiny random-init SSM pairs; "
                    "paper-llama, falcon-mamba-7b: full width, bf16, "
                    "random weights")
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
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace.json of the run")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="dump the metrics registry; .json -> JSON, else "
                    "plain text")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="also run a torch.profiler session (CUDA activity "
                    "on the card, CPU activity on the CPU) with the loop's "
                    "named ranges and write its Chrome trace into DIR")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; a CUDA device without a "
                    "visible card is an error, never a CPU fallback")
    args = ap.parse_args(argv)
    if args.mode is None:
        args.mode = ("batched" if args.engine in BATCHED_ENGINES
                     else "sequential")
    if args.draft_mode == "parallel" and args.pair in SSM_PAIRS:
        raise SystemExit("--draft-mode parallel needs an attention-only "
                         f"draft model; --pair {args.pair} has mamba "
                         "layers")
    if args.draft_mode == "parallel" and args.engine not in ("sps",
                                                             "specbranch"):
        raise SystemExit("--draft-mode parallel requires a drafting "
                         f"engine (sps/specbranch), not {args.engine}")
    if args.mode == "batched" and args.engine not in BATCHED_ENGINES:
        raise SystemExit(
            f"--mode batched supports {sorted(BATCHED_ENGINES)}; "
            f"run --engine {args.engine} with --mode sequential")
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
                        temperature=args.temperature,
                        spec_predictor=args.spec_predictor,
                        draft_mode=args.draft_mode, max_len=max_len)
    try:
        pair = load_pair(args.pair, device)
    except FileNotFoundError as e:
        raise SystemExit(str(e))
    tracing = bool(args.trace or args.metrics_out or args.profile_dir)
    rec = TraceRecorder() if tracing else NULL_RECORDER
    if args.profile_dir:
        DL.set_trace_annotations(True)
    try:
        with profiler_session(args.profile_dir, device):
            if args.mode == "sequential":
                rep = run_sequential(args, ecfg, prompts, pair, device, rec)
            else:
                rep = run_batched(args, ecfg, prompts, pair, device, rec)
    finally:
        DL.set_trace_annotations(False)
    if args.profile_dir:
        print(f"profiler trace written to {args.profile_dir}")
    if args.trace:
        write_trace(rec, args.trace)
        print(f"trace written to {args.trace} "
              f"({len(rec.events)} events; open at https://ui.perfetto.dev)")
    if args.metrics_out:
        write_metrics(rec.registry, args.metrics_out)
        print(f"metrics written to {args.metrics_out}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=2, default=float)
        print(f"report written to {args.json}")


def run_batched(args, ecfg: EngineConfig, prompts, pair, device,
                rec=NULL_RECORDER) -> dict:
    results, rep, eng, wall = serve(
        pair, ecfg, prompts, args.new_tokens, device=device,
        max_batch=args.max_batch, page_size=args.page_size,
        pool_pages=args.pool_pages, swap_pages=args.swap_pages,
        arrival_interval=args.arrival_interval, engine=args.engine,
        attn_backend=args.attn_backend, rec=rec,
        draft_heads=load_draft_heads(args.pair, ecfg, pair, device))
    rep["device"] = _device_name(device)
    print(f"\n== batched {args.engine} on {args.pair} pair ({rep['device']}): "
          f"{len(results)} requests, max_batch={args.max_batch}, "
          f"{wall:.1f}s wall ==")
    for rid in sorted(results):
        r = results[rid]
        print(f"req {rid}: {len(r.tokens)} tok  M={r.stats.mean_accepted:.2f}"
              f"  RB={r.stats.rollback_rate:.2f}")
    pool = rep["pool"]
    print(f"rounds: {rep['rounds']}  preemptions: {rep['preemptions']}"
          f"  dispatches/round: "
          f"{rep.get('dispatches_per_round', float('nan')):.2f}")
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
    return rep


if __name__ == "__main__":
    main()
