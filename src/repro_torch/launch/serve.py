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
``paper-llama``).  ``--prefix-cache on`` (batched mode, paged backend)
shares published prompt-prefix pages across requests
(``serving.prefix_cache``) and adds the reference's ``prefix cache:``
line and report block; it exits, as in the reference, in sequential mode
and with ``--attn-backend dense``.  ``--mesh DP,TP`` (batched mode)
serves on a DP x TP serving mesh (DESIGN.md §7.10): validated before the
pair loads, as in the reference, then one process per rank
(``launch.mesh.spawn``) — NCCL with one card per rank for ``--device
cuda``, gloo processes for ``--device cpu`` — each loading the pair and
serving its shard of it, and rank 0 printing the report (and writing
``--json`` / ``--trace`` / ``--metrics-out``).  ``--mesh 1,1`` is the
unmeshed serve.  ``serve_jobs`` is the rank target that tests and
``chip_smoke.py`` spawn to serve on a mesh.
``--pair`` takes the reference's pairs — the committed Zipf-Markov
``misaligned`` / ``aligned`` pairs and the tiny random-init SSM-bearing
``falcon-shaped`` / ``jamba-shaped`` pairs (their mamba state rides the
checkpoint ring in batched mode, checkpoint + replay in sequential
mode) — and configs the reference defines, served at full width with
random weights from fixed seeds (target 0, draft 1; no checkpoint is
needed): ``paper-llama``, the paper's LLaMA-68M draft / LLaMA-7B target,
and every assigned architecture that decodes (``configs.ARCH_IDS`` but
the encoder-only hubert-xlarge), e.g. ``falcon-mamba-7b``,
``gemma3-4b`` or ``granite-moe-3b-a800m`` (whose draft's 3 heads of 85
run on the attention kernels' ragged path), with its ``draft()``; all
bf16 (random draft heads from seed 2 in parallel draft mode).  The largest (grok-1-314b,
jamba-1.5-large-398b, gemma2-27b at bf16) do not fit one 80 GB card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \\
      --requests 8 --new-tokens 32 --pair paper-llama
  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \\
      --requests 8 --new-tokens 32 --pair falcon-mamba-7b
  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \\
      --requests 8 --new-tokens 32 --pair gemma3-4b
  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \\
      --requests 8 --new-tokens 16 --pair granite-moe-3b-a800m
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --mode sequential --engine specbranch
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --mode batched --engine sps
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --attn-backend dense --trace trace.json --metrics-out m.json
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --prefix-cache on
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --mode batched --mesh 1,2

H-RAD has no flag, as in the reference: it is reached through the
engines' ``hrad_params`` (``serve(..., hrad_params=...)`` here).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.paper_pairs import PAPER_PAIRS
from repro_torch.data.synthetic import ZipfMarkov
from repro_torch.kernels import ops
from repro_torch.launch import mesh as MESH
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
from repro_torch.sharding.hlo_analysis import collective_counts
from repro_torch.training.optim import tree_map
from repro_torch.training.pairs import (HYBRID_KINDS, VOCAB,
                                        draft_heads_for, get_pair,
                                        hybrid_pair)

# the assigned architectures that decode, served with their draft()
ARCH_PAIRS = tuple(a for a in ARCH_IDS if get_config(a).supports_decode())
FULL_WIDTH = ("paper-llama",) + ARCH_PAIRS
PAIRS = ("misaligned", "aligned") + HYBRID_KINDS + FULL_WIDTH
SSM_PAIRS = HYBRID_KINDS + tuple(
    a for a in ARCH_PAIRS if any(m == "mamba" for m, _ in
                                 get_config(a).pattern))
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
    0, draft seed 1): the paper's LLaMA 68M/7B, or an assigned
    architecture (``ARCH_PAIRS``) with its ``draft()``."""
    if kind in FULL_WIDTH:
        if kind == "paper-llama":
            dcfg, tcfg, _c = PAPER_PAIRS["llama"]
        else:
            tcfg = get_config(kind)
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
    The tiny pairs' trained heads come from ``training.pairs.
    draft_heads_for`` (the reference's cache, the port's, or trained on
    the device at first use); ``paper-llama`` draws random
    heads from a seeded generator, as its weights are (``main`` has
    refused SSM-bearing pairs and non-drafting engines)."""
    if ecfg.draft_mode != "parallel":
        return None
    K = heads_k(ecfg)
    if pair_kind in FULL_WIDTH:
        gen = torch.Generator(device=device)
        gen.manual_seed(HEADS_SEED)
        return M.init_draft_heads(pair[1], K, gen, device)
    return draft_heads_for(pair_kind, K=K, device=device)


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
          draft_heads=None, prefix_cache: bool = False, arrivals=None,
          rec=NULL_RECORDER, mesh=None, debug_check: bool = False):
    """Build the batched ``engine`` (a name in ``BATCHED_ENGINES``; with
    an H-RAD MLP for SpecBranch, draft heads for parallel drafting, the
    prefix cache when ``prefix_cache``) on ``attn_backend`` with the
    recorder ``rec`` and its scheduler, and serve ``prompts``, request i
    arriving at ``arrivals[i]`` on the modeled clock (default ``i *
    arrival_interval``); on this rank's shard of ``mesh`` when given, and
    with the engine's per-round invariant checks when ``debug_check``.
    Returns (results by rid, scheduler report, engine, wall seconds)."""
    dp, dcfg, tp, tcfg = pair
    eng = BATCHED_ENGINES[engine](
        dp, dcfg, tp, tcfg, ecfg, max_batch=max_batch,
        page_size=page_size, pool_pages=pool_pages, swap_pages=swap_pages,
        hrad_params=hrad_params, attn_backend=attn_backend,
        draft_heads=draft_heads, prefix_cache=prefix_cache, device=device,
        mesh=mesh, debug_check=debug_check)
    eng.set_recorder(rec)        # before the scheduler picks up eng.rec
    sched = ContinuousBatchScheduler(eng)
    if arrivals is None:
        arrivals = [i * arrival_interval for i in range(len(prompts))]
    reqs = [ServeRequest(rid=i, prompt=p, max_new_tokens=new_tokens,
                         arrival=a)
            for i, (p, a) in enumerate(zip(prompts, arrivals))]
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


# ---------------------------------------------------------------------------
# serving on a mesh
# ---------------------------------------------------------------------------

def forward_census(eng, mesh) -> Dict[str, Dict[str, int]]:
    """The collectives one target verify forward issues (a fresh engine's
    decoder stepping 4 tokens on every row, as the reference's census
    lowers it) and those one ``copy_page`` issues, by ``kind@n``; with
    the forward's recorded bytes by ``kind@n`` (``forward_bytes``)."""
    dec = eng.tgt_dec
    mesh.census.reset()
    dec.step(np.zeros((dec.n_rows, 4), np.int32),
             np.zeros(dec.n_rows, np.int64))
    fwd = collective_counts(mesh.census)
    fwd_bytes = mesh.census.raw_bytes()
    mesh.census.reset()
    if dec.state.paged is not None:
        dec.copy_page(0, 1)
    page = collective_counts(mesh.census)
    mesh.census.reset()
    return {"forward": fwd, "copy_page": page, "forward_bytes": fwd_bytes}


def _job_pair(job: Dict[str, Any], device):
    """A job's pair as full host trees: ``pair`` as given, or the weights
    of ``pair_kind`` drawn on ``device`` (the draws an unmeshed serve
    there makes) and moved to the host, so that the device holds only
    the shards the engine cuts from them."""
    if "pair" in job:
        return job["pair"]
    dp, dcfg, tp, tcfg = load_pair(job["pair_kind"], device)
    return (tree_map(torch.Tensor.cpu, dp), dcfg,
            tree_map(torch.Tensor.cpu, tp), tcfg)


def _job_engine_kw(job: Dict[str, Any]) -> Dict[str, Any]:
    return dict(engine=job.get("engine", "specbranch"),
                max_batch=job.get("max_batch", 8),
                page_size=job.get("page_size", 16),
                pool_pages=job.get("pool_pages"),
                attn_backend=job.get("attn_backend", "paged"))


def _job_census(mesh, job: Dict[str, Any], pair) -> Dict[str, Any]:
    kw = _job_engine_kw(job)
    eng = BATCHED_ENGINES[kw.pop("engine")](*pair, job["ecfg"], mesh=mesh,
                                            **kw)
    return forward_census(eng, mesh)


def _serve_job(mesh, job: Dict[str, Any]) -> Dict[str, Any]:
    dev = mesh.device
    pair = _job_pair(job, dev)
    out: Dict[str, Any] = {"name": job.get("name")}
    if job.get("census"):
        out["census"] = _job_census(mesh, job, pair)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    mesh.census.reset()
    results, rep, eng, wall = serve(
        pair, job["ecfg"], job["prompts"], job["new_tokens"], device=dev,
        swap_pages=job.get("swap_pages", 256),
        hrad_params=job.get("hrad_params"), mesh=mesh, debug_check=True,
        **_job_engine_kw(job))
    eng.pool.check()
    out.update(
        tokens={rid: [int(t) for t in r.tokens]
                for rid, r in results.items()},
        pages_in_use=eng.pool.pages_in_use,
        pool=eng.pool.stats.as_dict(),
        rounds=rep["rounds"], wall=wall,
        total_tokens=rep["total_tokens"],
        launches=dict(ops.LAUNCHES),
        collectives=collective_counts(mesh.census),
        peak_bytes=(torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else 0))
    return out


def serve_jobs(mesh, jobs: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Rank target (``launch.mesh.spawn``): ``serve`` each job on this
    rank's shard of ``mesh``, with ``debug_check`` on.  A job names the
    pair (``pair``, a (draft params, draft cfg, target params, target
    cfg) tuple of full CPU tensors, or ``pair_kind`` for ``load_pair``),
    ``ecfg``, ``prompts``, ``new_tokens`` and ``serve``'s knobs
    (``engine``, ``attn_backend``, ``max_batch``, ``page_size``,
    ``pool_pages``, ``swap_pages``, ``hrad_params``); with ``census`` a
    fresh engine first takes ``forward_census``.  Returns per job: the
    streams by rid, pool pages in use and stats, rounds, wall seconds,
    kernel launches and collectives of the serve, and its peak device
    memory from the engine's build on (CUDA)."""
    return [_serve_job(mesh, job) for job in jobs]


def _mesh_devices(device: str, n: int):
    """Backend and per-rank devices of an ``n``-rank CLI mesh: NCCL with
    one card per rank for CUDA, gloo processes for the CPU."""
    if torch.device(device).type == "cuda":
        return "nccl", [f"cuda:{i}" for i in range(n)]
    return "gloo", ["cpu"] * n


def _cli_rank(mesh, argv: List[str]) -> Dict[str, Any]:
    """Rank target of ``--mesh``: the whole CLI run on this rank's shard;
    rank 0 prints and writes, the others run silent."""
    args = _parse(argv)
    if mesh.rank == 0:
        return _run(args, mesh)
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        return _run(args, mesh)


def _parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="specbranch", choices=list(ENGINES))
    ap.add_argument("--mode", default=None,
                    choices=["sequential", "batched"])
    ap.add_argument("--pair", default="misaligned", choices=PAIRS,
                    help="misaligned/aligned: the reference's trained "
                    "pairs (cached checkpoints); falcon-shaped/"
                    "jamba-shaped: tiny random-init SSM pairs; "
                    "paper-llama and the assigned architectures that "
                    "decode (with their draft(); granite-moe-3b-a800m's "
                    "at head dim 85): full width, bf16, random weights")
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
    ap.add_argument("--mesh", default=None, metavar="DP,TP",
                    help="serving mesh (batched mode): DP-way data "
                    "parallelism over dense cache rows x TP-way tensor "
                    "parallelism over attention heads / MLP hidden, one "
                    "process per rank (NCCL, one card each, with --device "
                    "cuda; gloo with --device cpu).  TP must divide both "
                    "models' head counts.  1,1: the unmeshed serve")
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
    if args.prefix_cache == "on":
        if args.mode != "batched":
            raise SystemExit("--prefix-cache on requires --mode batched "
                             "(sequential engines have no page pool)")
        if args.attn_backend == "dense":
            raise SystemExit(
                "--prefix-cache on is incompatible with --attn-backend "
                "dense: dense rows hold a private KV copy per request, so "
                "there are no page runs to share zero-copy.  Use "
                "--attn-backend paged (the default), or drop "
                "--prefix-cache to keep the dense equivalence oracle.")
    if args.mesh is not None:
        if args.mode != "batched":
            raise SystemExit("--mesh requires --mode batched")
        try:
            # fail fast (syntax + device count) BEFORE the pair loads; the
            # head checks run once the model configs are known
            args.mesh_dims = MESH.parse_mesh_arg(args.mesh)
            MESH.validate_serving_mesh(*args.mesh_dims, device=args.device)
        except ValueError as e:
            raise SystemExit(str(e))
    return args


def main(argv=None) -> None:
    args = _parse(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    dims = getattr(args, "mesh_dims", (1, 1))
    if dims == (1, 1):
        _run(args)
        return
    dp, tp = dims
    cfgs = _pair_configs(args.pair)
    try:
        MESH.validate_serving_mesh(dp, tp, configs=cfgs, device=device)
    except ValueError as e:
        raise SystemExit(str(e))
    backend, devices = _mesh_devices(args.device, dp * tp)
    argv = list(sys.argv[1:] if argv is None else argv)
    # CPU ranks share the host's cores (each with them all, the ranks'
    # intra-op threads oversubscribe the host many times over)
    threads = (max(1, (os.cpu_count() or 1) // (dp * tp))
               if backend == "gloo" else 0)
    MESH.spawn(dp, tp, "repro_torch.launch.serve:_cli_rank", argv,
               backend=backend, devices=devices, timeout_s=3600.0,
               threads=threads)


def _pair_configs(kind: str):
    """(draft cfg, target cfg) of ``--pair kind`` without its weights."""
    if kind == "paper-llama":
        dcfg, tcfg, _c = PAPER_PAIRS["llama"]
        return dcfg, tcfg
    if kind in FULL_WIDTH:
        return get_config(kind).draft(), get_config(kind)
    pair = load_pair(kind, "cpu")
    return pair[1], pair[3]


def _run(args, mesh=None) -> dict:
    """Serve as ``args`` say (on this rank's shard of ``mesh``, when
    given; only rank 0 writes files) and return the report."""
    device = mesh.device if mesh is not None \
        else resolve_device(args.device)
    lead = mesh is None or mesh.rank == 0
    prompts = make_prompts(args.requests)
    max_len = args.max_len or auto_max_len(prompts, args.new_tokens,
                                           args.gamma, args.c)
    ecfg = EngineConfig(gamma=args.gamma, c=args.c,
                        temperature=args.temperature,
                        spec_predictor=args.spec_predictor,
                        draft_mode=args.draft_mode, max_len=max_len)
    pair = load_pair(args.pair, device)
    tracing = bool(args.trace or args.metrics_out or args.profile_dir)
    rec = TraceRecorder() if tracing else NULL_RECORDER
    if args.profile_dir:
        DL.set_trace_annotations(True)
    try:
        with profiler_session(args.profile_dir, device):
            if args.mode == "sequential":
                rep = run_sequential(args, ecfg, prompts, pair, device, rec)
            else:
                rep = run_batched(args, ecfg, prompts, pair, device, rec,
                                  mesh=mesh)
    finally:
        DL.set_trace_annotations(False)
    if not lead:
        return rep
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
    return rep


def run_batched(args, ecfg: EngineConfig, prompts, pair, device,
                rec=NULL_RECORDER, mesh=None) -> dict:
    results, rep, eng, wall = serve(
        pair, ecfg, prompts, args.new_tokens, device=device,
        max_batch=args.max_batch, page_size=args.page_size,
        pool_pages=args.pool_pages, swap_pages=args.swap_pages,
        arrival_interval=args.arrival_interval, engine=args.engine,
        attn_backend=args.attn_backend, rec=rec,
        prefix_cache=args.prefix_cache == "on", mesh=mesh,
        draft_heads=load_draft_heads(args.pair, ecfg, pair, device))
    rep["device"] = _device_name(device)
    where = rep["device"]
    if mesh is not None:
        where += (f", mesh {mesh.shape['data']}x{mesh.shape['model']} "
                  f"({mesh.backend})")
    print(f"\n== batched {args.engine} on {args.pair} pair ({where}): "
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
    if "prefix_cache" in rep:
        pc = rep["prefix_cache"]
        print(f"prefix cache: hits={pc['hits']}/{pc['lookups']} "
              f"saved_tokens={pc['saved_tokens']} "
              f"published={pc['published_runs']} "
              f"evicted={pc['evicted_runs']}")
    print(f"aggregate tokens/s (modeled, t=1): "
          f"{rep['tokens_per_cost']:.4f}")
    print(f"wall tokens/s ({rep['device']}): "
          f"{rep['total_tokens'] / max(wall, 1e-9):.1f}")
    return rep


if __name__ == "__main__":
    main()
