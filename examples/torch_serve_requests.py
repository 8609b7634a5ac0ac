"""End-to-end serving with the PyTorch port (the port of
``serve_requests.py``): requests through the scheduler with the full
SpecBranch stack (H-RAD + branch parallelism), plus the per-request and
aggregate serving report.

  PYTHONPATH=src python examples/torch_serve_requests.py [n_requests] \\
      [trace.json] [--device cpu] [--prefix-cache on] [--new-tokens N]

The default run serves the requests one after another through the
sequential SpecBranch engine, as the reference example does.  H-RAD uses
the trained MLP that the reference caches in ``.cache/pairs``
(``hrad-misaligned-K4.npz``, written by ``examples/serve_requests.py``)
or else the port's own (``.cache/torch_pairs``), which
``training.pairs.hrad_for_pair`` trains on the device at first use, as
the reference's benchmarks do.  A second argument records a
speculation-aware trace (open it at https://ui.perfetto.dev).

``--prefix-cache on`` serves instead through the batched paged
SpecBranch engine with the cross-request prefix cache (DESIGN.md
§7.13): the requests share a 32-token system prompt and arrive one after
another, so every request after the first binds the cached prompt pages
zero-copy and prefills only its own suffix.  The report then carries the
``prefix_cache`` block (hits, saved tokens, published and evicted runs).
The serving CLI exposes the same switch:

  PYTHONPATH=src python -m repro_torch.launch.serve --prefix-cache on

Runs on the GPU unless ``--device cpu`` is given (every kernel's plain
PyTorch version then); a missing GPU is an error, never a fallback.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.data.synthetic import ZipfMarkov  # noqa: E402
from repro_torch.obs import (NULL_RECORDER, TraceRecorder,  # noqa: E402
                             write_trace)
from repro_torch.runtime import prng  # noqa: E402
from repro_torch.runtime.cost_model import CostModel  # noqa: E402
from repro_torch.runtime.scheduler import Request, Scheduler  # noqa: E402
from repro_torch.runtime.specbranch import SpecBranchEngine  # noqa: E402
from repro_torch.serving import (BatchedSpecBranchEngine,  # noqa: E402
                                 ContinuousBatchScheduler, ServeRequest)
from repro_torch.training.pairs import (VOCAB, default_ecfg,  # noqa: E402
                                        get_pair, hrad_for_pair)

SYSTEM_PROMPT_LEN = 32
SUFFIX_LEN = 8



def serve_sequential(pair, ecfg, hrad, n_req: int, n_new: int,
                     rec) -> None:
    engine = SpecBranchEngine(*pair, ecfg, hrad_params=hrad)
    engine.set_recorder(rec)
    zm = ZipfMarkov(vocab=VOCAB, seed=7)
    reqs = [Request(rid=i, prompt=[int(t) for t in p],
                    max_new_tokens=n_new)
            for i, p in enumerate(zm.prompts(n_req, 14, seed=21))]
    sched = Scheduler(engine)
    done = sched.run(reqs, prng.PRNGKey(0))
    cost = CostModel(c=ecfg.c)
    print(f"{'rid':>4s} {'tokens':>7s} {'M':>6s} {'speedup':>8s} "
          f"{'RB':>6s} {'wall_s':>7s}")
    for r in done:
        rep = r.result.report(cost)
        print(f"{r.rid:4d} {rep['tokens']:7.0f} {rep['M']:6.2f} "
              f"{rep['speedup']:8.2f} {rep['rollback_rate']:6.2f} "
              f"{r.wall_s:7.2f}")
    print(f"\naggregate: {sched.aggregate(done, cost)}")


def shared_prompts(n_req: int):
    """``n_req`` prompts: one shared system prompt, then each request's
    own suffix (Zipf-Markov samples, fixed seeds)."""
    zm = ZipfMarkov(vocab=VOCAB, seed=7)
    system = [int(t) for t in zm.prompts(1, SYSTEM_PROMPT_LEN, seed=5)[0]]
    return [system + [int(t) for t in p]
            for p in zm.prompts(n_req, SUFFIX_LEN, seed=21)]


def serve_prefix_cached(pair, ecfg, hrad, n_req: int, n_new: int, device,
                        rec) -> dict:
    engine = BatchedSpecBranchEngine(
        *pair, ecfg, max_batch=4, hrad_params=hrad, attn_backend="paged",
        prefix_cache=True, device=device)
    engine.set_recorder(rec)       # before the scheduler picks up eng.rec
    sched = ContinuousBatchScheduler(engine)
    # one arrival at a time: each request retires, and publishes its
    # prompt prefix, before the next one arrives
    res = sched.run([ServeRequest(rid=i, prompt=p,
                                  max_new_tokens=n_new,
                                  arrival=1000.0 * i)
                     for i, p in enumerate(shared_prompts(n_req))])
    print(f"{'rid':>4s} {'tokens':>7s} {'M':>6s} {'RB':>6s}")
    for rid in sorted(res):
        st = res[rid].stats
        print(f"{rid:4d} {len(res[rid].tokens):7d} {st.mean_accepted:6.2f} "
              f"{st.rollback_rate:6.2f}")
    rep = sched.report()
    pc = rep["prefix_cache"]
    print(f"\nprefix cache: hits={pc['hits']}/{pc['lookups']} "
          f"saved_tokens={pc['saved_tokens']} "
          f"published={pc['published_runs']} "
          f"evicted={pc['evicted_runs']}")
    print(f"TTFT p50 (modeled): {rep['ttft_p50']:.1f}  "
          f"aggregate tokens/s (modeled, t=1): "
          f"{rep['tokens_per_cost']:.4f}")
    return rep


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("n_requests", nargs="?", type=int, default=4)
    ap.add_argument("trace", nargs="?", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    ap.add_argument("--prefix-cache", default="off", choices=["off", "on"])
    ap.add_argument("--new-tokens", type=int, default=32)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    kind = "misaligned"
    pair = get_pair(kind, device=device)
    ecfg = default_ecfg(kind)
    hrad = hrad_for_pair(kind, device=device)
    rec = TraceRecorder() if args.trace else NULL_RECORDER
    if args.prefix_cache == "on":
        serve_prefix_cached(pair, ecfg, hrad, args.n_requests,
                            args.new_tokens, device, rec)
    else:
        serve_sequential(pair, ecfg, hrad, args.n_requests, args.new_tokens,
                         rec)
    if args.trace:
        write_trace(rec, args.trace)
        print(f"trace written to {args.trace} ({len(rec.events)} events); "
              f"open it at https://ui.perfetto.dev")


if __name__ == "__main__":
    main()
