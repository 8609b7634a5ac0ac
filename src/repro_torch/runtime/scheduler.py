"""Sequential-request serving (port of ``repro.runtime.scheduler``): each
request runs its engine to completion in arrival order — the ``--mode
sequential`` baseline of ``launch.serve`` — with per-request stats and
an aggregate report whose metric definitions the batched scheduler
shares.  Request keys are split from one threefry key as in the
reference, so request i draws the reference's random numbers.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import torch

from repro_torch.runtime import prng
from repro_torch.runtime.cost_model import CostModel, percentile
from repro_torch.runtime.engines import Engine, GenResult


@dataclasses.dataclass
class Request:
    rid: int
    prompt: Sequence[int]
    max_new_tokens: int
    embeds: Optional[object] = None
    result: Optional[GenResult] = None
    wall_s: float = 0.0


def sequential_arrival_cost(timelines, cost: CostModel,
                            arrival_interval: float) -> float:
    """Modeled completion time of back-to-back sequential serving with
    staggered arrivals: the clock idles until request i arrives at
    ``i * arrival_interval`` (the batched scheduler's arrival model)."""
    clock = 0.0
    for i, tl in enumerate(timelines):
        clock = max(clock, i * arrival_interval)
        clock += cost.total(tl)
    return clock


class Scheduler:
    def __init__(self, engine: Engine):
        self.engine = engine

    def run(self, requests: List[Request], key: torch.Tensor
            ) -> List[Request]:
        """Serve ``requests`` in order; ``req.wall_s`` ends after the
        card has finished the request's work."""
        rec = self.engine.rec
        for req in requests:
            key, sub = prng.split(key)
            self.engine.trace_rid = req.rid   # tag this request's events
            if rec.enabled:
                rec.request("admit", req.rid, prompt_len=len(req.prompt),
                            max_new=req.max_new_tokens)
            t0 = time.time()
            req.result = self.engine.generate(
                list(req.prompt), req.max_new_tokens, sub,
                embeds=req.embeds)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            req.wall_s = time.time() - t0
            if rec.enabled:
                st = req.result.stats
                rec.finish(req.rid, emitted=st.emitted,
                           rollback_tokens=st.rollback_tokens,
                           pruned_tokens=st.pruned_tokens)
        return requests

    def aggregate(self, requests: List[Request], cost: CostModel) -> dict:
        done = [r for r in requests if r.result]
        reps = [r.result.report(cost) for r in done]
        if not reps:
            return {}
        keys = ("M", "speedup", "rollback_rate")
        agg = {k: sum(r[k] for r in reps) / len(reps) for k in keys}
        agg["total_tokens"] = sum(r["tokens"] for r in reps)
        agg["wall_s"] = sum(r.wall_s for r in requests)
        walls = [r.wall_s for r in done]
        agg["wall_p50"] = percentile(walls, 50)
        agg["wall_p95"] = percentile(walls, 95)
        # modeled aggregate throughput: requests run back to back, so the
        # total cost is the sum of per-request timeline costs
        total_cost = sum(cost.total(r.result.timeline) for r in done)
        agg["total_cost"] = total_cost
        agg["tokens_per_cost"] = agg["total_tokens"] / max(total_cost, 1e-9)
        return agg
