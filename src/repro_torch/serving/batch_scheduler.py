"""Continuous-batching scheduler (port of ``repro.serving.batch_scheduler``,
DESIGN.md §7.3).

Requests are admitted and retired at *step* (engine-round) granularity: a
request that arrives while others are mid-generation joins the very next
round, and a finished request frees its rows and pages immediately — no
static batch boundaries.

Policies:

  * **Admission** — strict FIFO by arrival time.  The queue head blocks
    admission until it fits (rows + pool pages + one round of slack);
    later requests are never admitted around it, which makes starvation
    impossible: every admitted set is a prefix of the arrival order, and
    every active request participates in every round.
  * **Preemption** — when the pool cannot cover a round's worst case, the
    engine evicts the *youngest* admitted request (FIFO-preserving) and the
    scheduler re-queues it at the front; generated tokens stand (they were
    already streamed) and its target KV is restored from the paged swap
    store — or recomputed — at re-admission.
  * **Streaming** — per-request ``on_token(rid, token, t_model)`` callbacks
    fire in commit order within a round, never beyond ``max_new_tokens``.

The modeled clock only advances with engine rounds; when the batch is empty
it jumps to the next arrival (an idle server).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.runtime.engines import GenResult
from repro_torch.serving.metrics import ServingMetrics


@dataclasses.dataclass
class ServeRequest:
    rid: int
    prompt: Sequence[int]
    max_new_tokens: int
    arrival: float = 0.0             # modeled time units (CostModel t)
    on_token: Optional[Callable[[int, int, float], None]] = None


class ContinuousBatchScheduler:
    def __init__(self, engine, metrics: Optional[ServingMetrics] = None):
        self.engine = engine
        self.metrics = metrics if metrics is not None else ServingMetrics()
        # observability: pick up whatever recorder the engine carries
        # (NULL_RECORDER by default) and mirror scheduler-side aggregates
        # into its registry so one dump carries both layers.
        self.rec = getattr(engine, "rec", None)
        if self.rec is not None and self.rec.enabled:
            self.metrics.attach_registry(self.rec.registry)

    # ------------------------------------------------------------------ run
    def run(self, requests: List[ServeRequest]) -> Dict[int, GenResult]:
        eng = self.engine
        queue = deque(sorted(requests, key=lambda r: (r.arrival, r.rid)))
        rec = self.rec if (self.rec is not None and self.rec.enabled) \
            else None
        for r in queue:
            self.metrics.on_arrival(r.rid, r.arrival)
            if rec is not None:
                rec.request("arrival", r.rid, t=r.arrival,
                            prompt_len=len(r.prompt),
                            max_new=r.max_new_tokens)
        results: Dict[int, GenResult] = {}

        while queue or eng.active:
            self._admit(queue)
            if rec is not None:
                rec.sample("queue_depth", len(queue), t=eng.clock)
            if not eng.active:
                # idle server: jump the clock to the next arrival
                assert queue, "scheduler stuck with an empty batch"
                nxt = queue[0].arrival
                if nxt <= eng.clock and not eng.can_admit(
                        *self._admit_dims(queue[0])):
                    raise RuntimeError(
                        f"request {queue[0].rid} can never be admitted "
                        "(pool or row capacity too small)")
                eng.clock = max(eng.clock, nxt)
                continue
            t0 = time.time()
            n_rnd0 = len(eng.timeline)
            rr = eng.step_round()
            step_wall = time.time() - t0
            now = eng.clock
            for rid, n in rr["committed"].items():
                if n > 0:
                    self.metrics.on_tokens(rid, n, now)
            for victim in rr["preempted"]:
                self.metrics.on_preempt(victim.rid)
                queue.appendleft(ServeRequest(
                    rid=victim.rid, prompt=victim.prompt,
                    max_new_tokens=victim.max_new,
                    arrival=victim_arrival(self.metrics, victim.rid),
                    on_token=victim.on_token))
            for seq, res in eng.retire_done():
                results[seq.rid] = res
                self.metrics.on_finish(seq.rid, now)
            last_rnd = (eng.timeline[-1]
                        if len(eng.timeline) > n_rnd0 else None)
            pool = eng.pool
            self.metrics.on_round(
                pool.occupancy, step_wall=step_wall,
                # measured dispatches ride the round tuple in parallel
                # draft mode; sequential rounds imply one forward per
                # draft step plus the target calls
                dispatches=(None if last_rnd is None
                            else (int(last_rnd[3]) if len(last_rnd) > 3
                                  else int(last_rnd[1]) + int(last_rnd[2]))),
                logical_occupancy=getattr(pool, "logical_occupancy", None),
                shared_pages=getattr(pool, "shared_pages", None))
            if rec is not None:
                rec.sample("pool_occupancy", pool.occupancy, t=eng.clock)
                shared = getattr(pool, "shared_pages", None)
                if shared:
                    rec.sample("pool_shared_pages", shared, t=eng.clock)
        return results

    # ------------------------------------------------------------ admission
    def _admit_dims(self, req: ServeRequest) -> tuple:
        """(prompt length incl. resumed tokens, remaining new tokens)."""
        resumed = self.engine.resume_out_len(req.rid)
        return (len(req.prompt) + resumed,
                max(0, req.max_new_tokens - resumed))

    def _admit(self, queue: deque) -> None:
        """Admit the longest admissible FIFO prefix as ONE group: requests
        are reserved (rows + pool bookkeeping) one by one, then the whole
        group's prompts are ingested by batched bucketed prefill — one
        forward per (decoder, prefill-ladder rung) per admission round
        (DESIGN.md §7.8), not one per request."""
        eng = self.engine
        admitted = 0
        while queue and queue[0].arrival <= eng.clock:
            req = queue[0]
            if not eng.can_admit(*self._admit_dims(req)):
                break                      # FIFO: never admit around the head
            queue.popleft()
            eng.reserve(req.rid, req.prompt, req.max_new_tokens,
                        on_token=req.on_token)
            self.metrics.on_admit(req.rid, eng.clock)
            admitted += 1
        if admitted:
            eng.commit_admissions()

    # -------------------------------------------------------------- report
    def report(self) -> dict:
        eng = self.engine
        transfer = None
        if hasattr(eng, "host_transfer_bytes"):
            transfer = {"host_transfer_bytes": eng.host_transfer_bytes,
                        "host_fetches": eng.host_fetches}
        out = self.metrics.summary(eng.clock,
                                   pool_stats=eng.pool.stats.as_dict(),
                                   transfer=transfer)
        pc = getattr(eng, "prefix_cache", None)
        if pc is not None:
            out["prefix_cache"] = pc.stats.as_dict()
        return out


def victim_arrival(metrics: ServingMetrics, rid: int) -> float:
    tr = metrics.traces.get(rid)
    return tr.arrival if tr is not None else 0.0
