"""Serving metrics (port of ``repro.serving.metrics``, DESIGN.md §7.4).

Two clocks run side by side:

  * the *modeled* clock — CostModel time units accumulated per engine
    round (runtime/cost_model.py), comparable with the reference's runs;
  * the *wall* clock — real seconds; on the card this is the serving
    speed users see.

TTFT / inter-token latency are measured per request against the modeled
clock; tokens committed by the same verify call share a timestamp.
Host-transfer accounting: the engines tally every device -> host byte
they move (verdict/token packets, prefill token staging — never logits);
``summary`` reports totals, per-step bytes and wall-clock step-latency
percentiles.  ``attach_registry`` mirrors the scheduler-side aggregates
into an ``obs.registry.MetricsRegistry`` under ``serving_*`` names.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from repro_torch.obs.registry import (Counter, Gauge, Histogram,  # noqa: F401
                                MetricsRegistry)
from repro_torch.runtime.cost_model import percentile

__all__ = ["ServingMetrics", "RequestTrace", "percentile",
           "MetricsRegistry", "Counter", "Gauge", "Histogram"]


@dataclasses.dataclass
class RequestTrace:
    rid: int
    arrival: float                   # modeled time the request arrived
    admitted: Optional[float] = None
    finished: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    wall_admitted: Optional[float] = None
    wall_finished: Optional[float] = None
    preemptions: int = 0

    @property
    def ttft(self) -> Optional[float]:
        if not self.token_times:
            return None
        return self.token_times[0] - self.arrival

    @property
    def itls(self) -> List[float]:
        tt = self.token_times
        return [b - a for a, b in zip(tt, tt[1:])]


class ServingMetrics:
    """Aggregates per-request traces + pool occupancy over a serving run."""

    def __init__(self):
        self.traces: Dict[int, RequestTrace] = {}
        self.occupancy_samples: List[float] = []   # pool fill at round ends
        self.logical_samples: List[float] = []     # bound-page (logical) fill
        self.shared_samples: List[int] = []        # physical pages shared >1x
        self.rounds = 0
        self.preemptions = 0
        self.step_walls: List[float] = []          # wall seconds per round
        self.dispatch_samples: List[int] = []      # device dispatches/round
        self._wall0 = time.time()
        self._reg: Optional[MetricsRegistry] = None

    def attach_registry(self, reg: Optional[MetricsRegistry]) -> None:
        """Mirror scheduler-side aggregates into ``reg`` (serving_* names)
        as events arrive.  Pass None to detach."""
        self._reg = reg

    # ------------------------------------------------------------- events
    def on_arrival(self, rid: int, t: float) -> None:
        self.traces[rid] = RequestTrace(rid=rid, arrival=t)

    def on_admit(self, rid: int, t: float) -> None:
        tr = self.traces[rid]
        if tr.admitted is None:            # re-admission after preemption
            tr.admitted = t
        tr.wall_admitted = tr.wall_admitted or time.time()

    def on_tokens(self, rid: int, n: int, t: float) -> None:
        self.traces[rid].token_times.extend([t] * n)
        if self._reg is not None:
            self._reg.counter("serving_tokens_total").inc(n)

    def on_finish(self, rid: int, t: float) -> None:
        tr = self.traces[rid]
        tr.finished = t
        tr.wall_finished = time.time()
        if self._reg is not None:
            if tr.ttft is not None:
                self._reg.histogram("serving_ttft").observe(tr.ttft)
            for d in tr.itls:
                self._reg.histogram("serving_itl").observe(d)

    def on_preempt(self, rid: int) -> None:
        self.traces[rid].preemptions += 1
        self.preemptions += 1
        if self._reg is not None:
            self._reg.counter("serving_preemptions_total").inc()

    def on_round(self, occupancy: float,
                 step_wall: Optional[float] = None,
                 dispatches: Optional[int] = None,
                 logical_occupancy: Optional[float] = None,
                 shared_pages: Optional[int] = None) -> None:
        self.rounds += 1
        self.occupancy_samples.append(occupancy)
        if logical_occupancy is not None:
            # physical occupancy counts each shared page ONCE; the logical
            # view sums table-bound pages, so logical - physical is the
            # COW/prefix-cache sharing win per round
            self.logical_samples.append(logical_occupancy)
        if shared_pages is not None:
            self.shared_samples.append(int(shared_pages))
        if step_wall is not None:
            self.step_walls.append(step_wall)
        if dispatches is not None:
            self.dispatch_samples.append(int(dispatches))
        if self._reg is not None:
            self._reg.counter("serving_rounds_total").inc()
            self._reg.histogram("serving_pool_occupancy").observe(occupancy)
            if logical_occupancy is not None:
                self._reg.histogram(
                    "serving_pool_logical_occupancy").observe(
                        logical_occupancy)
            if shared_pages is not None:
                self._reg.gauge("serving_shared_pages").set(shared_pages)
            if step_wall is not None:
                self._reg.histogram("serving_step_wall_s").observe(step_wall)
            if dispatches is not None:
                self._reg.counter("serving_dispatches_total").inc(dispatches)
                self._reg.histogram(
                    "serving_round_dispatches").observe(dispatches)

    # ------------------------------------------------------------ summary
    def summary(self, total_cost: float, pool_stats: Optional[dict] = None,
                transfer: Optional[dict] = None) -> dict:
        toks = sum(len(t.token_times) for t in self.traces.values())
        ttfts = [t.ttft for t in self.traces.values() if t.ttft is not None]
        itls = [d for t in self.traces.values() for d in t.itls]
        wall = time.time() - self._wall0
        out = {
            "requests": len(self.traces),
            "total_tokens": toks,
            "total_cost": total_cost,
            "tokens_per_cost": toks / max(total_cost, 1e-9),
            "wall_s": wall,
            "tokens_per_sec_wall": toks / max(wall, 1e-9),
            "rounds": self.rounds,
            "preemptions": self.preemptions,
            "ttft_p50": percentile(ttfts, 50),
            "ttft_p95": percentile(ttfts, 95),
            "itl_p50": percentile(itls, 50),
            "itl_p95": percentile(itls, 95),
            "pool_occupancy_mean": (sum(self.occupancy_samples)
                                    / max(len(self.occupancy_samples), 1)),
            "pool_occupancy_peak": max(self.occupancy_samples, default=0.0),
        }
        if self.logical_samples:
            out["pool_logical_occupancy_mean"] = (
                sum(self.logical_samples) / len(self.logical_samples))
            out["pool_logical_occupancy_peak"] = max(self.logical_samples)
        if self.shared_samples:
            out["shared_pages_peak"] = max(self.shared_samples)
        if self.step_walls:
            out["step_wall_p50"] = percentile(self.step_walls, 50)
            out["step_wall_p95"] = percentile(self.step_walls, 95)
        if self.dispatch_samples:
            # device dispatches per engine round (DESIGN.md §7.12): the
            # single-pass parallel drafting target is 2 (draft + verify)
            out["dispatches_per_round"] = (sum(self.dispatch_samples)
                                           / len(self.dispatch_samples))
        if transfer is not None:
            total = transfer.get("host_transfer_bytes", 0)
            out["host_transfer_bytes"] = total
            out["host_fetches"] = transfer.get("host_fetches", 0)
            out["per_step_transfer_bytes"] = total / max(self.rounds, 1)
        if pool_stats is not None:
            out["pool"] = dict(pool_stats)
        return out
