"""Speculation-aware structured event trace (port of
``repro.obs.trace``, DESIGN.md §7.9).

One ``TraceRecorder`` observes one serving run.  Events are plain dicts in
an append-only list — per-request lifecycle (arrival → admit → prefill →
decode rounds → finish / preempt / swap), per-round speculation events
(chunk length, branch count, tokens drafted / accepted / rolled back /
pruned, epsilon stops, H-RAD decisions, rollback cause) and wall-clock
phase spans (draft / verify / commit / prefill lanes), exported to a
Chrome/Perfetto ``trace.json`` by ``obs.export``.

Overhead contract:

  * **no extra device sync** — every event is built from host values the
    engines already hold: the small int32/f32 packets the device-resident
    loop fetches anyway, the modeled clock, and ``time.perf_counter()``.
    Recording never changes what crosses the device boundary, so the
    engines' ``host_fetches`` and transfer bytes are the same with the
    recorder on and off.  On the card a span is host wall time: it covers
    the asynchronous launches issued in it, not their device execution;
  * **no-op when disabled** — the engines hold ``NULL_RECORDER`` by
    default, whose methods are empty and whose ``enabled`` flag lets call
    sites skip even the cost of assembling event fields
    (``if rec.enabled:``);
  * **reconciles exactly** — the recorder updates its ``MetricsRegistry``
    from the same values it records, so per-request trace sums equal
    registry totals equal engine ``GenStats``.

Speculation-event causes (rollback attribution):

  ``accept``        — SpS round, every drafted token accepted (+ bonus)
  ``chunk-reject``  — mid-chunk rejection: chunk tail (and, in branch
                      stage, one continuation depth) rolled back (Fig. 1a)
  ``branch-miss``   — chunk accepted but no branch survives Alg. 2: the
                      continuation depth rolls back
  ``branch-adopt``  — a branch won; losses are pruned_tokens (H-RAD
                      posterior), not rollback
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from repro_torch.obs.registry import MetricsRegistry

__all__ = ["TraceRecorder", "NullRecorder", "NULL_RECORDER"]


class NullRecorder:
    """Disabled recorder: every hook is an empty method.

    The engines call these unconditionally on cheap paths and guard
    anything that would build dicts/lists behind ``rec.enabled`` — with
    this object installed the instrumented loop does no recording work and
    (by construction — no device values are touched) adds no syncs.
    """

    enabled = False
    registry: Optional[MetricsRegistry] = None
    events: List[dict] = []          # shared empty list; never appended to

    def now(self) -> float:
        return 0.0

    def event(self, kind: str, **fields) -> None:
        pass

    def request(self, kind: str, rid: int, **fields) -> None:
        pass

    def finish(self, rid: int, **fields) -> None:
        pass

    def spec(self, **fields) -> None:
        pass

    def round(self, **fields) -> None:
        pass

    def span(self, lane: str, wall0: float, wall1: float, **fields) -> None:
        pass

    def prefill(self, **fields) -> None:
        pass

    def sample(self, name: str, value: float, **fields) -> None:
        pass

    def reclaim(self, pool: str, reason: str, pages: int, **fields) -> None:
        pass

    def prefix(self, kind: str, **fields) -> None:
        pass

    def cow(self, pool: str, **fields) -> None:
        pass

    def model_call(self, **fields) -> None:
        pass


NULL_RECORDER = NullRecorder()


class TraceRecorder(NullRecorder):
    """Enabled recorder: appends events and mirrors them into a registry.

    Wall timestamps are ``time.perf_counter()`` seconds relative to the
    recorder's creation; modeled-clock timestamps ride along as ``t`` where
    the caller has them (the two clocks of serving/metrics.py).
    """

    enabled = True

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.events: List[dict] = []
        self._wall0 = time.perf_counter()
        # running mean acceptance rate, for the drift metric: how far each
        # verify round's acceptance sits from the mean of the rounds before
        # it — the signal a history-driven speculation controller watches.
        self._acc_n = 0
        self._acc_mean = 0.0

    # ------------------------------------------------------------- core
    def now(self) -> float:
        return time.perf_counter() - self._wall0

    def event(self, kind: str, **fields) -> None:
        e: Dict[str, Any] = {"kind": kind, "wall": self.now()}
        e.update(fields)
        self.events.append(e)

    # ------------------------------------------------- request lifecycle
    def request(self, kind: str, rid: int, **fields) -> None:
        """Lifecycle event: arrival / admit / prefill / preempt /
        swap_out / swap_in."""
        self.event(kind, rid=rid, **fields)
        if kind == "admit":
            self.registry.counter("admissions_total").inc()
        elif kind == "preempt":
            self.registry.counter("preemptions_total").inc()

    def finish(self, rid: int, *, emitted: int, rollback_tokens: int,
               pruned_tokens: int = 0, **fields) -> None:
        self.event("finish", rid=rid, emitted=emitted,
                   rollback_tokens=rollback_tokens,
                   pruned_tokens=pruned_tokens, **fields)
        reg = self.registry
        reg.counter("requests_finished_total").inc()
        reg.histogram("rollback_tokens_per_request").observe(rollback_tokens)

    # --------------------------------------------------- speculation round
    def spec(self, *, rid: int, round: int, stage: str, committed: int = 0,
             accepted: int = 0, drafted: int = 0, rolled_back: int = 0,
             pruned: int = 0, cause: str = "", gamma: int = 0, k: int = 0,
             bonus: bool = False, eps_stop: bool = False,
             hrad: Optional[int] = None,
             pred: Optional[Dict[str, Any]] = None,
             dispatches: Optional[int] = None,
             t: Optional[float] = None) -> None:
        """One request's speculation outcome in one engine round.

        ``stage``: "sps" (vanilla SD verify), "draft" (SpecBranch DRAFT
        stage — chunk built, nothing verified yet), "branch" (SpecBranch
        BRANCH stage verdict).  ``gamma`` is the chunk length under
        verification, ``k`` the branch count, ``cause`` the rollback
        attribution (module docstring).  ``pred`` carries the history
        predictor's per-round decision (runtime/predictor.py
        ``Decision.obs()``: chosen gamma / k_cap / epsilon + the score and
        cold flag that produced them) — the controller is evaluated on the
        same spec events it consumes.
        """
        self.event("spec", rid=rid, round=round, stage=stage,
                   committed=committed, accepted=accepted, drafted=drafted,
                   rolled_back=rolled_back, pruned=pruned, cause=cause,
                   gamma=gamma, k=k, bonus=bonus, eps_stop=eps_stop,
                   hrad=hrad, pred=pred, dispatches=dispatches, t=t)
        reg = self.registry
        reg.counter("tokens_committed_total").inc(committed)
        reg.counter("tokens_accepted_total").inc(accepted)
        reg.counter("tokens_drafted_total").inc(drafted)
        if rolled_back:
            reg.counter("rollback_tokens_total").inc(rolled_back)
            if cause:
                reg.counter("rollback_tokens_"
                            + cause.replace("-", "_")).inc(rolled_back)
        if pruned:
            reg.counter("pruned_tokens_total").inc(pruned)
        if eps_stop:
            reg.counter("eps_stops_total").inc()
        if hrad is not None:
            reg.counter(f"hrad_signal_{hrad}_total").inc()
        if pred is not None:
            reg.counter("pred_decisions_total").inc()
            reg.histogram("pred_score").observe(float(pred["score"]))
            reg.histogram("pred_gamma").observe(float(pred["gamma"]))
        if stage in ("sps", "branch") and gamma > 0:
            rate = min(accepted, gamma) / gamma
            reg.histogram("acceptance_rate").observe(rate)
            if self._acc_n > 0:
                reg.histogram("acceptance_rate_drift").observe(
                    rate - self._acc_mean)
            self._acc_n += 1
            self._acc_mean += (rate - self._acc_mean) / self._acc_n

    def round(self, *, engine: str, index: int, mode: str, draft_steps: int,
              target_calls: int, batch: int, wall0: float, wall1: float,
              dispatches: Optional[int] = None,
              t0: Optional[float] = None,
              t1: Optional[float] = None) -> None:
        self.event("round", engine=engine, index=index, mode=mode,
                   draft_steps=draft_steps, target_calls=target_calls,
                   batch=batch, dispatches=dispatches,
                   wall0=wall0, wall1=wall1, t0=t0, t1=t1)
        self.registry.counter("rounds_total").inc()
        self.registry.histogram("round_wall_s").observe(wall1 - wall0)
        if dispatches is not None:
            # per-round device-dispatch count (DESIGN.md §7.12): the
            # single-pass parallel drafting claim — 1 + gamma collapsing
            # to 2 — measured where it happens, gateable from the registry
            self.registry.counter("dispatches_total").inc(dispatches)
            self.registry.histogram("round_dispatches").observe(dispatches)

    def span(self, lane: str, wall0: float, wall1: float, **fields) -> None:
        """Wall-clock phase span on an engine lane (draft / verify /
        commit / prefill).  Lanes may overlap in time — that overlap IS the
        hidden-verify claim, visible in Perfetto."""
        self.event("span", lane=lane, wall0=wall0, wall1=wall1, **fields)

    # ------------------------------------------------------ serving signals
    def prefill(self, *, width: int, lanes: int, used: int, tokens: int,
                t: Optional[float] = None, rids=None) -> None:
        """One batched bucketed prefill forward: ``used`` of ``lanes``
        lanes carried real prompts, ``tokens`` real tokens over a
        ``lanes x width`` frame."""
        util = tokens / max(lanes * width, 1)
        self.event("prefill", width=width, lanes=lanes, used=used,
                   tokens=tokens, util=util, t=t, rids=rids)
        self.registry.counter("prefill_forwards_total").inc()
        self.registry.histogram("prefill_bucket_utilization").observe(util)

    def sample(self, name: str, value: float,
               t: Optional[float] = None) -> None:
        """Counter-track sample (queue depth, pool occupancy): one point on
        a Perfetto counter lane + gauge/histogram in the registry."""
        self.event("sample", name=name, value=float(value), t=t)
        self.registry.gauge(name).set(value)
        self.registry.histogram(name).observe(value)

    def reclaim(self, pool: str, reason: str, pages: int, **fields) -> None:
        """Page-reclaim attribution from the KV pool's release hook."""
        self.event("reclaim", pool=pool, reason=reason, pages=pages,
                   **fields)
        self.registry.counter("reclaimed_pages_total").inc(pages)
        self.registry.counter(f"reclaimed_pages_{reason}").inc(pages)

    def prefix(self, kind: str, **fields) -> None:
        """Prefix-cache lifecycle (serving/prefix_cache.py): ``kind`` is
        "hit" / "miss" (admission lookup, ``tokens`` = prefix bound
        zero-copy), "publish" (retire/preempt handed a run to the cache;
        ``created`` False when it deduped) or "evict" (pressure-driven
        LRU reclaim)."""
        self.event("prefix", op=kind, **fields)
        reg = self.registry
        if kind in ("hit", "miss"):
            reg.counter("prefix_lookups_total").inc()
        if kind == "hit":
            reg.counter("prefix_hits_total").inc()
            reg.counter("prefix_saved_tokens_total").inc(
                int(fields.get("tokens", 0)))
        elif kind == "publish":
            if fields.get("created", True):
                reg.counter("prefix_published_runs_total").inc()
        elif kind == "evict":
            reg.counter("prefix_evicted_runs_total").inc()

    def cow(self, pool: str, **fields) -> None:
        """One copy-on-write page split in pool ``pool`` — a write landed
        on a page shared with a branch fork or a cached prefix run."""
        self.event("cow", pool=pool, **fields)
        self.registry.counter("cow_copies_total").inc()
        self.registry.counter(f"cow_copies_{pool}").inc()

    def model_call(self, **fields) -> None:
        """Sequential-runner forward (runtime/runner.py)."""
        self.event("model_call", **fields)
        self.registry.counter("model_calls_total").inc()
        self.registry.counter("model_call_tokens_total").inc(
            int(fields.get("tokens", 0)))

    # ------------------------------------------------------- reconciliation
    def request_totals(self) -> Dict[int, Dict[str, int]]:
        """Per-request sums over spec events — the quantities that must
        equal engine ``GenStats`` exactly (committed == emitted,
        rolled_back == rollback_tokens, pruned == pruned_tokens)."""
        out: Dict[int, Dict[str, int]] = {}
        for e in self.events:
            if e["kind"] != "spec":
                continue
            d = out.setdefault(e["rid"], {"committed": 0, "accepted": 0,
                                          "drafted": 0, "rolled_back": 0,
                                          "pruned": 0})
            d["committed"] += e["committed"]
            d["accepted"] += e["accepted"]
            d["drafted"] += e["drafted"]
            d["rolled_back"] += e["rolled_back"]
            d["pruned"] += e["pruned"]
        return out
