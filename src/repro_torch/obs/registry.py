"""Counter / gauge / histogram metrics registry (DESIGN.md §7.9).

The serving stack's aggregates (`serving/metrics.py`) answer "how did the
run go"; this registry answers "what happened, named and countable" — the
speculation-aware totals (committed / accepted / rolled-back / pruned
tokens, rollback attribution by cause, reclaimed pages by reason) plus the
operational signals the next ROADMAP items consume (acceptance-rate drift
for history-driven speculation control, queue depth and pool occupancy for
SLO-aware scheduling).

Design constraints:

  * host-only and allocation-light: updating a metric is a dict lookup plus
    an int/float add — never a device sync (the zero-sync contract of the
    device-resident loop, §7.7, extends to observability);
  * get-or-create access (``registry.counter(name)``), so instrumentation
    sites don't coordinate a schema up front;
  * deterministic dumps: ``as_dict`` orders metrics by name and histograms
    report the pinned interpolated percentiles (runtime/cost_model.py), so
    two identical runs produce byte-identical metrics files.

The trace recorder (obs/trace.py) updates this registry from the SAME host
packets its events are built from, which is what makes trace-event sums and
registry totals reconcile exactly (tests/test_obs_trace.py).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.runtime.cost_model import percentile

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """Monotonic event/total counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-value metric (queue depth, occupancy at the latest round)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Value distribution; summarized with the pinned percentile method."""

    __slots__ = ("name", "values")

    def __init__(self, name: str):
        self.name = name
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    def summary(self) -> Dict[str, float]:
        vs = self.values
        if not vs:
            return {"count": 0, "sum": 0.0}
        return {
            "count": len(vs),
            "sum": float(sum(vs)),
            "mean": float(sum(vs) / len(vs)),
            "min": float(min(vs)),
            "max": float(max(vs)),
            "p50": percentile(vs, 50),
            "p95": percentile(vs, 95),
        }


class MetricsRegistry:
    """Get-or-create registry of counters, gauges and histograms."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name)
        return h

    # ------------------------------------------------------------- export
    def as_dict(self) -> dict:
        return {
            "counters": {n: self.counters[n].value
                         for n in sorted(self.counters)},
            "gauges": {n: self.gauges[n].value for n in sorted(self.gauges)},
            "histograms": {n: self.histograms[n].summary()
                           for n in sorted(self.histograms)},
        }

    def render_text(self) -> str:
        """Plain-text dump (one metric per line, sorted)."""
        lines = []
        for n in sorted(self.counters):
            lines.append(f"{n} {self.counters[n].value}")
        for n in sorted(self.gauges):
            lines.append(f"{n} {self.gauges[n].value:g}")
        for n in sorted(self.histograms):
            s = self.histograms[n].summary()
            if s["count"] == 0:
                lines.append(f"{n} count=0")
                continue
            lines.append(
                f"{n} count={s['count']} mean={s['mean']:g} "
                f"p50={s['p50']:g} p95={s['p95']:g} "
                f"min={s['min']:g} max={s['max']:g}")
        return "\n".join(lines) + "\n"
