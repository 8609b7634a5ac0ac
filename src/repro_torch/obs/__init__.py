"""Speculation-aware observability layer (port of ``repro.obs``).

trace.py    — structured event recorder (no-op NullRecorder when disabled)
registry.py — counter/gauge/histogram metrics registry
export.py   — Perfetto trace.json + metrics dumps + torch.profiler session
"""
from repro_torch.obs.export import (perfetto_trace, profiler_session,
                                    write_metrics, write_trace)
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry)
from repro_torch.obs.trace import NULL_RECORDER, NullRecorder, TraceRecorder

__all__ = [
    "TraceRecorder", "NullRecorder", "NULL_RECORDER",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "perfetto_trace", "write_trace", "write_metrics", "profiler_session",
]
