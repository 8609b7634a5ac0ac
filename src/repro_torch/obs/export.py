"""Exporters for the trace recorder (port of ``repro.obs.export``):
Perfetto trace.json, metrics dumps and a profiler session.

``perfetto_trace`` converts a ``TraceRecorder``'s event list into the
Chrome trace-event JSON format (``{"traceEvents": [...]}``), loadable in
https://ui.perfetto.dev or ``chrome://tracing``.  Track layout:

  pid 1 "scheduler"  — round spans ("X") and counter tracks ("C") for
                       queue depth / pool occupancy
  pid 2 "engine"     — draft / verify / commit / prefill lanes as tids;
                       overlap between the draft and verify lanes is the
                       hidden-verify claim made visible
  pid 3 "requests"   — one tid per request (admit → finish span, plus
                       instant events for spec rounds / preempt / swap)

All timestamps are microseconds of ``rec.now()`` wall time (perf_counter
relative to recorder creation).  The exporter is pure post-processing: it
never touches the engines or the device.  ``profiler_session`` is a
``torch.profiler`` session (the reference's is a ``jax.profiler`` one)
whose Chrome trace holds the device-side timeline.
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import Optional

import torch

from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.trace import TraceRecorder

__all__ = ["perfetto_trace", "write_trace", "write_metrics",
           "profiler_session"]

_PID_SCHED = 1
_PID_ENGINE = 2
_PID_REQ = 3

_ENGINE_LANES = {"draft": 1, "verify": 2, "commit": 3, "prefill": 4}


def _us(wall: float) -> int:
    return int(wall * 1e6)


def perfetto_trace(rec: TraceRecorder) -> dict:
    """Build a Chrome/Perfetto trace-event document from a recorder."""
    ev = []

    def meta(pid, name, tid=None):
        e = {"ph": "M", "pid": pid, "name": "process_name",
             "args": {"name": name}}
        if tid is not None:
            e["name"] = "thread_name"
            e["tid"] = tid
        ev.append(e)

    meta(_PID_SCHED, "scheduler")
    meta(_PID_ENGINE, "engine")
    meta(_PID_REQ, "requests")
    for lane, tid in _ENGINE_LANES.items():
        meta(_PID_ENGINE, lane, tid=tid)

    req_named = set()
    req_open: dict = {}                       # rid -> admit wall time

    for e in rec.events:
        kind = e["kind"]
        wall = e.get("wall", 0.0)
        if kind == "span":
            tid = _ENGINE_LANES.get(e["lane"], 9)
            args = {k: v for k, v in e.items()
                    if k not in ("kind", "lane", "wall0", "wall1", "wall")
                    and v is not None}
            ev.append({"ph": "X", "pid": _PID_ENGINE, "tid": tid,
                       "name": e["lane"], "ts": _us(e["wall0"]),
                       "dur": max(_us(e["wall1"]) - _us(e["wall0"]), 1),
                       "args": args})
        elif kind == "round":
            ev.append({"ph": "X", "pid": _PID_SCHED, "tid": 1,
                       "name": f"round[{e['mode']}]",
                       "ts": _us(e["wall0"]),
                       "dur": max(_us(e["wall1"]) - _us(e["wall0"]), 1),
                       "args": {"index": e["index"], "batch": e["batch"],
                                "draft_steps": e["draft_steps"],
                                "target_calls": e["target_calls"]}})
        elif kind == "sample":
            ev.append({"ph": "C", "pid": _PID_SCHED, "tid": 2,
                       "name": e["name"], "ts": _us(wall),
                       "args": {e["name"]: e["value"]}})
        elif kind == "spec":
            rid = e["rid"]
            args = {k: e[k] for k in ("stage", "committed", "accepted",
                                      "drafted", "rolled_back", "pruned",
                                      "cause", "gamma", "k")}
            if e.get("pred") is not None:   # history-predictor decision
                args["pred"] = e["pred"]
            ev.append({"ph": "i", "pid": _PID_REQ, "tid": rid + 1, "s": "t",
                       "name": f"spec[{e['stage']}]"
                               + (f":{e['cause']}" if e["cause"] else ""),
                       "ts": _us(wall), "args": args})
        elif kind in ("admit", "arrival", "prefill_row", "swap_in",
                      "swap_out", "preempt"):
            rid = e["rid"]
            if rid not in req_named:
                req_named.add(rid)
                meta(_PID_REQ, f"r{rid}", tid=rid + 1)
            if kind == "admit":
                req_open[rid] = wall
            ev.append({"ph": "i", "pid": _PID_REQ, "tid": rid + 1, "s": "t",
                       "name": kind, "ts": _us(wall),
                       "args": {k: v for k, v in e.items()
                                if k not in ("kind", "wall")
                                and v is not None}})
        elif kind == "finish":
            rid = e["rid"]
            t0 = req_open.pop(rid, wall)
            ev.append({"ph": "X", "pid": _PID_REQ, "tid": rid + 1,
                       "name": f"r{rid}", "ts": _us(t0),
                       "dur": max(_us(wall) - _us(t0), 1),
                       "args": {"emitted": e["emitted"],
                                "rollback_tokens": e["rollback_tokens"],
                                "pruned_tokens": e["pruned_tokens"]}})
        elif kind == "prefill":
            ev.append({"ph": "X", "pid": _PID_ENGINE,
                       "tid": _ENGINE_LANES["prefill"], "name": "prefill",
                       "ts": _us(wall), "dur": 1,
                       "args": {"width": e["width"], "lanes": e["lanes"],
                                "used": e["used"], "util": e["util"]}})
        elif kind == "reclaim":
            ev.append({"ph": "i", "pid": _PID_SCHED, "tid": 3, "s": "t",
                       "name": f"reclaim:{e['reason']}", "ts": _us(wall),
                       "args": {"pool": e["pool"], "pages": e["pages"]}})
        elif kind == "model_call":
            ev.append({"ph": "i", "pid": _PID_ENGINE, "tid": 9, "s": "t",
                       "name": "model_call", "ts": _us(wall),
                       "args": {k: v for k, v in e.items()
                                if k not in ("kind", "wall")}})

    # leave any still-open requests visible as zero-length spans
    for rid, t0 in req_open.items():
        ev.append({"ph": "X", "pid": _PID_REQ, "tid": rid + 1,
                   "name": f"r{rid} (open)", "ts": _us(t0), "dur": 1,
                   "args": {}})

    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def write_trace(rec: TraceRecorder, path: str) -> None:
    with open(path, "w") as f:
        json.dump(perfetto_trace(rec), f)


def write_metrics(registry: MetricsRegistry, path: str) -> None:
    """Metrics dump: JSON if the path ends in .json, plain text otherwise."""
    if path.endswith(".json"):
        with open(path, "w") as f:
            json.dump(registry.as_dict(), f, indent=2, sort_keys=True)
            f.write("\n")
    else:
        with open(path, "w") as f:
            f.write(registry.render_text())


@contextlib.contextmanager
def profiler_session(logdir: Optional[str], device="cuda"):
    """Optional ``torch.profiler`` session around a run.

    Yields None immediately when ``logdir`` is falsy; otherwise profiles
    the block (CUDA activity when ``device`` is a CUDA device, CPU
    activity otherwise), yields the profiler, and writes its Chrome trace
    to ``DIR/trace.<pid>.json`` on exit, so the device-side picture sits
    next to the host-side trace.json."""
    if not logdir:
        yield None
        return
    act = torch.profiler.ProfilerActivity
    acts = ([act.CUDA] if torch.device(device).type == "cuda"
            else [act.CPU])
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace.{os.getpid()}.json"))
