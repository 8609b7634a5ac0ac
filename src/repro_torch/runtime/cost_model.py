"""Step-accounting cost model (copy of ``repro.runtime.cost_model``, which
is framework-free; DESIGN.md §3).

The paper's own latency model (Sec. 4.1) prices a draft-model token at
``t`` and a target-model call at ``c*t``; it is the modeled clock the
serving metrics report beside wall time.  Engines emit a timeline
of rounds; this module turns it into the per-token latency / speedup /
tokens-per-second numbers reported in Tables 2-3.

Round kinds:
  ("serial",   draft_tokens, target_calls)   cost = d*t + calls*c*t
  ("parallel", draft_tokens, target_calls)   cost = max(d*t, calls*c*t)
  ("target",   0,            target_calls)   cost = calls*c*t   (AR decode)

Rounds may carry a fourth element, the measured DEVICE DISPATCH count
(model forwards launched that round — DESIGN.md §7.12).  Single-pass
parallel drafting collapses a round's 1 + gamma dispatches to 2, a win the
per-token terms above cannot see; ``t_dispatch`` prices the fixed per-
dispatch overhead (launch latency, host staging) so the collapse shows up
in the modeled latency.  Historical 3-tuples price their implied dispatch
count (draft_tokens + target_calls: one forward per sequential draft step);
with the default ``t_dispatch = 0`` every number is unchanged, bitwise.
For 4-tuples the draft-forward time is (dispatches - target_calls) * t —
one chunk forward regardless of chunk width — while the drafted-token cost
stays visible through the dispatch term.

Admission rounds may appear as ("prefill", staged_tokens, forwards):
cost = staged_tokens * t_prefill + forwards * t_dispatch.  With the
default ``t_prefill = 0`` engines never emit them, so TTFT keeps today's
arrival-to-first-commit reading; pricing prefill (the prefix-cache bench
does) makes a cached admission — fewer staged suffix tokens, fewer rung
forwards — visibly cheaper on the modeled clock.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

Round = Tuple[str, int, int]


def percentile(xs: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile, Hyndman-Fan type 7 (the numpy /
    Excel default): rank r = q/100 * (n-1), value = lerp between the
    neighboring order statistics.  Pinned here so small-sample p50/p95
    (tens of requests in a serving sweep) are stable, documented numbers
    rather than whatever a nearest-rank index rounds to.  q in [0, 100],
    clamped; 0.0 on empty input.
    """
    if not xs:
        return 0.0
    ys = sorted(xs)
    if len(ys) == 1:
        return float(ys[0])
    r = (min(max(q, 0.0), 100.0) / 100.0) * (len(ys) - 1)
    lo = int(math.floor(r))
    hi = min(lo + 1, len(ys) - 1)
    frac = r - lo
    return float(ys[lo] * (1.0 - frac) + ys[hi] * frac)


@dataclasses.dataclass
class CostModel:
    c: float = 10.0         # target-call / draft-token speed ratio
    t: float = 1.0          # draft per-token time (arbitrary unit)
    tokens_per_sec_ar: float = 0.0  # optional absolute calibration
    t_dispatch: float = 0.0  # fixed per-device-dispatch overhead
    t_prefill: float = 0.0   # per-staged-prefill-token time (0 = unpriced)

    def round_cost(self, r: Round) -> float:
        kind, d, calls = r[0], r[1], r[2]
        if kind == "prefill":
            # d = staged tokens (lanes * rung width), calls = forwards
            return d * self.t_prefill + calls * self.t_dispatch
        if len(r) > 3:
            nd = int(r[3])
            # measured dispatches: draft forwards are whatever is not a
            # target call, and each draft forward covers the whole chunk
            dfwd = max(nd - calls, 0)
        else:
            nd = d + calls          # implied: one forward per draft step
            dfwd = d
        over = nd * self.t_dispatch
        if kind == "serial":
            return dfwd * self.t + calls * self.c * self.t + over
        if kind == "parallel":
            return max(dfwd * self.t, calls * self.c * self.t) + over
        if kind == "target":
            return calls * self.c * self.t + over
        raise ValueError(kind)

    def total(self, timeline: List[Round]) -> float:
        return sum(self.round_cost(r) for r in timeline)

    def per_token(self, timeline: List[Round], n_tokens: int) -> float:
        return self.total(timeline) / max(n_tokens, 1)

    def speedup_vs_ar(self, timeline: List[Round], n_tokens: int) -> float:
        """Speedup over autoregressive target decoding (c*t per token)."""
        return (self.c * self.t) / self.per_token(timeline, n_tokens)

    def tokens_per_sec(self, timeline: List[Round], n_tokens: int,
                       ar_tps: float) -> float:
        """Absolute speed if AR decoding runs at ``ar_tps`` tokens/s."""
        return ar_tps * self.speedup_vs_ar(timeline, n_tokens)
