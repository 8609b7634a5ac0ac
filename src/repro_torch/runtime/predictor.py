"""History-driven speculation controller (port of
``repro.runtime.predictor``, copied: it is framework-free host math).

A two-level branch predictor pointed at the accept/reject stream each
request already produces:

  * a **2-bit saturating counter per request** (strongly-reject 0 ..
    strongly-accept 3, initialized weakly-accept);
  * a **global pattern-history table (PHT)**: each request keeps an H-bit
    shift register of its last H round outcomes, which indexes a table of
    2**H 2-bit counters *shared across requests*;
  * a **global fallback counter** for cold requests (fewer than
    ``warmup`` observed rounds).

Each round the predictor blends these into a score in [0, 1] and emits a
:class:`Decision`: ``gamma`` snapped to the bucket ladder (powers of two
up to gamma_max), a branch cap ``k_cap`` in [1, k_max] under which Eq. 7's
adaptive k still applies, and ``epsilon`` within a factor of 2 of the
configured base.  The predictor only picks what is drafted, never what
is accepted, so verification stays lossless; ``mode="off"``
(:func:`make_predictor` returns None) leaves every engine path as it is
without one.  ``mode="oracle"`` replaces the counters with exact running
acceptance-rate EMAs.  Updates consume only host packets the engines
already fetch, and the state machine has no RNG: a decision trace
replayed with the same outcome script reproduces bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

__all__ = ["PredictorConfig", "Decision", "SpeculationPredictor",
           "make_predictor", "gamma_ladder"]


def gamma_ladder(gamma_max: int) -> List[int]:
    """Allowed draft lengths: powers of two up to gamma_max, plus
    gamma_max itself.  Matches device_loop.bucket()'s padding rungs, so an
    adaptive gamma never introduces a token width the jitted step hasn't
    already traced at the static ``bucket(gamma_max)`` pad."""
    ladder = []
    w = 1
    while w < gamma_max:
        ladder.append(w)
        w *= 2
    ladder.append(max(1, gamma_max))
    return ladder


@dataclasses.dataclass(frozen=True)
class PredictorConfig:
    mode: str = "on"            # "on" | "oracle" ("off" -> no predictor)
    history_bits: int = 4       # H — PHT indexed by last H round outcomes
    warmup: int = 3             # rounds before per-request state is trusted
    ema_alpha: float = 0.25     # oracle-mode EMA step
    eps_min: float = 1e-4


@dataclasses.dataclass(frozen=True)
class Decision:
    """One round's knob settings plus the state that produced them (the
    ``pred`` fields recorded on obs spec events)."""
    gamma: int
    k_cap: int
    epsilon: float
    score: float
    cold: bool

    def obs(self) -> Dict[str, object]:
        return {"gamma": self.gamma, "k_cap": self.k_cap,
                "epsilon": round(self.epsilon, 6),
                "score": round(self.score, 4), "cold": self.cold}


class _ReqState:
    __slots__ = ("counter", "history", "rounds", "ema")

    def __init__(self) -> None:
        self.counter = 2          # weakly-accept
        self.history = 0          # H-bit outcome shift register
        self.rounds = 0
        self.ema = 0.5


class SpeculationPredictor:
    """Per-request acceptance-history predictor; see module docstring.

    API:
      ``start(rid)``             ensure state exists (idempotent — survives
                                 preemption/re-admission, keyed by rid)
      ``decide(rid)``            -> Decision for the next round
      ``update(rid, hit, frac)`` feed one verify outcome (host packet
                                 values); ``hit`` = chunk fully accepted,
                                 ``frac`` = accepted fraction in [0, 1]
      ``drop(rid)``              free state when a request finishes
    """

    def __init__(self, gamma_max: int, k_max: int, eps_base: float,
                 cfg: Optional[PredictorConfig] = None):
        self.cfg = cfg if cfg is not None else PredictorConfig()
        if self.cfg.mode not in ("on", "oracle"):
            raise ValueError(f"bad predictor mode: {self.cfg.mode!r}")
        self.gamma_max = max(1, int(gamma_max))
        self.k_max = max(1, int(k_max))
        self.eps_base = float(eps_base)
        self.ladder = gamma_ladder(self.gamma_max)
        self._mask = (1 << self.cfg.history_bits) - 1
        self._pht = [2] * (1 << self.cfg.history_bits)
        self._global = 2          # fallback 2-bit counter
        self._global_ema = 0.5
        self._global_rounds = 0
        self._req: Dict[int, _ReqState] = {}

    # ------------------------------------------------------------ state
    def start(self, rid: int) -> _ReqState:
        st = self._req.get(rid)
        if st is None:
            st = self._req[rid] = _ReqState()
        return st

    def drop(self, rid: int) -> None:
        self._req.pop(rid, None)

    # ------------------------------------------------------------ score
    def _score(self, st: _ReqState) -> float:
        if self.cfg.mode == "oracle":
            if st.rounds < self.cfg.warmup:
                return self._global_ema
            return st.ema
        if st.rounds < self.cfg.warmup:
            return self._global / 3.0
        return 0.5 * (st.counter / 3.0 + self._pht[st.history] / 3.0)

    # ----------------------------------------------------------- decide
    def decide(self, rid: int) -> Decision:
        st = self.start(rid)
        cold = st.rounds < self.cfg.warmup
        score = self._score(st)
        # gamma: snap score onto the bucket ladder (score 1 -> gamma_max)
        gi = int(round(score * (len(self.ladder) - 1)))
        gamma = self.ladder[max(0, min(gi, len(self.ladder) - 1))]
        # k cap: misaligned streams hedge with more branches
        k_cap = -(-self.k_max * (1.0 - score) // 1)      # ceil
        k_cap = max(1, min(self.k_max, int(k_cap)))
        # epsilon: within [base/2, base*2]; score 0.5 -> base
        eps = self.eps_base * (2.0 ** (1.0 - 2.0 * score))
        eps = max(self.cfg.eps_min, min(1.0 - self.cfg.eps_min, eps))
        return Decision(gamma=gamma, k_cap=k_cap, epsilon=eps,
                        score=score, cold=cold)

    # ----------------------------------------------------------- update
    def update(self, rid: int, hit: bool, frac: Optional[float] = None
               ) -> None:
        """One verify outcome from the host packet: ``hit`` = the chunk was
        fully accepted (SpS all_acc; SpecBranch chunk-accept + a surviving
        branch), ``frac`` = n_accepted / drafted for the oracle EMA."""
        st = self.start(rid)
        f = float(frac) if frac is not None else (1.0 if hit else 0.0)
        f = max(0.0, min(1.0, f))
        a = self.cfg.ema_alpha
        step = 1 if hit else -1
        # two-level update: local counter, shared PHT at the OLD history,
        # then shift the outcome into the register
        st.counter = max(0, min(3, st.counter + step))
        h = st.history
        self._pht[h] = max(0, min(3, self._pht[h] + step))
        st.history = ((h << 1) | (1 if hit else 0)) & self._mask
        st.ema += a * (f - st.ema)
        st.rounds += 1
        self._global = max(0, min(3, self._global + step))
        self._global_ema += a * (f - self._global_ema)
        self._global_rounds += 1

    # ------------------------------------------------------------- intro
    def snapshot(self, rid: int) -> Dict[str, object]:
        """Predictor internals for obs/debugging (not used in decisions)."""
        st = self.start(rid)
        return {"counter": st.counter, "history": st.history,
                "rounds": st.rounds, "ema": round(st.ema, 4),
                "global": self._global,
                "pht": self._pht[st.history]}


def make_predictor(mode: str, gamma_max: int, k_max: int, eps_base: float,
                   cfg: Optional[PredictorConfig] = None
                   ) -> Optional[SpeculationPredictor]:
    """Factory for the engines: ``mode="off"`` (the default EngineConfig
    value) returns None, keeping every engine path bitwise-identical to the
    predictor-less build."""
    if mode in ("off", "", None):
        return None
    base = cfg if cfg is not None else PredictorConfig()
    return SpeculationPredictor(
        gamma_max, k_max, eps_base,
        dataclasses.replace(base, mode=mode))
