"""Engine configuration and per-request results (the dataclasses of
``repro.runtime.engines``; the sequential engines themselves are a later
slice of the port).

Rollback accounting (Sec. 6 / E.3): ``rollback_tokens`` counts draft-forward
tokens discarded after target verification at sequence-position
granularity; tokens cut before verification are ``pruned_tokens``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.runtime.cost_model import CostModel, Round


@dataclasses.dataclass
class EngineConfig:
    gamma: int = 8                 # static draft length (SpS) / gamma_max
    k_max: int = 6                 # max parallel branches (Eq. 7 cap)
    epsilon: float = 0.3           # confidence threshold (implicit signal)
    c: float = 10.0                # target/draft speed ratio
    temperature: float = 0.0       # target sampling temperature
    draft_temperature: float = 1.0 # sampling temp for drafted tokens
    signal_temperature: float = 1.0
    # ^ temp for *signals*: confidence stop rules, branch-point candidates
    #   and adaptive k (signals never change what is sampled)
    adaedl_lambda: float = 0.15
    lookahead_n: int = 3
    hrad_k_layers: int = 4
    branch_mode: str = "sample"    # "sample" (lossless) | "topk" (Eq. 7)
    use_hrad: bool = True          # needs hrad_params to have an effect
    use_branch: bool = True        # ablation: SpecBranch w/o branch
    gamma_branch_override: int = 0 # 0 = auto (speed-ratio-matched)
    spec_predictor: str = "off"    # "off" only in this slice of the port
    draft_mode: str = "sequential" # "sequential" only in this slice
    max_len: int = 4096
    seed: int = 0

    @property
    def gamma_branch(self) -> int:
        """Per-branch draft length in the branch stage, sized so the gb+1
        batched draft steps finish inside the c-cost verification window
        (Sec. 5.2)."""
        if self.gamma_branch_override:
            return self.gamma_branch_override
        return max(1, int(round(self.c)) - 1)


@dataclasses.dataclass
class GenStats:
    emitted: int = 0
    draft_tokens: int = 0          # draft-model token forwards (lineage)
    target_calls: int = 0
    rollback_tokens: int = 0       # drafted positions discarded post-verify
    pruned_tokens: int = 0         # positions cut pre-verify
    hrad_signals: List[int] = dataclasses.field(default_factory=list)
    accept_runs: List[int] = dataclasses.field(default_factory=list)
    _run: int = 0

    def run_extend(self, n: int) -> None:
        self._run += n

    def run_break(self) -> None:
        if self._run > 0:
            self.accept_runs.append(self._run)
        self._run = 0

    def finish(self) -> None:
        self.run_break()

    @property
    def mean_accepted(self) -> float:
        """M — mean continuously-accepted length (Sec. 6 / E.3)."""
        return float(np.mean(self.accept_runs)) if self.accept_runs else 0.0

    @property
    def rollback_rate(self) -> float:
        tot = self.emitted + self.rollback_tokens
        return self.rollback_tokens / max(tot, 1)


@dataclasses.dataclass
class GenResult:
    tokens: List[int]
    stats: GenStats
    timeline: List[Round]

    def report(self, cost: CostModel) -> Dict[str, float]:
        n = len(self.tokens)
        return {
            "tokens": n,
            "M": self.stats.mean_accepted,
            "speedup": cost.speedup_vs_ar(self.timeline, n),
            "per_token_latency": cost.per_token(self.timeline, n),
            "rollback_rate": self.stats.rollback_rate,
            "rollback_tokens": self.stats.rollback_tokens,
            "pruned_tokens": self.stats.pruned_tokens,
            "draft_tokens": self.stats.draft_tokens,
            "target_calls": self.stats.target_calls,
        }
