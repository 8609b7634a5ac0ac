"""Sequential serving engines (port of ``repro.runtime.engines``):
Autoregressive, SpS, AdaEDL, ConfidenceSD, Lookahead and PEARL over the
``ModelRunner`` substrate, plus the engine configuration and per-request
results the batched engines share.  SpecBranch is in
``runtime.specbranch``.

Engine contract: ``generate(prompt, n_new, key)`` returns a ``GenResult``
whose ``tokens`` are distributed exactly as target-model decoding
(token-for-token identical under greedy), drawing every random number
from the threefry key as the reference does, so a stream equals the
reference's on the same weights.  ``prompt + ctx.out`` is the committed
stream; after a rejection the runners are reset to ``len(prompt) +
len(out) - 1`` with the newest token pending.

Rollback accounting (Sec. 6 / E.3): ``rollback_tokens`` counts draft-forward
tokens discarded after target verification at sequence-position
granularity; tokens cut before verification are ``pruned_tokens``.

``hrad_params`` (an H-RAD MLP, ``core.hrad``) is used by SpecBranch;
the target runner then captures the last ``hrad_k_layers`` feature points
of every forward.  With a recorder installed (``set_recorder``) the
engines emit the reference's per-round spec events and the runners one
model_call event per forward.

``draft_mode="parallel"`` (DESIGN.md §7.12) proposes a whole chunk from
ONE masked draft forward through multi-position draft heads
(``draft_heads``, ``models.model.init_draft_heads``); the verify
protocol, PRNG consumption and rollback are those of the sequential
drafter, only the proposal distributions differ.  ``spec_predictor``
"on" / "oracle" installs the history predictor (``runtime.predictor``),
which SpecBranch consults each round.  Stub-frontend embeddings are a
later slice (ROADMAP.md queue A).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import NULL_RECORDER
from repro_torch.runtime import predictor as P
from repro_torch.runtime import prng
from repro_torch.runtime import sampling as S
from repro_torch.runtime.cost_model import CostModel, Round
from repro_torch.runtime.runner import ModelRunner


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
    spec_predictor: str = "off"    # "off" | "on" | "oracle": the history
    #   predictor (runtime.predictor) adapts gamma/k/epsilon per round;
    #   "off" runs every path without one
    draft_mode: str = "sequential" # "sequential" | "parallel": the whole
    #   chunk from one masked draft forward through draft heads
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


class _Ctx:
    def __init__(self, key: torch.Tensor):
        self.out: List[int] = []
        self.stats = GenStats()
        self.timeline: List[Round] = []
        self.key = key

    def split(self) -> torch.Tensor:
        self.key, k = prng.split(self.key)
        return k


# ---------------------------------------------------------------------------
# base
# ---------------------------------------------------------------------------

class Engine:
    name = "base"
    # observability (obs.trace): the class-level NULL_RECORDER keeps every
    # hook a no-op; the sequential scheduler sets trace_rid before each
    # request so that spec events carry request ids
    rec = NULL_RECORDER
    trace_rid = 0

    def __init__(self, draft_params, draft_cfg: Optional[ModelConfig],
                 target_params, target_cfg: ModelConfig,
                 ecfg: EngineConfig, hrad_params=None, draft_heads=None):
        self.dp, self.dcfg = draft_params, draft_cfg
        self.tp, self.tcfg = target_params, target_cfg
        self.ecfg = ecfg
        # multi-position draft heads beside the draft's weights, the head
        # stack in float32 once (the head product runs in f32)
        self.draft_heads = None
        if draft_heads is not None and draft_params is not None:
            dev = draft_params["embed"].device
            self.draft_heads = {
                k: v.to(dev, torch.float32 if k == "heads" else v.dtype)
                for k, v in draft_heads.items()}
        if ecfg.draft_mode not in ("sequential", "parallel"):
            raise ValueError(f"unknown draft_mode {ecfg.draft_mode!r}")
        if ecfg.draft_mode == "parallel" and draft_cfg is not None:
            if draft_heads is None:
                raise ValueError(
                    "draft_mode='parallel' needs draft_heads (see "
                    "models.model.init_draft_heads / training.pairs)")
            if any(m == "mamba" for m, _ in draft_cfg.pattern):
                raise ValueError(
                    "parallel draft mode needs an attention-only draft "
                    f"model, got pattern {draft_cfg.pattern}")
            need = max(ecfg.gamma, ecfg.gamma_branch)
            have = int(draft_heads["heads"].shape[0])
            if have < need:
                raise ValueError(
                    f"draft_heads has K={have} heads; parallel mode needs "
                    f">= max(gamma, gamma_branch) = {need}")
        # the MLP in float32 beside the target's weights
        self.hrad_params = (None if hrad_params is None else
                            {k: v.to(device=target_params["embed"].device,
                                     dtype=torch.float32)
                             for k, v in hrad_params.items()})
        # the history predictor; None for "off" (call sites guard on that,
        # so the off path runs exactly the predictor-less code)
        self.predictor = P.make_predictor(
            ecfg.spec_predictor, ecfg.gamma, ecfg.k_max, ecfg.epsilon)

    def set_recorder(self, rec, rid: int = 0) -> None:
        self.rec = rec
        self.trace_rid = rid

    def _new_runners(self) -> Tuple[Optional[ModelRunner], ModelRunner]:
        recorder = self.rec if self.rec.enabled else None
        d = (ModelRunner(self.dp, self.dcfg, max_len=self.ecfg.max_len,
                         recorder=recorder, trace_role="draft")
             if self.dcfg is not None else None)
        # only H-RAD reads features, and only the target's
        hrad = self.hrad_params is not None and self.ecfg.use_hrad
        t = ModelRunner(self.tp, self.tcfg, max_len=self.ecfg.max_len,
                        feature_points=self.ecfg.hrad_k_layers if hrad
                        else 0, recorder=recorder, trace_role="target")
        return d, t

    def _tprobs(self, logits: torch.Tensor) -> torch.Tensor:
        return S.probs_from_logits(logits, self.ecfg.temperature)

    def _qprobs(self, logits: torch.Tensor) -> torch.Tensor:
        return S.probs_from_logits(logits, self.ecfg.draft_temperature)

    def _qsignal(self, logits: torch.Tensor) -> torch.Tensor:
        return S.probs_from_logits(logits, self.ecfg.signal_temperature)

    def _sample(self, ctx: _Ctx, probs: torch.Tensor) -> int:
        return int(S.sample(ctx.split(), probs))

    def generate(self, prompt: Sequence[int], n_new: int,
                 key: torch.Tensor, embeds=None) -> GenResult:
        raise NotImplementedError

    def _check_embeds(self, embeds) -> None:
        if embeds is not None:
            raise NotImplementedError(
                "stub-frontend embeddings are not in this slice of the "
                "PyTorch port (ROADMAP.md queue A)")

    # shared target verification ------------------------------------------
    def _verify(self, target: ModelRunner, drafts: List[int],
                q_stack: Optional[torch.Tensor], ctx: _Ctx):
        """Target-verify ``pending + drafts``; one target call.

        Returns (n_accepted, next_token, all_accepted, bonus_probs).
        p for drafts[i] is the target distribution after pending +
        drafts[:i]; with nothing pending the distribution before drafts[0]
        is the previous call's last logits (PEARL / SpecBranch steady
        state).
        """
        npend = len(target.pending)
        g = len(drafts)
        pre = (self._tprobs(target.last_logits[0]) if npend == 0 else None)
        logits = target.forward(drafts)
        ctx.stats.target_calls += 1
        row = logits[0]
        bonus = self._tprobs(row[npend + g - 1]) if (npend + g) > 0 else pre
        if g == 0:
            return 0, -1, True, bonus
        if npend == 0:
            p_stack = torch.cat([pre[None], self._tprobs(row[:g - 1])])
        else:
            p_stack = self._tprobs(row[npend - 1: npend - 1 + g])
        verdict = S.verify_chain(ctx.split(), p_stack, q_stack[:g], drafts)
        return verdict.n_accepted, verdict.next_token, \
            verdict.all_accepted, bonus

    # lineage reset ---------------------------------------------------------
    def _reset_lineage(self, runner: ModelRunner, prompt_len: int,
                       ctx: _Ctx) -> None:
        """Reset a runner to the committed stream, newest tail pending.

        Sequential drafting: the runner's lineage always covers the
        committed stream, so this is reset_to(committed - 1) with the last
        token pending.  In parallel draft mode drafted tokens never enter
        the draft cache, so its lineage may be BEHIND the committed
        stream; the un-ingested committed tail then becomes pending."""
        tgt_len = prompt_len + len(ctx.out) - 1
        if runner.pos >= tgt_len:
            runner.reset_to(tgt_len)
            runner.pending = [ctx.out[-1]]
        else:
            runner.pending = [int(t)
                              for t in ctx.out[runner.pos - prompt_len:]]


# ---------------------------------------------------------------------------
# 1. Autoregressive (1.00x baseline)
# ---------------------------------------------------------------------------

class AutoregressiveEngine(Engine):
    name = "autoregressive"

    def __init__(self, target_params, target_cfg, ecfg: EngineConfig):
        super().__init__(None, None, target_params, target_cfg, ecfg)

    def generate(self, prompt, n_new, key, embeds=None) -> GenResult:
        self._check_embeds(embeds)
        ctx = _Ctx(key)
        _, target = self._new_runners()
        target.forward(list(prompt))
        ctx.stats.target_calls += 1
        for _ in range(n_new):
            tok = self._sample(ctx, self._tprobs(target.last_logits[0]))
            ctx.out.append(tok)
            target.forward([tok])
            ctx.stats.target_calls += 1
            ctx.timeline.append(("target", 0, 1))
        ctx.stats.emitted = len(ctx.out)
        ctx.stats.finish()
        return GenResult(ctx.out, ctx.stats, ctx.timeline)


# ---------------------------------------------------------------------------
# 2/3. SpS (vanilla SD) and AdaEDL — serial draft-then-verify
# ---------------------------------------------------------------------------

class SpSEngine(Engine):
    name = "sps"

    def _stop_rule(self, q: torch.Tensor) -> bool:
        return False

    def _draft_round(self, draft: ModelRunner, ctx: _Ctx, gamma: int
                     ) -> Tuple[List[int], torch.Tensor, List[float]]:
        """Draft up to gamma tokens, ingesting all but the last.

        Returns (drafted, q_stack (g, V), confidences).  Exactly g draft
        forwards per round (the pending ingest doubles as the first one).
        """
        if self.ecfg.draft_mode == "parallel":
            return self._draft_round_parallel(draft, ctx, gamma)
        if draft.pending:
            draft.forward([])
        qs, drafted, confs = [], [], []
        for i in range(gamma):
            q = self._qprobs(draft.last_logits[0])
            q_sig = self._qsignal(draft.last_logits[0])
            tok = self._sample(ctx, q)
            qs.append(q)
            confs.append(float(q_sig.max()))
            drafted.append(tok)
            ctx.stats.draft_tokens += 1
            if i == gamma - 1 or self._stop_rule(q_sig):
                break
            draft.forward([tok])
        return drafted, torch.stack(qs), confs

    def _draft_round_parallel(self, draft: ModelRunner, ctx: _Ctx,
                              gamma: int
                              ) -> Tuple[List[int], torch.Tensor,
                                         List[float]]:
        """One-dispatch drafting (DESIGN.md §7.12): every proposal
        distribution comes from one masked forward; sampling, stop rules
        and PRNG consumption (one ``ctx.split()`` per drafted token) are
        the sequential loop's, so only the q_i distributions differ."""
        q_all = draft.forward_parallel(gamma, self.draft_heads)
        qs, drafted, confs = [], [], []
        for i in range(gamma):
            lg = q_all[0, i]
            q = self._qprobs(lg)
            q_sig = self._qsignal(lg)
            tok = self._sample(ctx, q)
            qs.append(q)
            confs.append(float(q_sig.max()))
            drafted.append(tok)
            ctx.stats.draft_tokens += 1
            if i == gamma - 1 or self._stop_rule(q_sig):
                break
        return drafted, torch.stack(qs), confs

    def generate(self, prompt, n_new, key, embeds=None) -> GenResult:
        self._check_embeds(embeds)
        ctx = _Ctx(key)
        draft, target = self._new_runners()
        draft.prefill(prompt)
        target.prefill(prompt)
        ctx.stats.target_calls += 1
        plen = len(prompt)
        parallel_draft = self.ecfg.draft_mode == "parallel"
        while len(ctx.out) < n_new:
            draft.checkpoint(), target.checkpoint()
            calls0 = draft.n_calls + target.n_calls
            drafted, q_stack, _ = self._draft_round(draft, ctx,
                                                    self.ecfg.gamma)
            g = len(drafted)
            n, nxt, all_acc, bonus = self._verify(target, drafted, q_stack,
                                                  ctx)
            ndisp = draft.n_calls + target.n_calls - calls0
            ctx.timeline.append(("serial", g, 1, ndisp) if parallel_draft
                                else ("serial", g, 1))
            if all_acc:
                nxt = self._sample(ctx, bonus)
                ctx.out.extend(drafted + [nxt])
                ctx.stats.emitted += g + 1
                ctx.stats.run_extend(g + 1)   # bonus continues the run
                target.pending = [nxt]
                # parallel mode: drafted tokens never entered the draft
                # cache, so the whole accepted run becomes pending
                draft.pending = (drafted + [nxt] if parallel_draft
                                 else [drafted[-1], nxt])
                if self.rec.enabled:
                    self.rec.spec(rid=self.trace_rid,
                                  round=len(ctx.timeline) - 1, stage="sps",
                                  committed=g + 1, accepted=g, drafted=g,
                                  cause="accept", gamma=g, bonus=True,
                                  dispatches=ndisp)
            else:
                ctx.out.extend(drafted[:n] + [nxt])
                ctx.stats.emitted += n + 1
                ctx.stats.run_extend(n)
                ctx.stats.run_break()
                ctx.stats.rollback_tokens += g - n
                self._reset_lineage(target, plen, ctx)
                self._reset_lineage(draft, plen, ctx)
                if self.rec.enabled:
                    self.rec.spec(rid=self.trace_rid,
                                  round=len(ctx.timeline) - 1, stage="sps",
                                  committed=n + 1, accepted=n, drafted=g,
                                  rolled_back=g - n, cause="chunk-reject",
                                  gamma=g, dispatches=ndisp)
        ctx.stats.finish()
        return GenResult(ctx.out[:n_new], ctx.stats, ctx.timeline)


class AdaEDLEngine(SpSEngine):
    name = "adaedl"

    def _stop_rule(self, q: torch.Tensor) -> bool:
        bound = float(S.entropy_bound(q, self.ecfg.adaedl_lambda))
        return bound < self.ecfg.epsilon


class ConfidenceSDEngine(SpSEngine):
    """Implicit confidence early-stopping + vanilla SD (Table 4 baseline)."""
    name = "confidence-sd"

    def _stop_rule(self, q: torch.Tensor) -> bool:
        return float(q.max()) < self.ecfg.epsilon


# ---------------------------------------------------------------------------
# 4. Lookahead-lite (n-gram pool, no draft model)
# ---------------------------------------------------------------------------

class LookaheadEngine(Engine):
    name = "lookahead"

    def __init__(self, target_params, target_cfg, ecfg: EngineConfig):
        super().__init__(None, None, target_params, target_cfg, ecfg)

    def generate(self, prompt, n_new, key, embeds=None) -> GenResult:
        self._check_embeds(embeds)
        ctx = _Ctx(key)
        _, target = self._new_runners()
        target.prefill(prompt)
        ctx.stats.target_calls += 1
        plen = len(prompt)
        n = self.ecfg.lookahead_n
        pool: Dict[tuple, List[int]] = {}
        hist = list(prompt)

        def update_pool(seq):
            for i in range(max(0, len(seq) - n)):
                pool[tuple(seq[i:i + n - 1])] = \
                    seq[i + n - 1: i + n - 1 + self.ecfg.gamma]

        update_pool(hist)
        while len(ctx.out) < n_new:
            target.checkpoint()
            guess = pool.get(tuple(hist[-(n - 1):]), [])[:self.ecfg.gamma]
            npend = len(target.pending)
            logits = target.forward(list(guess))
            ctx.stats.target_calls += 1
            ctx.timeline.append(("serial", 0, 1))
            row = logits[0]
            n_ok = 0
            for i, gtok in enumerate(guess):
                p = self._tprobs(row[npend - 1 + i])
                if int(torch.argmax(p)) != gtok:
                    break
                n_ok += 1
            nxt = self._sample(ctx, self._tprobs(row[npend - 1 + n_ok]))
            emitted = list(guess[:n_ok]) + [nxt]
            ctx.out.extend(emitted)
            ctx.stats.emitted += len(emitted)
            ctx.stats.run_extend(n_ok)
            ctx.stats.run_break()
            ctx.stats.rollback_tokens += len(guess) - n_ok
            if self.rec.enabled:
                self.rec.spec(rid=self.trace_rid,
                              round=len(ctx.timeline) - 1, stage="sps",
                              committed=len(emitted), accepted=n_ok,
                              drafted=len(guess),
                              rolled_back=len(guess) - n_ok,
                              cause=("accept" if n_ok == len(guess)
                                     else "chunk-reject"),
                              gamma=len(guess))
            self._reset_lineage(target, plen, ctx)
            hist.extend(emitted)
            update_pool(hist)
        ctx.stats.finish()
        return GenResult(ctx.out[:n_new], ctx.stats, ctx.timeline)


# ---------------------------------------------------------------------------
# 5. PEARL — chunk-level parallel drafting/verification
# ---------------------------------------------------------------------------

class PEARLEngine(SpSEngine):
    """Parallel SD with pre/post-verify (PEARL, [25]).

    Warm-up round: draft a chunk while the target pre-verifies its first
    token.  Steady state: the target verifies the current chunk while the
    draft generates the next one; a mid-chunk rejection dooms the whole
    parallel chunk (Fig. 1a) — the rollback cost SpecBranch attacks.
    """
    name = "pearl"

    def generate(self, prompt, n_new, key, embeds=None) -> GenResult:
        if self.ecfg.draft_mode == "parallel":
            raise NotImplementedError(
                "PEARL pipelines sequential drafting against verification; "
                "use draft_mode='sequential'")
        self._check_embeds(embeds)
        ctx = _Ctx(key)
        draft, target = self._new_runners()
        draft.prefill(prompt)
        target.prefill(prompt)
        ctx.stats.target_calls += 1
        plen = len(prompt)
        gamma = self.ecfg.gamma
        cur: List[int] = []
        cur_q = None
        while len(ctx.out) < n_new:
            draft.checkpoint(), target.checkpoint()
            if not cur:
                # ---- warm-up: draft chunk || pre-verify first token ----
                cur, cur_q, _ = self._draft_round(draft, ctx, gamma)
                draft.pending = [cur[-1]]
                n, nxt, ok, _ = self._verify(target, cur[:1], cur_q[:1], ctx)
                ctx.timeline.append(("parallel", len(cur), 1))
                if not ok:
                    ctx.stats.rollback_tokens += len(cur)
                    ctx.stats.run_break()
                    ctx.out.append(nxt)
                    ctx.stats.emitted += 1
                    self._reset_lineage(target, plen, ctx)
                    self._reset_lineage(draft, plen, ctx)
                    if self.rec.enabled:
                        self.rec.spec(rid=self.trace_rid,
                                      round=len(ctx.timeline) - 1,
                                      stage="sps", committed=1, accepted=0,
                                      drafted=len(cur),
                                      rolled_back=len(cur),
                                      cause="chunk-reject", gamma=1)
                    cur = []
                    continue
                ctx.out.append(cur[0])
                ctx.stats.emitted += 1
                ctx.stats.run_extend(1)
                if self.rec.enabled:
                    self.rec.spec(rid=self.trace_rid,
                                  round=len(ctx.timeline) - 1, stage="sps",
                                  committed=1, accepted=1,
                                  drafted=len(cur), cause="accept", gamma=1)
                rest, rest_q = cur[1:], cur_q[1:]
            else:
                rest, rest_q = cur, cur_q

            # ---- parallel: verify `rest` || draft next chunk ----
            nxt_chunk, nxt_q, _ = self._draft_round(draft, ctx, gamma)
            draft.pending = [nxt_chunk[-1]]
            n, nxt, all_acc, bonus = self._verify(target, rest, rest_q, ctx)
            ctx.timeline.append(("parallel", len(nxt_chunk), 1))
            if all_acc:
                ctx.out.extend(rest)
                ctx.stats.emitted += len(rest)
                ctx.stats.run_extend(len(rest))
                if self.rec.enabled:
                    self.rec.spec(rid=self.trace_rid,
                                  round=len(ctx.timeline) - 1, stage="sps",
                                  committed=len(rest), accepted=len(rest),
                                  drafted=len(nxt_chunk), cause="accept",
                                  gamma=max(len(rest), 1))
                cur, cur_q = nxt_chunk, nxt_q   # pipeline rolls on
            else:
                ctx.out.extend(rest[:n] + [nxt])
                ctx.stats.emitted += n + 1
                ctx.stats.run_extend(n)
                ctx.stats.run_break()
                # doomed: rest beyond n + the whole speculative next chunk
                ctx.stats.rollback_tokens += (len(rest) - n) + len(nxt_chunk)
                self._reset_lineage(target, plen, ctx)
                self._reset_lineage(draft, plen, ctx)
                if self.rec.enabled:
                    self.rec.spec(rid=self.trace_rid,
                                  round=len(ctx.timeline) - 1, stage="sps",
                                  committed=n + 1, accepted=n,
                                  drafted=len(nxt_chunk),
                                  rolled_back=(len(rest) - n)
                                  + len(nxt_chunk),
                                  cause="chunk-reject",
                                  gamma=max(len(rest), 1))
                cur = []
        ctx.stats.finish()
        return GenResult(ctx.out[:n_new], ctx.stats, ctx.timeline)
