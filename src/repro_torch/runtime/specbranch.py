"""SpecBranch engine (port of ``repro.runtime.specbranch``) — hybrid
drafting + rollback-aware branch parallelism (Sec. 5, Algorithm 1).

DRAFT stage (serial; target idle): H-RAD predicts s_t from the target
features of the previous target call and the embedding of the newest
token (``core.hrad``).  s_t = 0 (all-reject) drafts nothing and branches
at once; s_t = 1 (confidence) drafts until the draft confidence max q <
epsilon, or gamma tokens; s_t = 2 (all-accept) drafts gamma tokens.  The
stop position is the branch point and the drafted prefix the
verification chunk.  Without H-RAD parameters (or with ``use_hrad``
off) s_t = 1, the implicit confidence signal.

BRANCH stage (parallel): spawn k = max(1, floor(k_max * (1 - q(x_b))))
candidates from q(x_b) (Eq. 7), fork the draft cache and draft a
gamma_branch-token continuation on every branch (batched) while the
target verifies the chunk in the same modeled slot.  A mid-chunk
rejection rolls back and returns to DRAFT; an accepted chunk verifies the
branch point by branch speculative sampling (Algorithm 2): an accepted
branch is kept and the engine stays in BRANCH, where the posterior H-RAD
signal (Sec. 5.2, on this verification's features) chooses how much of
its continuation to keep: all of it (s = 2), none (s = 0: pruned, the
branch point is its first token) or up to its first low-confidence
position (s = 1).  No accepted branch emits the residual sample and
returns to DRAFT.

With the history predictor (``spec_predictor`` "on" / "oracle") each
round's gamma, epsilon and branch cap come from the request's acceptance
history, updated from the verdicts.  In parallel draft mode
(DESIGN.md §7.12) the DRAFT stage proposes its chunk from one masked
forward, then one catch-up forward brings the draft cache to the chunk
head so the branch stage forks exactly as in sequential mode.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import hrad as H
from repro_torch.runtime import prng
from repro_torch.runtime import sampling as S
from repro_torch.runtime.engines import Engine, GenResult, _Ctx
from repro_torch.runtime.runner import ModelRunner


class SpecBranchEngine(Engine):
    name = "specbranch"

    # ------------------------------------------------------------ helpers
    def _hrad_signal(self, feats: Optional[torch.Tensor], token: int,
                     ctx: _Ctx) -> int:
        """s_t from the H-RAD MLP on (feats, embedding of ``token``); the
        soft signal (1) without one."""
        if (not self.ecfg.use_hrad or self.hrad_params is None
                or feats is None):
            return 1
        z = H.build_feature(feats, self._embed_of(token),
                            self.ecfg.hrad_k_layers)
        s = int(H.predict(self.hrad_params, z)[0])
        ctx.stats.hrad_signals.append(s)
        return s

    def _feats_last(self, runner: ModelRunner) -> Optional[torch.Tensor]:
        """The runner's captured points at the last position, batch row
        0: (K, 1, D)."""
        f = runner.last_features
        return None if f is None else f[:, 0:1]

    def _embed_of(self, token: int) -> torch.Tensor:
        return H.token_embedding(
            self.tp, torch.tensor([token], device=self.tp["embed"].device))

    def _branch_k(self, q_b: torch.Tensor,
                  k_cap: Optional[int] = None) -> int:
        if not self.ecfg.use_branch:
            return 1
        cap = self.ecfg.k_max if k_cap is None \
            else min(self.ecfg.k_max, max(1, k_cap))
        return min(cap, S.adaptive_k(float(q_b.max()), cap))

    # ----------------------------------------------------------- drafting
    def _serial_draft(self, draft: ModelRunner, ctx: _Ctx, s: int,
                      gamma: Optional[int] = None,
                      epsilon: Optional[float] = None
                      ) -> Tuple[List[int], List[torch.Tensor],
                                 torch.Tensor]:
        """DRAFT-stage drafting per the signal s (Eq. 6).

        Returns (chunk, q_list for the chunk, q_b at the branch point).
        Every drafted chunk token is ingested.  ``gamma`` / ``epsilon``
        override the static knobs when the history predictor drives them.
        """
        gamma = self.ecfg.gamma if gamma is None else gamma
        epsilon = self.ecfg.epsilon if epsilon is None else epsilon
        if s != 0 and self.ecfg.draft_mode == "parallel":
            return self._serial_draft_parallel(draft, ctx, s, gamma,
                                               epsilon)
        if draft.pending:
            draft.forward([])
        chunk, qs = [], []
        if s == 0:
            ctx.stats.draft_tokens += 1      # the branch-point distribution
            return chunk, qs, self._qsignal(draft.last_logits[0])
        for _ in range(gamma):
            q = self._qprobs(draft.last_logits[0])
            q_sig = self._qsignal(draft.last_logits[0])
            ctx.stats.draft_tokens += 1
            if s == 1 and float(q_sig.max()) < epsilon:
                return chunk, qs, q_sig      # branch point found
            tok = self._sample(ctx, q)
            chunk.append(tok)
            qs.append(q)
            draft.forward([tok])
        ctx.stats.draft_tokens += 1
        return chunk, qs, self._qsignal(draft.last_logits[0])

    def _serial_draft_parallel(self, draft: ModelRunner, ctx: _Ctx, s: int,
                               gamma: int, epsilon: float
                               ) -> Tuple[List[int], List[torch.Tensor],
                                          torch.Tensor]:
        """One-dispatch DRAFT stage: every proposal distribution from one
        masked forward; the sampling loop, epsilon stop and PRNG
        consumption are ``_serial_draft``'s.  The caller runs a catch-up
        ``draft.forward(chunk)`` before the branch stage."""
        q_all = draft.forward_parallel(gamma, self.draft_heads)
        chunk, qs = [], []
        for i in range(gamma):
            lg = q_all[0, i]
            q = self._qprobs(lg)
            q_sig = self._qsignal(lg)
            ctx.stats.draft_tokens += 1
            if s == 1 and float(q_sig.max()) < epsilon:
                return chunk, qs, q_sig      # branch point found
            tok = self._sample(ctx, q)
            chunk.append(tok)
            qs.append(q)
        ctx.stats.draft_tokens += 1
        return chunk, qs, self._qsignal(q_all[0, gamma])

    def _branch_draft(self, draft: ModelRunner, cands: np.ndarray,
                      ctx: _Ctx) -> Tuple[np.ndarray, List[torch.Tensor],
                                          List[torch.Tensor], np.ndarray]:
        """Fork + batched continuation drafting on k branches.

        Returns (conts (k, gb), cont_q sampling dists, cont_sig signal
        dists — lists of (k, V) per step — and confs (k, gb)).
        """
        k = len(cands)
        gb = self.ecfg.gamma_branch
        draft.fork(k)
        draft.forward_batched(cands[:, None])  # advances branch rows
        ctx.stats.draft_tokens += 1
        conts = np.zeros((k, gb), np.int64)
        confs = np.zeros((k, gb), np.float64)
        cont_q: List[torch.Tensor] = []
        cont_sig: List[torch.Tensor] = []
        for j in range(gb):
            q = self._qprobs(draft.last_logits)            # (k, V)
            q_sig = self._qsignal(draft.last_logits)
            cont_q.append(q)
            cont_sig.append(q_sig)
            toks = S.sample(prng.split(ctx.split(), k), q).cpu().numpy()
            conts[:, j] = toks
            confs[:, j] = q_sig.max(-1).values.double().cpu().numpy()
            draft.forward_batched(toks[:, None])
            ctx.stats.draft_tokens += 1
        return conts, cont_q, cont_sig, confs

    # ----------------------------------------------------------- generate
    def generate(self, prompt, n_new, key, embeds=None) -> GenResult:
        self._check_embeds(embeds)
        ctx = _Ctx(key)
        draft, target = self._new_runners()
        draft.prefill(prompt)
        target.prefill(prompt)
        ctx.stats.target_calls += 1
        plen = len(prompt)
        gb = self.ecfg.gamma_branch
        parallel = self.ecfg.use_branch
        parallel_draft = self.ecfg.draft_mode == "parallel"
        pred = self.predictor     # keyed by rid: survives preemption
        if pred is not None:
            pred.start(self.trace_rid)
        dec = None

        mode = "draft"
        chunk: List[int] = []
        chunk_q: List[torch.Tensor] = []
        q_b: Optional[torch.Tensor] = None

        while len(ctx.out) < n_new:
            draft.checkpoint(), target.checkpoint()
            # the round's knobs from the acceptance history
            dec = pred.decide(self.trace_rid) if pred is not None else None
            gamma_t = dec.gamma if dec is not None else self.ecfg.gamma
            eps_t = dec.epsilon if dec is not None else self.ecfg.epsilon
            pobs = dec.obs() if dec is not None else None
            if mode == "draft":
                # ---------------- DRAFT stage (serial) ----------------
                calls0 = draft.n_calls
                # the newest committed token (pending holds the whole
                # un-ingested committed tail in parallel mode)
                e_tok = (draft.pending[-1] if draft.pending
                         else target.pending[-1])
                s = self._hrad_signal(self._feats_last(target), e_tok, ctx)
                chunk, chunk_q, q_b = self._serial_draft(
                    draft, ctx, s, gamma=gamma_t, epsilon=eps_t)
                if parallel_draft and chunk:
                    # catch-up dispatch: the draft cache up to the chunk
                    # head, so the branch stage forks (and reads the true
                    # branch-point distribution) as in sequential mode
                    draft.forward(chunk)
                    q_b = self._qsignal(draft.last_logits[0])
                ndisp = draft.n_calls - calls0
                ctx.timeline.append(
                    ("serial", len(chunk) + 1, 0, ndisp) if parallel_draft
                    else ("serial", len(chunk) + 1, 0))
                if self.rec.enabled:
                    self.rec.spec(
                        rid=self.trace_rid, round=len(ctx.timeline) - 1,
                        stage="draft", drafted=len(chunk) + 1,
                        gamma=gamma_t,
                        eps_stop=(s == 1 and len(chunk) < gamma_t),
                        hrad=(s if self.ecfg.use_hrad else None),
                        pred=pobs, dispatches=ndisp)
                mode = "branch"
                continue

            # ---------------- BRANCH stage (parallel) ----------------
            k = self._branch_k(q_b, dec.k_cap if dec is not None else None)
            cands = S.draw_branch_candidates(ctx.split(), q_b, k,
                                             self.ecfg.branch_mode)
            cands = cands.cpu().numpy()
            # draft k continuations || target verifies the chunk
            conts, cont_q, cont_sig, confs = self._branch_draft(
                draft, cands, ctx)
            n, nxt, all_acc, p_b = self._verify(
                target, chunk, torch.stack(chunk_q) if chunk_q else None,
                ctx)
            ctx.timeline.append(
                ("parallel", gb + 1, 1) if parallel
                else ("serial", gb + 1, 1))
            if pred is not None and chunk:
                # the chunk's verify outcome, from the verdict on the host
                pred.update(self.trace_rid, bool(all_acc),
                            n / max(len(chunk), 1))

            if not all_acc:
                # mid-chunk rejection: branches are doomed (Fig. 1a)
                ctx.out.extend(chunk[:n] + [nxt])
                ctx.stats.emitted += n + 1
                ctx.stats.run_extend(n)
                ctx.stats.run_break()
                ctx.stats.rollback_tokens += (len(chunk) - n) + gb
                if self.rec.enabled:
                    self.rec.spec(
                        rid=self.trace_rid, round=len(ctx.timeline) - 1,
                        stage="branch", committed=n + 1, accepted=n,
                        drafted=len(chunk),
                        rolled_back=(len(chunk) - n) + gb,
                        cause="chunk-reject", gamma=max(len(chunk), 1),
                        k=len(cands), pred=pobs)
                draft.unfork()
                self._reset_lineage(target, plen, ctx)
                self._reset_lineage(draft, plen, ctx)
                mode = "draft"
                continue

            # chunk fully accepted -> branch-point verification (Alg. 2)
            verdict = S.branch_spec_sample(ctx.split(), p_b, cands, q_b)
            if pred is not None:
                # did a hedge branch survive Algorithm 2?
                pred.update(self.trace_rid, verdict.accepted_branch >= 0)
            if verdict.accepted_branch < 0:
                # no branch survives: emit the residual sample, rollback
                ctx.out.extend(chunk + [verdict.token])
                ctx.stats.emitted += len(chunk) + 1
                ctx.stats.run_extend(len(chunk))
                ctx.stats.run_break()
                ctx.stats.rollback_tokens += gb
                if self.rec.enabled:
                    self.rec.spec(
                        rid=self.trace_rid, round=len(ctx.timeline) - 1,
                        stage="branch", committed=len(chunk) + 1,
                        accepted=len(chunk), drafted=len(chunk),
                        rolled_back=gb, cause="branch-miss",
                        gamma=max(len(chunk), 1), k=len(cands), pred=pobs)
                draft.unfork()
                self._reset_lineage(target, plen, ctx)
                self._reset_lineage(draft, plen, ctx)
                mode = "draft"
                continue

            i = verdict.accepted_branch
            tok_b = verdict.token
            n_acc = len(chunk)            # committed chunk length
            ctx.out.extend(chunk + [tok_b])
            ctx.stats.emitted += len(chunk) + 1
            ctx.stats.run_extend(len(chunk) + 1)
            target.pending = [tok_b]
            draft.select(i)
            draft.sync_lineage([int(cands[i])] + [int(t) for t in conts[i]])

            # posterior H-RAD (Sec. 5.2): features from THIS verification
            s = self._hrad_signal(self._feats_last(target), tok_b, ctx)
            cont_i = [int(t) for t in conts[i]]
            q_i = [cq[i] for cq in cont_q]
            pruned = 0
            if s == 2:
                # the draft cache already holds the whole continuation
                chunk, chunk_q = cont_i, q_i
                q_b = self._qsignal(draft.last_logits[0])
            elif s == 0:
                # prune the whole continuation; branch at its first token
                chunk, chunk_q = [], []
                q_b = cont_sig[0][i]
                pruned = gb
                ctx.stats.pruned_tokens += gb
                draft.reset_to(plen + len(ctx.out))   # lineage incl. tok_b
            else:
                # keep it up to its first low-confidence position
                j = next((jj for jj in range(gb) if confs[i, jj] < eps_t),
                         gb)
                if j == gb:
                    chunk, chunk_q = cont_i, q_i
                    q_b = self._qsignal(draft.last_logits[0])
                else:
                    chunk, chunk_q = cont_i[:j], q_i[:j]
                    q_b = cont_sig[j][i]
                    pruned = gb - j
                    ctx.stats.pruned_tokens += gb - j
                    draft.reset_to(plen + len(ctx.out) + j)
            if self.rec.enabled:
                self.rec.spec(
                    rid=self.trace_rid, round=len(ctx.timeline) - 1,
                    stage="branch", committed=n_acc + 1,
                    accepted=n_acc + 1, drafted=n_acc, pruned=pruned,
                    cause="branch-adopt", gamma=max(n_acc, 1),
                    k=len(cands),
                    hrad=(s if self.ecfg.use_hrad else None), pred=pobs)
            mode = "branch"

        ctx.stats.finish()
        return GenResult(ctx.out[:n_new], ctx.stats, ctx.timeline)
