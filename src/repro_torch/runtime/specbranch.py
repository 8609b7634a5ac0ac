"""SpecBranch engine (port of ``repro.runtime.specbranch``) — hybrid
drafting + rollback-aware branch parallelism (Sec. 5, Algorithm 1).

DRAFT stage (serial; target idle): draft per the signal s_t.  Without
H-RAD parameters s_t = 1 (the implicit confidence signal, as in the
reference when ``hrad_params`` is None): draft until the draft
confidence max q < epsilon, or gamma tokens; the stop position is the
branch point and the drafted prefix the verification chunk.

BRANCH stage (parallel): spawn k = max(1, floor(k_max * (1 - q(x_b))))
candidates from q(x_b) (Eq. 7), fork the draft cache and draft a
gamma_branch-token continuation on every branch (batched) while the
target verifies the chunk in the same modeled slot.  A mid-chunk
rejection rolls back and returns to DRAFT; an accepted chunk verifies the
branch point by branch speculative sampling (Algorithm 2): an accepted
branch is kept (its continuation is cut at its first low-confidence
position, which becomes the next branch point) and the engine stays in
BRANCH; no accepted branch emits the residual sample and returns to
DRAFT.

H-RAD (s_t in {0, 2}), the history predictor and parallel drafting are
later slices of the port (ROADMAP.md queue A); the engine raises when
asked for them.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.runtime import prng
from repro_torch.runtime import sampling as S
from repro_torch.runtime.engines import Engine, GenResult, _Ctx
from repro_torch.runtime.runner import ModelRunner


class SpecBranchEngine(Engine):
    name = "specbranch"

    def _branch_k(self, q_b: torch.Tensor) -> int:
        if not self.ecfg.use_branch:
            return 1
        cap = self.ecfg.k_max
        return min(cap, S.adaptive_k(float(q_b.max()), cap))

    # ----------------------------------------------------------- drafting
    def _serial_draft(self, draft: ModelRunner, ctx: _Ctx
                      ) -> Tuple[List[int], List[torch.Tensor],
                                 torch.Tensor]:
        """DRAFT-stage drafting under s_t = 1 (Eq. 6).

        Returns (chunk, q_list for the chunk, q_b at the branch point).
        Every drafted chunk token is ingested.
        """
        gamma, epsilon = self.ecfg.gamma, self.ecfg.epsilon
        if draft.pending:
            draft.forward([])
        chunk, qs = [], []
        for _ in range(gamma):
            q = self._qprobs(draft.last_logits[0])
            q_sig = self._qsignal(draft.last_logits[0])
            ctx.stats.draft_tokens += 1
            if float(q_sig.max()) < epsilon:
                return chunk, qs, q_sig      # branch point found
            tok = self._sample(ctx, q)
            chunk.append(tok)
            qs.append(q)
            draft.forward([tok])
        ctx.stats.draft_tokens += 1
        return chunk, qs, self._qsignal(draft.last_logits[0])

    def _serial_draft_parallel(self, *a, **kw):
        raise NotImplementedError(
            "parallel drafting is not in this slice of the PyTorch port "
            "(ROADMAP.md queue A)")

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
        eps = self.ecfg.epsilon
        parallel = self.ecfg.use_branch

        mode = "draft"
        chunk: List[int] = []
        chunk_q: List[torch.Tensor] = []
        q_b: Optional[torch.Tensor] = None

        while len(ctx.out) < n_new:
            draft.checkpoint(), target.checkpoint()
            if mode == "draft":
                # ---------------- DRAFT stage (serial) ----------------
                chunk, chunk_q, q_b = self._serial_draft(draft, ctx)
                ctx.timeline.append(("serial", len(chunk) + 1, 0))
                mode = "branch"
                continue

            # ---------------- BRANCH stage (parallel) ----------------
            k = self._branch_k(q_b)
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

            if not all_acc:
                # mid-chunk rejection: branches are doomed (Fig. 1a)
                ctx.out.extend(chunk[:n] + [nxt])
                ctx.stats.emitted += n + 1
                ctx.stats.run_extend(n)
                ctx.stats.run_break()
                ctx.stats.rollback_tokens += (len(chunk) - n) + gb
                draft.unfork()
                self._reset_lineage(target, plen, ctx)
                self._reset_lineage(draft, plen, ctx)
                mode = "draft"
                continue

            # chunk fully accepted -> branch-point verification (Alg. 2)
            verdict = S.branch_spec_sample(ctx.split(), p_b, cands, q_b)
            if verdict.accepted_branch < 0:
                # no branch survives: emit the residual sample, rollback
                ctx.out.extend(chunk + [verdict.token])
                ctx.stats.emitted += len(chunk) + 1
                ctx.stats.run_extend(len(chunk))
                ctx.stats.run_break()
                ctx.stats.rollback_tokens += gb
                draft.unfork()
                self._reset_lineage(target, plen, ctx)
                self._reset_lineage(draft, plen, ctx)
                mode = "draft"
                continue

            i = verdict.accepted_branch
            tok_b = verdict.token
            ctx.out.extend(chunk + [tok_b])
            ctx.stats.emitted += len(chunk) + 1
            ctx.stats.run_extend(len(chunk) + 1)
            target.pending = [tok_b]
            draft.select(i)
            draft.sync_lineage([int(cands[i])] + [int(t) for t in conts[i]])

            # keep the continuation up to its first low-confidence position
            cont_i = [int(t) for t in conts[i]]
            q_i = [cq[i] for cq in cont_q]
            j = next((jj for jj in range(gb) if confs[i, jj] < eps), gb)
            if j == gb:
                chunk, chunk_q = cont_i, q_i
                q_b = self._qsignal(draft.last_logits[0])
            else:
                chunk, chunk_q = cont_i[:j], q_i[:j]
                q_b = cont_sig[j][i]
                ctx.stats.pruned_tokens += gb - j
                draft.reset_to(plen + len(ctx.out) + j)
            mode = "branch"

        ctx.stats.finish()
        return GenResult(ctx.out[:n_new], ctx.stats, ctx.timeline)
