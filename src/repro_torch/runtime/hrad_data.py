"""H-RAD offline training-data collection (port of
``repro.runtime.hrad_data``; Sec. 6, "H-RAD Training").

Runs vanilla-SD rounds over a corpus of prompts and records, per round,

    z_t   = concat(target features f_{t-1} at the round's first input
            position, embedding e_t of that input token)      (Eq. 4)
    label = 0 if nothing accepted | 1 if partial | 2 if all accepted

exactly the a-priori feature the SpecBranch DRAFT stage feeds the MLP at
inference time.  The engine is the port's sequential ``SpSEngine``; its
target runner keeps the last ``hrad_k_layers`` feature points (the
reference's runner keeps all of them and ``build_feature`` takes the same
last K).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import hrad as H
from repro_torch.runtime import prng
from repro_torch.runtime.engines import EngineConfig, SpSEngine, _Ctx
from repro_torch.runtime.runner import ModelRunner


class _CollectingSpS(SpSEngine):
    """Vanilla SD that records (z_t, s_t) per verification round."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.zs: List[np.ndarray] = []
        self.labels: List[int] = []

    def _new_runners(self):
        return (ModelRunner(self.dp, self.dcfg, max_len=self.ecfg.max_len),
                ModelRunner(self.tp, self.tcfg, max_len=self.ecfg.max_len,
                            feature_points=self.ecfg.hrad_k_layers))

    def generate(self, prompt, n_new, key, embeds=None):
        ctx = _Ctx(key)
        draft, target = self._new_runners()
        draft.prefill(prompt)
        target.prefill(prompt)
        plen = len(prompt)
        while len(ctx.out) < n_new:
            draft.checkpoint(), target.checkpoint()
            feats = target.last_features
            tok0 = (draft.pending or target.pending)[0]
            z = None
            if feats is not None:
                emb = self.tp["embed"][torch.tensor(
                    [tok0], device=self.tp["embed"].device)].float()
                z = H.build_feature(feats[:, 0:1], emb,
                                    self.ecfg.hrad_k_layers)
            drafted, q_stack, _ = self._draft_round(draft, ctx,
                                                    self.ecfg.gamma)
            g = len(drafted)
            n, nxt, all_acc, bonus = self._verify(target, drafted, q_stack,
                                                  ctx)
            if z is not None and g == self.ecfg.gamma:
                self.zs.append(z[0].cpu().numpy())
                self.labels.append(H.label_from_outcome(n, g))
            if all_acc:
                nxt = self._sample(ctx, bonus)
                ctx.out.extend(drafted + [nxt])
                target.pending = [nxt]
                draft.pending = [drafted[-1], nxt]
            else:
                ctx.out.extend(drafted[:n] + [nxt])
                self._reset_lineage(target, plen, ctx)
                self._reset_lineage(draft, plen, ctx)
        return ctx.out


def collect(draft_params, draft_cfg, target_params, target_cfg,
            prompts: Sequence[Sequence[int]], n_new: int,
            ecfg: EngineConfig, seed: int = 0
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Collect an H-RAD dataset over ``prompts`` (per prompt, the key
    ``key, k = split(key)`` from ``PRNGKey(seed)``, as the reference).
    Returns (z (N, (K+1)*D) float32, labels (N,) int32)."""
    eng = _CollectingSpS(draft_params, draft_cfg, target_params, target_cfg,
                         ecfg)
    key = prng.PRNGKey(seed)
    for p in prompts:
        ks = prng.split(key)
        key, k = ks[0], ks[1]
        eng.generate(list(p), n_new, k)
    return np.stack(eng.zs), np.asarray(eng.labels, np.int32)
