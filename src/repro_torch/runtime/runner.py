"""Host-side model runner (port of ``repro.runtime.runner``): owns the dense
ring decode cache, logical position, pending tokens and last logits of one
model instance (draft or target).

Rollback model, as in the reference:

* Attention: positional.  Stale slots beyond the kept length are masked
  by causality until the next write overwrites them, so ``reset_to`` is
  bookkeeping.
* Mamba layers carry recurrent state: rollback restores the latest
  checkpoint <= the target length and replays the delta — a real extra
  forward, logged in ``replay_calls``.

Branch forks replicate the cache on the batch axis (axis 1 of every
leaf).  The cache is written IN PLACE by each forward; ``fork`` makes the
branch rows a copy, so ``unfork`` restores the untouched pre-fork cache
as the reference's immutable arrays do, and ``checkpoint`` COPIES the
Mamba carry leaves (the reference holds references to immutable arrays,
which later in-place writes would mutate here).  The attention leaves are
not copied: their rollback is positional, so the live cache serves any
checkpoint.

``last_features`` holds what H-RAD reads of the last forward: the
hidden state after each of the last ``feature_points`` feature points at
the final position, (K, B, D), where the reference keeps every point at
every position; it follows the reference's lifecycle (set by every
forward, saved by ``checkpoint``, sliced by ``select``, cleared by
``reset_to`` and ``unfork``).  A runner built with ``feature_points`` 0
captures nothing.

``forward_parallel`` is the single-pass parallel draft (DESIGN.md
§7.12): the pending tokens plus g masked draft slots in one forward, the
slots' keys stored invisible.  Stub-frontend embeddings are a later
slice of the port (ROADMAP.md queue A).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def _later_slice(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in this slice of the PyTorch port (ROADMAP.md "
        "queue A)")


def _has_ssm(cfg: ModelConfig) -> bool:
    return any(m == "mamba" for m, _ in cfg.pattern)


def _is_ssm_slot(c: Dict[str, torch.Tensor]) -> bool:
    return "ssm" in c


@dataclasses.dataclass
class _Checkpoint:
    pos: int
    ssm: List[Dict[str, torch.Tensor]]     # copies of the carry slots
    last_logits: Optional[torch.Tensor]
    last_features: Optional[torch.Tensor]


class ModelRunner:
    """One model + its decode cache, driven token-by-token from the host.

    Invariants:
      * ``tokens[:pos]`` are ingested in the cache; ``pending`` are emitted
        by the engine but not yet ingested.
      * ``last_logits`` is the (B, V) distribution following ``tokens[pos-1]``.
    """

    MAX_CHECKPOINTS = 8

    def __init__(self, params, cfg: ModelConfig, *, max_len: int = 4096,
                 feature_points: int = 0, recorder=None,
                 trace_role: str = ""):
        self.params = params
        self.cfg = cfg
        self.max_len = max_len
        self.feature_points = feature_points
        # optional obs.trace recorder: one model_call event per forward
        self.rec = recorder
        self.trace_role = trace_role
        self.device = params["embed"].device
        self.batch = 1
        self.has_ssm = _has_ssm(cfg)
        self.cache = M.init_cache(cfg, 1, max_len, self.device)
        self.pos = 0
        self.pending: List[int] = []
        self.last_logits: Optional[torch.Tensor] = None     # (B, V)
        self.last_features: Optional[torch.Tensor] = None   # (K, B, D)
        self.tokens: List[int] = []
        self.n_calls = 0
        self.n_call_tokens = 0
        self.replay_calls = 0
        self._ckpts: List[_Checkpoint] = []
        self._prefork: Optional[Tuple[Any, int]] = None

    @torch.no_grad()
    def _fwd(self, tokens: torch.Tensor) -> torch.Tensor:
        B, T = tokens.shape
        positions = (self.pos + torch.arange(T, dtype=torch.int32,
                                             device=self.device)
                     ).expand(B, T).contiguous()
        capture = self.feature_points > 0
        logits, aux = M.forward(self.params, self.cfg, tokens,
                                cache=self.cache, positions=positions,
                                feature_mode="last" if capture else None,
                                feature_points=self.feature_points)
        self.last_features = aux["features"] if capture else None
        return logits

    # -------------------------------------------------------------- forward
    def forward(self, tokens: Sequence[int]) -> torch.Tensor:
        """Ingest ``pending + tokens`` (batch 1).  Returns logits (1, T, V)."""
        assert self.batch == 1
        toks = list(self.pending) + [int(t) for t in tokens]
        self.pending = []
        assert toks, "forward of zero tokens"
        logits = self._fwd(torch.tensor([toks], dtype=torch.int64,
                                        device=self.device))
        self.pos += len(toks)
        self.tokens.extend(toks)
        self.n_calls += 1
        self.n_call_tokens += len(toks)
        self.last_logits = logits[:, -1]
        if self.rec is not None and self.rec.enabled:
            self.rec.model_call(role=self.trace_role, tokens=len(toks),
                                batch=1, pos=self.pos)
        return logits

    @torch.no_grad()
    def forward_parallel(self, g: int, dhead) -> torch.Tensor:
        """Single-pass parallel draft: ingest ``pending`` and run ``g``
        masked draft slots in ONE forward.

        Only the pending tokens advance ``pos`` / ``tokens``: the slots'
        cache writes are invisible (stored at position -1) and are
        overwritten when real tokens arrive at those positions.  Returns
        q_all (1, g+1, V) f32 raw logits: entry 0 the AR distribution
        after the pending tokens (what a sequential tick would see),
        entry i head i's distribution for position ``pos + i``, entry g
        the next-position signal distribution (SpecBranch's q_b)."""
        assert self.batch == 1
        assert not self.has_ssm, \
            "parallel draft mode needs an attention-only draft model"
        toks = [int(t) for t in self.pending]
        self.pending = []
        assert toks, "forward_parallel with no pending tokens"
        nreal, T = len(toks), len(toks) + g
        dev = self.device
        positions, pdraft = M.pdraft_frame(
            torch.tensor([self.pos], device=dev),
            torch.tensor([nreal], device=dev), T, dhead["mask_embed"])
        logits, aux = M.forward(
            self.params, self.cfg,
            torch.tensor([toks + [0] * g], dtype=torch.int64, device=dev),
            cache=self.cache, positions=positions, feature_mode="all",
            feature_points=1, pdraft=pdraft)
        hlg = M.draft_head_logits(self.params, self.cfg, dhead,
                                  aux["features"][-1][:, nreal:])
        ar = logits[:, nreal - 1]
        q_all = torch.cat([ar.float()[:, None], hlg], dim=1)
        self.pos += nreal
        self.tokens.extend(toks)
        self.n_calls += 1
        self.n_call_tokens += T
        self.last_logits = ar
        self.last_features = None
        if self.rec is not None and self.rec.enabled:
            self.rec.model_call(role=self.trace_role, tokens=T, batch=1,
                                pos=self.pos)
        return q_all

    def forward_embeds(self, embeds) -> torch.Tensor:
        raise _later_slice("stub-frontend embeddings")

    def forward_batched(self, token_rows: np.ndarray) -> torch.Tensor:
        """Branch-mode forward: token_rows (k, T), one row per branch."""
        assert not self.pending and self.batch == token_rows.shape[0]
        logits = self._fwd(torch.as_tensor(np.asarray(token_rows),
                                           dtype=torch.int64,
                                           device=self.device))
        self.pos += token_rows.shape[1]
        self.n_calls += 1
        self.n_call_tokens += int(np.prod(token_rows.shape))
        self.last_logits = logits[:, -1]
        if self.rec is not None and self.rec.enabled:
            self.rec.model_call(role=self.trace_role,
                                tokens=int(np.prod(token_rows.shape)),
                                batch=self.batch, pos=self.pos)
        return logits

    def prefill(self, prompt: Sequence[int]) -> None:
        """Ingest prompt[:-1]; the final prompt token becomes pending so the
        first verification round always has >= 1 input token."""
        prompt = list(prompt)
        assert len(prompt) >= 2, "need a prompt of >= 2 tokens"
        self.forward(prompt[:-1])
        self.pending = [prompt[-1]]
        self.checkpoint()

    # ----------------------------------------------------------- rollback
    @torch.no_grad()
    def checkpoint(self) -> None:
        """Record a restore point (round start, batch 1): a copy of every
        Mamba carry slot; nothing for an attention-only model."""
        if not self.has_ssm:
            return
        ssm = [{k: v.clone() for k, v in c.items()}
               for c in M.iter_slots(self.cache) if _is_ssm_slot(c)]
        self._ckpts.append(_Checkpoint(self.pos, ssm, self.last_logits,
                                       self.last_features))
        if len(self._ckpts) > self.MAX_CHECKPOINTS:
            self._ckpts.pop(0)

    @torch.no_grad()
    def reset_to(self, abs_len: int) -> None:
        """Truncate the ingested stream to ``abs_len`` tokens.

        Attention-only: positional (free).  SSM: restore the latest
        checkpoint <= abs_len and replay the delta (logged).
        ``last_logits`` is invalidated unless recoverable — engines always
        refill ``pending`` after a reset, so the next forward regenerates
        it."""
        assert abs_len <= self.pos
        self.pending = []
        if abs_len == self.pos:
            return
        replay = self.tokens[:abs_len]
        if not self.has_ssm:
            self.pos = abs_len
            self.tokens = replay
            self.last_logits = None
            self.last_features = None
            return
        cks = [c for c in self._ckpts if c.pos <= abs_len]
        assert cks, "no checkpoint available for SSM rollback"
        ck = cks[-1]
        saved = iter(ck.ssm)
        self.cache = M.map_slot_caches(
            self.cache, lambda c: ({k: v.clone() for k, v in
                                    next(saved).items()}
                                   if _is_ssm_slot(c) else c))
        self.pos, self.last_logits = ck.pos, ck.last_logits
        self.last_features = ck.last_features
        self.tokens = replay
        delta = replay[ck.pos:]
        if delta:
            self.tokens = replay[:ck.pos]
            self.forward(delta)
            self.replay_calls += 1

    # ------------------------------------------------------------- branch
    def fork(self, k: int) -> None:
        """Replicate the (batch=1) cache into k branch rows."""
        assert self.batch == 1
        self._prefork = (self.cache, self.pos)
        self.cache = M.map_slot_caches(self.cache, lambda c: {
            n: a.repeat_interleave(k, dim=1) for n, a in c.items()})
        self.batch = k

    def select(self, i: int) -> None:
        """Keep branch row i, collapse back to batch=1."""
        self.cache = M.map_slot_caches(self.cache, lambda c: {
            n: a[:, i:i + 1].clone() for n, a in c.items()})
        if self.last_logits is not None:
            self.last_logits = self.last_logits[i:i + 1]
        if self.last_features is not None:
            self.last_features = self.last_features[:, i:i + 1]
        self.batch = 1
        self._prefork = None

    def sync_lineage(self, toks: Sequence[int]) -> None:
        """Back-fill the lineage with the winning branch's ingested tokens
        (``forward_batched`` advances ``pos`` without extending
        ``tokens``: rows diverge until a branch wins)."""
        assert self.batch == 1 and self._prefork is None
        self.tokens.extend(int(t) for t in toks)
        assert len(self.tokens) == self.pos, (len(self.tokens), self.pos)

    def unfork(self) -> None:
        """Abandon all branches: restore the pre-fork cache."""
        assert self._prefork is not None
        self.cache, self.pos = self._prefork
        self.tokens = self.tokens[:self.pos]
        self.batch = 1
        self.last_logits = None
        self.last_features = None
        self._prefork = None


def greedy_reference(params, cfg: ModelConfig, prompt: Sequence[int],
                     n_new: int, *, max_len: int = 4096) -> List[int]:
    """Plain autoregressive greedy generation through the runner (the
    oracle of the lossless tests)."""
    r = ModelRunner(params, cfg, max_len=max_len)
    r.forward(list(prompt))
    out = []
    for _ in range(n_new):
        nxt = int(torch.argmax(r.last_logits[0]))
        out.append(nxt)
        r.forward([nxt])
    return out
