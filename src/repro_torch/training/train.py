"""Training (port of ``repro.training.train``): the causal-LM /
masked-encoder loss with the MoE load-balance term, the train step, the
parallel-draft heads' loss and trainer, and the small loop that trains
the tiny Zipf-Markov pairs.

Gradients come from ``torch.autograd`` over the port's forward; on the
card its flash-attention and selective-scan kernels carry their own
backward kernels (``kernels.ops``).  A step takes the parameter tree as
plain tensors (no ``requires_grad``), differentiates a detached copy that
shares their storage, and updates them in place with
``training.optim.apply``; nothing returned carries a graph, so trained
parameters serve as they are.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.training import optim


@dataclasses.dataclass
class TrainConfig:
    steps: int = 300
    batch: int = 16
    seq_len: int = 64
    moe_aux_weight: float = 0.01
    log_every: int = 50
    optim: optim.AdamWConfig = dataclasses.field(
        default_factory=optim.AdamWConfig)


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position cross entropy: logsumexp minus the label's logit,
    in float32 (the reference contracts a one-hot; a gather is the same
    sum without the (B, T, V) one-hot)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    tok = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return lse - tok


def lm_loss(params: Any, cfg: ModelConfig, batch_tokens: torch.Tensor,
            moe_aux_weight: float = 0.01,
            embeds: Optional[torch.Tensor] = None,
            remat: bool = False) -> Tuple[torch.Tensor, Dict]:
    """Next-token CE over tokens[:, :-1] -> tokens[:, 1:], plus
    ``moe_aux_weight`` times the MoE load-balance loss.  An encoder
    (``causal=False``) predicts its inputs at their own positions (the
    reference's masked same-position loss).  Stub ``embeds`` come first
    and their positions are sliced off the logits.  Returns (loss,
    {"nll", "moe_aux"})."""
    inp = batch_tokens[:, :-1]
    lab = batch_tokens[:, 1:] if cfg.causal else inp
    logits, aux = M.forward(params, cfg, inp, embeds=embeds, remat=remat)
    if embeds is not None:
        logits = logits[:, embeds.shape[1]:]
    nll = _ce(logits, lab).mean()
    loss = nll + moe_aux_weight * aux["moe_aux"]
    return loss, {"nll": nll, "moe_aux": aux["moe_aux"]}


def value_and_grad(loss_fn, params: Any, *args, **kw
                   ) -> Tuple[torch.Tensor, Dict, Any]:
    """(loss, metrics, grads) of ``loss_fn(params, *args, **kw)`` by
    autograd: the leaves are differentiated through detached views of
    ``params`` (same storage), and a leaf the loss does not reach gets a
    zero gradient, as ``jax.value_and_grad`` gives."""
    leaves = [t.detach().requires_grad_(True)
              for t in optim.tree_leaves(params)]
    p = optim.tree_unflatten(params, leaves)
    with torch.enable_grad():
        loss, metrics = loss_fn(p, *args, **kw)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, optim.tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """step(params, opt_state, batch_tokens) -> (params, opt_state, loss,
    metrics): one AdamW step on ``lm_loss`` (params updated in place)."""
    def step(params, opt_state, batch_tokens):
        loss, metrics, grads = value_and_grad(
            lm_loss, params, cfg, batch_tokens, tcfg.moe_aux_weight)
        params, opt_state = optim.apply(tcfg.optim, params, grads,
                                        opt_state)
        return params, opt_state, loss, metrics
    return step


def head_anchors(seq_len: int, K: int) -> Tuple[int, ...]:
    """The evenly spaced static anchors of ``train_draft_heads``: labels
    reach a + K + 1, so the last admissible anchor is seq_len - K - 2."""
    hi = seq_len - K - 2
    if hi < 1:
        raise ValueError(f"seq_len {seq_len} too short for K={K}")
    n_anchor = min(8, hi)
    return tuple(int(round(1 + i * (hi - 1) / max(n_anchor - 1, 1)))
                 for i in range(n_anchor))


def draft_head_loss(dhead: Any, base_params: Any, cfg: ModelConfig,
                    batch_tokens: torch.Tensor, anchors: Sequence[int],
                    K: int) -> Tuple[torch.Tensor, Dict]:
    """CE loss of K parallel-position draft heads (DESIGN.md §7.12).

    One forward carries the real sequence plus ``len(anchors)`` groups of
    K slot columns appended at the end of the frame.  The slot for anchor
    ``a``, offset ``i`` rides at position ``a + 1 + i`` with its query
    clamped to the ``a`` horizon and its key stored invisible — the
    layout of the single-pass draft forward at inference — and head ``i``
    is scored against the token at position ``a + 2 + i``.  Slot keys are
    hidden from every query, so slot groups never see each other."""
    B, Lp = batch_tokens.shape
    A = len(anchors)
    dev = batch_tokens.device
    anc = torch.tensor(list(anchors), dtype=torch.int64, device=dev)
    anchor_of = anc.repeat_interleave(K)                        # (A*K,)
    off_of = torch.arange(K, device=dev).repeat(A)              # (A*K,)
    t = torch.arange(Lp + A * K, device=dev)
    cols = t >= Lp
    slot_pos = torch.cat([t[:Lp], anchor_of + 1 + off_of])
    ctx = torch.cat([t[:Lp], anchor_of])
    sidx = torch.cat([torch.zeros(Lp, dtype=torch.int64, device=dev),
                      off_of])
    toks = torch.cat([batch_tokens,
                      torch.zeros((B, A * K), dtype=batch_tokens.dtype,
                                  device=dev)], dim=1)

    def bc(v):
        return v[None].expand(B, Lp + A * K)
    pdraft = {"cols": bc(cols), "ctx": bc(ctx).to(torch.int32),
              "sidx": bc(sidx), "embed": dhead["mask_embed"]}
    _, aux = M.forward(base_params, cfg, toks,
                       positions=bc(slot_pos).to(torch.int32),
                       feature_mode="all", pdraft=pdraft)
    slot_feats = aux["features"][-1][:, Lp:, :].reshape(B, A, K, -1)
    lg = M.draft_head_logits(base_params, cfg, dhead, slot_feats)
    lab = batch_tokens[:, anc[:, None] + 2
                       + torch.arange(K, device=dev)[None]]     # (B, A, K)
    loss = _ce(lg, lab).mean()
    return loss, {"nll": loss}


def _batches(data_iter: Iterator[np.ndarray], device, seq_len=None):
    for b in data_iter:
        b = b if seq_len is None else b[:, :seq_len]
        yield torch.from_numpy(np.ascontiguousarray(b)).to(device)


def train_draft_heads(base_params: Any, cfg: ModelConfig,
                      data_iter: Iterator[np.ndarray], K: int,
                      tcfg: TrainConfig, seed: int = 0,
                      verbose: bool = True, device="cuda"
                      ) -> Tuple[Any, Dict[str, float]]:
    """Train K parallel-position draft heads over a FROZEN base draft
    model (DESIGN.md §7.12): only ``mask_embed`` and ``heads`` receive
    gradients, so the AR distribution is untouched.  The heads start from
    ``init_draft_heads`` under ``torch.Generator(seed)`` on ``device``
    (the port's draws, not the reference's).  Returns (dhead,
    metrics)."""
    if any(m == "mamba" for m, _ in cfg.pattern):
        raise ValueError("draft heads need an attention-only base: "
                         f"{cfg.pattern}")
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dhead = M.init_draft_heads(cfg, K, gen, dev)
    opt_state = optim.init(dhead)
    anchors = head_anchors(tcfg.seq_len, K)
    loss = None
    t0 = time.time()
    batches = _batches(data_iter, dev, tcfg.seq_len)
    for i in range(tcfg.steps):
        loss, _, grads = value_and_grad(draft_head_loss, dhead,
                                        base_params, cfg, next(batches),
                                        anchors, K)
        dhead, opt_state = optim.apply(tcfg.optim, dhead, grads, opt_state)
        if verbose and (i % tcfg.log_every == 0 or i == tcfg.steps - 1):
            print(f"  head step {i:4d}  loss={float(loss):.4f}  "
                  f"({time.time() - t0:.1f}s)")
    return dhead, {"final_loss": float(loss)}


def train_lm(cfg: ModelConfig, data_iter: Iterator[np.ndarray],
             tcfg: TrainConfig, seed: int = 0, verbose: bool = True,
             device="cuda") -> Tuple[Any, Dict[str, float]]:
    """Train a model from ``init_params(cfg, seed, device)``; returns
    (params, final metrics)."""
    params = M.init_params(cfg, seed, device)
    opt_state = optim.init(params)
    step_fn = make_train_step(cfg, tcfg)
    loss = None
    t0 = time.time()
    batches = _batches(data_iter, torch.device(device))
    for i in range(tcfg.steps):
        params, opt_state, loss, _ = step_fn(params, opt_state,
                                             next(batches))
        if verbose and (i % tcfg.log_every == 0 or i == tcfg.steps - 1):
            print(f"  step {i:4d}  loss={float(loss):.4f}  "
                  f"({time.time() - t0:.1f}s)")
    return params, {"final_loss": float(loss)}
