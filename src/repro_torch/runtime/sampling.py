"""Speculative-sampling device functions (port of the device twins in
``repro.runtime.sampling``).

All distributions are float32 probability tensors, batched over requests.
Uniforms come from per-request folded threefry keys (``uniform_grid``), so
a request's random stream depends only on ``(rid, decision counter)`` —
never on its batchmates — and matches the reference bit for bit.  The
float64 numpy cores of the reference belong to the sequential engines, a
later slice of the port.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.runtime import prng


def probs_from_logits(logits: torch.Tensor, temperature: float
                      ) -> torch.Tensor:
    """(..., V) logits -> probabilities; temperature 0 -> one-hot argmax."""
    logits = logits.float()
    if temperature == 0.0:
        return torch.nn.functional.one_hot(
            logits.argmax(-1), logits.shape[-1]).float()
    return torch.softmax(logits / temperature, dim=-1)


def adaptive_k(q_conf: float, k_max: int) -> int:
    """Eq. (7): k = max(1, floor(k_max * (1 - q(x_b))))."""
    return max(1, int(k_max * (1.0 - q_conf)))


def uniform_grid(base_key: torch.Tensor, rids: torch.Tensor,
                 ctrs: torch.Tensor, width: int) -> torch.Tensor:
    """(S, width) float32 uniforms where element (s, j) is
    ``uniform(fold_in(fold_in(base_key, rids[s]), ctrs[s] + j))`` — a pure
    function of the request's own coordinates, not of s, the batch or the
    width.  Computed on the device of ``rids``."""
    j = torch.arange(width, dtype=torch.int64, device=rids.device)
    k = prng.fold_in(base_key.to(rids.device), rids.to(torch.int64))
    k = prng.fold_in(k[:, None, :], ctrs.to(torch.int64)[:, None] + j[None])
    return prng.uniform(k)


def categorical_from_uniform(probs: torch.Tensor, u: torch.Tensor
                             ) -> torch.Tensor:
    """Inverse-CDF sample (..., V) x (...) -> (...) int32: the cdf is
    renormalised by its last entry and the count is of ``cdf <= u``
    (searchsorted side="right"), clamped to V - 1."""
    cdf = torch.cumsum(probs.float(), dim=-1)
    cdf = cdf / cdf[..., -1:].clamp_min(1e-30)
    tok = (cdf <= u[..., None]).sum(-1)
    return tok.clamp(0, probs.shape[-1] - 1).to(torch.int32)


def _residual(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    r = (p - q).clamp_min(0.0)
    z = r.sum(-1, keepdim=True)
    return torch.where(z > 1e-12, r / z.clamp_min(1e-30), p)


def verify_chain_device(p_probs: torch.Tensor, q_probs: torch.Tensor,
                        toks: torch.Tensor, lens: torch.Tensor,
                        ugrid: torch.Tensor,
                        bonus_probs: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched chain verification with ragged draft widths.

    p_probs, q_probs (S, R, V); toks (S, R); lens (S,) real draft lengths;
    ugrid (S, >= R + 1): row s uses ugrid[s, :lens[s]] for the accept
    tests and ugrid[s, lens[s]] for the residual / bonus draw.  Returns
    (n_acc (S,) i32, next_token (S,) i32 — -1 on all-accept rows without
    a bonus — and all_acc (S,) bool).
    """
    S, R, V = p_probs.shape
    idx = toks.long()[..., None]
    p_t = torch.gather(p_probs, -1, idx)[..., 0]
    q_t = torch.gather(q_probs, -1, idx)[..., 0]
    j = torch.arange(R, device=p_probs.device)[None]
    lens = lens.long()
    within = j < lens[:, None]
    acc = ugrid[:, :R] <= p_t / q_t.clamp_min(1e-30)
    run = torch.cumprod(torch.where(within, acc, True).to(torch.int32),
                        dim=1)
    n_acc = (run * within.to(torch.int32)).sum(1).to(torch.int32)
    all_acc = n_acc.long() == lens
    pos = n_acc.long().clamp_max(R - 1)[:, None, None].expand(S, 1, V)
    r = _residual(torch.gather(p_probs, 1, pos)[:, 0],
                  torch.gather(q_probs, 1, pos)[:, 0])
    u_fin = torch.gather(ugrid, 1, lens[:, None])[:, 0]
    nxt = categorical_from_uniform(r, u_fin)
    if bonus_probs is not None:
        nxt = torch.where(all_acc, categorical_from_uniform(bonus_probs,
                                                            u_fin), nxt)
    else:
        nxt = torch.where(all_acc, torch.full_like(nxt, -1), nxt)
    return n_acc, nxt.to(torch.int32), all_acc


def branch_verdict_device(p_b: torch.Tensor, q_b: torch.Tensor,
                          cands: torch.Tensor, ks: torch.Tensor,
                          ugrid: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Algorithm 2 (branch speculative sampling).

    p_b, q_b (S, V); cands (S, K) padded candidate ids; ks (S,) real
    candidate counts; ugrid (S, >= K + 1): row s uses ugrid[s, :ks[s]]
    and ugrid[s, ks[s]] for the final residual draw.  Returns
    (accepted_branch (S,) i32, -1 when none, and token (S,) i32).
    """
    S, K = cands.shape
    dev = p_b.device
    acc = torch.full((S,), -1, dtype=torch.int32, device=dev)
    tok = torch.zeros((S,), dtype=torch.int32, device=dev)
    p_cur = p_b.float()
    ks = ks.long()
    for i in range(K):            # K = k_max is small
        active = (i < ks) & (acc < 0)
        t = cands[:, i].long()
        p_t = torch.gather(p_cur, 1, t[:, None])[:, 0]
        q_t = torch.gather(q_b, 1, t[:, None])[:, 0]
        hit = active & (ugrid[:, i] < p_t / q_t.clamp_min(1e-30))
        acc = torch.where(hit, torch.full_like(acc, i), acc)
        tok = torch.where(hit, t.to(torch.int32), tok)
        r = _residual(p_cur, q_b)
        p_cur = torch.where((active & ~hit)[:, None], r, p_cur)
    u_fin = torch.gather(ugrid, 1, ks[:, None])[:, 0]
    tok = torch.where(acc < 0, categorical_from_uniform(p_cur, u_fin), tok)
    return acc, tok
