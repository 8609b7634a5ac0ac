"""Speculative-sampling device functions (port of the device twins in
``repro.runtime.sampling``).

All distributions are float32 probability tensors.  Two families, as in
the reference:

  * the host-side functions of the sequential engines: ``sample``
    (``jax.random.categorical`` through ``prng.categorical``), the
    float64 numpy cores ``verify_chain_np`` / ``branch_spec_sample_np`` /
    ``_np_categorical`` and their key-taking wrappers, which draw their
    uniforms with ``prng.uniform_shaped`` exactly as the reference does;
  * the device twins of the batched engines, whose uniforms come from
    per-request folded threefry keys (``uniform_grid``), so a request's
    random stream depends only on ``(rid, decision counter)`` — never on
    its batchmates — and matches the reference bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
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


def sample(key: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Categorical sample from probabilities (..., V); ``key`` is (2,) or
    a (..., 2) batch of keys, one per leading row (the reference's
    ``vmap(sample)(split(key, k), q)``)."""
    return prng.categorical(key, torch.log(probs.float().clamp_min(1e-30)))


def residual(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """norm(max(0, p - q)) — the rejection-resampling distribution; p
    where p <= q everywhere (possible only up to rounding)."""
    r = (p - q).clamp_min(0.0)
    z = r.sum(-1, keepdim=True)
    return torch.where(z > 1e-12, r / z.clamp_min(1e-30), p)


def top1_confidence(q: torch.Tensor) -> torch.Tensor:
    return q.max(-1).values


def entropy_bound(q: torch.Tensor, lam: float = 0.15) -> torch.Tensor:
    """AdaEDL's acceptance lower bound 1 - sqrt(lambda * H(q))."""
    h = -(q * torch.log(q.clamp_min(1e-30))).sum(-1)
    return 1.0 - torch.sqrt((lam * h).clamp_min(0.0))


class ChainVerdict(NamedTuple):
    n_accepted: int          # tokens of the draft chain accepted
    next_token: int          # resampled (on reject) or bonus (all-accept)
    all_accepted: bool


class BranchVerdict(NamedTuple):
    accepted_branch: int     # index into candidates, -1 if none accepted
    token: int               # the emitted branch-point token (~ p exactly)


def _np_categorical(u: float, probs) -> int:
    cdf = np.cumsum(probs)
    cdf /= max(cdf[-1], 1e-30)
    return int(np.searchsorted(cdf, u, side="right").clip(0, len(cdf) - 1))


def verify_chain_np(us, p_np, q_np, toks, bonus_np=None) -> ChainVerdict:
    """Float64 numpy core of chain verification: us (gamma + 1,) — us[i]
    decides draft position i, us[-1] draws the residual / bonus."""
    gamma = len(toks)
    n = gamma
    for i in range(gamma):
        t = int(toks[i])
        if us[i] > p_np[i, t] / max(q_np[i, t], 1e-30):
            n = i
            break
    if n == gamma:
        if bonus_np is None:
            return ChainVerdict(n, -1, True)
        return ChainVerdict(n, _np_categorical(us[-1], bonus_np), True)
    r = np.maximum(p_np[n] - q_np[n], 0.0)
    z = r.sum()
    r = r / z if z > 1e-12 else p_np[n]
    return ChainVerdict(n, _np_categorical(us[-1], r), False)


def _f64(x: torch.Tensor) -> np.ndarray:
    return x.detach().double().cpu().numpy()


def verify_chain(key: torch.Tensor, p_probs: torch.Tensor,
                 q_probs: torch.Tensor, draft_tokens,
                 bonus_probs: Optional[torch.Tensor] = None
                 ) -> ChainVerdict:
    """Chain speculative verification (Sec. 3) on the host: p/q (gamma,
    V), the drafted ids, an optional bonus distribution (V,)."""
    toks = np.asarray(draft_tokens)
    us = _f64(prng.uniform_shaped(key, (len(toks) + 1,)))
    return verify_chain_np(us, _f64(p_probs), _f64(q_probs), toks,
                           None if bonus_probs is None
                           else _f64(bonus_probs))


def branch_spec_sample_np(us, p_np, cands, q_np) -> BranchVerdict:
    """Float64 numpy core of Algorithm 2: us (k + 1,) — us[i] decides
    candidate i, us[-1] draws the final residual sample."""
    p_cur = p_np
    for i in range(len(cands)):
        t = int(cands[i])
        if us[i] < p_cur[t] / max(q_np[t], 1e-30):
            return BranchVerdict(i, t)
        r = np.maximum(p_cur - q_np, 0.0)
        z = r.sum()
        p_cur = r / z if z > 1e-12 else p_cur
    return BranchVerdict(-1, _np_categorical(us[-1], p_cur))


def branch_spec_sample(key: torch.Tensor, p_b: torch.Tensor, candidates,
                       q_b: torch.Tensor) -> BranchVerdict:
    """Algorithm 2 — branch speculative sampling of candidates drawn from
    q_b against the target distribution p_b at the branch point."""
    cands = np.asarray(candidates)
    us = _f64(prng.uniform_shaped(key, (len(cands) + 1,)))
    return branch_spec_sample_np(us, _f64(p_b), cands, _f64(q_b))


def draw_branch_candidates(key: torch.Tensor, q_b: torch.Tensor, k: int,
                           mode: str = "sample") -> torch.Tensor:
    """Branch-point candidates (Eq. 7): k i.i.d. draws from q_b (mode
    "sample", lossless with Algorithm 2), or its top k ("topk"; ties go
    to the lower id, as ``lax.top_k`` breaks them)."""
    if mode == "topk":
        return torch.sort(q_b, descending=True, stable=True).indices[:k]
    return sample(prng.split(key, k), q_b.expand(k, q_b.shape[-1]))


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
    r = residual(torch.gather(p_probs, 1, pos)[:, 0],
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
        r = residual(p_cur, q_b)
        p_cur = torch.where((active & ~hit)[:, None], r, p_cur)
    u_fin = torch.gather(ugrid, 1, ks[:, None])[:, 0]
    tok = torch.where(acc < 0, categorical_from_uniform(p_cur, u_fin), tok)
    return acc, tok
