"""Plain PyTorch versions of the port's kernels.

These are the CPU path of ``kernels.ops`` and the versions every CUDA
kernel is held against on the card.  Each follows its JAX counterpart's
arithmetic: ``paged_attention_ref`` is the gather form of
``repro.kernels.paged_attention.paged_decode_attention_xla`` (so a
zero-length row returns zeros, as the kernels do),
``verify_accept_batched_ref`` is ``repro.kernels.ref.
verify_accept_batched_ref`` and ``paged_gather_ref`` the contract of
``repro.kernels.paged.paged_gather``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, table: torch.Tensor,
                        lens: torch.Tensor, q_start: torch.Tensor, *,
                        window: int = 0, cap: Optional[float] = None
                        ) -> torch.Tensor:
    """Attention over paged KV: gather each row's pages dense through the
    table, then masked softmax.  q (B, T, H, hd); k/v pages (P, ps, KV,
    hd); table (B, n_max); lens, q_start (B,).  Returns (B, T, H, hd)."""
    B, T, H, hd = q.shape
    _P, ps, KV, _ = k_pages.shape
    n_max = table.shape[1]
    G = H // KV
    S = n_max * ps
    tab = table.long()
    k = k_pages[tab].reshape(B, S, KV, hd).float()
    v = v_pages[tab].reshape(B, S, KV, hd).float()
    qr = q.reshape(B, T, KV, G, hd).float() * (1.0 / math.sqrt(hd))
    logits = torch.einsum("btkgh,bskh->bkgts", qr, k)
    if cap is not None:
        logits = cap * torch.tanh(logits / cap)
    dev = q.device
    kpos = torch.arange(S, device=dev)
    qpos = q_start.long()[:, None] + torch.arange(T, device=dev)[None]
    mask = ((kpos[None, None] < lens.long()[:, None, None])
            & (kpos[None, None] <= qpos[:, :, None]))          # (B, T, S)
    if window > 0:
        mask &= (qpos[:, :, None] - kpos[None, None]) < window
    maskb = mask[:, None, None]                                # (B,1,1,T,S)
    logits = torch.where(maskb, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(-1, keepdim=True)
    p = torch.where(maskb, torch.exp(logits - m), torch.zeros_like(logits))
    denom = p.sum(-1).clamp_min(1e-20)
    o = torch.einsum("bkgts,bskh->bkgth", p, v) / denom[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd).to(q.dtype)


def verify_accept_batched_ref(p_logits: torch.Tensor, q_logits: torch.Tensor,
                              tokens: torch.Tensor, lens: torch.Tensor,
                              uniforms: torch.Tensor,
                              res_uniforms: torch.Tensor
                              ) -> Tuple[torch.Tensor, ...]:
    """Batched ragged verification.  p/q logits (B, R, V) f32; tokens,
    uniforms, res_uniforms (B, R); lens (B,).  Returns (accept (B, R)
    i32, residual token (B, R) i32, p_tok, q_tok (B, R) f32); positions
    r >= lens[b] are zeros."""
    p = torch.softmax(p_logits.float(), dim=-1)
    q = torch.softmax(q_logits.float(), dim=-1)
    _B, R, V = p.shape
    valid = (torch.arange(R, device=p.device)[None]
             < lens.long()[:, None])
    t = tokens.long()[..., None]
    zero = torch.zeros((), device=p.device)
    p_t = torch.where(valid, torch.gather(p, -1, t)[..., 0], zero)
    q_t = torch.where(valid, torch.gather(q, -1, t)[..., 0], zero)
    accept = (valid & (uniforms.float()
                       <= p_t / q_t.clamp_min(1e-30))).to(torch.int32)
    r = (p - q).clamp_min(0.0)
    z = r.sum(-1, keepdim=True)
    r = torch.where(z > 1e-12, r / z.clamp_min(1e-30), p)
    cdf = torch.cumsum(r, dim=-1)
    # renormalised by the last entry and clamped: an f32 cumsum can end
    # below a uniform in (cdf[-1], 1), which must not emit token id V
    cdf = cdf / cdf[..., -1:].clamp_min(1e-30)
    res = (cdf <= res_uniforms.float()[..., None]).sum(-1)
    res = torch.where(valid, res.clamp_max(V - 1),
                      torch.zeros_like(res)).to(torch.int32)
    return accept, res, p_t, q_t


def paged_gather_ref(pages: torch.Tensor, table: torch.Tensor,
                     valid_len: int) -> torch.Tensor:
    """Logical pages ``table[i]`` of a (P, ps, dim) buffer as contiguous
    (n * ps, dim) rows; rows at or past ``valid_len`` are zeros."""
    _P, ps, dim = pages.shape
    out = pages[table.long()].reshape(-1, dim).clone()
    out[valid_len:] = 0
    return out
