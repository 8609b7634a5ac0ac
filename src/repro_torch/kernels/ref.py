"""Plain PyTorch versions of the port's kernels.

These are the CPU path of ``kernels.ops`` and the versions every CUDA
kernel is held against on the card.  Each follows its JAX counterpart's
arithmetic: ``paged_attention_ref`` is the gather form of
``repro.kernels.paged_attention.paged_decode_attention_xla`` (so a
zero-length row returns zeros, as the kernels do),
``verify_accept_batched_ref`` is ``repro.kernels.ref.
verify_accept_batched_ref``, ``paged_gather_ref`` the contract of
``repro.kernels.paged.paged_gather``, and ``flash_attention_ref`` the
chunked online softmax of ``repro.models.layers.attend`` (the function
TPU kernel ``repro.kernels.flash_attention.flash_attention`` computes),
``ssm_scan_ref`` is ``repro.kernels.ref.ssm_scan_ref``,
``ssm_scan_ring_ref`` the checkpoint-ring gather, scan and scatter of
``repro.models.layers.mamba`` (with the port's lane-to-row map),
``branch_decode_ref`` is ``repro.kernels.ref.branch_decode_ref`` (the
broadcast prefix concatenated with each branch's suffix) and
``verify_accept_ref`` is ``repro.kernels.ref.verify_accept_ref``.
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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        cap: Optional[float] = None, kv_chunk: int = 2048,
                        q_ctx: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Online-softmax attention over ``kv_chunk``-wide key chunks.

    q (B, T, H, hd); k, v (B, S, KV, hd); q_pos (B, T) and k_pos (B, S)
    absolute positions (k_pos -1 marks an invalid slot); window > 0 masks
    keys with q_pos - k_pos >= window; q_ctx (B, T), optional, is a
    per-query causal horizon used instead of q_pos.  Returns (B, T, H, hd).
    """
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    if q_ctx is None:
        q_ctx = q_pos
    scale = 1.0 / math.sqrt(hd)
    qf = (q.float() * scale).reshape(B, T, KV, G, hd)
    n_chunks = max(1, math.ceil(S / kv_chunk))
    pad = n_chunks * kv_chunk - S
    if pad:
        # pad slots are invalid keys (position -1) with zero values, as in
        # the reference: a query that sees no key at all then averages
        # over every slot of the padded width, as the reference does
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-1)
    m = torch.full((B, KV, G, T), NEG_INF, device=q.device)
    l = torch.zeros((B, KV, G, T), device=q.device)
    acc = torch.zeros((B, T, KV, G, hd), device=q.device)
    for c in range(n_chunks):
        kb = k[:, c * kv_chunk:(c + 1) * kv_chunk].float()
        vb = v[:, c * kv_chunk:(c + 1) * kv_chunk].float()
        pb = k_pos[:, c * kv_chunk:(c + 1) * kv_chunk]
        logits = torch.einsum("btkgh,bckh->bkgtc", qf, kb)
        if cap is not None:
            logits = cap * torch.tanh(logits / cap)
        pbb = pb[:, None, None, None, :]
        mask = pbb >= 0
        if causal:
            mask = mask & (pbb <= q_ctx[:, None, None, :, None])
        if window > 0:
            mask = mask & ((q_pos[:, None, None, :, None] - pbb) < window)
        logits = torch.where(mask, logits,
                             torch.full_like(logits, NEG_INF))
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bkgtc,bckh->btkgh", p, vb)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    l = l.clamp_min(1e-20).permute(0, 3, 1, 2)[..., None]
    return (acc / l).reshape(B, T, H, hd).to(q.dtype)


def ssm_scan_ref(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                 h0: torch.Tensor, *, return_states: bool = False
                 ) -> Tuple[torch.Tensor, ...]:
    """Sequential selective scan, h_t = exp(dt_t A) h_{t-1} + (dt_t x_t)
    B_t and y_t = <h_t, C_t> + D x_t, in float32.  x, dt (B, T, E); Bm,
    Cm (B, T, N); A (E, N); D (E,); h0 (B, E, N).  Returns (y (B, T, E),
    hT (B, E, N)); with ``return_states`` also hs (B, T, E, N), the
    post-step carry after every position."""
    xf = x.float()
    dtf = dt.float()
    decay = torch.exp(dtf[..., None] * A.float())              # (B,T,E,N)
    drive = (dtf * xf)[..., None] * Bm.float()[:, :, None, :]
    h = h0.float()
    hs = []
    for t in range(x.shape[1]):
        h = decay[:, t] * h + drive[:, t]
        hs.append(h)
    hs_t = torch.stack(hs, dim=1) if hs else \
        h.new_zeros((x.shape[0], 0) + tuple(h.shape[1:]))
    y = torch.einsum("bten,btn->bte", hs_t, Cm.float()) + D.float() * xf
    if return_states:
        return y, h, hs_t
    return y, h


def ssm_scan_ring_ref(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                      Cm: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                      h_ring: torch.Tensor, p0: torch.Tensor,
                      rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The scan over a checkpoint ring h_ring (n_rows, Rg, E, N), updated
    in place: gather each lane's initial state from slot p0 % Rg of its
    row (zeros for a fresh lane, p0 == 0, and for a pad lane, row < 0),
    scan with every post-step state kept, and scatter the trailing
    min(T, Rg) states to slots (p0 + t + 1) % Rg of the live lanes' rows
    (a longer span laps the ring: slicing first keeps every written slot
    unique).  p0, rows (B,); rows None maps lane b to row b.  Returns y
    (B, T, E) float32."""
    B, T, _E = x.shape
    Rg = h_ring.shape[1]
    dev = x.device
    p0 = p0.long()
    rows = (torch.arange(B, device=dev) if rows is None else rows.long())
    live = rows >= 0
    fresh = ((p0 == 0) | ~live)[:, None, None]
    h0 = torch.where(fresh, 0.0, h_ring[rows.clamp_min(0), p0 % Rg])
    y, _hT, hs = ssm_scan_ref(x, dt, Bm, Cm, A, D, h0, return_states=True)
    Tr = min(T, Rg)
    t_idx = torch.arange(T - Tr, T, device=dev)                 # (Tr,)
    slots = (p0[:, None] + t_idx[None] + 1) % Rg                # (B, Tr)
    h_ring[rows[live][:, None], slots[live]] = hs[live, T - Tr:]
    return y


def branch_decode_ref(q: torch.Tensor, prefix_k: torch.Tensor,
                      prefix_v: torch.Tensor, prefix_pos: torch.Tensor,
                      suffix_k: torch.Tensor, suffix_v: torch.Tensor,
                      suffix_pos: torch.Tensor, q_pos: torch.Tensor, *,
                      cap: Optional[float] = None) -> torch.Tensor:
    """Shared-prefix branch decode (Eq. 8): the prefix (1, Sp, KV, hd),
    broadcast to the k branches, concatenated with each branch's suffix
    (k, Ss, KV, hd) (positions likewise), then causal attention.  q (k,
    Tq, H, hd); q_pos (k, Tq).  Returns (k, Tq, H, hd) in q's dtype."""
    kb = q.shape[0]

    def cat(pre, suf):
        return torch.cat([pre.expand((kb,) + tuple(pre.shape[1:])), suf],
                         dim=1)
    return flash_attention_ref(q, cat(prefix_k, suffix_k),
                               cat(prefix_v, suffix_v), q_pos,
                               cat(prefix_pos, suffix_pos), causal=True,
                               cap=cap)


def verify_accept_ref(p_logits: torch.Tensor, q_logits: torch.Tensor,
                      tokens: torch.Tensor, uniforms: torch.Tensor,
                      res_uniforms: torch.Tensor
                      ) -> Tuple[torch.Tensor, ...]:
    """Single-request verification: every one of the R rows of (R, V)
    logits is a valid draft position.  Returns (accept (R,) i32, residual
    token (R,) i32, p_tok, q_tok (R,) f32)."""
    R = p_logits.shape[0]
    lens = torch.full((1,), R, dtype=torch.int32, device=p_logits.device)
    out = verify_accept_batched_ref(p_logits[None], q_logits[None],
                                    tokens[None], lens, uniforms[None],
                                    res_uniforms[None])
    return tuple(x[0] for x in out)
