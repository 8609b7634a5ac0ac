"""Neural-net primitives (port of ``repro.models.layers``).

Parameters are nested dicts of tensors in the reference's layout (weights
stored as (in, out), applied as ``x @ w``).  ``attend`` is the reference's
chunked online-softmax attention in plain PyTorch (it is jnp in the
reference too, not a Pallas kernel); the paged branch of ``attention``
scatters new K/V into the page buffers in place and attends through
``ops.paged_attention`` — the CUDA kernel on the card.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope_sin_cos(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., T) int -> sin/cos of shape (..., T, head_dim//2)."""
    half = head_dim // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=positions.device) / half))
    ang = positions.float()[..., None] * freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """x (B, T, H, hd); sin/cos (B, T, hd//2)."""
    dt = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    s, c = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(dt)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor, k_pos: torch.Tensor, *,
           causal: bool = True, window: int = 0,
           cap: Optional[float] = None, kv_chunk: int = 2048,
           q_ctx: Optional[torch.Tensor] = None) -> torch.Tensor:
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
        logits = softcap(logits, cap)
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


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, cache: Optional[Params] = None,
              window: int = 0, kv_chunk: int = 2048,
              paged: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> torch.Tensor:
    """One attention block (pre-norm, residual outside).

    With ``cache`` = {"k_pages": (P+1, ps, KV, hd), "v_pages": ...} (one
    layer's paged buffers, updated IN PLACE) ``paged`` must carry the
    call's page-table view ``(table (B, n_max) int32, lens (B,) int32)``:
    new K/V land at page ``table[b, pos // ps]`` slot ``pos % ps``, writes
    at positions >= lens (batch padding, idle rows) go to the trash page
    (the last physical page), and attention runs over the pages through
    ``ops.paged_attention`` with ``q_start = positions[:, 0]``.  Without a
    cache the block attends over the chunk itself (the autoregressive
    reference's path).  The dense ring-buffer cache is a later slice.
    """
    B, T, _D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(B, T, H, hd)
    k = (h @ p["wk"]).reshape(B, T, KV, hd)
    v = (h @ p["wv"]).reshape(B, T, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    sin, cos = rope_sin_cos(positions, hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)

    if cache is not None:
        if paged is None:
            raise ValueError("a paged cache needs the (table, lens) view")
        table, lens = paged
        kp, vp = cache["k_pages"], cache["v_pages"]
        ps = kp.shape[1]
        trash = kp.shape[0] - 1
        pos = positions.long()
        lp = torch.clamp(pos // ps, max=table.shape[1] - 1)
        page = torch.gather(table.long(), 1, lp)                  # (B, T)
        page = torch.where(pos < lens.long()[:, None], page,
                           torch.full_like(page, trash))
        off = pos % ps
        kp[page, off] = k.to(kp.dtype)
        vp[page, off] = v.to(vp.dtype)
        out = ops.paged_attention(q.contiguous(), kp, vp, table, lens,
                                  positions[:, 0].contiguous(),
                                  window=window, cap=cfg.attn_softcap)
        return out.reshape(B, T, H * hd) @ p["wo"]

    out = attend(q, k, v, positions, positions, causal=cfg.causal,
                 window=window, cap=cfg.attn_softcap, kv_chunk=kv_chunk)
    return out.reshape(B, T, H * hd) @ p["wo"]


def init_paged_attn_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                          device, stack: int = 1) -> Params:
    """Paged KV storage for ``stack`` attention layers: page id ->
    (page_size, KV, hd) tile, plus one trash page (index ``num_pages``)
    that absorbs masked pad writes."""
    shape = (stack, num_pages + 1, page_size, cfg.num_kv_heads, cfg.hd)
    return {"k_pages": torch.zeros(shape, dtype=cfg.tdtype, device=device),
            "v_pages": torch.zeros(shape, dtype=cfg.tdtype, device=device)}


def ffn(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    return (silu(h @ p["wg"]) * (h @ p["wu"])) @ p["wd"]
