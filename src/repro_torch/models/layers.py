"""Neural-net primitives (port of ``repro.models.layers``).

Parameters are nested dicts of tensors in the reference's layout (weights
stored as (in, out), applied as ``x @ w``).  ``attend`` runs through
``ops.flash_attention`` (the CUDA flash kernel on the card, the chunked
plain version on the CPU); ``attention`` writes new K/V in place into a
dense ring cache (attending through ``attend``) or into paged buffers
(attending through ``ops.paged_attention``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


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
    """Online-softmax attention over position-masked dense KV.

    q (B, T, H, hd); k, v (B, S, KV, hd); q_pos (B, T) and k_pos (B, S)
    absolute positions (k_pos -1 marks an invalid slot); window > 0 masks
    keys with q_pos - k_pos >= window; q_ctx (B, T), optional, is a
    per-query causal horizon used instead of q_pos.  Returns (B, T, H, hd).
    Runs through ``ops.flash_attention``: the CUDA kernel on the card, the
    chunked plain version (``kv_chunk`` wide) on the CPU.
    """
    return ops.flash_attention(q, k, v, q_pos, k_pos, causal=causal,
                               window=window, cap=cap, kv_chunk=kv_chunk,
                               q_ctx=q_ctx)


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, cache: Optional[Params] = None,
              window: int = 0, kv_chunk: int = 2048,
              cache_mode: str = "append",
              paged: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> torch.Tensor:
    """One attention block (pre-norm, residual outside).

    Dense ring cache ``{"k": (B, Sc, KV, hd), "v": ..., "pos": (B, Sc)
    int32}`` (one layer's view, updated IN PLACE): the chunk's K/V land
    at slot ``position % Sc`` (only its last Sc tokens when T > Sc), and
    the queries attend through ``attend`` — the flash kernel on the card.
    ``cache_mode`` "append" attends, for a windowed layer, over the
    pre-write cache ∪ the chunk (writing first could evict slots still
    inside earlier queries' windows; stale slots at or after the chunk
    start, left by a rollback, are masked), and for a global layer over
    the cache after the write (stale slots there are masked by
    causality); "fresh" (prefill into an empty cache) attends over the
    chunk alone and writes it.

    Paged cache ``{"k_pages": (P+1, ps, KV, hd), "v_pages": ...}``:
    ``paged`` must carry the call's page-table view ``(table (B, n_max)
    int32, lens (B,) int32)``: new K/V land at page ``table[b, pos // ps]``
    slot ``pos % ps``, writes at positions >= lens (batch padding, idle
    rows) go to the trash page (the last physical page), and attention
    runs over the pages through ``ops.paged_attention`` with ``q_start =
    positions[:, 0]``.  Without a cache the block attends over the chunk
    itself.
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

    if cache is not None and "k" in cache:
        out = _attend_ring(q, k, v, positions, cache, cfg, window=window,
                           kv_chunk=kv_chunk, cache_mode=cache_mode)
        return out.reshape(B, T, H * hd) @ p["wo"]
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


def _attend_ring(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 positions: torch.Tensor, cache: Params, cfg: ModelConfig,
                 *, window: int, kv_chunk: int, cache_mode: str
                 ) -> torch.Tensor:
    """Write the chunk into a dense ring cache in place and attend (see
    ``attention``)."""
    if cache_mode not in ("append", "fresh"):
        raise ValueError(f"unknown cache_mode {cache_mode!r}")
    B, T = positions.shape
    ck, cv, cp = cache["k"], cache["v"], cache["pos"]
    Sc = ck.shape[1]
    if cache_mode == "fresh":
        k_all, v_all, kpos = k, v, positions
    elif window > 0:
        # read before the write below: the pre-write cache ∪ the chunk
        old_pos = torch.where(cp >= positions[:, :1],
                              torch.full_like(cp, -1), cp)
        k_all = torch.cat([ck, k.to(ck.dtype)], dim=1)
        v_all = torch.cat([cv, v.to(cv.dtype)], dim=1)
        kpos = torch.cat([old_pos, positions.to(cp.dtype)], dim=1)
    # only the chunk's tail survives a chunk longer than the ring: slice
    # before the scatter so no slot is written twice
    kw, vw, pw = ((k[:, -Sc:], v[:, -Sc:], positions[:, -Sc:]) if T > Sc
                  else (k, v, positions))
    slots = pw.long() % Sc
    bidx = torch.arange(B, device=ck.device)[:, None]
    ck[bidx, slots] = kw.to(ck.dtype)
    cv[bidx, slots] = vw.to(cv.dtype)
    cp[bidx, slots] = pw.to(cp.dtype)
    if cache_mode == "append" and window == 0:
        k_all, v_all, kpos = ck, cv, cp
    return attend(q, k_all, v_all, positions, kpos, causal=cfg.causal,
                  window=window, cap=cfg.attn_softcap, kv_chunk=kv_chunk)


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, window: int,
                    device, ring_slack: int = 0, stack: int = 1) -> Params:
    """Dense ring cache of ``stack`` attention layers: (stack, batch, Sc,
    KV, hd) K/V and (stack, batch, Sc) int32 positions, -1 where unwritten.
    Sc = max_len for a global layer; ``min(window + ring_slack, max_len)``
    for a windowed one (``ring_slack`` keeps keys that writes running
    ahead of a row's length would evict, as the reference documents)."""
    Sc = min(window + ring_slack, max_len) if window > 0 else max_len
    shape = (stack, batch, Sc, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.tdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.tdtype, device=device),
            "pos": torch.full((stack, batch, Sc), -1, dtype=torch.int32,
                              device=device)}


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
