"""Neural-net primitives (port of ``repro.models.layers``).

Parameters are nested dicts of tensors in the reference's layout (weights
stored as (in, out), applied as ``x @ w``).  ``attend`` runs through
``ops.flash_attention`` (the CUDA flash kernel on the card, the chunked
plain version on the CPU); ``attention`` writes new K/V in place into a
dense ring cache (attending through ``attend``) or into paged buffers
(attending through ``ops.paged_attention``).  ``mamba`` runs its scan
through ``ops.ssm_scan`` (the CUDA selective-scan kernel on the card) and
updates its carried state or checkpoint ring in place; ``moe_ffn`` is
plain PyTorch, as the reference's is plain jnp.
"""
from __future__ import annotations

import math
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
              paged: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              pdraft: Optional[Params] = None) -> torch.Tensor:
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

    Parallel draft slots (DESIGN.md §7.12): ``pdraft`` = ``{"cols": (B, T)
    bool, "ctx": (B, T) int32}`` marks chunk columns that are draft slots.
    They keep their true positions for RoPE and the window, but their KEYS
    are stored with position -1 (on a dense ring at slot ``position %
    Sc``, where the real token will later land), so no query sees them,
    and their QUERIES are clamped to the ``ctx`` horizon (the last real
    position).  The paged path needs neither: slot positions lie at or
    beyond ``lens``, so their writes go to the trash page and the kernel
    shows every query only keys ``< lens``.
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

    store_pos, q_ctx = positions, None
    if pdraft is not None:
        store_pos = torch.where(pdraft["cols"],
                                torch.full_like(positions, -1), positions)
        q_ctx = pdraft["ctx"]

    if cache is not None and "k" in cache:
        out = _attend_ring(q, k, v, positions, cache, cfg, window=window,
                           kv_chunk=kv_chunk, cache_mode=cache_mode,
                           store_pos=store_pos, q_ctx=q_ctx)
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

    out = attend(q, k, v, positions, store_pos, causal=cfg.causal,
                 window=window, cap=cfg.attn_softcap, kv_chunk=kv_chunk,
                 q_ctx=q_ctx)
    return out.reshape(B, T, H * hd) @ p["wo"]


def _attend_ring(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 positions: torch.Tensor, cache: Params, cfg: ModelConfig,
                 *, window: int, kv_chunk: int, cache_mode: str,
                 store_pos: torch.Tensor,
                 q_ctx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write the chunk into a dense ring cache in place and attend (see
    ``attention``).  The chunk's keys are stored at ``store_pos`` (-1 for
    a parallel draft slot) in the slot of their true position."""
    if cache_mode not in ("append", "fresh"):
        raise ValueError(f"unknown cache_mode {cache_mode!r}")
    B, T = positions.shape
    ck, cv, cp = cache["k"], cache["v"], cache["pos"]
    Sc = ck.shape[1]
    if cache_mode == "fresh":
        k_all, v_all, kpos = k, v, store_pos
    elif window > 0:
        # read before the write below: the pre-write cache ∪ the chunk
        old_pos = torch.where(cp >= positions[:, :1],
                              torch.full_like(cp, -1), cp)
        k_all = torch.cat([ck, k.to(ck.dtype)], dim=1)
        v_all = torch.cat([cv, v.to(cv.dtype)], dim=1)
        kpos = torch.cat([old_pos, store_pos.to(cp.dtype)], dim=1)
    # only the chunk's tail survives a chunk longer than the ring: slice
    # before the scatter so no slot is written twice
    kw, vw, pw, sw = ((k[:, -Sc:], v[:, -Sc:], positions[:, -Sc:],
                       store_pos[:, -Sc:]) if T > Sc
                      else (k, v, positions, store_pos))
    slots = pw.long() % Sc
    bidx = torch.arange(B, device=ck.device)[:, None]
    ck[bidx, slots] = kw.to(ck.dtype)
    cv[bidx, slots] = vw.to(cv.dtype)
    cp[bidx, slots] = sw.to(cp.dtype)
    if cache_mode == "append" and window == 0:
        k_all, v_all, kpos = ck, cv, cp
    return attend(q, k_all, v_all, positions, kpos, causal=cfg.causal,
                  window=window, cap=cfg.attn_softcap, kv_chunk=kv_chunk,
                  q_ctx=q_ctx)


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


# ---------------------------------------------------------------------------
# MoE FFN — capacity-based scatter dispatch (GShard-style, gather variant)
# ---------------------------------------------------------------------------

def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = math.ceil(n_tokens * cfg.num_experts_per_tok / cfg.num_experts
                  * cfg.capacity_factor)
    return max(4, min(c, n_tokens))


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Top-k routed MoE (the reference's output; its load-balance loss is
    a training term and is not computed here).  Each (token, choice) gets
    its rank within its expert by a stable sort, tokens past the capacity
    C are dropped, and the expert products run over the (E, C, D)
    dispatch buffer.  ``torch.topk`` may order exactly tied probabilities
    differently from ``jax.lax.top_k``."""
    B, T, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    flat = h.reshape(B * T, D)
    n = B * T
    C = moe_capacity(cfg, n)
    dev = x.device

    probs = torch.softmax(flat.float() @ p["router"], dim=-1)   # (n, E)
    gate, eidx = torch.topk(probs, K, dim=-1)                    # (n, K)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    e_flat = eidx.reshape(n * K)
    order = torch.argsort(e_flat, stable=True)
    counts = torch.bincount(e_flat, minlength=E)
    starts = torch.cumsum(counts, 0) - counts                    # exclusive
    pos_sorted = torch.arange(n * K, device=dev) - starts[e_flat[order]]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    keep = pos < C
    safe_pos = torch.where(keep, pos, torch.full_like(pos, C - 1))

    src = flat.repeat_interleave(K, dim=0)
    buf = torch.zeros((E, C, D), dtype=flat.dtype, device=dev)
    buf.index_put_((e_flat, safe_pos),
                   torch.where(keep[:, None], src, torch.zeros_like(src)),
                   accumulate=True)
    hg = torch.einsum("ecd,edf->ecf", buf, p["wg"])
    hu = torch.einsum("ecd,edf->ecf", buf, p["wu"])
    out_buf = torch.einsum("ecf,efd->ecd", silu(hg) * hu, p["wd"])

    gathered = out_buf[e_flat, safe_pos]                         # (n*K, D)
    w = (gate.reshape(n * K) * keep).to(flat.dtype)
    y = (gathered * w[:, None]).reshape(n, K, D).sum(dim=1)
    return y.reshape(B, T, D)


# ---------------------------------------------------------------------------
# Mamba-1 block (selective scan)
# ---------------------------------------------------------------------------

def init_mamba_cache(cfg: ModelConfig, batch: int, device, ring: int = 0,
                     stack: int = 1) -> Params:
    """Recurrent decode state of ``stack`` mamba layers.

    ring == 0 (sequential decode): the carried state only, ``conv``
    (stack, batch, Cv-1, E) and ``ssm`` (stack, batch, E, N) float32 —
    rollback is checkpoint + replay (runtime/runner.py).

    ring > 0 (batched serving): a position-indexed checkpoint ring,
    ``h_ring`` (stack, batch, ring, E, N) float32 and ``conv_ring``
    (stack, batch, ring, Cv-1, E).  Slot ``k % ring`` holds the post-step
    state after the row's k-th token; a forward starting at position p0
    loads slot ``p0 % ring`` (position 0 is the zero state), so rollback
    is positional, as for attention."""
    E, N, Cv = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    lead = (stack, batch) + ((ring,) if ring > 0 else ())
    h = torch.zeros(lead + (E, N), dtype=torch.float32, device=device)
    conv = torch.zeros(lead + (Cv - 1, E), dtype=cfg.tdtype, device=device)
    if ring > 0:
        return {"h_ring": h, "conv_ring": conv}
    return {"conv": conv, "ssm": h}


def _causal_conv(xp: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  xp (B, T, E); w (Cv, E); prev (B, Cv-1,
    E) or None (zeros).  Returns (out (B, T, E), the new Cv-1 tail)."""
    Cv = w.shape[0]
    T = xp.shape[1]
    if prev is None:
        prev = xp.new_zeros((xp.shape[0], Cv - 1, xp.shape[2]))
    full = torch.cat([prev.to(xp.dtype), xp], dim=1)        # (B,T+Cv-1,E)
    out = sum(full[:, i:i + T] * w[i] for i in range(Cv)) + b
    return out, full[:, full.shape[1] - (Cv - 1):]


def mamba(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
          cache: Optional[Params] = None,
          positions: Optional[torch.Tensor] = None,
          ring_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mamba-1 mixer.  x (B, T, D) -> (B, T, D).

    With a ring cache (``init_mamba_cache`` with ring > 0) ``positions``
    (B, T) are needed: each lane's initial state loads from the
    checkpoint slot of its start position (position 0 = zero state) and
    the post-step state of each of the trailing ``min(T, ring)`` steps is
    written IN PLACE to slot ``(position + 1) % ring``.  Pad steps of a
    batched call write future slots, which real writes overwrite before
    any load sees them.  ``ring_rows`` (B,) maps lanes to ring rows
    (default: lane i is row i); a lane with row -1 is a pad lane: its
    conv window and scan start from zeros and its writes are dropped.
    The scan reads and writes the ring in one kernel
    (``ops.ssm_scan_ring``); the conv tails are scattered here.  A carry cache (ring == 0) is read and
    updated in place; without a cache the scan starts from zeros."""
    B, T, _D = x.shape
    E, N, R = cfg.d_inner, cfg.ssm_state, cfg.dtr
    Cv = cfg.ssm_conv
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    xp, z = (h @ p["in_proj"]).split(E, dim=-1)               # (B,T,E) each

    ring = cache is not None and "h_ring" in cache
    dev = x.device
    if ring:
        if positions is None:
            raise ValueError("a ring SSM cache needs positions")
        h_ring, conv_ring = cache["h_ring"], cache["conv_ring"]
        Rg = h_ring.shape[1]
        p0 = positions[:, 0].long()
        rows = (torch.arange(B, device=dev) if ring_rows is None
                else ring_rows.long())
        slot0 = p0 % Rg
        # a new row, and a pad lane, start from zeros (as the scan does)
        fresh = ((p0 == 0) | (rows < 0))[:, None, None]
        prev = torch.where(fresh, 0.0, conv_ring[rows.clamp_min(0), slot0])
    else:
        prev = cache["conv"] if cache is not None else None
        h0 = (cache["ssm"] if cache is not None
              else torch.zeros((B, E, N), dtype=torch.float32, device=dev))
    xc, new_conv = _causal_conv(xp, p["conv_w"], p["conv_b"], prev)
    xc = silu(xc)

    dbc = xc @ p["x_db"]
    dt_raw = dbc[..., :R]
    Bmat = dbc[..., R:R + N].float().contiguous()                 # (B,T,N)
    Cmat = dbc[..., R + N:].float().contiguous()
    u = dt_raw @ p["dt_w"] + p["dt_b"]
    delta = torch.logaddexp(u, torch.zeros((), dtype=u.dtype, device=dev)
                            ).float().contiguous()                # softplus
    A = -torch.exp(p["A_log"].float()).contiguous()               # (E,N)
    Dv = p["Dskip"].float().contiguous()
    if ring:
        # the scan reads each lane's initial state from the ring and
        # writes the checkpoints of its trailing min(T, Rg) steps into it
        y = ops.ssm_scan_ring(
            xc.contiguous(), delta, Bmat, Cmat, A, Dv, h_ring,
            positions[:, 0].to(torch.int32),
            None if ring_rows is None else ring_rows.to(torch.int32))
    else:
        y, hT = ops.ssm_scan(xc.contiguous(), delta, Bmat, Cmat, A, Dv,
                             h0.contiguous())
    out = (y.to(x.dtype) * silu(z)) @ p["out_proj"]

    if ring:
        # the conv tails of the trailing min(T, Rg) steps (a longer span
        # laps the ring and the survivors are the last Rg tails — slicing
        # first keeps every written slot unique)
        Tr = min(T, Rg)
        t_idx = torch.arange(T - Tr, T, device=dev)                # (Tr,)
        slots = (p0[:, None] + t_idx[None] + 1) % Rg               # (B,Tr)
        full = torch.cat([prev.to(xp.dtype), xp], dim=1)
        widx = t_idx[:, None] + 1 + torch.arange(Cv - 1, device=dev)[None]
        tails = full[:, widx]                                  # (B,Tr,Cv-1,E)
        if ring_rows is not None:
            live = rows >= 0
            rows, slots, tails = rows[live], slots[live], tails[live]
        conv_ring[rows[:, None], slots] = tails.to(conv_ring.dtype)
    elif cache is not None:
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(hT)
    return out
