"""Full model: embedding -> periodic layer stack -> logits (port of
``repro.models.model``).

The parameter tree keeps the reference's layout: ``blocks[s]`` holds slot
``s`` of the period with every leaf stacked on a leading ``n_periods``
axis, ``rem`` the unrolled remainder layers.  The reference scans the
stacked periods; here a Python loop indexes them.  Caches (dense ring
caches from ``init_cache``, paged ones from ``init_paged_cache``) keep
the same leading stack axis and are updated IN PLACE by the forward,
where the reference returns a new cache.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, check_supported

Params = Dict[str, Any]


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int, device="cuda") -> Params:
    """Random parameters from ``torch.Generator(seed)`` with the
    reference's shapes and scales (normal weights scaled by
    1/sqrt(fan_in), zero norm scales), drawn straight in the model's
    dtype on ``device``.  The draws are not the reference's: runs that
    compare the two frameworks carry the reference's weights over with
    ``training.checkpoint.from_numpy_params``."""
    check_supported(cfg)
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = cfg.tdtype
    D, H, KV, hd, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                       cfg.d_ff)

    def normal(shape, fan_in):
        return torch.randn(shape, generator=gen, device=dev, dtype=dt) \
            .mul_(1.0 / math.sqrt(fan_in))

    def zeros(shape):
        return torch.zeros(shape, device=dev, dtype=dt)

    def slot(n: int, kind) -> Params:
        mixer, ffn_kind = kind
        lead = (n,)
        p: Params = {"mixer": {
            "ln": zeros(lead + (D,)),
            "wq": normal(lead + (D, H * hd), D),
            "wk": normal(lead + (D, KV * hd), D),
            "wv": normal(lead + (D, KV * hd), D),
            "wo": normal(lead + (H * hd, D), H * hd)}}
        if cfg.qk_norm:
            p["mixer"]["q_norm"] = zeros(lead + (hd,))
            p["mixer"]["k_norm"] = zeros(lead + (hd,))
        if ffn_kind == "dense":
            p["ffn"] = {"ln": zeros(lead + (D,)),
                        "wg": normal(lead + (D, F), D),
                        "wu": normal(lead + (D, F), D),
                        "wd": normal(lead + (F, D), F)}
        return p

    params: Params = {
        "embed": normal((cfg.vocab_size, D), D),
        "final_norm": zeros((D,)),
        "blocks": [slot(cfg.n_periods, cfg.pattern[s])
                   for s in range(cfg.period)],
        "rem": [slot(1, cfg.pattern[r]) for r in range(cfg.n_rem)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, cfg.vocab_size), D)
    return params


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def _slot_window(cfg: ModelConfig, mixer: str) -> int:
    return cfg.sliding_window if mixer == "local" else 0


def _init_slot_cache(cfg: ModelConfig, slot, batch: int, max_len: int,
                     device, stack: int, ring_slack: int = 0) -> Params:
    return L.init_attn_cache(cfg, batch, max_len, _slot_window(cfg, slot[0]),
                             device, ring_slack=ring_slack, stack=stack)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               ring_slack: int = 0) -> Params:
    """Dense ring decode cache mirroring the params layout: every leaf has
    a leading stack axis (n_periods for ``blocks``, 1 for ``rem``), so
    batch is uniformly axis 1 — the runner's branch fork / select rely on
    this.  ``ring_slack`` pads windowed rings (the reference's
    ``ssm_ring`` doubles as that slack; mamba slots are a later slice)."""
    check_supported(cfg)
    return {"blocks": [_init_slot_cache(cfg, cfg.pattern[s], batch, max_len,
                                        device, cfg.n_periods, ring_slack)
                       for s in range(cfg.period)],
            "rem": [_init_slot_cache(cfg, cfg.pattern[r], batch, max_len,
                                     device, 1, ring_slack)
                    for r in range(cfg.n_rem)]}


def map_slot_caches(cache: Params, fn) -> Params:
    """Apply ``fn`` to every slot cache dict (blocks + remainder),
    preserving the layout."""
    return {"blocks": [fn(c) for c in cache["blocks"]],
            "rem": [fn(c) for c in cache["rem"]]}


def cache_bytes(cfg: ModelConfig, batch: int, max_len: int) -> int:
    """Bytes of ``init_cache(cfg, batch, max_len)``, from shapes alone."""
    cache = init_cache(cfg, batch, max_len, device="meta")
    return sum(x.numel() * x.element_size() for c in iter_slots(cache)
               for x in c.values())


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device) -> Params:
    """Physically paged decode cache: every attention slot stores KV
    scattered across ``num_pages`` pages (+ one trash page) addressed per
    call through a page table.  Leaves keep the leading stack axis of
    the parameter tree (n_periods for ``blocks``, 1 for ``rem``) and have
    no batch axis: rows exist only as page-table views."""
    check_supported(cfg)

    def slot(n: int) -> Params:
        return L.init_paged_attn_cache(cfg, num_pages, page_size, device,
                                       stack=n)

    return {"blocks": [slot(cfg.n_periods) for _ in range(cfg.period)],
            "rem": [slot(1) for _ in range(cfg.n_rem)]}


def iter_slots(cache: Params):
    """Slot cache dicts in stable (blocks, rem) order."""
    yield from cache["blocks"]
    yield from cache["rem"]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _apply_slot(p: Params, x: torch.Tensor, cfg: ModelConfig, slot, *,
                positions: torch.Tensor, cache: Optional[Params],
                paged, kv_chunk: int, cache_mode: str) -> torch.Tensor:
    mixer, ffn_kind = slot
    x = x + L.attention(p["mixer"], x, cfg, positions=positions,
                        cache=cache, window=_slot_window(cfg, mixer),
                        kv_chunk=kv_chunk, cache_mode=cache_mode,
                        paged=paged)
    if ffn_kind == "dense":
        x = x + L.ffn(p["ffn"], x, cfg)
    return x


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache: Optional[Params] = None,
            positions: Optional[torch.Tensor] = None,
            paged: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            feature_mode: Optional[str] = None,
            logits_mode: str = "all",
            kv_chunk: int = 2048,
            cache_mode: str = "append"
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the model.

    tokens (B, T) int; positions (B, T) absolute positions (default
    arange); cache (written in place) a dense ring cache from
    ``init_cache`` (``cache_mode`` "append" or "fresh", see
    ``layers.attention``), a paged cache from ``init_paged_cache`` with
    ``paged`` = (table (B, n_max) int32, lens (B,) int32), or None for a
    cache-less forward.  feature_mode "last" puts the final-position
    hidden state after every period / remainder layer in
    aux["features"] as (n_points, B, D); "all" keeps every position,
    (n_points, B, T, D); None skips them.  logits_mode "last" computes
    only the final position's logits.  Returns (logits (B, T', V) f32,
    aux).
    """
    check_supported(cfg)
    x = (params["embed"][tokens.long()] * math.sqrt(cfg.d_model)) \
        .to(cfg.tdtype)
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=x.device).expand(B, T)
    feats: List[torch.Tensor] = []

    def keep(x):
        if feature_mode is not None:
            feats.append(x[:, -1, :] if feature_mode == "last" else x)

    for i in range(cfg.n_periods):
        for s, slot in enumerate(cfg.pattern):
            c = None if cache is None else _index(cache["blocks"][s], i)
            x = _apply_slot(_index(params["blocks"][s], i), x, cfg, slot,
                            positions=positions, cache=c, paged=paged,
                            kv_chunk=kv_chunk, cache_mode=cache_mode)
        keep(x)
    for r in range(cfg.n_rem):
        c = None if cache is None else _index(cache["rem"][r], 0)
        x = _apply_slot(_index(params["rem"][r], 0), x, cfg, cfg.pattern[r],
                        positions=positions, cache=c, paged=paged,
                        kv_chunk=kv_chunk, cache_mode=cache_mode)
        keep(x)

    if logits_mode == "last":
        x = x[:, -1:]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    logits = L.softcap((x @ head).float(), cfg.final_softcap)
    aux: Dict[str, Any] = {}
    if feature_mode is not None:
        aux["features"] = torch.stack(feats)
    return logits, aux


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache: Params, kv_chunk: int = 2048
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Prefill: forward over the prompt writing the dense cache."""
    return forward(params, cfg, tokens, cache=cache, kv_chunk=kv_chunk)


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                cache: Params, pos: torch.Tensor, kv_chunk: int = 2048
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Decode T new tokens (T = 1 for plain AR, T = gamma to verify);
    pos (B,) int32 is the absolute position of the first one."""
    T = tokens.shape[1]
    positions = pos.to(torch.int32)[:, None] + torch.arange(
        T, dtype=torch.int32, device=pos.device)[None]
    return forward(params, cfg, tokens, cache=cache, positions=positions,
                   kv_chunk=kv_chunk)


@torch.no_grad()
def greedy_reference(params: Params, cfg: ModelConfig,
                     prompts: Sequence[Sequence[int]], n_new: int
                     ) -> List[List[int]]:
    """Plain autoregressive greedy decoding of the target model alone —
    the oracle the speculative streams must equal at temperature 0.  Each
    step is a cache-less forward over the whole sequence; prompts of one
    length decode as one batch."""
    dev = params["embed"].device
    out: List[List[int]] = [[] for _ in prompts]
    by_len: Dict[int, List[int]] = {}
    for i, p in enumerate(prompts):
        by_len.setdefault(len(p), []).append(i)
    for idx in by_len.values():
        seqs = torch.tensor([list(prompts[i]) for i in idx],
                            dtype=torch.int64, device=dev)
        for _ in range(n_new):
            logits, _ = forward(params, cfg, seqs, logits_mode="last")
            nxt = logits[:, -1].argmax(-1)
            seqs = torch.cat([seqs, nxt[:, None]], dim=1)
        for row, i in enumerate(idx):
            out[i] = seqs[row, len(prompts[i]):].tolist()
    return out
