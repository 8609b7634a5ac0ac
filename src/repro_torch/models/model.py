"""Full model: embedding -> periodic layer stack -> logits (port of
``repro.models.model``).

The parameter tree keeps the reference's layout: ``blocks[s]`` holds slot
``s`` of the period with every leaf stacked on a leading ``n_periods``
axis, ``rem`` the unrolled remainder layers.  The reference scans the
stacked periods; here a Python loop indexes them.  Paged caches keep the
same leading stack axis and are updated in place by the forward.
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
                paged, kv_chunk: int) -> torch.Tensor:
    mixer, ffn_kind = slot
    window = cfg.sliding_window if mixer == "local" else 0
    x = x + L.attention(p["mixer"], x, cfg, positions=positions,
                        cache=cache, window=window, kv_chunk=kv_chunk,
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
            kv_chunk: int = 2048) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the model.

    tokens (B, T) int; positions (B, T) absolute positions (default
    arange); cache from ``init_paged_cache`` (written in place) with
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
                            kv_chunk=kv_chunk)
        keep(x)
    for r in range(cfg.n_rem):
        c = None if cache is None else _index(cache["rem"][r], 0)
        x = _apply_slot(_index(params["rem"][r], 0), x, cfg, cfg.pattern[r],
                        positions=positions, cache=c, paged=paged,
                        kv_chunk=kv_chunk)
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
