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

F32_LEAVES = ("A_log", "Dskip", "router")


def param_dtype(name: str, cfg: ModelConfig) -> torch.dtype:
    """The dtype the reference's init gives leaf ``name``: Mamba's
    ``A_log`` and ``Dskip`` and the MoE ``router`` stay float32 whatever
    the model's dtype; every other leaf is ``cfg.tdtype``."""
    return torch.float32 if name in F32_LEAVES else cfg.tdtype


def init_params(cfg: ModelConfig, seed: int, device="cuda") -> Params:
    """Random parameters from ``torch.Generator(seed)`` with the
    reference's shapes, scales and per-leaf dtypes (normal weights scaled
    by 1/sqrt(fan_in), zero norm scales, Mamba's A_log = log(1..N), Dskip
    = 1 and dt bias -4.6), drawn on ``device``.  The draws are not the
    reference's: runs that compare the two frameworks carry the
    reference's weights over with ``training.checkpoint.from_numpy_params``."""
    check_supported(cfg)
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    D, H, KV, hd, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                       cfg.d_ff)

    def normal(name, shape, fan_in):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=param_dtype(name, cfg)) \
            .mul_(1.0 / math.sqrt(fan_in))

    def full(name, shape, value):
        return torch.full(shape, value, device=dev,
                          dtype=param_dtype(name, cfg))

    def attn(lead) -> Params:
        p = {"ln": full("ln", lead + (D,), 0.0),
             "wq": normal("wq", lead + (D, H * hd), D),
             "wk": normal("wk", lead + (D, KV * hd), D),
             "wv": normal("wv", lead + (D, KV * hd), D),
             "wo": normal("wo", lead + (H * hd, D), H * hd)}
        if cfg.qk_norm:
            p["q_norm"] = full("q_norm", lead + (hd,), 0.0)
            p["k_norm"] = full("k_norm", lead + (hd,), 0.0)
        return p

    def mamba(lead) -> Params:
        E, N, R, Cv = cfg.d_inner, cfg.ssm_state, cfg.dtr, cfg.ssm_conv
        a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                       device=dev)).expand(lead + (E, N))
        return {"ln": full("ln", lead + (D,), 0.0),
                "in_proj": normal("in_proj", lead + (D, 2 * E), D),
                "conv_w": normal("conv_w", lead + (Cv, E), Cv),
                "conv_b": full("conv_b", lead + (E,), 0.0),
                "x_db": normal("x_db", lead + (E, R + 2 * N), E),
                "dt_w": normal("dt_w", lead + (R, E), R),
                "dt_b": full("dt_b", lead + (E,), -4.6),
                "A_log": a_log.contiguous(),
                "Dskip": full("Dskip", lead + (E,), 1.0),
                "out_proj": normal("out_proj", lead + (E, D), E)}

    def slot(n: int, kind) -> Params:
        mixer, ffn_kind = kind
        lead = (n,)
        p: Params = {"mixer": attn(lead) if mixer in ("attn", "local")
                     else mamba(lead)}
        if ffn_kind == "dense":
            p["ffn"] = {"ln": full("ln", lead + (D,), 0.0),
                        "wg": normal("wg", lead + (D, F), D),
                        "wu": normal("wu", lead + (D, F), D),
                        "wd": normal("wd", lead + (F, D), F)}
        elif ffn_kind == "moe":
            Ex, Fe = cfg.num_experts, cfg.expert_ff
            p["ffn"] = {"ln": full("ln", lead + (D,), 0.0),
                        "router": normal("router", lead + (D, Ex), D),
                        "wg": normal("wg", lead + (Ex, D, Fe), D),
                        "wu": normal("wu", lead + (Ex, D, Fe), D),
                        "wd": normal("wd", lead + (Ex, Fe, D), Fe)}
        return p

    params: Params = {
        "embed": normal("embed", (cfg.vocab_size, D), D),
        "final_norm": full("final_norm", (D,), 0.0),
        "blocks": [slot(cfg.n_periods, cfg.pattern[s])
                   for s in range(cfg.period)],
        "rem": [slot(1, cfg.pattern[r]) for r in range(cfg.n_rem)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal("lm_head", (D, cfg.vocab_size), D)
    return params


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def _slot_window(cfg: ModelConfig, mixer: str) -> int:
    return cfg.sliding_window if mixer == "local" else 0


def _init_slot_cache(cfg: ModelConfig, slot, batch: int, max_len: int,
                     device, stack: int, ssm_ring: int = 0) -> Params:
    mixer = slot[0]
    if mixer in ("attn", "local"):
        # the checkpoint-ring depth doubles as sliding-window slack: both
        # bound how far ahead of a row's logical length writes may land
        return L.init_attn_cache(cfg, batch, max_len,
                                 _slot_window(cfg, mixer), device,
                                 ring_slack=ssm_ring, stack=stack)
    return L.init_mamba_cache(cfg, batch, device, ring=ssm_ring, stack=stack)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               ssm_ring: int = 0) -> Params:
    """Dense ring decode cache mirroring the params layout: every leaf has
    a leading stack axis (n_periods for ``blocks``, 1 for ``rem``), so
    batch is uniformly axis 1 — the runner's branch fork / select rely on
    this.  ``ssm_ring`` > 0 gives every mamba slot a position-indexed
    checkpoint ring of that depth (0: the carried state of the
    sequential runner) and pads windowed attention rings by as much."""
    check_supported(cfg)
    return {"blocks": [_init_slot_cache(cfg, cfg.pattern[s], batch, max_len,
                                        device, cfg.n_periods, ssm_ring)
                       for s in range(cfg.period)],
            "rem": [_init_slot_cache(cfg, cfg.pattern[r], batch, max_len,
                                     device, 1, ssm_ring)
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
                     device, *, n_rows: int = 0, ssm_ring: int = 0) -> Params:
    """Physically paged decode cache: every attention slot stores KV
    scattered across ``num_pages`` pages (+ one trash page) addressed per
    call through a page table; those leaves keep the leading stack axis
    of the parameter tree and have no batch axis (rows exist only as
    page-table views).  Mamba slots cannot be paged: each carries a
    per-row checkpoint ring (``n_rows`` rows of depth ``ssm_ring``), so
    an SSM or hybrid config gets a mixed tree."""
    check_supported(cfg)
    if any(m == "mamba" for m, _ in cfg.pattern) \
            and (n_rows <= 0 or ssm_ring <= 0):
        raise ValueError("mamba slots in a paged cache ride per-row "
                         "checkpoint rings: pass n_rows > 0 and "
                         "ssm_ring > 0")

    def slot(kind, n: int) -> Params:
        if kind[0] in ("attn", "local"):
            return L.init_paged_attn_cache(cfg, num_pages, page_size,
                                           device, stack=n)
        return L.init_mamba_cache(cfg, n_rows, device, ring=ssm_ring,
                                  stack=n)

    return {"blocks": [slot(cfg.pattern[s], cfg.n_periods)
                       for s in range(cfg.period)],
            "rem": [slot(cfg.pattern[r], 1) for r in range(cfg.n_rem)]}


def iter_slots(cache: Params):
    """Slot cache dicts in stable (blocks, rem) order."""
    yield from cache["blocks"]
    yield from cache["rem"]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _apply_slot(p: Params, x: torch.Tensor, cfg: ModelConfig, slot, *,
                positions: torch.Tensor, cache: Optional[Params],
                paged, kv_chunk: int, cache_mode: str,
                ring_rows: Optional[torch.Tensor],
                pdraft: Optional[Params] = None) -> torch.Tensor:
    mixer, ffn_kind = slot
    if mixer in ("attn", "local"):
        x = x + L.attention(p["mixer"], x, cfg, positions=positions,
                            cache=cache, window=_slot_window(cfg, mixer),
                            kv_chunk=kv_chunk, cache_mode=cache_mode,
                            paged=paged, pdraft=pdraft)
    else:
        if pdraft is not None:
            raise ValueError(
                "parallel draft positions need attention-only models: a "
                "mamba slot's scan would thread recurrent state through "
                "the draft slots (DESIGN.md §7.12)")
        x = x + L.mamba(p["mixer"], x, cfg, cache=cache,
                        positions=positions, ring_rows=ring_rows)
    if ffn_kind == "dense":
        x = x + L.ffn(p["ffn"], x, cfg)
    elif ffn_kind == "moe":
        x = x + L.moe_ffn(p["ffn"], x, cfg)
    return x


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache: Optional[Params] = None,
            positions: Optional[torch.Tensor] = None,
            paged: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            feature_mode: Optional[str] = None,
            feature_points: int = 0,
            feature_index: Optional[torch.Tensor] = None,
            logits_mode: str = "all",
            kv_chunk: int = 2048,
            cache_mode: str = "append",
            ring_rows: Optional[torch.Tensor] = None,
            pdraft: Optional[Params] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the model.

    tokens (B, T) int; positions (B, T) absolute positions (default
    arange); cache (written in place) a dense ring cache from
    ``init_cache`` (``cache_mode`` "append" or "fresh", see
    ``layers.attention``), a paged cache from ``init_paged_cache`` with
    ``paged`` = (table (B, n_max) int32, lens (B,) int32), or None for a
    cache-less forward.  ``ring_rows`` (B,) maps lanes to the rows of
    mamba checkpoint rings (``layers.mamba``; default lane i = row i).
    feature_mode "last" puts the final-position hidden state after every
    period / remainder layer in aux["features"] as (n_points, B, D); "at"
    the hidden state at position ``feature_index[b]`` (B,) of each row,
    also (n_points, B, D); "all" keeps every position, (n_points, B, T,
    D); None skips them.  ``feature_points`` > 0 keeps only the last that
    many points (H-RAD reads its last K).  logits_mode "last" computes
    only the final position's logits.

    ``pdraft`` (DESIGN.md §7.12) marks parallel-draft slot columns:
    ``{"cols": (B, T) bool, "ctx": (B, T) int32, "sidx": (B, T) int,
    "embed": (K, d_model)}``.  Slot columns replace their token embedding
    with the slot embedding ``embed[sidx]``, store their keys invisible
    and clamp their queries to the ``ctx`` horizon
    (``layers.attention``); ``draft_head_logits`` turns their last-point
    features into head logits.  Attention-only models (a mamba slot
    raises).  Returns (logits (B, T', V) f32, aux).
    """
    check_supported(cfg)
    emb = params["embed"][tokens.long()] * math.sqrt(cfg.d_model)
    pd_attn = None
    if pdraft is not None:
        K = pdraft["embed"].shape[0]
        se = (pdraft["embed"][pdraft["sidx"].long().clamp(0, K - 1)]
              * math.sqrt(cfg.d_model))
        emb = torch.where(pdraft["cols"][..., None], se.to(emb.dtype), emb)
        pd_attn = {"cols": pdraft["cols"],
                   "ctx": pdraft["ctx"].to(torch.int32)}
    x = emb.to(cfg.tdtype)
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=x.device).expand(B, T)
    feats: List[torch.Tensor] = []
    n_points = cfg.n_periods + cfg.n_rem
    first = n_points - feature_points if feature_points > 0 else 0
    point = 0

    def keep(x):
        nonlocal point
        if feature_mode is not None and point >= first:
            if feature_mode == "last":
                x = x[:, -1, :]
            elif feature_mode == "at":
                x = x[torch.arange(B, device=x.device),
                      feature_index.to(x.device).long()]
            feats.append(x)
        point += 1

    for i in range(cfg.n_periods):
        for s, slot in enumerate(cfg.pattern):
            c = None if cache is None else _index(cache["blocks"][s], i)
            x = _apply_slot(_index(params["blocks"][s], i), x, cfg, slot,
                            positions=positions, cache=c, paged=paged,
                            kv_chunk=kv_chunk, cache_mode=cache_mode,
                            ring_rows=ring_rows, pdraft=pd_attn)
        keep(x)
    for r in range(cfg.n_rem):
        c = None if cache is None else _index(cache["rem"][r], 0)
        x = _apply_slot(_index(params["rem"][r], 0), x, cfg, cfg.pattern[r],
                        positions=positions, cache=c, paged=paged,
                        kv_chunk=kv_chunk, cache_mode=cache_mode,
                        ring_rows=ring_rows, pdraft=pd_attn)
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


# ---------------------------------------------------------------------------
# multi-token draft heads (single-pass parallel drafting, DESIGN.md §7.12)
# ---------------------------------------------------------------------------

def init_draft_heads(cfg: ModelConfig, K: int, generator: torch.Generator,
                     device="cuda") -> Params:
    """K parallel-position draft heads + K slot embeddings, drawn from
    ``generator`` on ``device`` with the reference's shapes, scale
    (1/sqrt(d_model)) and dtype: ``mask_embed`` (K, d_model) and
    ``heads`` (K, d_model, vocab).  Slot j (1-indexed) rides at position
    ``last_real + j`` of a draft forward with its embedding replaced by
    ``mask_embed[j-1]``; head j maps its final-layer hidden state to the
    distribution of the token at ``last_real + j + 1``.  The draws are
    not the reference's: runs that compare the two frameworks carry the
    reference's heads over with
    ``training.checkpoint.from_numpy_draft_heads``."""
    dev = torch.device(device)
    s = 1.0 / math.sqrt(cfg.d_model)

    def normal(shape):
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * s).to(cfg.tdtype)
    return {"mask_embed": normal((K, cfg.d_model)),
            "heads": normal((K, cfg.d_model, cfg.vocab_size))}


def pdraft_frame(pos: torch.Tensor, nreal: torch.Tensor, T: int,
                 embed: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """A parallel-draft frame of width T: row b starts at position pos[b]
    with nreal[b] real tokens, then draft slots.  Returns (positions (B,
    T) int32, the ``pdraft`` argument of ``forward``): slot columns keep
    their true positions, their queries see up to the row's last real
    position and slot j (0-based) rides slot embedding ``embed[j]``.  A
    row without real tokens is all slots (its lanes are garbage)."""
    t = torch.arange(T, dtype=torch.int32, device=pos.device)[None]
    p0 = pos.to(torch.int32)[:, None]
    nr = nreal.to(device=pos.device, dtype=torch.int32)[:, None]
    positions = p0 + t
    cols = t >= nr
    return positions, {"cols": cols,
                       "ctx": torch.where(cols, p0 + nr.clamp_min(1) - 1,
                                          positions),
                       "sidx": (t - nr).clamp_min(0), "embed": embed}


def draft_head_logits(params: Params, cfg: ModelConfig, dhead: Params,
                      hidden: torch.Tensor, j0: int = 0) -> torch.Tensor:
    """Head logits over slot hidden states: hidden (..., n, d_model), the
    final-layer (pre-final-norm) states at slot positions j0+1 .. j0+n.
    Applies the model's final norm and softcap, so head logits share the
    AR logits' scale.  Returns (..., n, vocab) float32."""
    n = hidden.shape[-2]
    hn = L.rms_norm(hidden, params["final_norm"], cfg.norm_eps)
    lg = torch.einsum("...nd,ndv->...nv", hn.float(),
                      dhead["heads"][j0:j0 + n].float())
    return L.softcap(lg, cfg.final_softcap)


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
