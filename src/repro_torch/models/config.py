"""Model configuration (port of ``repro.models.config``).

One ``ModelConfig`` describes the layer stack as a repeating *period* of
``(mixer, ffn)`` slots; ``num_layers = n_periods * period + n_rem``.  The
dataclass is the reference's field for field, so a config round-trips
between the two packages by ``dataclasses.asdict``; ``tdtype`` maps the
``dtype`` string to a torch dtype (the reference's ``jdtype``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

Slot = Tuple[str, str]  # (mixer_kind, ffn_kind)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[Slot, ...]        # repeating period of (mixer, ffn) slots

    head_dim: int = 0                # 0 -> d_model // num_heads
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    sliding_window: int = 0          # window for "local" mixers
    causal: bool = True
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0
    tie_embeddings: bool = True
    frontend: Optional[str] = None
    num_patches: int = 256
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dtr(self) -> int:
        return self.dt_rank or max(1, math.ceil(self.d_model / 16))

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_periods(self) -> int:
        return self.num_layers // self.period

    @property
    def n_rem(self) -> int:
        return self.num_layers - self.n_periods * self.period

    @property
    def tdtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def layer_kinds(self) -> Tuple[Slot, ...]:
        return tuple(self.pattern[i % self.period]
                     for i in range(self.num_layers))

    def has_attention(self) -> bool:
        return any(m in ("attn", "local") for m, _ in self.pattern)

    def pure_full_attention(self) -> bool:
        """True if every mixer is full (non-windowed) attention."""
        return all(m == "attn" for m, _ in self.pattern)

    def supports_decode(self) -> bool:
        return self.causal

    def supports_long_context(self) -> bool:
        """Sub-quadratic-per-token state growth: SSM / hybrid / windowed."""
        return self.supports_decode() and not self.pure_full_attention()

    def param_count(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        D, F, V, hd = self.d_model, self.d_ff, self.vocab_size, self.hd
        n = V * D * (1 if self.tie_embeddings else 2) + D
        for mixer, ffn in self.layer_kinds():
            n += D
            if mixer in ("attn", "local"):
                n += D * self.num_heads * hd * 2 \
                    + 2 * D * self.num_kv_heads * hd
                if self.qk_norm:
                    n += 2 * hd
            else:                                    # mamba
                E, N, R = self.d_inner, self.ssm_state, self.dtr
                n += D * 2 * E + self.ssm_conv * E + E + E * (R + 2 * N) \
                    + R * E + E + E * N + E + E * D
            if ffn == "dense":
                n += D + 3 * D * F
            elif ffn == "moe":
                n += D + D * self.num_experts \
                    + self.num_experts * 3 * D * self.expert_ff
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if self.num_experts == 0:
            return self.param_count()
        n_moe_layers = sum(1 for _, f in self.layer_kinds() if f == "moe")
        inactive = n_moe_layers * (self.num_experts
                                   - self.num_experts_per_tok) \
            * 3 * self.d_model * self.expert_ff
        return self.param_count() - inactive

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <= 2 periods, d_model <= 256, <= 4 experts,
        vocab <= 512, float32, with a drop-free MoE capacity (C == n_tokens)
        so outputs do not depend on the batch's composition."""
        P = self.period
        d = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, max(1, heads // 2))
        return self.replace(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 2 * P),
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=d // heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            moe_d_ff=min(self.expert_ff, 256) if self.num_experts else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4),
            num_experts_per_tok=min(self.num_experts_per_tok,
                                    min(self.num_experts, 4)) or 0,
            sliding_window=(min(self.sliding_window, 32)
                            if self.sliding_window else 0),
            num_patches=16,
            capacity_factor=(self.num_experts
                             / max(1, self.num_experts_per_tok)
                             if self.num_experts else self.capacity_factor),
            dtype="float32",
        )

    def draft(self) -> "ModelConfig":
        """Same-family scaled-down draft model for speculative decoding
        (the reference's ``ModelConfig.draft``)."""
        P = self.period
        d = max(256, self.d_model // 8)
        heads = max(2, self.num_heads // 8)
        kv = max(1, min(self.num_kv_heads, heads))
        return self.replace(
            name=self.name + "-draft",
            num_layers=min(self.num_layers, 2 * P),
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=d // heads,
            d_ff=(4 * d) if self.d_ff else 0,
            moe_d_ff=d if self.num_experts else 0,
            num_experts=min(self.num_experts, 4),
            num_experts_per_tok=min(self.num_experts_per_tok, 2) or 0,
        )


def dense_pattern(local_ratio: int = 0) -> Tuple[Slot, ...]:
    """local_ratio = n means (n local : 1 global); 0 means all-global."""
    if local_ratio == 0:
        return (("attn", "dense"),)
    return tuple([("local", "dense")] * local_ratio + [("attn", "dense")])


class NoDecodeError(ValueError):
    """A decode cache, a decode step or an engine was asked of a config
    with no autoregressive decode (``supports_decode()`` false: the
    encoder-only hubert-xlarge).  The reference has no decode path for
    such a config either; it only runs the cache-less forward."""


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a slot kind the model stack does not have."""
    for mixer, ffn in cfg.pattern:
        if mixer not in ("attn", "local", "mamba") \
                or ffn not in ("dense", "moe", "none"):
            raise NotImplementedError(
                f"{cfg.name}: slot ({mixer}, {ffn}) is not a layer kind "
                "of the port")


def check_decodes(cfg: ModelConfig) -> None:
    """Raise ``NoDecodeError`` for a config that cannot decode."""
    check_supported(cfg)
    if not cfg.supports_decode():
        raise NoDecodeError(
            f"{cfg.name} is encoder-only (causal=False): it has no "
            "autoregressive decode, no decode cache and no engine; run "
            "its cache-less forward (models.model.forward)")
