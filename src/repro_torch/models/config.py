"""Model configuration (port of ``repro.models.config``).

One ``ModelConfig`` describes the layer stack as a repeating *period* of
``(mixer, ffn)`` slots; ``num_layers = n_periods * period + n_rem``.  The
dataclass is the reference's field for field, so a config round-trips
between the two packages by ``dataclasses.asdict``; ``tdtype`` maps the
``dtype`` string to a torch dtype (the reference's ``jdtype``).
"""
from __future__ import annotations

import dataclasses
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

    def param_count(self) -> int:
        """Analytic parameter count of a dense attention stack (the only
        family this slice of the port builds)."""
        D, F, V, hd = self.d_model, self.d_ff, self.vocab_size, self.hd
        n = V * D * (1 if self.tie_embeddings else 2) + D
        for _mixer, ffn in self.layer_kinds():
            n += D + D * self.num_heads * hd * 2 \
                + 2 * D * self.num_kv_heads * hd
            if ffn == "dense":
                n += D + 3 * D * F
        return n

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def dense_pattern(local_ratio: int = 0) -> Tuple[Slot, ...]:
    """local_ratio = n means (n local : 1 global); 0 means all-global."""
    if local_ratio == 0:
        return (("attn", "dense"),)
    return tuple([("local", "dense")] * local_ratio + [("attn", "dense")])


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the architecture features a later slice of the port
    brings (mamba/MoE mixers, encoder-only stacks, stub frontends)."""
    for mixer, ffn in cfg.pattern:
        if mixer not in ("attn", "local") or ffn not in ("dense", "none"):
            raise NotImplementedError(
                f"{cfg.name}: slot ({mixer}, {ffn}) — mamba and MoE "
                "layers are ported in a later slice (ROADMAP.md queue A)")
    if not cfg.causal or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: encoder-only and stub-frontend configs are "
            "ported in a later slice (ROADMAP.md queue A)")
