"""jamba-1.5-large-398b — hybrid Mamba + attention (1:7) with MoE
[arXiv:2403.19887].

72 layers, d_model 8192, 64 heads (GQA kv=8), d_ff 24576, vocab 65536,
MoE 16 experts top-2 on every other layer.  Period of 8: one full-attention
mixer per 8 layers (slot 3), MoE FFN on even slots.
Port of ``repro.configs.jamba_1_5_large_398b``, field for field."""
from repro_torch.models.config import ModelConfig

_MIXERS = ["mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba",
           "mamba"]
_FFNS = ["moe" if i % 2 == 0 else "dense" for i in range(8)]

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern=tuple(zip(_MIXERS, _FFNS)),
    num_experts=16, num_experts_per_tok=2, moe_d_ff=24576,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    tie_embeddings=False,
    source="arXiv:2403.19887 (Jamba-1.5); Mamba+attn 1:7 interleave, MoE",
)
