"""granite-moe-3b-a800m — fine-grained MoE, 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base family].

32 layers, d_model 1536, 24 heads (GQA kv=8, head_dim 64), per-expert
d_ff 512, vocab 49155, MoE 40 experts top-8 on every layer.  (The assignment
line says "MoE 40e top-8" in the config and "32 experts" in the note; we
follow the config field: 40 experts.)
Port of ``repro.configs.granite_moe_3b_a800m``, field for field."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24, num_kv_heads=8, head_dim=64,
    d_ff=512,
    vocab_size=49155,
    pattern=(("attn", "moe"),),
    num_experts=40, num_experts_per_tok=8, moe_d_ff=512,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; 40e top-8",
)
