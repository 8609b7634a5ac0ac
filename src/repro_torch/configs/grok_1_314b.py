"""grok-1-314b — MoE transformer, 8 experts top-2  [hf:xai-org/grok-1].

64 layers, d_model 6144, 48 heads (GQA kv=8, head_dim 128), expert d_ff
32768, vocab 131072, MoE on every layer.
Port of ``repro.configs.grok_1_314b``, field for field."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    pattern=(("attn", "moe"),),
    num_experts=8, num_experts_per_tok=2, moe_d_ff=32768,
    attn_softcap=30.0,                    # grok uses attn logit capping
    final_softcap=30.0,
    tie_embeddings=True,
    source="hf:xai-org/grok-1; 8 experts top-2",
)
