"""internvl2-2b — VLM: InternViT (stub) + InternLM2-1.8B language decoder
[arXiv:2404.16821].

LM backbone: 24 layers, d_model 2048, 16 heads (GQA kv=8, head_dim 128),
d_ff 8192, vocab 92553.  The vision encoder + projector are a stub:
callers pass already-projected patch embeddings (B, num_patches, d_model)
as ``embeds=`` (``models.model.forward``, ``runtime.runner.forward_embeds``,
the sequential engines), which go before the token embeddings.  Pure full
attention -> long_500k skipped.
Port of ``repro.configs.internvl2_2b``, field for field."""
from repro_torch.models.config import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    pattern=dense_pattern(0),
    frontend="vision",
    num_patches=256,
    tie_embeddings=False,
    source="arXiv:2404.16821 (InternVL2); InternViT + InternLM2",
)
