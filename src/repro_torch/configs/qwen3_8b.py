"""qwen3-8b — dense GQA transformer with qk-norm  [hf:Qwen/Qwen3-8B].

36 layers, d_model 4096, 32 heads (GQA kv=8, head_dim 128), d_ff 12288,
vocab 151936.  Pure full attention -> long_500k decode is skipped.
Port of ``repro.configs.qwen3_8b``, field for field."""
from repro_torch.models.config import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    pattern=dense_pattern(0),
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="hf:Qwen/Qwen3-8B; qk_norm, GQA",
)
