"""mistral-nemo-12b — dense GQA transformer, 128k context
[hf:mistralai/Mistral-Nemo-Base-2407].

40 layers, d_model 5120, 32 heads (GQA kv=8, head_dim 128), d_ff 14336,
vocab 131072.  Pure full attention -> long_500k decode is skipped
(documented in DESIGN.md §6).
Port of ``repro.configs.mistral_nemo_12b``, field for field."""
from repro_torch.models.config import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    pattern=dense_pattern(0),
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="hf:mistralai/Mistral-Nemo-Base-2407; 128k ctx",
)
