"""gemma3-4b — dense GQA with 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt family].

34 layers, d_model 2560, 8 heads (GQA kv=4, head_dim 256), d_ff 10240,
vocab 262144.  Period of 6 (5 local window-1024 + 1 global); 34 = 5*6 + 4,
the 4 remainder layers reuse the pattern prefix (4 local) and are unrolled.
Gemma 3 drops softcapping and adds qk-norm.
Port of ``repro.configs.gemma3_4b``, field for field."""
from repro_torch.models.config import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8, num_kv_heads=4, head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    pattern=dense_pattern(5),            # 5 local : 1 global
    sliding_window=1024,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt; 5:1 local:global, 128k",
)
