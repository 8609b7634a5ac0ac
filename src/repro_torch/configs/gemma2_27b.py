"""gemma2-27b — dense GQA with local/global alternating attention and logit
softcapping  [arXiv:2408.00118].

46 layers, d_model 4608, 32 heads (GQA kv=16, head_dim 128), d_ff 36864,
vocab 256000.  Alternating (local window 4096, global) pairs; attention
softcap 50, final-logit softcap 30.
Port of ``repro.configs.gemma2_27b``, field for field."""
from repro_torch.models.config import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32, num_kv_heads=16, head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    pattern=dense_pattern(1),            # (local, global) alternating
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    tie_embeddings=True,
    source="arXiv:2408.00118 (Gemma 2); local+global alternating, softcap",
)
