"""hubert-xlarge — encoder-only audio backbone (wav2vec2 arch)
[arXiv:2106.07447].

48 layers, d_model 1280, 16 heads (kv=16, MHA), d_ff 5120, vocab 504
(k-means cluster targets).  Bidirectional attention (causal=False); the
conv/mel frontend is a stub — ``models.model.forward(..., embeds=)`` takes
precomputed frame embeddings of shape (B, T, d_model).  No autoregressive
decode (``supports_decode()`` is false): caches, decode steps and engines
raise ``NoDecodeError``.
Port of ``repro.configs.hubert_xlarge``, field for field."""
from repro_torch.models.config import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16, num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    pattern=dense_pattern(0),
    causal=False,
    frontend="audio",
    tie_embeddings=False,
    source="arXiv:2106.07447 (HuBERT); encoder-only, w2v2 arch",
)
