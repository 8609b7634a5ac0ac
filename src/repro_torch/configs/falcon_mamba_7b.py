"""falcon-mamba-7b — attention-free Mamba-1 SSM  [arXiv:2410.05355]
(port of ``repro.configs.falcon_mamba_7b``).

64 layers, d_model 4096, pure Mamba mixers (no attention, d_ff = 0 — the
Mamba block's expand-2 inner projection plays the FFN role), vocab 65024,
ssm_state 16.  ``CONFIG.draft()`` is its 2-layer d_model 512 draft.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1, num_kv_heads=1,        # unused: attention-free
    d_ff=0,
    vocab_size=65024,
    pattern=(("mamba", "none"),),
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    tie_embeddings=True,
    source="arXiv:2410.05355 (Falcon Mamba); mamba1 arch",
)
