"""The paper's draft/target model pairs (Table 7) as configs (port of
``repro.configs.paper_pairs``).

Speed ratios c follow Section 6: LLaMA 68M&7B c=10, Vicuna 68M&13B c=15,
Deepseek 1.3B&33B c=4, LLaMA-3.1 8B&70B c=5.
"""
from repro_torch.models.config import ModelConfig, dense_pattern


def _llama(name, layers, d, heads, kv, ff, vocab, theta=10_000.0):
    return ModelConfig(
        name=name, family="dense", num_layers=layers, d_model=d,
        num_heads=heads, num_kv_heads=kv, d_ff=ff, vocab_size=vocab,
        pattern=dense_pattern(0), rope_theta=theta, tie_embeddings=False)


LLAMA_68M = _llama("llama-68m", 2, 768, 12, 12, 3072, 32000)
LLAMA_7B = _llama("llama-7b", 32, 4096, 32, 32, 11008, 32000)
VICUNA_68M = _llama("vicuna-68m", 2, 768, 12, 12, 3072, 32000)
VICUNA_13B = _llama("vicuna-13b", 40, 5120, 40, 40, 13824, 32000)
DEEPSEEK_1_3B = _llama("deepseek-coder-1.3b", 24, 2048, 16, 16, 5504, 32256)
DEEPSEEK_33B = _llama("deepseek-coder-33b", 62, 7168, 56, 8, 19200, 32256)
LLAMA31_8B = _llama("llama-3.1-8b", 32, 4096, 32, 8, 14336, 128256,
                    theta=500_000.0)
LLAMA31_70B = _llama("llama-3.1-70b", 80, 8192, 64, 8, 28672, 128256,
                     theta=500_000.0)

# (draft, target, speed ratio c) — Section 6 of the paper
PAPER_PAIRS = {
    "llama": (LLAMA_68M, LLAMA_7B, 10),
    "vicuna": (VICUNA_68M, VICUNA_13B, 15),
    "deepseek": (DEEPSEEK_1_3B, DEEPSEEK_33B, 4),
    "llama31": (LLAMA31_8B, LLAMA31_70B, 5),
}
