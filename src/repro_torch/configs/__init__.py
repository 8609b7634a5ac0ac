"""Config registry (port of ``repro.configs``): the 10 assigned
architectures + the paper's own pairs.

``get_config(name)`` accepts the assigned arch ids (with dashes), e.g.
``get_config("falcon-mamba-7b")``, and the paper-pair config names (e.g.
``"llama-7b"``).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "falcon-mamba-7b",
    "jamba-1.5-large-398b",
    "mistral-nemo-12b",
    "gemma2-27b",
    "qwen3-8b",
    "grok-1-314b",
    "gemma3-4b",
    "hubert-xlarge",
    "internvl2-2b",
    "granite-moe-3b-a800m",
]

_MODULES: Dict[str, str] = {
    "falcon-mamba-7b": "falcon_mamba_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "gemma2-27b": "gemma2_27b",
    "qwen3-8b": "qwen3_8b",
    "grok-1-314b": "grok_1_314b",
    "gemma3-4b": "gemma3_4b",
    "hubert-xlarge": "hubert_xlarge",
    "internvl2-2b": "internvl2_2b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
}


def get_config(name: str) -> ModelConfig:
    if name in _MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
        return mod.CONFIG
    # paper pair configs, addressable as e.g. "llama-7b"
    from repro_torch.configs import paper_pairs as pp
    for cfg in [pp.LLAMA_68M, pp.LLAMA_7B, pp.VICUNA_68M, pp.VICUNA_13B,
                pp.DEEPSEEK_1_3B, pp.DEEPSEEK_33B, pp.LLAMA31_8B,
                pp.LLAMA31_70B]:
        if cfg.name == name:
            return cfg
    raise KeyError(f"unknown architecture: {name!r}; known: {ARCH_IDS}")


def all_assigned() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
