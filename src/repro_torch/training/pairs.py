"""The committed draft/target pairs on the Zipf-Markov language (load side
of ``repro.training.pairs``).

``get_pair`` reads the reference's cached checkpoints
(``.cache/pairs/zm-target.npz`` and ``zm-draft-mis.npz``, committed with
the repo) through ``training.checkpoint.load``.  Training a pair whose
checkpoint is missing (the aligned draft trains on first use in the
reference) is a later slice of the port.
"""
from __future__ import annotations

import os
from typing import Any, Tuple

from repro_torch.models.config import ModelConfig, dense_pattern
from repro_torch.training import checkpoint as ckpt

CACHE_DIR = os.environ.get("REPRO_PAIR_CACHE", ".cache/pairs")

VOCAB = 199


def _cfg(name: str, layers: int, d: int, heads: int) -> ModelConfig:
    return ModelConfig(
        name=name, family="dense", num_layers=layers, d_model=d,
        num_heads=heads, num_kv_heads=max(1, heads // 2), d_ff=4 * d,
        vocab_size=VOCAB, pattern=dense_pattern(0), dtype="float32")


TARGET_CFG = _cfg("zm-target", 4, 128, 4)
DRAFT_MIS_CFG = _cfg("zm-draft-mis", 1, 32, 2)
DRAFT_ALI_CFG = _cfg("zm-draft-ali", 1, 32, 2)


def _get(cfg: ModelConfig, cache_dir: str, device) -> Any:
    path = os.path.join(cache_dir, f"{cfg.name}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} is missing: the port loads the reference's cached "
            "pairs and cannot train them yet (training is a later slice; "
            "run the reference once with PYTHONPATH=src python -m "
            "repro.launch.serve to create it)")
    return ckpt.load(path, cfg, device)


def get_pair(kind: str = "misaligned", device="cuda",
             cache_dir: str = CACHE_DIR
             ) -> Tuple[Any, ModelConfig, Any, ModelConfig]:
    """Returns (draft_params, draft_cfg, target_params, target_cfg)."""
    if kind == "misaligned":
        dcfg = DRAFT_MIS_CFG
    elif kind == "aligned":
        dcfg = DRAFT_ALI_CFG
    else:
        raise ValueError(kind)
    tgt = _get(TARGET_CFG, cache_dir, device)
    return _get(dcfg, cache_dir, device), dcfg, tgt, TARGET_CFG
