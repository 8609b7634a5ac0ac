"""The draft/target pairs on the Zipf-Markov language (load side of
``repro.training.pairs``).

``get_pair`` reads the reference's cached checkpoints
(``.cache/pairs/zm-target.npz`` and ``zm-draft-mis.npz``, committed with
the repo) through ``training.checkpoint.load``.  Training a pair whose
checkpoint is missing (the aligned draft trains on first use in the
reference) is a later slice of the port.  ``draft_heads_for`` loads the
reference's trained parallel-draft heads from the same cache
(``heads-<key>.npz``, written by the reference on first use) and raises
when they are missing: training them is a later slice too.
``hybrid_pair`` builds the
reference's tiny random-init SSM-bearing pairs and ``local_pair`` its
gemma3-shaped sliding-window pair (same configs, weights drawn by the
port's own generator).  ``PAIR_C``, ``default_ecfg`` and
``hrad_for_pair`` are the port's copies of the reference's benchmark
presets (``benchmarks/common.py``) that the examples use;
``hrad_for_pair`` loads the reference's trained H-RAD MLP from the same
cache and raises when it is missing (H-RAD training is a later slice).
"""
from __future__ import annotations

import hashlib
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, dense_pattern
from repro_torch.runtime.engines import EngineConfig
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


def _head_cache_key(cfg: ModelConfig, K: int, steps: int, seed: int) -> str:
    """Cache key of trained draft heads (the reference's): a hash of the
    full head configuration — head count K and the architecture of the
    base the heads read — so heads of another K or another base never
    load under the same name."""
    arch = (f"{cfg.name}:L{cfg.num_layers}:d{cfg.d_model}"
            f":v{cfg.vocab_size}:eps{cfg.norm_eps}"
            f":cap{cfg.final_softcap}:K{K}:s{steps}:seed{seed}")
    return hashlib.sha256(arch.encode()).hexdigest()[:16]


def draft_heads_for(kind: str = "misaligned", K: int = 4,
                    steps: int = 200, seed: int = 11, device="cuda",
                    cache_dir: Optional[str] = None) -> Dict[str, Any]:
    """The trained multi-position draft heads (DESIGN.md §7.12) of the
    draft model of ``get_pair(kind)``, read from the reference's cache
    file ``heads-<key>.npz``.  A missing file raises: the port cannot
    train heads yet, and random heads would not be the trained ones."""
    if kind == "misaligned":
        dcfg = DRAFT_MIS_CFG
    elif kind == "aligned":
        dcfg = DRAFT_ALI_CFG
    else:
        raise ValueError(kind)
    path = os.path.join(
        cache_dir or CACHE_DIR,
        f"heads-{_head_cache_key(dcfg, K, steps, seed)}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} is missing: the port loads trained draft heads from "
            "the reference's cache and cannot train them yet (training, "
            "ROADMAP.md queue A item 4); create it with the reference "
            "(PYTHONPATH=src python -m repro.launch.serve --draft-mode "
            "parallel)")
    with np.load(path) as data:
        heads = {k: data[k] for k in data.files}
    return ckpt.from_numpy_draft_heads(heads, dcfg, device)


# the paper's target/draft cost ratio c per pair (Sec. 6), as the
# reference's benchmarks set it
PAIR_C = {"misaligned": 15.0, "aligned": 5.0}


def default_ecfg(kind: str, **kw) -> EngineConfig:
    """The reference benchmarks' engine settings for a committed pair:
    signal temperature 0.3 puts the tiny drafts' confidence in the
    paper's range, epsilon between the accepted and rejected modes,
    Eq. 7's literal Top-K branches, and branch continuations of gamma
    tokens (the tiny drafts over-draft at c-length continuations)."""
    base = dict(gamma=4, k_max=6, epsilon=0.5, c=PAIR_C[kind],
                temperature=0.0, draft_temperature=0.0,
                signal_temperature=0.3, branch_mode="topk",
                gamma_branch_override=4, max_len=2048)
    base.update(kw)
    return EngineConfig(**base)


def hrad_for_pair(kind: str, k_layers: int = 4, device="cuda",
                  cache_dir: Optional[str] = None
                  ) -> Dict[str, Any]:
    """The trained H-RAD MLP of a committed pair, read from the
    reference's cache file ``hrad-<kind>-K<k_layers>.npz`` as float32
    tensors on ``device``.  A missing file raises: the port cannot train
    the MLP yet (ROADMAP.md queue A item 4)."""
    path = os.path.join(cache_dir or CACHE_DIR,
                        f"hrad-{kind}-K{k_layers}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} is missing: the port loads the trained H-RAD MLP "
            "from the reference's cache and cannot train it yet "
            "(training, ROADMAP.md queue A item 4); create it with the "
            "reference (PYTHONPATH=src python examples/serve_requests.py)")
    with np.load(path) as data:
        params = {k: data[k] for k in data.files}
    return ckpt.from_numpy_hrad(params, device)


HYBRID_KINDS = ("falcon-shaped", "jamba-shaped")


def hybrid_configs(kind: str) -> Tuple[ModelConfig, ModelConfig]:
    """(draft_cfg, target_cfg) of a tiny SSM-bearing pair, the
    reference's ``hybrid_pair`` configs:

      * "falcon-shaped" — attention-free Mamba-1 stack (falcon-mamba-7b's
        family, arXiv:2410.05355);
      * "jamba-shaped"  — hybrid Mamba + attention with MoE FFNs
        (jamba-1.5's family), with a drop-free MoE capacity so outputs
        do not depend on the batch's composition."""
    common = dict(vocab_size=VOCAB, dtype="float32")
    if kind == "falcon-shaped":
        tcfg = ModelConfig(
            name="hy-falcon-t", family="ssm", num_layers=2, d_model=64,
            num_heads=2, num_kv_heads=1, d_ff=0,
            pattern=(("mamba", "none"),), **common)
        dcfg = ModelConfig(
            name="hy-falcon-d", family="ssm", num_layers=1, d_model=32,
            num_heads=2, num_kv_heads=1, d_ff=0,
            pattern=(("mamba", "none"),), **common)
    elif kind == "jamba-shaped":
        tcfg = ModelConfig(
            name="hy-jamba-t", family="hybrid", num_layers=2, d_model=64,
            num_heads=2, num_kv_heads=1, d_ff=256,
            pattern=(("mamba", "dense"), ("attn", "moe")),
            num_experts=4, num_experts_per_tok=2, moe_d_ff=64,
            capacity_factor=2.0, **common)
        dcfg = ModelConfig(
            name="hy-jamba-d", family="hybrid", num_layers=1, d_model=32,
            num_heads=2, num_kv_heads=1, d_ff=128,
            pattern=(("mamba", "dense"),), **common)
    else:
        raise ValueError(kind)
    return dcfg, tcfg


def hybrid_pair(kind: str, seed: int = 0, device="cuda"
                ) -> Tuple[Any, ModelConfig, Any, ModelConfig]:
    """(draft_params, draft_cfg, target_params, target_cfg): random-init
    weights from ``init_params`` (target ``seed``, draft ``seed + 1``).
    Greedy losslessness and rollback correctness are properties of the
    engine, not of model quality, so no training is needed."""
    dcfg, tcfg = hybrid_configs(kind)
    return (M.init_params(dcfg, seed + 1, device), dcfg,
            M.init_params(tcfg, seed, device), tcfg)


LOCAL_KINDS = ("gemma3-shaped",)


def local_configs(kind: str = "gemma3-shaped"
                  ) -> Tuple[ModelConfig, ModelConfig]:
    """(draft_cfg, target_cfg) of the tiny local-attention
    (sliding-window) pair, the reference's ``local_pair`` configs:
    gemma3's family, interleaved local (windowed ring cache) and global
    layers with qk-norm.  The window (8) is deliberately smaller than
    prompt + generation, so a serving test's rings wrap end to end while
    speculation overshoots and rolls back around them."""
    if kind != "gemma3-shaped":
        raise ValueError(kind)
    common = dict(vocab_size=VOCAB, dtype="float32", sliding_window=8)
    tcfg = ModelConfig(
        name="lo-gemma3-t", family="dense", num_layers=3, d_model=64,
        num_heads=2, num_kv_heads=1, d_ff=128, qk_norm=True,
        pattern=dense_pattern(2),            # 2 local : 1 global
        **common)
    dcfg = ModelConfig(
        name="lo-gemma3-d", family="dense", num_layers=1, d_model=32,
        num_heads=2, num_kv_heads=1, d_ff=64,
        pattern=(("local", "dense"),), **common)
    return dcfg, tcfg


def local_pair(kind: str = "gemma3-shaped", seed: int = 0, device="cuda"
               ) -> Tuple[Any, ModelConfig, Any, ModelConfig]:
    """(draft_params, draft_cfg, target_params, target_cfg) of
    ``local_configs(kind)``: random-init weights from ``init_params``
    (target ``seed``, draft ``seed + 1``; not the reference's draws —
    tests carry the reference's over with
    ``training.checkpoint.from_numpy_params``)."""
    dcfg, tcfg = local_configs(kind)
    return (M.init_params(dcfg, seed + 1, device), dcfg,
            M.init_params(tcfg, seed, device), tcfg)
