"""The draft/target pairs on the Zipf-Markov language (port of
``repro.training.pairs``).

``get_pair`` reads the reference's cached checkpoints from ``CACHE_DIR``
(``.cache/pairs/zm-target.npz`` and ``zm-draft-mis.npz``, committed with
the repo) through ``training.checkpoint.load``.  A pair member missing
there is read from the port's own cache, ``TORCH_CACHE_DIR``
(``.cache/torch_pairs``, ignored by git), or trained on the device with
the reference's recipe (``_train``: the aligned draft ``zm-draft-ali``
for ``ALI_STEPS``) and saved there.  ``draft_heads_for`` and
``hrad_for_pair`` do the same for the trained parallel-draft heads
(``heads-<key>.npz``, the reference's key) and the trained H-RAD MLP
(``hrad-<kind>-K<k>.npz``): a file the reference wrote into its cache
loads first; otherwise the port trains its own into ``TORCH_CACHE_DIR``.
The port never writes into the reference's cache, and its own files
never stand in for the reference's: their weights start from the port's
generator, not the reference's draws.  ``measure_alpha`` is the
reference's greedy acceptance rate.

``hybrid_pair`` builds the reference's tiny random-init SSM-bearing
pairs and ``local_pair`` its gemma3-shaped sliding-window pair (same
configs, weights drawn by the port's own generator).  ``PAIR_C`` and
``default_ecfg`` are the port's copies of the reference's benchmark
presets (``benchmarks/common.py``) that the examples use.
"""
from __future__ import annotations

import hashlib
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.core import hrad as H
from repro_torch.data.synthetic import ZipfMarkov
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, dense_pattern
from repro_torch.runtime import hrad_data, prng
from repro_torch.runtime.engines import EngineConfig, SpSEngine
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optim import AdamWConfig
from repro_torch.training.train import (TrainConfig, train_draft_heads,
                                        train_lm)

CACHE_DIR = os.environ.get("REPRO_PAIR_CACHE", ".cache/pairs")
TORCH_CACHE_DIR = os.environ.get("REPRO_TORCH_PAIR_CACHE",
                                 ".cache/torch_pairs")

VOCAB = 199


def _cfg(name: str, layers: int, d: int, heads: int) -> ModelConfig:
    return ModelConfig(
        name=name, family="dense", num_layers=layers, d_model=d,
        num_heads=heads, num_kv_heads=max(1, heads // 2), d_ff=4 * d,
        vocab_size=VOCAB, pattern=dense_pattern(0), dtype="float32")


TARGET_CFG = _cfg("zm-target", 4, 128, 4)
# same 1-layer d32 draft arch; alignment is steered by training budget:
# 200 steps -> ~0.53 argmax agreement with the target (the paper's poorly
# aligned 68M-vs-13B regime); 400 steps -> ~0.91 (Deepseek/LLaMA-3.1
# regime)
DRAFT_MIS_CFG = _cfg("zm-draft-mis", 1, 32, 2)
DRAFT_ALI_CFG = _cfg("zm-draft-ali", 1, 32, 2)
TARGET_STEPS = 400
MIS_STEPS = 200
ALI_STEPS = 400


def _train(cfg: ModelConfig, steps: int, seed: int, device="cuda"):
    """The reference's recipe: ``steps`` AdamW steps (lr 1e-3, cosine over
    ``steps``) on Zipf-Markov batches of 16 x 64 (chain seed 7, batch
    seed ``seed``) from ``init_params(cfg, seed)``."""
    zm = ZipfMarkov(vocab=VOCAB, seed=7)
    data = zm.batch_iter(16, 64, seed=seed)
    tc = TrainConfig(steps=steps, batch=16, seq_len=64,
                     optim=AdamWConfig(lr=1e-3, total_steps=steps))
    return train_lm(cfg, data, tc, seed=seed, verbose=False, device=device)


def _cached(name: str, cache_dir: Optional[str]) -> Optional[str]:
    """The reference's file ``name`` if it exists, else the port's own,
    else None."""
    for d in (cache_dir or CACHE_DIR, TORCH_CACHE_DIR):
        path = os.path.join(d, name)
        if os.path.exists(path):
            return path
    return None


def _get(cfg: ModelConfig, steps: int, seed: int, device,
         cache_dir: Optional[str] = None) -> Any:
    """A pair member's params: the reference's cached file, the port's
    own, or trained now and saved into the port's cache."""
    path = _cached(f"{cfg.name}.npz", cache_dir)
    if path is not None:
        try:
            return ckpt.load(path, cfg, device)
        except (OSError, KeyError, ValueError):
            pass                      # a torn or stale file: train anew
    params, _ = _train(cfg, steps, seed, device)
    ckpt.save(os.path.join(TORCH_CACHE_DIR, f"{cfg.name}.npz"), params)
    return params


def get_pair(kind: str = "misaligned", device="cuda",
             cache_dir: str = CACHE_DIR
             ) -> Tuple[Any, ModelConfig, Any, ModelConfig]:
    """Returns (draft_params, draft_cfg, target_params, target_cfg), read
    from ``cache_dir`` (by default the reference's cache as the module
    was imported: the committed pairs), the port's cache or trained."""
    if kind == "misaligned":
        dcfg, steps = DRAFT_MIS_CFG, MIS_STEPS
    elif kind == "aligned":
        dcfg, steps = DRAFT_ALI_CFG, ALI_STEPS
    else:
        raise ValueError(kind)
    tgt = _get(TARGET_CFG, TARGET_STEPS, 0, device, cache_dir)
    return _get(dcfg, steps, 6, device, cache_dir), dcfg, tgt, TARGET_CFG


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
    draft model of ``get_pair(kind)``: the reference's ``heads-<key>.npz``
    when it exists, else the port's own, else trained now over the frozen
    draft (the reference's recipe: ``steps`` steps of 16 x 64 Zipf-Markov
    batches, lr 1e-3, data and init seed ``seed``) and saved into the
    port's cache."""
    if kind == "misaligned":
        dcfg = DRAFT_MIS_CFG
    elif kind == "aligned":
        dcfg = DRAFT_ALI_CFG
    else:
        raise ValueError(kind)
    name = f"heads-{_head_cache_key(dcfg, K, steps, seed)}.npz"
    path = _cached(name, cache_dir)
    if path is not None:
        with np.load(path) as data:
            heads = {k: data[k] for k in data.files}
        return ckpt.from_numpy_draft_heads(heads, dcfg, device)
    dp, dcfg, _, _ = get_pair(kind, device)
    zm = ZipfMarkov(vocab=VOCAB, seed=7)
    data = zm.batch_iter(16, 64, seed=seed)
    tc = TrainConfig(steps=steps, batch=16, seq_len=64,
                     optim=AdamWConfig(lr=1e-3, total_steps=steps))
    dhead, _ = train_draft_heads(dp, dcfg, data, K, tc, seed=seed,
                                 verbose=False, device=device)
    ckpt.save(os.path.join(TORCH_CACHE_DIR, name), dhead)
    return dhead


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
    """The trained H-RAD MLP of a committed pair as float32 tensors on
    ``device``: the reference's ``hrad-<kind>-K<k_layers>.npz`` when it
    exists, else the port's own, else trained now with the reference
    benchmarks' recipe (``benchmarks/common.py``: ``collect`` over 6
    prompts of 12 tokens x 48 new tokens under ``default_ecfg(kind)``,
    then ``train_mlp`` for 12 epochs at lr 1e-3) and saved into the
    port's cache."""
    name = f"hrad-{kind}-K{k_layers}.npz"
    path = _cached(name, cache_dir)
    if path is not None:
        with np.load(path) as data:
            params = {k: data[k] for k in data.files}
        return ckpt.from_numpy_hrad(params, device)
    dp, dcfg, tp, tcfg = get_pair(kind, device)
    zm = ZipfMarkov(vocab=VOCAB, seed=7)
    z, labels = hrad_data.collect(
        dp, dcfg, tp, tcfg, zm.prompts(6, 12, seed=5), 48,
        default_ecfg(kind, hrad_k_layers=k_layers))
    hcfg = H.HRADConfig(k_layers=k_layers, d_model=tcfg.d_model, epochs=12,
                        lr=1e-3)
    params, _ = H.train_mlp(z, labels, hcfg, device=device)
    ckpt.save(os.path.join(TORCH_CACHE_DIR, name), params)
    return params


def measure_alpha(draft_params, draft_cfg, target_params, target_cfg,
                  n_prompts: int = 4, plen: int = 16, n_new: int = 48,
                  gamma: int = 4, seed: int = 0,
                  draft_temperature: float = 1.0) -> float:
    """Empirical acceptance rate alpha = E[beta] under the greedy target:
    accepted over drafted tokens of sequential SpS (gamma, temperature 0)
    on ``n_prompts`` Zipf-Markov prompts of ``plen`` tokens.  Drafts are
    sampled at ``draft_temperature`` (the engine's default 1.0, as the
    reference measures); 0 drafts greedily, and alpha is then the
    draft's argmax agreement with the target, the figure the pairs'
    training budgets are set by."""
    zm = ZipfMarkov(vocab=VOCAB, seed=7)
    eng = SpSEngine(draft_params, draft_cfg, target_params, target_cfg,
                    EngineConfig(gamma=gamma, temperature=0.0,
                                 draft_temperature=draft_temperature,
                                 max_len=1024))
    acc, tot = 0, 0
    for i, p in enumerate(zm.prompts(n_prompts, plen, seed=seed)):
        r = eng.generate(p, n_new, prng.PRNGKey(i))
        acc += r.stats.draft_tokens - r.stats.rollback_tokens
        tot += r.stats.draft_tokens
    return acc / max(tot, 1)


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
