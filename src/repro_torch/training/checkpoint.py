"""Checkpoint loading (port of the load side of
``repro.training.checkpoint``).

The reference saves a params tree as a flat npz whose keys are paths
("blocks.0.mixer.wq"; list indices and dict keys joined by dots), with
the periodic blocks stacked on a leading ``n_periods`` axis.  ``load``
rebuilds that tree as torch tensors; ``from_numpy_params`` carries any
tree of numpy arrays (for instance the reference's params after
``np.asarray``) into the port, so both frameworks can run on identical
weights; ``from_numpy_cache`` does the same for a decode cache (dense
attention rings, Mamba carries and checkpoint rings), so
both frameworks can also start from one mid-stream state;
``from_numpy_hrad`` carries an H-RAD MLP (``core.hrad``) the same way,
and ``from_numpy_draft_heads`` a set of parallel-draft heads
(``models.model.init_draft_heads``).  Saving is a later slice
(training).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import param_dtype


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[Any, Any] = {}
    for key, arr in flat.items():
        node = root
        parts = [int(s) if s.isdigit() else s for s in key.split(".")]
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [fix(node[i]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}
    return fix(root)


def _to_tensor(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)     # numpy has no native bfloat16
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def from_numpy_params(tree: Any, cfg: ModelConfig, device) -> Any:
    """The same tree with every array a tensor on ``device`` in the dtype
    the reference's init gives its leaf (``model.param_dtype``: float32
    for Mamba's ``A_log`` / ``Dskip`` and the MoE ``router``, ``cfg``'s
    dtype otherwise); ``blocks`` keeps an empty ``rem`` list when
    absent."""
    def conv(node, name=""):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _to_tensor(node, param_dtype(name, cfg), device)
    out = conv(tree)
    out.setdefault("rem", [])
    emb = out["embed"]
    if tuple(emb.shape) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"{cfg.name}: embed {tuple(emb.shape)} does not "
                         f"match ({cfg.vocab_size}, {cfg.d_model})")
    return out


def from_numpy_hrad(params: Dict[str, Any], device
                    ) -> Dict[str, torch.Tensor]:
    """An H-RAD MLP's parameters (``w0``, ``b0``, ... as numpy arrays, for
    instance the reference's ``init_mlp`` after ``np.asarray``) as float32
    tensors on ``device``, whatever the model's dtype."""
    return {k: _to_tensor(v, torch.float32, device)
            for k, v in params.items()}


def from_numpy_draft_heads(heads: Dict[str, Any], cfg: ModelConfig,
                           device) -> Dict[str, torch.Tensor]:
    """Parallel-draft heads (``mask_embed`` (K, d_model) and ``heads``
    (K, d_model, vocab) as numpy arrays, for instance the reference's
    ``init_draft_heads`` or a cached ``heads-<key>.npz``) as tensors on
    ``device`` in the draft model's dtype."""
    out = {k: _to_tensor(heads[k], cfg.tdtype, device)
           for k in ("mask_embed", "heads")}
    K = out["heads"].shape[0]
    if (tuple(out["mask_embed"].shape) != (K, cfg.d_model)
            or tuple(out["heads"].shape) != (K, cfg.d_model,
                                             cfg.vocab_size)):
        raise ValueError(
            f"{cfg.name}: draft heads {tuple(out['mask_embed'].shape)} / "
            f"{tuple(out['heads'].shape)} do not match d_model "
            f"{cfg.d_model}, vocab {cfg.vocab_size}")
    return out


_CACHE_DTYPES = {"pos": torch.int32, "ssm": torch.float32,
                 "h_ring": torch.float32}


def from_numpy_cache(tree: Any, cfg: ModelConfig, device) -> Any:
    """A decode cache tree of numpy arrays (the reference's ``init_cache``
    layout after ``np.asarray``) as the port's cache on ``device``: K/V
    and Mamba conv tails in ``cfg``'s dtype, positions int32, SSM carries
    and checkpoint rings float32."""
    def conv(node):
        if isinstance(node, dict):
            return {k: _to_tensor(v, _CACHE_DTYPES.get(k, cfg.tdtype),
                                  device)
                    for k, v in node.items()}
        return [conv(v) for v in node]
    return {"blocks": conv(tree["blocks"]), "rem": conv(tree["rem"])}


def load(path: str, cfg: ModelConfig, device) -> Any:
    """Read a flat-npz checkpoint into the port's params tree."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return from_numpy_params(_unflatten(flat), cfg, device)
