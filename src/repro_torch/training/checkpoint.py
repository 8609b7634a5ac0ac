"""Checkpoint loading (port of the load side of
``repro.training.checkpoint``).

The reference saves a params tree as a flat npz whose keys are paths
("blocks.0.mixer.wq"; list indices and dict keys joined by dots), with
the periodic blocks stacked on a leading ``n_periods`` axis.  ``load``
rebuilds that tree as torch tensors; ``from_numpy_params`` carries any
tree of numpy arrays (for instance the reference's params after
``np.asarray``) into the port, so both frameworks can run on identical
weights.  Saving is a later slice (training).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


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
    """The same tree with every array a tensor in ``cfg``'s dtype on
    ``device``; ``blocks`` keeps an empty ``rem`` list when absent."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _to_tensor(node, cfg.tdtype, device)
    out = conv(tree)
    out.setdefault("rem", [])
    emb = out["embed"]
    if tuple(emb.shape) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"{cfg.name}: embed {tuple(emb.shape)} does not "
                         f"match ({cfg.vocab_size}, {cfg.d_model})")
    return out


def load(path: str, cfg: ModelConfig, device) -> Any:
    """Read a flat-npz checkpoint into the port's params tree."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return from_numpy_params(_unflatten(flat), cfg, device)
