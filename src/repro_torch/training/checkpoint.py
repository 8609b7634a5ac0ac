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
(``models.model.init_draft_heads``).

``save`` writes a tree in the reference's layout (``_flatten``'s path
keys; a model's remainder layers without the port's size-1 stack axis),
bfloat16 leaves as float32 (numpy has no bfloat16; the reference's
``load`` casts to its template's dtype), to a temporary file that is then
renamed, so a concurrent reader never sees a torn file.  The reference's
``load`` reads what ``save`` writes, and ``load`` here reads the
reference's files.
"""
from __future__ import annotations

import os
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
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        # bfloat16 bits as an npz holds them without ml_dtypes: the top
        # half of a float32
        a = (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    elif a.dtype.name == "bfloat16":
        a = a.astype(np.float32)     # numpy has no native bfloat16
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def from_numpy_params(tree: Any, cfg: ModelConfig, device) -> Any:
    """The same tree with every array a tensor on ``device`` in the dtype
    the reference's init gives its leaf (``model.param_dtype``: float32
    for Mamba's ``A_log`` / ``Dskip`` and the MoE ``router``, ``cfg``'s
    dtype otherwise); ``blocks`` keeps an empty ``rem`` list when
    absent.  The reference's remainder layers carry no stack axis; the
    port's carry one of size 1, as their caches do in both packages."""
    def conv(node, name="", lead=False):
        if isinstance(node, dict):
            return {k: conv(v, k, lead) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v, lead=lead) for v in node]
        t = _to_tensor(node, param_dtype(name, cfg), device)
        return t[None] if lead else t
    out = {k: conv(v, k, lead=k == "rem") for k, v in tree.items()}
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


def _to_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Path-keyed numpy arrays of a tree ("blocks.0.mixer.wq": dict keys
    and list indices joined by dots), as the reference flattens."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    elif tree is None:
        pass
    else:
        out[prefix[:-1]] = _to_numpy(tree)
    return out


def _reference_layout(tree: Any) -> Any:
    """A model's params tree with its remainder layers' size-1 stack axis
    dropped (the reference's ``rem`` leaves carry none); other trees as
    they are."""
    if not (isinstance(tree, dict) and "embed" in tree
            and isinstance(tree.get("rem"), list)):
        return tree

    def unstack(node):
        if isinstance(node, dict):
            return {k: unstack(v) for k, v in node.items()}
        return node[0]
    return {**tree, "rem": [unstack(r) for r in tree["rem"]]}


def save(path: str, params: Any) -> None:
    """Write ``params`` (a model's params, draft heads, an H-RAD MLP or
    any tree of tensors / arrays) as a flat npz at ``path`` (".npz"
    appended when missing), through a temporary file and a rename."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    flat = _flatten(_reference_layout(params))
    if not path.endswith(".npz"):
        path += ".npz"        # np.savez appends it; keep tmp/final in sync
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    try:
        np.savez(tmp, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
