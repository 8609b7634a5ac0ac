"""Partition rules: FSDP("data") x TP("model") (+ "pod" = extra FSDP/DP)
(port of ``repro.sharding.rules``).

Strategy (DESIGN.md §5, MaxText-style):
  * weight matrices: contraction/input dim sharded over the FSDP axes
    ("pod","data" when divisible), output/head/hidden dim over "model";
  * experts: stacked expert dim over "pod" when divisible (expert-FSDP),
    per-expert hidden over "model";
  * activations: batch over ("pod","data"); long-context batch-1 decode
    shards the KV-cache *sequence* over "data" instead;
  * every rule degrades gracefully: an axis is only used if it divides the
    dimension, so reduced configs on a small mesh shard nothing.

Every function returns a tree of ``P`` specs matching the params / cache
tree; ``P`` is a tuple with one entry per dimension (None, an axis name,
or a tuple of axis names), compared entry for entry with the reference's
``PartitionSpec``.  The mesh is anything with a ``.shape`` dict of axis
sizes.  The port's trees carry a size-1 stack axis on the remainder
layers (``models.model``), so ``rem`` leaves are walked as stacked, like
``blocks`` leaves.

The rules are the single source of truth for the serving layout.  The
tensor-parallel forward (``models.layers``) needs two exceptions, both
applied in ``_tp_override`` and nowhere else:

  (a) KV heads that "model" does not divide: the rule shards their head
      dim, which attention cannot use (a split head needs an all-reduce of
      the scores).  Each rank instead holds the whole KV heads its query
      heads read: when the KV count divides the axis, one head each, that
      head replicated over ``tp / KV`` consecutive ranks (every rank when
      KV = 1), written ``Split("model", KV)``;
  (b) MoE experts: the rule puts "model" on D.  The port splits each
      expert's hidden F, as for the dense MLP, so the partial sums meet
      in one all-reduce.

``rank_block`` slices a rank's block of a full tensor from a spec and the
rank's mesh coordinates (the counterpart of ``named`` + ``device_put``);
``shard_shape`` gives the block's shape, so a cache is allocated at its
shard size directly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig


class P(tuple):
    """A partition spec: one entry per leading dimension (missing trailing
    entries are unsharded)."""

    def __new__(cls, *parts):
        return tuple.__new__(cls, parts)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


@dataclasses.dataclass(frozen=True)
class Split:
    """A dimension cut into ``blocks`` equal blocks over ``axis``, where
    ``blocks`` divides the axis size: the rank at index i along the axis
    takes block ``i * blocks // size``, so each block is replicated over
    ``size / blocks`` consecutive ranks (exception (a))."""
    axis: str
    blocks: int


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        return int(math.prod(_axis_size(mesh, n) for n in name))
    return mesh.shape[name] if name in mesh.shape else 1


def _fit(mesh, dim: int, *candidates):
    """First candidate axis (or axis tuple) that divides ``dim``; else None."""
    for cand in candidates:
        if cand is None:
            continue
        axes = tuple(a for a in (cand if isinstance(cand, tuple) else (cand,))
                     if a in mesh.shape)
        if not axes:
            continue
        if dim % _axis_size(mesh, axes) == 0:
            return axes if len(axes) > 1 else axes[0]
    return None


def fsdp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def batch_axes(mesh) -> Tuple[str, ...]:
    return fsdp_axes(mesh)


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

def _leaf_spec(mesh, path: Tuple[str, ...], shape: Tuple[int, ...],
               tp_only: bool = False) -> P:
    """Spec for one parameter leaf, given its key path and shape (without
    the stack axis).  tp_only=True drops the FSDP axes: params replicated
    over "data", sharded over "model" only."""
    name = path[-1]
    fa = () if tp_only else fsdp_axes(mesh)

    def d0(dim):
        return _fit(mesh, dim, fa, None if tp_only else "data")

    def dm(dim):
        return _fit(mesh, dim, "model")

    if name in ("ln", "final_norm", "conv_b", "dt_b", "Dskip", "q_norm",
                "k_norm"):
        if name in ("conv_b", "dt_b", "Dskip") and len(shape) == 1:
            return P(dm(shape[0]))
        return P(*([None] * len(shape)))
    if name == "embed":                      # (V, D)
        return P(dm(shape[0]), d0(shape[1]))
    if name == "lm_head":                    # (D, V)
        return P(d0(shape[0]), dm(shape[1]))
    if name in ("wq", "wk", "wv"):           # (D, H*hd)
        return P(d0(shape[0]), dm(shape[1]))
    if name == "wo":                         # (H*hd, D)
        return P(dm(shape[0]), d0(shape[1]))
    if name in ("wg", "wu", "wd") and len(shape) == 3:
        # MoE (E, D, F) / (E, F, D): experts over "pod" when divisible,
        # "model" along D, the remaining dim "data" only
        e_ax = _fit(mesh, shape[0], "pod")
        d_dims = (dm(shape[1]), _fit(mesh, shape[2], "data")) \
            if name in ("wg", "wu") else \
            (_fit(mesh, shape[1], "data"), dm(shape[2]))
        return P(e_ax, *d_dims)
    if name in ("wg", "wu"):
        return P(d0(shape[0]), dm(shape[1]))
    if name == "wd":
        return P(dm(shape[0]), d0(shape[1]))
    if name == "router":                     # (D, E) — small, replicate
        return P(None, None)
    if name == "in_proj":                    # (D, 2E)
        return P(d0(shape[0]), dm(shape[1]))
    if name == "conv_w":                     # (Cv, E)
        return P(None, dm(shape[1]))
    if name == "x_db":                       # (E, R+2N)
        return P(dm(shape[0]), None)
    if name == "dt_w":                       # (R, E)
        return P(None, dm(shape[1]))
    if name == "A_log":                      # (E, N)
        return P(dm(shape[0]), None)
    if name == "out_proj":                   # (E, D)
        return P(dm(shape[0]), d0(shape[1]))
    return P(*([None] * len(shape)))


def _walk(node, path, leaf):
    if isinstance(node, dict):
        return {k: _walk(v, path + (k,), leaf) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_walk(v, path + (str(i),), leaf)
                          for i, v in enumerate(node))
    return leaf(path, tuple(node.shape))


def _stacked(path) -> bool:
    return bool(path) and path[0] in ("blocks", "rem")


def params_specs(mesh, cfg: ModelConfig, params_shape: Any,
                 tp_only: bool = False) -> Any:
    """Spec tree for a params tree (of tensors, meta tensors or anything
    with ``.shape``); ``blocks`` and ``rem`` leaves carry a leading stack
    axis, left unsharded."""

    def leaf(path, shape):
        if _stacked(path):
            return P(None, *_leaf_spec(mesh, path, shape[1:],
                                       tp_only=tp_only))
        return _leaf_spec(mesh, path, shape, tp_only=tp_only)

    return _walk(params_shape, (), leaf)


# ---------------------------------------------------------------------------
# cache rules
# ---------------------------------------------------------------------------

def cache_specs(mesh, cfg: ModelConfig, cache_shape: Any, *,
                shard_seq: bool = False, seq_axis: str = "data",
                batch_axis: str = "") -> Any:
    """Decode-cache specs.  Cache leaves are (stack, B, ...).

    shard_seq=True with seq_axis="data" (batch-1 long context): shard the
    KV sequence over "data" instead of the batch.  seq_axis="model":
    sequence-parallel attention over the model axis, heads local."""
    ba = batch_axes(mesh)

    def leaf(path, shape):
        name = path[-1]
        if batch_axis:
            b = _fit(mesh, shape[1], batch_axis)
        else:
            b = (_fit(mesh, shape[1], ba, "data")
                 if (not shard_seq or seq_axis == "model") else None)
        if name in ("k", "v"):               # (stack, B, S, KV, hd)
            s = _fit(mesh, shape[2], seq_axis) if shard_seq else None
            if batch_axis or (shard_seq and seq_axis == "model"):
                kv = hd = None                # heads stay local
            else:
                kv = _fit(mesh, shape[3], "model")
                hd = None if kv else _fit(mesh, shape[4], "model")
            return P(None, b, s, kv, hd)
        if name == "pos":                    # (stack, B, S)
            s = _fit(mesh, shape[2], seq_axis) if shard_seq else None
            return P(None, b, s)
        if name == "conv":                   # (stack, B, Cv-1, E)
            return P(None, b, None, _fit(mesh, shape[3], "model"))
        if name == "ssm":                    # (stack, B, E, N)
            return P(None, b, _fit(mesh, shape[2], "model"), None)
        return P(*([None] * len(shape)))

    return _walk(cache_shape, (), leaf)


def tokens_spec(mesh, batch: int) -> P:
    return P(_fit(mesh, batch, batch_axes(mesh), "data"), None)


# ---------------------------------------------------------------------------
# serving cache rules (decode_state component layouts)
# ---------------------------------------------------------------------------

def serving_cache_specs(mesh, cfg: ModelConfig, cache_shape: Any, *,
                        batch_axis: str = "") -> Any:
    """Specs for a serving ``DecodeState`` cache tree (DESIGN.md §7.10).

      * dense attention rows ``k``/``v`` (stack, n_rows, S, KV, hd) and
        ``pos`` (stack, n_rows, S): rows over ``batch_axis`` (the dense
        backend's data parallelism), KV heads over "model" (head_dim when
        the KV count doesn't divide);
      * paged ``k_pages``/``v_pages`` (stack, num_pages + 1, page_size,
        KV, hd): the page axis stays UNSHARDED — every rank holds the
        head-shard of every logical page, so a page id names a family of
        per-rank shards and the host page tables replicate verbatim;
      * SSM checkpoint rings ``h_ring`` (stack, n_rows, ring, E, N) /
        ``conv_ring`` (stack, n_rows, ring, Cv-1, E): rows over
        ``batch_axis``, E over "model".

    Every rule degrades through ``_fit``: a 1x1 mesh shards nothing."""

    def heads_spec(shape):
        kv = _fit(mesh, shape[3], "model")
        hd = None if kv else _fit(mesh, shape[4], "model")
        return kv, hd

    def leaf(path, shape):
        name = path[-1]
        b = _fit(mesh, shape[1], batch_axis) if batch_axis else None
        if name in ("k", "v"):               # (stack, B, S, KV, hd)
            kv, hd = heads_spec(shape)
            return P(None, b, None, kv, hd)
        if name == "pos":                    # (stack, B, S)
            return P(None, b, None)
        if name in ("k_pages", "v_pages"):   # (stack, P+1, ps, KV, hd)
            kv, hd = heads_spec(shape)
            return P(None, None, None, kv, hd)
        if name == "h_ring":                 # (stack, B, ring, E, N)
            return P(None, b, None, _fit(mesh, shape[3], "model"), None)
        if name == "conv_ring":              # (stack, B, ring, Cv-1, E)
            return P(None, b, None, None, _fit(mesh, shape[4], "model"))
        return P(*([None] * len(shape)))

    return _walk(cache_shape, (), leaf)


# ---------------------------------------------------------------------------
# the tensor-parallel serving layout: the rules plus exceptions (a) and (b)
# ---------------------------------------------------------------------------

def kv_split(mesh, cfg: ModelConfig):
    """How the TP forward lays out ``cfg``'s KV heads over "model": the
    axis name when it divides them, ``Split("model", KV)`` when KV divides
    the axis (exception (a)), None on a mesh with no "model" split.
    Raises ValueError when neither divides the other: a rank's query
    heads would then read a ragged set of KV heads."""
    tp, kv = _axis_size(mesh, "model"), cfg.num_kv_heads
    if tp == 1:
        return None
    if kv % tp == 0:
        return "model"
    if tp % kv == 0:
        return Split("model", kv)
    raise ValueError(
        f"tp={tp} and {cfg.name!r}'s {kv} KV heads: one must divide the "
        f"other for whole-head attention shards")


def _tp_override(mesh, cfg: ModelConfig, name: str, shape, spec: P) -> P:
    """Exceptions (a) and (b) to the rules, for the port's tensor-parallel
    forward: ``spec`` is the rule's spec of leaf ``name`` of ``shape``
    (both without a params stack axis).  Every other leaf keeps the
    rule's spec."""
    # (a) KV heads "model" does not divide: whole heads per rank (the rule
    # splits their head dim, which attention cannot use)
    if name in ("wk", "wv", "k", "v", "k_pages", "v_pages") \
            and cfg.num_kv_heads % _axis_size(mesh, "model"):
        kv = kv_split(mesh, cfg)
        if name in ("wk", "wv"):             # (D, KV*hd)
            return P(spec[0], kv)
        return P(*spec[:-2], kv, None)       # (..., KV, hd)
    # (b) MoE experts split on their hidden F, like the dense MLP (the
    # rule puts "model" on D and "data" on F)
    if name in ("wg", "wu", "wd") and len(shape) == 3:
        f = 2 if name in ("wg", "wu") else 1
        out = [None, None, None]
        out[f] = _fit(mesh, shape[f], "model")
        return P(*out)
    return spec


def tp_params_specs(mesh, cfg: ModelConfig, params_shape: Any) -> Any:
    """The serving layout of a params tree: ``params_specs(tp_only=True)``
    (replicated over "data"; heads, MLP hidden, E and vocab over
    "model") with exceptions (a) and (b) applied."""

    def leaf(path, shape):
        lead = 1 if _stacked(path) else 0
        spec = _leaf_spec(mesh, path, shape[lead:], tp_only=True)
        spec = _tp_override(mesh, cfg, path[-1], shape[lead:], spec)
        return P(*([None] * lead), *spec)

    return _walk(params_shape, (), leaf)


def tp_cache_specs(mesh, cfg: ModelConfig, cache_shape: Any, *,
                   batch_axis: str = "") -> Any:
    """The serving layout of a ``DecodeState`` cache tree:
    ``serving_cache_specs`` with exception (a) applied."""
    specs = serving_cache_specs(mesh, cfg, cache_shape,
                                batch_axis=batch_axis)

    def leaf(path, shape):
        spec = _get(specs, path)
        return _tp_override(mesh, cfg, path[-1], shape, spec)

    return _walk(cache_shape, (), leaf)


def _get(tree, path):
    for k in path:
        tree = tree[k] if isinstance(tree, dict) else tree[int(k)]
    return tree


# ---------------------------------------------------------------------------
# a rank's block
# ---------------------------------------------------------------------------

def _entry_block(mesh, coords: Dict[str, int], entry, dim: int
                 ) -> Tuple[int, int]:
    """(block index, block count) of one spec entry at ``coords``."""
    if entry is None:
        return 0, 1
    if isinstance(entry, Split):
        n = _axis_size(mesh, entry.axis)
        if n % entry.blocks:
            raise ValueError(f"{entry} does not divide axis size {n}")
        return coords.get(entry.axis, 0) * entry.blocks // n, entry.blocks
    axes = entry if isinstance(entry, tuple) else (entry,)
    idx = 0
    for a in axes:                     # row-major over the listed axes
        idx = idx * _axis_size(mesh, a) + coords.get(a, 0)
    return idx, _axis_size(mesh, axes)


def shard_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a ``shape`` tensor under ``spec``."""
    out = list(shape)
    for i, entry in enumerate(spec):
        _, n = _entry_block(mesh, {}, entry, shape[i])
        if shape[i] % n:
            raise ValueError(f"{spec} does not divide {tuple(shape)}")
        out[i] = shape[i] // n
    return tuple(out)


def rank_block(full: torch.Tensor, spec: P, mesh,
               coords: Dict[str, int]) -> torch.Tensor:
    """The block of ``full`` that the rank at ``coords`` (axis name ->
    index) holds under ``spec``, contiguous; ``full`` itself when the spec
    splits nothing."""
    out = full
    for i, entry in enumerate(spec):
        idx, n = _entry_block(mesh, coords, entry, full.shape[i])
        if n == 1:
            continue
        if full.shape[i] % n:
            raise ValueError(f"{spec} does not divide {tuple(full.shape)}")
        size = full.shape[i] // n
        out = out.narrow(i, idx * size, size)
    return out if out is full else out.contiguous()


def tp_shard_params(params: Any, cfg: ModelConfig, mesh,
                    coords: Dict[str, int], device) -> Any:
    """The rank's blocks of a full params tree under ``tp_params_specs``,
    on ``device``.  ``in_proj``'s columns are ``[x | z]`` (the forward
    splits them at E): its "model" split applies to each half, so every
    rank holds its E/tp columns of x and of z."""
    specs = tp_params_specs(mesh, cfg, params)

    def leaf_fn(path, t, spec):
        if path[-1] == "in_proj" and spec[-1] is not None:
            # (..., D, 2E) -> (..., D, 2, E): split E within each half
            half = t.reshape(*t.shape[:-1], 2, t.shape[-1] // 2)
            blk = rank_block(half, P(*spec[:-1], None, spec[-1]), mesh,
                             coords)
            return blk.reshape(*blk.shape[:-2], -1).to(device)
        return rank_block(t, spec, mesh, coords).to(device)

    return _walk(params, (), lambda path, _shape: leaf_fn(
        path, _get(params, path), _get(specs, path)))
