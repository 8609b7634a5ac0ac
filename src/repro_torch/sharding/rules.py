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

The rules are the single source of truth for both layouts of the port.
The serving layout (``tp_params_specs``, ``tp_cache_specs``: TP over
"model", replicated over "data") and the production programs' layout
(``fsdp_params_specs``: FSDP over the FSDP axes, TP over "model"; the
training mesh and ``launch.steps``' steps) differ from the rules only by
four exceptions, applied in ``_tp_override`` and nowhere else:

  (a) KV heads that "model" does not divide: the rule shards their head
      dim, which attention cannot use (a split head needs an all-reduce of
      the scores).  Each rank instead holds the whole KV heads its block
      of query heads reads: the rank at index t along "model" (size tp)
      holds query heads [q0, q0 + H/tp), q0 = t * H/tp, and KV heads
      [q0 // G, (q0 + H/tp - 1) // G], G = H / KV, written
      ``HeadRange("model", H, KV)``.  Those blocks overlap, and their
      sizes can differ from rank to rank: one KV head per rank when tp is
      a multiple of KV (replicated over tp / KV ranks), one or two at
      grok-1-314b's tp = 12, three or four at granite-moe-3b-a800m's tp
      = 3.  Where a rank's query block starts inside a group (q0 % G !=
      0) and it holds more than one KV head, attention pads its queries
      with zero heads to whole groups of G, so the kernels keep their
      mapping (query head h reads KV head h // G) and the pad heads'
      outputs are dropped (``layers.attention``).  The cost: a rank holds
      up to two KV heads more than H / (tp G) (its K/V weights and cache),
      and a padded rank attends n_kv G query rows for its H / tp (at
      grok-1-314b's tp = 12: 12 rows for 4 on the ranks that straddle a
      group; at granite-moe-3b-a800m's tp = 3: 9 or 12 for 8);
  (b) MoE experts: the rule puts "model" on D.  The port splits each
      expert's hidden F, as for the dense MLP, so the partial sums meet
      in one all-reduce;
  (c) MoE experts under FSDP: the rule puts "data" on F, which (b) gave
      to "model".  "data" (with "pod", the FSDP axes) moves to D, when it
      divides D; the expert dim stays whole;
  (d) "model" wider than the query heads divide (gemma3-4b's 8 and
      granite-moe-3b-a800m's 24 heads at the production meshes' 16; the
      serving mesh refuses such a tp, as the reference does): the rule
      splits wq's columns inside heads.  The query heads instead split
      into gcd(H, tp) blocks, each whole on tp / gcd(H, tp) consecutive
      ranks (``HeadRange("model", H, H)`` on wq, (a) on the KV heads),
      which all attend over the block; wo keeps the rule's rows, an hd
      slice of the block's heads, so each rank multiplies its slice and
      the one all-reduce after wo sums each product once.  The cost: the
      block's attention runs tp / gcd(H, tp) times over.

``rank_block`` slices a rank's block of a full tensor from a spec and the
rank's mesh coordinates (the counterpart of ``named`` + ``device_put``);
``shard_shape`` gives the block's shape (it needs the coordinates where a
``HeadRange`` makes the blocks differ), so a cache is allocated at its
shard size directly; ``block_weights`` says how many ranks hold each
element of a block (the training step's global norm counts each once).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

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
class HeadRange:
    """A dimension of ``kv_heads`` equal units (a KV head, or a head's hd
    columns) of which the rank at index t along ``axis`` holds the heads
    its query heads read (exceptions (a) and (d)): blocks that overlap and
    whose sizes can differ.  With n the axis size and H = ``q_heads``,
    the query heads split into g = gcd(H, n) blocks, each held by n / g
    consecutive ranks (all of them when n divides H): rank t holds query
    block t // (n / g).  ``HeadRange(axis, H, H)`` is a rank's query
    heads themselves."""
    axis: str
    q_heads: int
    kv_heads: int

    def heads(self, index: int, size: int) -> Tuple[int, int]:
        """[lo, hi) of the heads of the rank at ``index``."""
        if self.q_heads % self.kv_heads:
            raise ValueError(f"{self}: the KV heads must divide the "
                             f"{self.q_heads} query heads")
        blocks = math.gcd(self.q_heads, size)
        g, hl = self.q_heads // self.kv_heads, self.q_heads // blocks
        q0 = (index // (size // blocks)) * hl
        return q0 // g, (q0 + hl - 1) // g + 1


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
# the port's layouts: the rules plus exceptions (a), (b) and (c)
# ---------------------------------------------------------------------------

def kv_split(mesh, cfg: ModelConfig):
    """How the TP forward lays out ``cfg``'s KV heads over "model": the
    axis name when it divides them, else ``HeadRange`` (exceptions (a)
    and (d)), None on a mesh with no "model" split.  Raises ValueError
    when the KV heads do not divide the query heads."""
    tp, kv, h = _axis_size(mesh, "model"), cfg.num_kv_heads, cfg.num_heads
    if tp == 1:
        return None
    if h % kv:
        raise ValueError(f"{cfg.name!r}'s {kv} KV heads do not divide its "
                         f"{h} query heads")
    if kv % tp == 0:
        return "model"
    return HeadRange("model", h, kv)


def _tp_override(mesh, cfg: ModelConfig, name: str, shape, spec: P,
                 fsdp: bool = False) -> P:
    """Exceptions (a), (b), (d) and, with ``fsdp``, (c) to the rules, for the
    port's tensor-parallel forward: ``spec`` is the rule's spec of leaf
    ``name`` of ``shape`` (both without a params stack axis).  Every other
    leaf keeps the rule's spec."""
    # (d) more ranks than query heads along "model": whole query heads
    # per rank, each block replicated over tp / gcd(H, tp) ranks
    if name == "wq" and cfg.num_heads % _axis_size(mesh, "model"):
        return P(spec[0], HeadRange("model", cfg.num_heads, cfg.num_heads))
    # (a) KV heads "model" does not divide: whole heads per rank (the rule
    # splits their head dim, which attention cannot use)
    if name in ("wk", "wv", "k", "v", "k_pages", "v_pages") \
            and cfg.num_kv_heads % _axis_size(mesh, "model"):
        kv = kv_split(mesh, cfg)
        if name in ("wk", "wv"):             # (D, KV*hd)
            return P(spec[0], kv)
        return P(*spec[:-2], kv, None)       # (..., KV, hd)
    # (b) MoE experts split on their hidden F, like the dense MLP (the
    # rule puts "model" on D and "data" on F); (c) under FSDP "data"
    # moves to D
    if name in ("wg", "wu", "wd") and len(shape) == 3:
        f = 2 if name in ("wg", "wu") else 1
        out = [None, None, None]
        out[f] = _fit(mesh, shape[f], "model")
        if fsdp:
            out[3 - f] = _fit(mesh, shape[3 - f], fsdp_axes(mesh), "data")
        return P(*out)
    return spec


def _layout(mesh, cfg: ModelConfig, params_shape: Any, fsdp: bool) -> Any:
    def leaf(path, shape):
        lead = 1 if _stacked(path) else 0
        spec = _leaf_spec(mesh, path, shape[lead:], tp_only=not fsdp)
        spec = _tp_override(mesh, cfg, path[-1], shape[lead:], spec,
                            fsdp=fsdp)
        return P(*([None] * lead), *spec)

    return _walk(params_shape, (), leaf)


def tp_params_specs(mesh, cfg: ModelConfig, params_shape: Any) -> Any:
    """The serving layout of a params tree: ``params_specs(tp_only=True)``
    (replicated over "data"; heads, MLP hidden, E and vocab over
    "model") with exceptions (a), (b) and (d) applied."""
    return _layout(mesh, cfg, params_shape, fsdp=False)


def fsdp_params_specs(mesh, cfg: ModelConfig, params_shape: Any) -> Any:
    """The layout of the production programs and the training mesh:
    ``params_specs`` (FSDP over the FSDP axes, TP over "model") with
    exceptions (a)-(d) applied.  Where the rule puts no FSDP
    axis on a leaf (norms, the router, Mamba's small leaves, a dim the
    axis does not divide), the leaf is replicated over "data"."""
    return _layout(mesh, cfg, params_shape, fsdp=True)


def tp_cache_specs(mesh, cfg: ModelConfig, cache_shape: Any, *,
                   batch_axis: str = "") -> Any:
    """The serving layout of a ``DecodeState`` cache tree:
    ``serving_cache_specs`` with exception (a) applied."""
    return override_cache_specs(
        mesh, cfg, cache_shape,
        serving_cache_specs(mesh, cfg, cache_shape, batch_axis=batch_axis))


def override_cache_specs(mesh, cfg: ModelConfig, cache_shape: Any,
                         specs: Any) -> Any:
    """A cache spec tree (``cache_specs`` or ``serving_cache_specs``)
    with exception (a) applied."""
    def leaf(path, shape):
        return _tp_override(mesh, cfg, path[-1], shape, _get(specs, path))

    return _walk(cache_shape, (), leaf)


def _get(tree, path):
    for k in path:
        tree = tree[k] if isinstance(tree, dict) else tree[int(k)]
    return tree


# ---------------------------------------------------------------------------
# a rank's block
# ---------------------------------------------------------------------------

def _entry_span(mesh, coords, entry, dim: int) -> Tuple[int, int]:
    """[start, stop) of the block of one spec entry along a dimension of
    size ``dim`` at ``coords`` (axis name -> index; None: the shape only,
    which a ``HeadRange`` entry refuses)."""
    if entry is None:
        return 0, dim
    if isinstance(entry, HeadRange):
        if coords is None:
            raise ValueError(f"{entry}: blocks differ by rank; pass the "
                             "rank's coordinates")
        if dim % entry.kv_heads:
            raise ValueError(f"{entry} does not divide {dim}")
        unit = dim // entry.kv_heads
        lo, hi = entry.heads(coords.get(entry.axis, 0),
                             _axis_size(mesh, entry.axis))
        return lo * unit, hi * unit
    axes = entry if isinstance(entry, tuple) else (entry,)
    n = _axis_size(mesh, axes)
    if dim % n:
        raise ValueError(f"{entry} (size {n}) does not divide {dim}")
    idx = 0
    for a in axes:                     # row-major over the listed axes
        idx = idx * _axis_size(mesh, a) + (coords or {}).get(a, 0)
    return idx * (dim // n), (idx + 1) * (dim // n)


def shard_shape(shape, spec: P, mesh, coords: Optional[Dict[str, int]]
                = None) -> Tuple[int, ...]:
    """The shape of one rank's block of a ``shape`` tensor under ``spec``;
    ``coords`` (the rank's) are needed where a ``HeadRange`` entry makes
    the blocks differ by rank."""
    out = list(shape)
    for i, entry in enumerate(spec):
        a, b = _entry_span(mesh, coords, entry, shape[i])
        out[i] = b - a
    return tuple(out)


def rank_block(full: torch.Tensor, spec: P, mesh,
               coords: Dict[str, int]) -> torch.Tensor:
    """The block of ``full`` that the rank at ``coords`` (axis name ->
    index) holds under ``spec``, contiguous; ``full`` itself when the spec
    splits nothing."""
    out = full
    for i, entry in enumerate(spec):
        a, b = _entry_span(mesh, coords, entry, full.shape[i])
        if b - a != full.shape[i]:
            out = out.narrow(i, a, b - a)
    return out if out is full else out.contiguous()


def holders(spec: P, shape, mesh, coords: Dict[str, int]):
    """How many ranks of the mesh hold each element of the block of the
    rank at ``coords``: an int, or for a ``HeadRange`` block a float32
    tensor that broadcasts along its dimension (each KV head counted by
    the ranks whose range reaches it)."""
    named = set()
    count, rng = 1, None
    for i, entry in enumerate(spec):
        if isinstance(entry, HeadRange):
            n = _axis_size(mesh, entry.axis)
            spans = [entry.heads(t, n) for t in range(n)]
            lo, hi = entry.heads(coords.get(entry.axis, 0), n)
            per = torch.tensor([sum(a <= j < b for a, b in spans)
                                for j in range(lo, hi)],
                               dtype=torch.float32)
            unit = shape[i] // entry.kv_heads
            per = per.repeat_interleave(unit)
            rng = per.reshape((-1,) + (1,) * (len(shape) - i - 1))
            named.add(entry.axis)
        elif entry is not None:
            named.update(entry if isinstance(entry, tuple) else (entry,))
    for a, n in mesh.shape.items():
        if a not in named:
            count *= n
    return count if rng is None else rng * count


def shard_tree(params: Any, specs: Any, mesh, coords: Dict[str, int],
               device) -> Any:
    """The rank's blocks of a full params tree under ``specs``, on
    ``device``.  ``in_proj``'s columns are ``[x | z]`` (the forward splits
    them at E): its "model" split applies to each half, so every rank
    holds its E/tp columns of x and of z."""

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


def tp_shard_params(params: Any, cfg: ModelConfig, mesh,
                    coords: Dict[str, int], device) -> Any:
    """The rank's blocks of a full params tree under ``tp_params_specs``,
    on ``device`` (see ``shard_tree``)."""
    return shard_tree(params, tp_params_specs(mesh, cfg, params), mesh,
                      coords, device)
