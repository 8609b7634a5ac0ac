"""AdamW with decoupled weight decay, global-norm clipping and cosine
decay (port of ``repro.training.optim``), over the port's parameter
trees (nested dicts and lists of tensors).

The arithmetic is the reference's: the global norm of the raw gradients
in float32, clipped to ``clip_norm``; m and v moving averages; bias
correction with the step count; the update ``p - lr * (mhat / (sqrt(vhat)
+ eps) + weight_decay * p)`` in float32, cast back to the parameter's
dtype.  m and v keep the parameter dtype (the reference's ``zeros_like``).
Not ``torch.optim``, whose update order differs.

``apply`` updates the parameters and the m / v states IN PLACE and
returns them (the reference returns new trees): at gemma3-4b's full width
a second copy of parameters, m and v would cost another 23 GB of device
memory.  The update runs in float32 temporaries of one slice of one leaf
at a time (a stacked leaf is cut along its layer axis into slices of at
most ``CHUNK`` elements; the update is elementwise, so slicing changes
nothing): a whole stacked leaf in float32, such as falcon-mamba-7b's
``in_proj`` (1.07G elements at 16 layers), would take 4.3 GB a
temporary.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 20
    total_steps: int = 1000
    min_lr_ratio: float = 0.1


CHUNK = 1 << 26          # elements of one float32 update slice (256 MB)


class OptState(NamedTuple):
    m: Any
    v: Any
    step: int


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree in ``jax.tree.leaves`` order (dict keys
    sorted, lists in order; None is no leaf)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of trees of its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def tree_unflatten(tree: Any, leaves: List[Any]) -> Any:
    """A tree of ``tree``'s structure holding ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return None if node is None else next(it)
    return build(tree)


def init(params: Any) -> OptState:
    return OptState(m=tree_map(torch.zeros_like, params),
                    v=tree_map(torch.zeros_like, params), step=0)


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup then cosine decay to ``min_lr_ratio * lr``, in float32
    as the reference computes it (step is the count before this update)."""
    s = torch.tensor(step, dtype=torch.int32)
    warm = torch.clamp((s + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi) * prog))
    return float(_f32(cfg.lr) * warm
                 * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos))


def _slices(t: torch.Tensor) -> List[torch.Tensor]:
    """Views of ``t`` along its first axis of at most ``CHUNK`` elements
    each (the whole tensor when it is that small or has no axis)."""
    if t.dim() == 0 or t.numel() <= CHUNK:
        return [t]
    per = max(1, CHUNK // max(1, t.numel() // t.shape[0]))
    return list(t.split(per, dim=0))


def global_norm(grads: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g^2), in float32 (leaf order as
    the reference's)."""
    total = None
    for g in tree_leaves(grads):
        for part in _slices(g):
            sq = part.float().square().sum()
            total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply(cfg: AdamWConfig, params: Any, grads: Any, state: OptState,
          gnorm: Optional[torch.Tensor] = None) -> Tuple[Any, OptState]:
    """One AdamW step (clip, moments, bias correction, decoupled decay).
    Updates ``params``, ``state.m`` and ``state.v`` in place and returns
    (params, the new OptState).  ``gnorm``, when given, is the global
    norm to clip by (a sharded step's, reduced over its mesh); else the
    norm of ``grads``."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(cfg, state.step)
    bc1 = float(1 - _f32(cfg.b1) ** step)
    bc2 = float(1 - _f32(cfg.b2) ** step)
    for leaves in zip(tree_leaves(params), tree_leaves(grads),
                      tree_leaves(state.m), tree_leaves(state.v)):
        for p, g, m, v in zip(*map(_slices, leaves)):
            gs = g.float() * scale.to(g.device)
            m32 = cfg.b1 * m.float() + (1 - cfg.b1) * gs
            v32 = cfg.b2 * v.float() + (1 - cfg.b2) * gs * gs
            del gs
            pf = p.float()
            upd = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps) \
                + cfg.weight_decay * pf
            p.copy_(pf - lr * upd)
            m.copy_(m32)
            v.copy_(v32)
    return params, OptState(state.m, state.v, step)
