"""The production programs per input shape (port of
``repro.launch.steps``): the train, prefill and serve steps, their input
shapes on the meta device, and their partition specs.

Shapes (assigned):
  train_4k     seq 4096,   global_batch 256   -> train_step
  prefill_32k  seq 32768,  global_batch 32    -> prefill_step
  decode_32k   seq 32768,  global_batch 128   -> serve_step (gamma-token
               SpecBranch verification against a full-length KV cache)
  long_500k    seq 524288, global_batch 1     -> serve_step, cache sequence
               sharded over "data" (batch=1 cannot shard)

Applicability rules (DESIGN.md §6): encoder-only archs skip decode shapes;
pure-full-attention archs skip long_500k.

On a mesh (``launch.mesh.ServingMesh``) every step runs the rank's part
of the program.  The rank holds its blocks of the weights under
``sharding.rules.fsdp_params_specs`` (FSDP over "data", TP over "model",
exceptions (a)-(c)); each layer gathers its weights' "data" blocks just
before it runs (``MeshAxis.fsdp_gather``; in the train step, inside the
layer's remat, and its gradient is reduce-scattered back) and runs the
tensor-parallel forward of ``models``.  Rows are split over "data"
(``rows_split``; MoE capacity and statistics then span the whole batch),
the cache is the rank's block of the rules' cache specs with exception
(a), and the logits come back as the rank's block of the out specs (rows
over "data", vocabulary over "model").  The reference's
``_dist_fwd_kwargs`` (activation and logits sharding constraints, the
one-hot embedding, the MoE buffer spec) are GSPMD constraints; the port's
layout places every tensor itself and has no counterpart for them.

long_500k (``shard_seq``): each rank holds its block of every ring's
slots; an attention layer all-gathers its ring's K, V and positions over
"data", attends and writes over the whole ring, and keeps its block (the
``Census`` counts the gathers).  That is exact; a merge of per-block
partial softmaxes would move less but sum in another order.

The reference's ``REPRO_OPT_*`` switches (``REPRO_OPT_DECODE_BATCH``,
``REPRO_OPT_NO_ATTN_QHD``, ``REPRO_OPT_TP_ONLY``,
``REPRO_OPT_DECODE_SEQ``) are its own performance experiments, not part
of the programs, and are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import set_checkpoint_early_stop as \
    checkpoint_early_stop

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import moe_capacity
from repro_torch.sharding import rules
from repro_torch.sharding.rules import P
from repro_torch.training import optim
from repro_torch.training.train import _ce, lm_loss, value_and_grad

GAMMA_VERIFY = 4          # draft tokens per SpecBranch verification step
KV_CHUNK = 2048           # the plain attention's key chunk (the reference's)
MOE_AUX_WEIGHT = 0.01


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    batch: int
    kind: str                 # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# micro-batch count for train_4k (gradient accumulation inside the step),
# the reference's
MICROBATCHES = {
    "jamba-1.5-large-398b": 16,
    "grok-1-314b": 16,
    "gemma2-27b": 8,
    "mistral-nemo-12b": 8,
    "qwen3-8b": 8,
    "falcon-mamba-7b": 8,
    "gemma3-4b": 4,
    "hubert-xlarge": 4,
    "internvl2-2b": 4,
    "granite-moe-3b-a800m": 4,
}


def applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    ss = SHAPES[shape]
    if ss.kind == "decode":
        if not cfg.supports_decode():
            return False, "encoder-only (no autoregressive decode)"
        if shape == "long_500k" and not cfg.supports_long_context():
            return False, "pure full attention (no sub-quadratic variant)"
    return True, ""


# ---------------------------------------------------------------------------
# input shapes (meta tensors: no generator, no allocation)
# ---------------------------------------------------------------------------

def params_shape(cfg: ModelConfig) -> Any:
    return M.init_params(cfg, 0, device="meta")


def cache_shape(cfg: ModelConfig, batch: int, max_len: int) -> Any:
    return M.init_cache(cfg, batch, max_len, device="meta")


def opt_shape(params: Any) -> optim.OptState:
    return optim.init(params)


# ---------------------------------------------------------------------------
# the rank's part of a program
# ---------------------------------------------------------------------------

def _data_dims(spec_tree: Any, lead: int) -> Any:
    """The dim of each leaf that "data" splits (None where it splits
    none), for a layer's leaves without their ``lead`` stack axes."""
    def leaf(sp):
        for i, e in enumerate(sp):
            if isinstance(e, tuple):
                raise ValueError(f"{sp}: the executed mesh has no 'pod'")
            if e == "data":
                return i - lead
        return None
    return _map_specs(leaf, spec_tree)


def _map_specs(fn, tree):
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return [_map_specs(fn, v) for v in tree]


def fsdp_gather_hook(mesh, layout: Any):
    """``models.model.forward``'s ``gather``: each layer's weights from the
    rank's FSDP blocks under ``layout``, gathered over "data" (None on a
    mesh whose "data" axis is 1)."""
    ax = mesh.axis("data")
    if ax.size == 1:
        return None
    top = {k: _data_dims(layout[k], 0)
           for k in ("embed", "final_norm", "lm_head") if k in layout}
    parts = {"blocks": [_data_dims(b, 1) for b in layout["blocks"]],
             "rem": [_data_dims(r, 1) for r in layout["rem"]]}

    def gather(where, p):
        dims = top if where[0] == "top" else parts[where[0]][where[1]]
        return optim.tree_map(
            lambda x, d: x if d is None else ax.fsdp_gather(x, d), p, dims)
    return gather


def _mesh_kw(cfg: ModelConfig, mesh, rows_split: bool,
             shard_seq: bool = False) -> Dict[str, Any]:
    if mesh is None:
        return {}
    data = mesh.axis("data")
    split = data.size > 1
    return dict(tp=mesh.tp, logits_split=True,
                gather=fsdp_gather_hook(
                    mesh, rules.fsdp_params_specs(mesh, cfg,
                                                  params_shape(cfg))),
                dp=data if split and rows_split and not shard_seq else None,
                seq=data if split and shard_seq else None)


def make_prefill_step(cfg: ModelConfig, mesh=None, *,
                      rows_split: bool = True):
    """step(params, tokens (B, T), cache) -> (last-position logits (B, V),
    cache): a prompt into an empty dense cache (written in place).  On a
    mesh: the rank's blocks (see the module docstring)."""
    kw = _mesh_kw(cfg, mesh, rows_split)

    @torch.no_grad()
    def step(params, tokens, cache):
        B, T = tokens.shape
        positions = torch.arange(T, dtype=torch.int32,
                                 device=tokens.device).expand(B, T)
        logits, _ = M.forward(params, cfg, tokens, cache=cache,
                              positions=positions, logits_mode="last",
                              kv_chunk=KV_CHUNK, cache_mode="fresh", **kw)
        return logits[:, -1], cache
    return step


def make_prefill_step_embeds(cfg: ModelConfig, mesh=None, *,
                             rows_split: bool = True):
    """Encoder / frontend prefill: step(params, embeds (B, T, D)) ->
    per-position logits (B, T, V), cache-less."""
    kw = _mesh_kw(cfg, mesh, rows_split)

    @torch.no_grad()
    def step(params, embeds):
        logits, _ = M.forward(params, cfg, None, embeds=embeds,
                              logits_mode="all", kv_chunk=KV_CHUNK, **kw)
        return logits
    return step


def make_serve_step(cfg: ModelConfig, gamma: int = GAMMA_VERIFY,
                    mesh=None, *, rows_split: bool = True,
                    shard_seq: bool = False):
    """SpecBranch target-side verification: step(params, tokens (B,
    gamma), cache, pos (B,)) -> (per-position logits (B, gamma, V),
    cache): gamma draft tokens against a full-length dense cache (written
    in place).  ``shard_seq``: the cache's slots are split over "data"
    (long_500k; see the module docstring), every attention ring's slot
    count divisible by the "data" size (``input_specs`` checks it)."""
    kw = _mesh_kw(cfg, mesh, rows_split, shard_seq)

    @torch.no_grad()
    def step(params, tokens, cache, pos):
        positions = pos.to(torch.int32)[:, None] + torch.arange(
            gamma, dtype=torch.int32, device=tokens.device)[None]
        logits, _ = M.forward(params, cfg, tokens, cache=cache,
                              positions=positions, logits_mode="all",
                              kv_chunk=KV_CHUNK, **kw)
        return logits, cache
    return step


def make_train_step(cfg: ModelConfig, n_micro: int,
                    ocfg: Optional[optim.AdamWConfig] = None):
    """step(params, opt_state, batch (B, T+1)) -> (params, opt_state,
    mean loss): ``n_micro`` micro-batches of B / n_micro rows, each a
    remat forward and backward, their gradients summed in the parameter
    dtype (as the reference accumulates: f32 accumulators would double a
    bf16 model's gradient memory) and divided by ``n_micro``, then one
    AdamW step (params updated in place).  The backward recomputes each
    layer whole (no early stop), so its products and collectives are the
    ones ``step_costs`` counts."""
    ocfg = ocfg or optim.AdamWConfig()

    def step(params, opt_state, batch):
        B = batch.shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} is not a multiple of n_micro "
                             f"{n_micro}")
        micro = batch.reshape(n_micro, B // n_micro, batch.shape[1])
        gsum, lsum = None, torch.zeros((), dtype=torch.float32,
                                       device=batch.device)
        for mb in micro:
            with checkpoint_early_stop(False):
                loss, _, grads = value_and_grad(
                    lambda p, b: lm_loss(p, cfg, b, remat=True), params, mb)
            lsum = lsum + loss
            gsum = _accumulate(gsum, grads)
        for a in optim.tree_leaves(gsum):
            a.div_(n_micro)
        gnorm = optim.global_norm(gsum)
        step.gnorms.append(gnorm)
        params, opt_state = optim.apply(ocfg, params, gsum, opt_state,
                                        gnorm=gnorm)
        return params, opt_state, lsum / n_micro

    step.gnorms = []          # each step's global gradient norm (tensors)
    return step


def _accumulate(gsum, grads):
    if gsum is None:
        return grads
    for a, g in zip(optim.tree_leaves(gsum), optim.tree_leaves(grads)):
        a.add_(g)
    return gsum


# ---------------------------------------------------------------------------
# the FSDP x TP train step
# ---------------------------------------------------------------------------

def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor, tp,
                      vocab: int) -> torch.Tensor:
    """Per-position cross entropy of logits whose vocabulary is split over
    ``tp`` (the rank's columns), as the reference's ``lm_loss`` computes
    it under GSPMD: the max and the exponentials' sum meet in two
    all-reduces, the label's logit in a third; nothing gathers the
    vocabulary.  Full-vocabulary logits take ``_ce``."""
    if tp is None or logits.shape[-1] == vocab:
        return _ce(logits, labels)
    lf = logits.float()
    Vl = lf.shape[-1]
    m = tp.all_reduce_max(lf.amax(-1))
    lse = torch.log(tp.all_reduce(torch.exp(lf - m[..., None]).sum(-1))) + m
    local = labels.long() - tp.index * Vl
    mine = (local >= 0) & (local < Vl)
    tok = torch.gather(lf, -1, local.clamp(0, Vl - 1)[..., None])[..., 0]
    return lse - tp.all_reduce(torch.where(mine, tok,
                                           torch.zeros_like(tok)))


def spec_leaves(specs: Any) -> list:
    """The specs of a spec tree in ``optim.tree_leaves`` order."""
    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    return [x for v in specs for x in spec_leaves(v)]


def _leaf_names(tree: Any, name: str = "") -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaf_names(tree[k], k)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaf_names(v, name)]
    return [name]


def make_mesh_train_step(cfg: ModelConfig, n_micro: int, mesh,
                         ocfg: Optional[optim.AdamWConfig] = None,
                         keep_grads: bool = False):
    """The FSDP x TP train step on a ``(dp, tp)`` mesh:
    step(params, opt_state, batch (B, T+1)) -> (params, opt_state, mean
    loss), with ``params`` and the AdamW moments the rank's blocks under
    ``rules.fsdp_params_specs`` (updated in place) and ``batch`` the
    whole global batch (the rank takes its rows).  It equals
    ``make_train_step`` on one device:

      * micro-batch i is global rows [i B/n, (i+1) B/n), split over
        "data" within it;
      * the loss is the global mean: each rank's is its rows' NLL sum over
        the global token count (vocabulary-parallel) plus the MoE term,
        whose capacity, token ranks and fractions span the micro-batch;
      * each layer gathers its weights over "data" and reduce-scatters
        their gradients back; a leaf that "data" does not split sums its
        gradient over "data"; q_norm / k_norm (applied to split heads)
        and the KV-head ranges of exception (a) sum theirs over "model";
      * the global norm sums every rank's squares once per element (each
        element over the ranks holding it, ``rules.holders``).

    ``step.gnorms`` holds each step's global norm (tensors);
    ``keep_grads`` keeps each step's gradient blocks in ``step.grads``.
    """
    ocfg = ocfg or optim.AdamWConfig()
    pshape = params_shape(cfg)
    layout = rules.fsdp_params_specs(mesh, cfg, pshape)
    gather = fsdp_gather_hook(mesh, layout)
    tp, data, model = mesh.tp, mesh.axis("data"), mesh.axis("model")
    dp = data if data.size > 1 else None
    specs = spec_leaves(layout)
    shapes = [tuple(x.shape) for x in optim.tree_leaves(pshape)]
    names = _leaf_names(pshape)
    weights = [rules.holders(sp, sh, mesh, mesh.coords)
               for sp, sh in zip(specs, shapes)]

    def loss_fn(p, rows, n_tokens):
        inp = rows[:, :-1]
        lab = rows[:, 1:] if cfg.causal else inp
        logits, aux = M.forward(p, cfg, inp, remat=True, tp=tp, dp=dp,
                                gather=gather, logits_split=True)
        nll = vocab_parallel_ce(logits, lab, tp, cfg.vocab_size).sum() \
            / n_tokens
        return nll + MOE_AUX_WEIGHT * aux["moe_aux"], \
            {"nll": nll, "moe_aux": aux["moe_aux"]}

    def finish(g, sp, name):
        """The rank's block of the summed gradient of one leaf."""
        if dp is not None and not any(e == "data" for e in sp):
            g = data.all_reduce(g)
        if tp is None:
            return g
        if name in ("q_norm", "k_norm"):
            return model.all_reduce(g)
        for i, e in enumerate(sp):
            if isinstance(e, rules.HeadRange):   # overlapping KV heads
                lo, hi = e.heads(model.index, model.size)
                unit = g.shape[i] // (hi - lo)
                shape = list(g.shape)
                shape[i] = e.kv_heads * unit
                full = g.new_zeros(shape)
                full.narrow(i, lo * unit, (hi - lo) * unit).copy_(g)
                return model.all_reduce(full).narrow(
                    i, lo * unit, (hi - lo) * unit).contiguous()
        return g

    def step(params, opt_state, batch):
        B = batch.shape[0]
        Bm = B // n_micro
        if B % n_micro or Bm % data.size:
            raise ValueError(f"batch {B} does not split into {n_micro} "
                             f"micro-batches over {data.size} data ranks")
        rows = Bm // data.size
        n_tokens = Bm * (batch.shape[1] - 1)
        gsum, nll, aux = None, 0.0, 0.0
        for i in range(n_micro):
            lo = i * Bm + data.index * rows
            with checkpoint_early_stop(False):
                _, met, grads = value_and_grad(loss_fn, params,
                                               batch[lo:lo + rows], n_tokens)
            nll = nll + met["nll"]
            aux = aux + met["moe_aux"]
            gsum = _accumulate(gsum, grads)
        with torch.no_grad():
            leaves = []
            sq = torch.zeros((), dtype=torch.float32, device=batch.device)
            for g, sp, name, w in zip(optim.tree_leaves(gsum), specs, names,
                                      weights):
                g = finish(g.div_(n_micro), sp, name)
                wt = w.to(g.device) if torch.is_tensor(w) else float(w)
                sq = sq + (g.float().square() / wt).sum()
                leaves.append(g)
            gnorm = torch.sqrt(mesh.all_reduce(sq))
            grads = optim.tree_unflatten(gsum, leaves)
            step.gnorms.append(gnorm)
            if keep_grads:
                step.grads.append(optim.tree_map(torch.clone, grads))
            params, opt_state = optim.apply(ocfg, params, grads, opt_state,
                                            gnorm=gnorm)
            nll = torch.as_tensor(nll, dtype=torch.float32,
                                  device=batch.device).reshape(())
            if dp is not None:
                nll = data.all_reduce(nll.clone())
            loss = (nll + MOE_AUX_WEIGHT * aux) / n_micro
        return params, opt_state, loss

    step.gnorms, step.grads = [], []
    return step


# ---------------------------------------------------------------------------
# input specs (meta stand-ins; the rules' specs as the reference's)
# ---------------------------------------------------------------------------

def _live(mesh) -> bool:
    return hasattr(mesh, "axes")


def input_specs(cfg: ModelConfig, shape: str, mesh) -> Dict[str, Any]:
    """Returns dict(fn, args, in_specs, out_specs, layout): ``args`` meta
    stand-ins of the inputs; ``in_specs`` / ``out_specs`` the rules'
    ``P`` trees, equal to the reference's shardings; ``layout`` the port's
    layout of the inputs (the rules with exceptions (a)-(c)), which the
    rank's blocks follow.  ``fn`` runs the rank's part on a live mesh
    (``launch.mesh.ServingMesh``), else the one-device program."""
    ss = SHAPES[shape]
    live = mesh if _live(mesh) else None
    pshape = params_shape(cfg)
    pspec = rules.params_specs(mesh, cfg, pshape)
    play = rules.fsdp_params_specs(mesh, cfg, pshape)
    ba = rules.batch_axes(mesh)
    btok = rules.tokens_spec(mesh, ss.batch)
    rows_split = btok[0] is not None
    vocab = rules._fit(mesh, cfg.vocab_size, "model")

    if ss.kind == "train":
        n_micro = MICROBATCHES.get(cfg.name, 1)
        fn = (make_mesh_train_step(cfg, n_micro, live) if live is not None
              else make_train_step(cfg, n_micro))
        ospec = optim.OptState(m=pspec, v=pspec, step=P())
        batch = torch.empty((ss.batch, ss.seq_len + 1), dtype=torch.int32,
                            device="meta")
        return dict(fn=fn, args=(pshape, opt_shape(pshape), batch),
                    in_specs=(pspec, ospec, btok),
                    out_specs=(pspec, ospec, P()),
                    layout=(play, optim.OptState(m=play, v=play, step=P()),
                            btok))

    bax = rules._fit(mesh, ss.batch, ba, "data")
    if ss.kind == "prefill":
        if cfg.frontend == "audio":
            fn = make_prefill_step_embeds(cfg, live, rows_split=rows_split)
            embeds = torch.empty((ss.batch, ss.seq_len, cfg.d_model),
                                 dtype=cfg.tdtype, device="meta")
            esh, osh = P(bax, None, None), P(bax, None, vocab)
            return dict(fn=fn, args=(pshape, embeds), in_specs=(pspec, esh),
                        out_specs=osh, layout=(play, esh))
        fn = make_prefill_step(cfg, live, rows_split=rows_split)
        cshape = cache_shape(cfg, ss.batch, ss.seq_len)
        cspec = rules.cache_specs(mesh, cfg, cshape)
        tokens = torch.empty((ss.batch, ss.seq_len), dtype=torch.int32,
                             device="meta")
        logits = P(bax, vocab)
        return dict(fn=fn, args=(pshape, tokens, cshape),
                    in_specs=(pspec, btok, cspec),
                    out_specs=(logits, cspec),
                    layout=(play, btok, rules.override_cache_specs(
                        mesh, cfg, cshape, cspec)))

    # decode
    shard_seq = shape == "long_500k"
    fn = make_serve_step(cfg, mesh=live, rows_split=rows_split,
                         shard_seq=shard_seq)
    cshape = cache_shape(cfg, ss.batch, ss.seq_len)
    cspec = rules.cache_specs(mesh, cfg, cshape, shard_seq=shard_seq)
    if shard_seq and any(sp[2] is None for sp in spec_leaves(cspec)
                         if len(sp) == 5 and rules._axis_size(
                             mesh, "data") > 1):
        raise ValueError(f"{shape}: every attention ring's slots must "
                         "split over 'data' for the sequence split")
    tokens = torch.empty((ss.batch, GAMMA_VERIFY), dtype=torch.int32,
                         device="meta")
    pos = torch.empty((ss.batch,), dtype=torch.int32, device="meta")
    logits = P(bax, None, vocab)
    return dict(fn=fn, args=(pshape, tokens, cshape, pos),
                in_specs=(pspec, P(bax, None), cspec, P(bax)),
                out_specs=(logits, cspec),
                layout=(play, P(bax, None), rules.override_cache_specs(
                    mesh, cfg, cshape, cspec), P(bax)))


# ---------------------------------------------------------------------------
# closed-form costs of a rank's part (the dry run's figures)
# ---------------------------------------------------------------------------

def _elt(dtype: torch.dtype) -> int:
    return dtype.itemsize


def _strip_fsdp(sp: P, mesh) -> P:
    fa = set(rules.fsdp_axes(mesh))
    return P(*(None if e is not None and not isinstance(e, rules.HeadRange)
               and set(e if isinstance(e, tuple) else (e,)) <= fa else e
               for e in sp))


def _fsdp_group(sp: P, mesh) -> Tuple[int, Any]:
    """(size, axis) of the FSDP entry of a spec; (1, None) without."""
    fa = set(rules.fsdp_axes(mesh))
    for e in sp:
        if e is not None and not isinstance(e, rules.HeadRange) \
                and set(e if isinstance(e, tuple) else (e,)) <= fa:
            return rules._axis_size(mesh, e), e
    return 1, None


def _rows_axis(mesh, rows: int):
    return rules._fit(mesh, rows, rules.batch_axes(mesh), "data")


def step_costs(cfg: ModelConfig, kind: str, batch: int, seq: int, mesh,
               coords: Dict[str, int], *, n_micro: int = 1,
               gamma: int = GAMMA_VERIFY, kv_chunk: int = KV_CHUNK,
               shard_seq: bool = False) -> Dict[str, Any]:
    """The dot FLOPs and the collectives of one rank's part of a
    production step, in closed form from the config, the layout and the
    rank's coordinates: ``{"flops": ..., "events": [(kind, group size,
    recorded bytes), ...]}`` (``hlo_analysis.bytes_by_kind`` turns the
    events into bytes moved).  ``kind`` is "train" (``batch`` rows of
    ``seq`` + 1 tokens in ``n_micro`` micro-batches), "prefill",
    "prefill_embeds" (``seq`` positions) or "decode" (``gamma`` tokens
    against a ``seq``-slot cache).

    The FLOPs count every product the step computes (2 per
    multiply-add): the layers' projections, attention's two products
    over the keys of the view it attends (padded to ``kv_chunk``, masked
    or not, as the plain attention and the reference compute them), the
    MoE router and the experts over their (E, C, D) buffer, Mamba's four
    projections and its scan's readout, and the head; a train step
    counts each layer's forward three more times (its remat recompute and
    the backward's two products a product) and the head's two more.  The
    events are the collectives the step issues, forward and backward, as
    its ``Census`` records them.  ``tests/test_torch_steps.py`` holds
    both equal to ``FlopCounterMode`` and to the census of executed
    steps.  Each event also names the axis its group spans ("model",
    "data", a tuple of FSDP axes, or "world"), for the link it crosses."""
    pshape = params_shape(cfg)
    layout = rules.fsdp_params_specs(mesh, cfg, pshape)
    tp = rules._axis_size(mesh, "model")
    elt = _elt(cfg.tdtype)
    D, hd, V = cfg.d_model, cfg.hd, cfg.vocab_size
    train = kind == "train"
    rows_all = batch // n_micro if train else batch
    rows_ax = _rows_axis(mesh, rows_all)
    dp_rows = rules._axis_size(mesh, rows_ax) if rows_ax is not None else 1
    seq_split = (rules._axis_size(mesh, "data") if shard_seq else 1)
    if shard_seq:
        rows_ax, dp_rows = None, 1
    Br = rows_all // dp_rows
    T = gamma if kind == "decode" else seq
    N = Br * T
    stats = dp_rows > 1 and cfg.num_experts > 0
    n_glob = N * dp_rows

    def tp_shape(leaf, sp, lead):
        return rules.shard_shape(tuple(leaf.shape)[lead:],
                                 _strip_fsdp(sp, mesh)[lead:], mesh, coords)

    def nbytes(shape, dtype):
        n = 1
        for d in shape:
            n *= d
        return n * _elt(dtype)

    def gathers(tree, spec_tree, lead):
        """(group, bytes gathered, axis) of each FSDP leaf of one layer."""
        out = []
        for leaf, sp in zip(optim.tree_leaves(tree), spec_leaves(spec_tree)):
            n, ax = _fsdp_group(sp, mesh)
            if n > 1:
                out.append((n, nbytes(tp_shape(leaf, sp, lead), leaf.dtype),
                            ax))
        return out

    def slot_cost(p, sp, slot):
        """(fwd flops, fwd events, bwd events) of one layer."""
        mixer, ffn_kind = slot
        flops, fwd, bwd = 0.0, [], []
        for n, b, ax in gathers(p, sp, 1):
            fwd.append(("all-gather", n, b, ax))
            bwd.append(("reduce-scatter", n, b, ax))
        m, ms = p["mixer"], sp["mixer"]
        if mixer in ("attn", "local"):
            Hl = tp_shape(m["wq"], ms["wq"], 1)[-1] // hd
            KVl = tp_shape(m["wk"], ms["wk"], 1)[-1] // hd
            rows_wo = tp_shape(m["wo"], ms["wo"], 1)[-2]
            G = cfg.num_heads // cfg.num_kv_heads
            width = Hl
            if tp > 1 and KVl > 1 and KVl * G != Hl:
                width = KVl * G
            window = cfg.sliding_window if mixer == "local" else 0
            if kind == "decode":
                Sc = min(window, seq) if window else seq
                S = Sc + T if window else Sc
                if seq_split > 1:
                    for nb in (Br * Sc * KVl * hd * elt,) * 2 \
                            + (Br * Sc * 4,):
                        fwd.append(("all-gather", seq_split, nb, "data"))
            else:
                S = T
            Sp = -(-S // kv_chunk) * kv_chunk
            flops += 2 * N * D * (Hl + 2 * KVl) * hd \
                + 4 * Br * T * width * Sp * hd + 2 * N * rows_wo * D
            if Hl != cfg.num_heads:
                fwd.append(("all-reduce", tp, N * D * elt, "model"))
                bwd.append(("all-reduce", tp, N * D * elt, "model"))
        else:
            El = tp_shape(m["out_proj"], ms["out_proj"], 1)[-2]
            R, Ns = cfg.dtr, cfg.ssm_state
            flops += 2 * N * (D * 2 * El + El * (R + 2 * Ns) + R * El
                              + El * D + El * Ns)
            if El != cfg.d_inner:
                for nb in (N * (R + 2 * Ns) * elt, N * D * elt):
                    fwd.append(("all-reduce", tp, nb, "model"))
                    bwd.append(("all-reduce", tp, nb, "model"))
        if ffn_kind == "dense":
            Fl = tp_shape(p["ffn"]["wd"], sp["ffn"]["wd"], 1)[-2]
            flops += 6 * N * D * Fl
            if Fl != cfg.d_ff:
                fwd.append(("all-reduce", tp, N * D * elt, "model"))
                bwd.append(("all-reduce", tp, N * D * elt, "model"))
        elif ffn_kind == "moe":
            E, K = cfg.num_experts, cfg.num_experts_per_tok
            Fel = tp_shape(p["ffn"]["wd"], sp["ffn"]["wd"], 1)[-2]
            C = moe_capacity(cfg, n_glob if stats else N)
            flops += 2 * N * D * E + 6 * E * C * D * Fel
            if stats:
                fwd.append(("all-gather", dp_rows, dp_rows * E * 8,
                            rows_ax))
                fwd.append(("all-reduce", dp_rows, E * 4, rows_ax))
            if Fel != cfg.expert_ff:
                fwd.append(("all-reduce", tp, N * D * elt, "model"))
                bwd.append(("all-reduce", tp, N * D * elt, "model"))
                bwd.append(("all-reduce", tp, N * K * elt, "model"))
        return flops, fwd, bwd

    layer_flops, layer_fwd, layer_bwd = 0.0, [], []
    for part in ("blocks", "rem"):
        for s, (p, sp) in enumerate(zip(pshape[part], layout[part])):
            slot = cfg.pattern[s]
            reps = cfg.n_periods if part == "blocks" else 1
            f, fw, bw = slot_cost(p, sp, slot)
            layer_flops += reps * f
            layer_fwd += fw * reps
            layer_bwd += bw * reps

    top, tops = {}, {}
    for k in ("embed", "final_norm", "lm_head"):
        if k in pshape:
            top[k], tops[k] = pshape[k], layout[k]
    top_fwd, top_bwd = [], []
    for n, b, ax in gathers(top, tops, 0):
        top_fwd.append(("all-gather", n, b, ax))
        top_bwd.append(("reduce-scatter", n, b, ax))
    head = pshape.get("lm_head")
    head_sp = layout["lm_head"] if head is not None else None
    Vl = (tp_shape(head, head_sp, 0)[-1] if head is not None
          else tp_shape(pshape["embed"], layout["embed"], 0)[0])
    vsplit = Vl != V
    if kind != "prefill_embeds" and vsplit:
        top_fwd.append(("all-reduce", tp, N * D * elt, "model"))
    n_log = Br if kind == "prefill" else N
    head_flops = 2 * n_log * D * Vl
    if train and vsplit:
        top_fwd += [("all-reduce", tp, N * 4, "model")] * 3
        top_bwd.append(("all-reduce", tp, N * D * elt, "model"))

    if not train:
        return {"flops": layer_flops + head_flops,
                "events": top_fwd + layer_fwd}
    events = (top_fwd + layer_fwd * 2 + layer_bwd + top_bwd) * n_micro
    fa_sizes = {a: mesh.shape[a] for a in rules.fsdp_axes(mesh)}
    world = 1
    for v in mesh.shape.values():
        world *= v
    for leaf, sp, name in zip(optim.tree_leaves(pshape), spec_leaves(layout),
                              _leaf_names(pshape)):
        blk = rules.shard_shape(tuple(leaf.shape), sp, mesh, coords)
        named = set()
        for e in sp:
            if e is not None and not isinstance(e, rules.HeadRange):
                named.update(e if isinstance(e, tuple) else (e,))
        rep = tuple(a for a in fa_sizes if a not in named)
        n_rep = rules._axis_size(mesh, rep)
        if n_rep > 1:
            events.append(("all-reduce", n_rep, nbytes(blk, leaf.dtype),
                           rep))
        if tp == 1:
            continue
        if name in ("q_norm", "k_norm"):
            events.append(("all-reduce", tp, nbytes(blk, leaf.dtype),
                           "model"))
        for i, e in enumerate(sp):
            if isinstance(e, rules.HeadRange):
                full = list(blk)
                full[i] = leaf.shape[i]
                events.append(("all-reduce", tp, nbytes(full, leaf.dtype),
                               "model"))
    if world > 1:
        events.append(("all-reduce", world, 4, "world"))
    if dp_rows > 1:
        events.append(("all-reduce", dp_rows, 4, rows_ax))
    return {"flops": (4 * layer_flops + 3 * head_flops) * n_micro,
            "events": events}


def events_by_key(events) -> Dict[str, Tuple[int, int]]:
    """``{"kind@n": (count, recorded bytes)}`` of ``step_costs`` events,
    the form ``census_by_key`` reads a ``Census`` in."""
    out: Dict[str, Tuple[int, int]] = {}
    for kind, n, b, *_ in events:
        c, t = out.get(f"{kind}@{n}", (0, 0))
        out[f"{kind}@{n}"] = (c + 1, t + int(b))
    return out


def census_by_key(census) -> Dict[str, Tuple[int, int]]:
    raw = census.raw_bytes()
    return {k: (c, raw[k]) for k, c in census.counts().items()}


def _tree_np(tree):
    return optim.tree_map(lambda t: t.detach().cpu().float().numpy(), tree)


def step_jobs(mesh, jobs) -> list:
    """Rank target (``launch.mesh.spawn``): run production steps on this
    rank's blocks.  A job: ``cfg``, ``kind`` ("prefill", "decode" or
    "prefill_embeds"), ``params`` (the full tree, CPU tensors), ``inputs``
    (numpy: tokens, or embeds; with "decode" also ``pos``), ``cache`` (the
    full cache tree before the step, CPU tensors, or None) and
    ``shard_seq``.  Each returns the rank's logits and cache blocks
    (numpy), its census ``{"kind@n": (count, bytes)}`` and the FLOPs
    ``FlopCounterMode`` counted."""
    from torch.utils.flop_counter import FlopCounterMode
    out = []
    for job in jobs:
        cfg, kind = job["cfg"], job["kind"]
        pshape = params_shape(cfg)
        layout = rules.fsdp_params_specs(mesh, cfg, pshape)
        params = rules.shard_tree(job["params"], layout, mesh, mesh.coords,
                                  mesh.device)
        inp = job["inputs"]
        B = inp[0].shape[0]
        bax = rules._fit(mesh, B, rules.batch_axes(mesh), "data")
        rows_split = bax is not None and not job.get("shard_seq")

        def rows(a):
            t = torch.from_numpy(a).to(mesh.device)
            return rules.rank_block(t, P(bax if rows_split else None),
                                    mesh, mesh.coords)
        cache = None
        if job.get("cache") is not None:
            cshape = optim.tree_map(lambda t: t.to("meta"), job["cache"])
            cspec = rules.override_cache_specs(mesh, cfg, cshape,
                                               rules.cache_specs(
                                                   mesh, cfg, cshape,
                                                   shard_seq=job.get(
                                                       "shard_seq", False)))
            cache = optim.tree_map(torch.clone, rules.shard_tree(
                job["cache"], cspec, mesh, mesh.coords, mesh.device))
        mesh.census.reset()
        with FlopCounterMode(display=False) as fc:
            if kind == "prefill":
                logits, cache = make_prefill_step(
                    cfg, mesh, rows_split=rows_split)(
                        params, rows(inp[0]).long(), cache)
            elif kind == "prefill_embeds":
                logits = make_prefill_step_embeds(
                    cfg, mesh, rows_split=rows_split)(params, rows(inp[0]))
            else:
                logits, cache = make_serve_step(
                    cfg, mesh=mesh, rows_split=rows_split,
                    shard_seq=job.get("shard_seq", False))(
                        params, rows(inp[0]).long(), cache, rows(inp[1]))
        out.append(dict(name=job.get("name"), logits=_tree_np(logits),
                        cache=None if cache is None else _tree_np(cache),
                        census=census_by_key(mesh.census),
                        flops=fc.get_total_flops()))
    return out
