"""Device-resident inner loop of the batched serving engines (port of
``repro.serving.device_loop``, DESIGN.md §7.7).

Every distribution stays on the device; the host gets small int32/f32
packets (sampled tokens, confidences, accept lengths, branch verdicts).
Token widths are padded up the bucket ladders so the loop sees a handful
of shapes.  Uniforms come from ``sampling.uniform_grid``: element (s, j)
is a pure function of (rid_s, ctr_s + j), and the engine advances each
request's counter by its own consumption, so sampled streams do not
depend on batch composition.  The (rid, ctr) coordinates are host
integers, so the grid is hashed on the host and uploaded as one small
tensor instead of some hundred elementwise launches on the card.

Arguments that the engine stages on the host (row indices, lengths,
coordinates) may be numpy arrays; they move to the logits' device here.

``annotate`` names profiler ranges around the loop's dispatch sites when
``set_trace_annotations(True)`` (``launch.serve --profile-dir``) turned
them on: a ``torch.profiler.record_function`` range, and an NVTX range as
well when the engine runs on the card.

On a serving mesh (DESIGN.md §7.10) every function here runs unchanged on
every rank: the tensor-parallel forward already returns full-vocabulary
logits, so the packets are replicated by construction, as the reference's
``_replicated`` pins them.  ``replicated`` is the one step that is left:
the dense backend's rows split over "data" come back to every rank.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.runtime import sampling as S

__all__ = ["replicated", "bucket", "prefill_bucket", "prefill_rungs",
           "kernel_route",
           "tick_sample", "draft_chunk", "masked_token_column",
           "compose_verify_tokens",
           "sps_verify", "draw_cands", "branch_verify",
           "set_trace_annotations", "annotate"]

# Off by default: ``annotate`` then returns a nullcontext, so the hot path
# pays one module-global read.
_ANNOTATE = False


def set_trace_annotations(on: bool) -> None:
    global _ANNOTATE
    _ANNOTATE = bool(on)


def annotate(name: str, device="cpu"):
    """Named profiler range when annotations are on; free otherwise.  The
    NVTX half is chosen by ``device`` (a CPU-only build has no NVTX)."""
    if not _ANNOTATE:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.profiler.record_function(name))
    if torch.device(device).type == "cuda":
        stack.enter_context(torch.cuda.nvtx.range(name))
    return stack


def replicated(x: torch.Tensor, data, dim: int) -> torch.Tensor:
    """``x`` of every "data" rank's rows, concatenated along ``dim`` (the
    row axis), on every rank: one all-gather over the ``data`` axis
    (``launch.mesh.MeshAxis``); ``x`` itself when the rows are not split
    (``data`` None)."""
    return x if data is None else data.all_gather(x, dim)


def bucket(n: int) -> int:
    """Round a token width up the ladder 1/2/4/8/..."""
    b = 1
    while b < n:
        b *= 2
    return b


def prefill_bucket(n: int, quantum: int) -> int:
    """Prefill length ladder: a prompt length rounded up to a multiple of
    ``quantum`` (bounds the pad overshoot to quantum - 1 positions)."""
    assert quantum > 0
    return max(quantum, -(-n // quantum) * quantum)


def prefill_rungs(lengths, quantum: int):
    """Distinct prefill-ladder rungs (ascending) a set of lengths lands on."""
    return sorted({prefill_bucket(n, quantum) for n in lengths if n > 0})


def kernel_route(ttemp: float, dtemp: float, device) -> bool:
    """Does the fused verify run through the CUDA ``verify_accept``
    kernel?  True on a CUDA device when both temperatures are > 0 (the
    kernel softmaxes pre-scaled logits; temperature 0 needs the one-hot
    probs path).  No override sends CUDA tensors elsewhere."""
    if ttemp <= 0.0 or dtemp <= 0.0:
        return False
    return torch.device(device).type == "cuda"


def _dev(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def _ugrid(base_key, rids, ctrs, width: int, device) -> torch.Tensor:
    return S.uniform_grid(base_key, torch.as_tensor(rids).cpu(),
                          torch.as_tensor(ctrs).cpu(), width).to(device)


def _chain_via_kernel(p_lg: torch.Tensor, q_lg: torch.Tensor,
                      toks: torch.Tensor, lens: torch.Tensor,
                      ugrid: torch.Tensor):
    """Chain verdict through the batched verify kernel: temperature-
    prescaled LOGITS in, per-position accept flags and residual samples
    out, then the leading-run reduction of ``verify_chain_device``.  The
    residual draw reuses the chain's final uniform ``ugrid[s, lens[s]]``
    broadcast as the kernel's per-position ``w``."""
    S_, R = toks.shape
    lens = lens.to(torch.int32)
    u_fin = torch.gather(ugrid, 1, lens.long()[:, None])[:, 0]
    w = u_fin[:, None].expand(S_, R).contiguous()
    acc, res, _, _ = ops.verify_accept_batched(
        p_lg.contiguous(), q_lg.contiguous(),
        toks.to(torch.int32).contiguous(), lens.contiguous(),
        ugrid[:, :R].contiguous(), w)
    within = torch.arange(R, device=toks.device)[None] < lens.long()[:, None]
    run = torch.cumprod(torch.where(within, acc, torch.ones_like(acc)), 1)
    n_acc = (run * within.to(torch.int32)).sum(1).to(torch.int32)
    all_acc = n_acc == lens
    nxt = torch.gather(res, 1, n_acc.long().clamp_max(R - 1)[:, None])[:, 0]
    nxt = torch.where(all_acc, torch.full_like(nxt, -1), nxt)
    return n_acc, nxt.to(torch.int32), all_acc


@torch.no_grad()
def tick_sample(lg: torch.Tensor, last, rids, ctrs, base_key, *,
                dtemp: float, stemp: float):
    """One fused draft-sampling tick over a batched forward's logits.

    Indexed BY DECODER ROW: lg (n_rows, T, V); last/rids/ctrs (n_rows,) —
    last-real-token column and PRNG coordinates of the request in each row
    (other rows carry (0, 0) and compute garbage the host ignores).
    Returns (tokens (n_rows,) i32 on the device, q_slice (n_rows, V) raw
    logits on the device, packed (n_rows, 2) f32 [token, confidence])."""
    dev = lg.device
    n = lg.shape[0]
    sl = lg[torch.arange(n, device=dev), _dev(last, dev, torch.int64)]
    qp = S.probs_from_logits(sl, dtemp)
    sg = S.probs_from_logits(sl, stemp)
    u = _ugrid(base_key, rids, ctrs, 1, dev)[:, 0]
    tok = S.categorical_from_uniform(qp, u)
    packed = torch.stack([tok.float(), sg.amax(-1)], dim=-1)
    return tok, sl, packed


@torch.no_grad()
def draft_chunk(lg: torch.Tensor, feats: torch.Tensor,
                final_norm: torch.Tensor, heads: torch.Tensor, last, rids,
                ctrs, base_key, *, g: int, dtemp: float, stemp: float,
                eps: float = 1e-6, cap=None):
    """One fused parallel-draft chunk, ``tick_sample``'s single-dispatch
    twin (DESIGN.md §7.12), over ONE draft forward that ingested each
    row's pending tokens plus ``g`` masked slots.

    Indexed BY DECODER ROW: lg (n_rows, T, V) the forward's logits, feats
    (n_rows, T, D) its final-layer (pre-final-norm) hidden states, last
    (n_rows,) the last REAL column (slot j, 1..g, rides at ``last + j``).
    final_norm (D,) and heads (K, D, V), K >= g, are the draft's norm
    scale and head stack.  Entry 0 of the distributions is the AR
    distribution at ``last``, entry i (1..g) head i on slot i.  Chunk
    token i is drawn from entry i-1 with the uniform at (rid, ctr + i):
    the coordinates g sequential ticks would consume.

    Returns (tok_stack (g, n_rows) i32, q_stack (g+1, n_rows, V) f32 raw
    logits — entries 0..g-1 feed the verify, entry g is the next-position
    signal distribution — and packed (n_rows, g+1, 2) f32 [token,
    confidence], row g carrying (-1, conf)), all on the device."""
    dev = lg.device
    n, T = lg.shape[0], lg.shape[1]
    last = _dev(last, dev, torch.int64)
    ar = lg[torch.arange(n, device=dev), last]                  # (n, V)
    j = torch.arange(1, g + 1, device=dev)[None]
    sidx = (last[:, None] + j).clamp(0, feats.shape[1] - 1)     # (n, g)
    hs = torch.gather(feats, 1,
                      sidx[..., None].expand(n, g, feats.shape[2]))
    hn = L.rms_norm(hs, final_norm, eps)
    hlg = L.softcap(torch.einsum("ngd,gdv->ngv", hn.float(),
                                 heads[:g].float()), cap)
    q_all = torch.cat([ar.float()[:, None], hlg], dim=1)       # (n, g+1, V)
    qp = S.probs_from_logits(q_all[:, :g], dtemp)
    u = _ugrid(base_key, rids, ctrs, g, dev)                    # (n, g)
    tok = S.categorical_from_uniform(qp, u)                     # (n, g)
    conf = S.probs_from_logits(q_all, stemp).amax(-1)           # (n, g+1)
    tokf = torch.cat([tok.float(),
                      torch.full((n, 1), -1.0, device=dev)], dim=1)
    packed = torch.stack([tokf, conf], dim=-1)
    return tok.T.contiguous(), q_all.transpose(0, 1), packed


def masked_token_column(tokens: torch.Tensor, mask) -> torch.Tensor:
    """(n_rows,) sampled tokens -> (n_rows, 1) step input with
    non-ingesting rows zeroed."""
    mask = _dev(mask, tokens.device, torch.bool)
    return torch.where(mask, tokens.to(torch.int32),
                       torch.zeros_like(tokens, dtype=torch.int32))[:, None]


@torch.no_grad()
def compose_verify_tokens(pend, npend, tok_stack: torch.Tensor, drows,
                          trows, *, n_rows: int, Tb: int) -> torch.Tensor:
    """Target-verify step input: row s holds pend[s] ++ drafted[s] padded
    to Tb, scattered into the target decoder's (n_rows, Tb) frame.  pend
    (S, P) host-staged pending tokens; npend (S,); tok_stack (g,
    n_draft_rows) the draft ticks' tokens (device); drows/trows (S,)."""
    dev = tok_stack.device
    pend = _dev(pend, dev, torch.int64)
    npend = _dev(npend, dev, torch.int64)
    S_, P = pend.shape
    g = tok_stack.shape[0]
    drafted = tok_stack[:, _dev(drows, dev, torch.int64)].T.long()
    t = torch.arange(Tb, device=dev)[None]
    pidx = t.clamp(0, P - 1).expand(S_, Tb)
    didx = (t - npend[:, None]).clamp(0, g - 1)
    vals = torch.where(t < npend[:, None], torch.gather(pend, 1, pidx),
                       torch.gather(drafted, 1, didx))
    full = torch.zeros((n_rows + 1, Tb), dtype=torch.int32, device=dev)
    # out-of-range rows are pad lanes: they land in a dropped extra row
    tr = _dev(trows, dev, torch.int64).clamp(0, n_rows)
    full[tr] = vals.to(torch.int32)
    return full[:n_rows]


@torch.no_grad()
def sps_verify(tlg: torch.Tensor, q_stack: torch.Tensor,
               tok_stack: torch.Tensor, trows, drows, npend, rids, ctrs,
               base_key, glens=None, *, g: int, ttemp: float, dtemp: float,
               kernel: bool = False) -> torch.Tensor:
    """Fused SpS verification: target-forward logits in, one small packet
    out.  tlg (n_rows, Tb, V); q_stack (g, n_draft_rows, V) raw draft
    logits from the ticks; tok_stack (g, n_draft_rows); trows/drows/
    npend (S,) target row, draft row and pending count per lane.  Row s
    uses uniforms (rid_s, ctr_s + 0..g): g accept tests and the residual
    or bonus draw.  ``glens`` (S,), optional: per-row real draft lengths
    <= g (the history predictor's per-request gamma); row s then verifies
    its own glens[s] tokens, takes its bonus at position glens[s] and its
    final uniform at offset glens[s].  ``kernel`` sends the
    accept/residual pass through the batched verify kernel on
    temperature-prescaled logits, with ``glens`` as the kernel's ragged
    ``lens``.  Returns the packet (S, 3 + g) i32 [n_acc, next_token,
    all_acc, drafted tokens]."""
    dev = tlg.device
    # pad lanes carry an out-of-range row: they read the last row, as the
    # reference's clamped gather does, and the host ignores them
    trows = _dev(trows, dev, torch.int64).clamp_max(tlg.shape[0] - 1)
    drows = _dev(drows, dev, torch.int64)
    npend = _dev(npend, dev, torch.int64)
    rowlg = tlg[trows]                                    # (S, Tb, V)
    S_, Tb, V = rowlg.shape
    j = torch.arange(g + 1, device=dev)[None]
    idx = (npend[:, None] - 1 + j).clamp(0, Tb - 1)
    pall = torch.gather(rowlg, 1, idx[..., None].expand(S_, g + 1, V))
    q_raw = q_stack[:, drows].transpose(0, 1)             # (S, g, V)
    drafted = tok_stack[:, drows].T.to(torch.int32)       # (S, g)
    ugrid = _ugrid(base_key, rids, ctrs, g + 1, dev)
    if glens is None:
        lens = torch.full((S_,), g, dtype=torch.int32, device=dev)
        bonus_lg = pall[:, g]
        u_fin = ugrid[:, g]
    else:
        lens = _dev(glens, dev, torch.int32).clamp(0, g)
        bonus_lg = pall[torch.arange(S_, device=dev), lens.long()]
        u_fin = torch.gather(ugrid, 1, lens.long()[:, None])[:, 0]
    bonus = S.probs_from_logits(bonus_lg, ttemp)
    if kernel:
        n_acc, nxt, all_acc = _chain_via_kernel(
            pall[:, :g] / ttemp, q_raw / dtemp, drafted, lens, ugrid)
        nxt = torch.where(all_acc,
                          S.categorical_from_uniform(bonus, u_fin)
                          .to(torch.int32), nxt)
    else:
        n_acc, nxt, all_acc = S.verify_chain_device(
            S.probs_from_logits(pall[:, :g], ttemp),
            S.probs_from_logits(q_raw, dtemp), drafted, lens, ugrid, bonus)
    return torch.cat([n_acc[:, None], nxt[:, None],
                      all_acc.to(torch.int32)[:, None], drafted], dim=1)


@torch.no_grad()
def draw_cands(qb_lg: torch.Tensor, rids, ctrs, base_key, *, K: int,
               stemp: float, mode: str) -> torch.Tensor:
    """Branch-point candidates from the stored q_b signal logits (S, V):
    mode "sample" draws K i.i.d. inverse-CDF samples at counter offsets
    0..K-1, "topk" takes the deterministic Top-K.  Returns (S, K) i32."""
    if mode == "topk":
        return torch.topk(qb_lg, K, dim=-1).indices.to(torch.int32)
    qb = S.probs_from_logits(qb_lg, stemp)
    ugrid = _ugrid(base_key, rids, ctrs, K, qb_lg.device)
    return S.categorical_from_uniform(qb[:, None, :].expand(-1, K, -1),
                                      ugrid)


@torch.no_grad()
def branch_verify(tlg: torch.Tensor, trows, npend, gch,
                  chunk_q: torch.Tensor, chunk_toks, cands, ks,
                  qb_lg: torch.Tensor, rids, ctrs, base_key, *,
                  CH: int, K: int, ttemp: float, dtemp: float, stemp: float,
                  kernel: bool = False) -> torch.Tensor:
    """Fused SpecBranch verdict: chain-verify each request's chunk (ragged
    lengths gch <= CH) AND run Algorithm 2 over its branch candidates,
    from one target forward's logits.

    chunk_q (S, CH, V) raw draft logits of the chunk; chunk_toks (S, CH);
    cands (S, K); ks (S,) real candidate counts; qb_lg (S, V) branch-point
    signal logits.  Uniforms per request: [0, gch] for the chain and
    [CH + 1, CH + 1 + ks] for the branch stage.  Returns the packet (S, 5)
    i32 [n_acc, chain_next, all_acc, accepted_branch, branch_token]."""
    dev = tlg.device
    # pad lanes carry an out-of-range row: they read the last row, as the
    # reference's clamped gather does, and the host ignores them
    trows = _dev(trows, dev, torch.int64).clamp_max(tlg.shape[0] - 1)
    npend = _dev(npend, dev, torch.int64)
    gch = _dev(gch, dev, torch.int64)
    rowlg = tlg[trows]
    S_, Tr, V = rowlg.shape
    j = torch.arange(CH + 1, device=dev)[None]
    idx = (npend[:, None] - 1 + j).clamp(0, Tr - 1)
    lall = torch.gather(rowlg, 1, idx[..., None].expand(S_, CH + 1, V))
    pall = S.probs_from_logits(lall, ttemp)
    p_b = pall[torch.arange(S_, device=dev), gch]
    W = CH + 1 + K + 1
    ugrid = _ugrid(base_key, rids, ctrs, W, dev)
    chunk_toks = _dev(chunk_toks, dev, torch.int32)
    if CH == 0:
        n_acc = torch.zeros((S_,), dtype=torch.int32, device=dev)
        nxt = torch.full((S_,), -1, dtype=torch.int32, device=dev)
        all_acc = torch.ones((S_,), dtype=torch.bool, device=dev)
    elif kernel:
        n_acc, nxt, all_acc = _chain_via_kernel(
            lall[:, :CH] / ttemp, chunk_q / dtemp, chunk_toks, gch,
            ugrid[:, :CH + 1])
    else:
        n_acc, nxt, all_acc = S.verify_chain_device(
            pall[:, :CH], S.probs_from_logits(chunk_q, dtemp), chunk_toks,
            gch, ugrid[:, :CH + 1], None)
    acc_b, tok_b = S.branch_verdict_device(
        p_b, S.probs_from_logits(qb_lg, stemp),
        _dev(cands, dev, torch.int64), _dev(ks, dev, torch.int64),
        ugrid[:, CH + 1:])
    return torch.stack([n_acc, nxt, all_acc.to(torch.int32), acc_b, tok_b],
                       dim=1)
