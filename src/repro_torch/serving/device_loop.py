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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.runtime import sampling as S

__all__ = ["bucket", "prefill_bucket", "prefill_rungs", "kernel_route",
           "tick_sample", "masked_token_column", "compose_verify_tokens",
           "draw_cands", "branch_verify"]


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
