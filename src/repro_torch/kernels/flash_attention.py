"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``),
the port of the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention``: online-softmax GQA
attention over position-masked dense KV — the dense ring cache of the
sequential runner and the cache-less forward.

Layout as in ``layers.attend``: q (B, T, H, hd); k, v (B, S, KV, hd);
q_pos, q_ctx (B, T) and k_pos (B, S) int32 absolute positions, k_pos -1
marking an invalid slot.  A key s is visible to query t when
``k_pos >= 0``, ``k_pos <= q_ctx`` (causal) and ``q_pos - k_pos < window``
(window > 0).  The kernel's tile loop (``csrc/decode_attention.cuh``) is
the paged and branch-decode kernels': one block holds 16 query rows (G
heads x tokens, so T is tiled) of one kv head, or 64 (its wide block)
when an item has that many, and the key axis is split when those blocks
would leave SMs idle, planned from S (``kernels.decode_attention``).

A query that sees no key at all gets zeros (the plain version averages V
over its padded width there); the sequential runner never produces one,
because every query's own key is written before it attends.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels.paged_attention import check_rows16


def block_rows(T: int, H: int, KV: int) -> int:
    """Query rows a block holds: ``WIDE_ROWS`` when an item has that many
    rows per kv head (G heads x T tokens), else ``ROWS``."""
    return DA.WIDE_ROWS if T * (H // KV) >= DA.WIDE_ROWS else DA.ROWS


def split_plan(B: int, T: int, H: int, KV: int, S: int,
               sm_count: int) -> Tuple[int, int]:
    """(n_split, split_len) of a call: B x row blocks x kv heads blocks,
    the key axis planned from S."""
    rows = block_rows(T, H, KV)
    return DA.plan_splits(B * DA.row_tiles(T * (H // KV), rows) * KV, S,
                          sm_count)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    cap: Optional[float] = None,
                    q_ctx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel (one launch, split-KV included) on CUDA tensors;
    returns (B, T, H, hd) in q's dtype.  Non-contiguous inputs are copied,
    positions cast to int32; raises on a CPU tensor, a bad
    dtype/shape/head dim or a launch error."""
    B, T, H, hd = q.shape
    Bk, S, KV, hd_k = k.shape
    if q_ctx is None:
        q_ctx = q_pos
    args = {"q": q, "k": k, "v": v, "q_pos": q_pos, "k_pos": k_pos,
            "q_ctx": q_ctx}
    for name, x in args.items():
        if x.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {x.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: dtype {q.dtype} unsupported")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v differ in dtype")
    if (Bk != B or v.shape != k.shape or hd_k != hd or H % KV):
        raise ValueError("flash_attention: shape mismatch "
                         f"q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    for name, x, shape in (("q_pos", q_pos, (B, T)), ("q_ctx", q_ctx, (B, T)),
                           ("k_pos", k_pos, (B, S))):
        if tuple(x.shape) != shape or x.dtype.is_floating_point:
            raise ValueError(f"flash_attention: {name} must be integer "
                             f"{shape}, got {x.dtype} {tuple(x.shape)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    q_pos, k_pos, q_ctx = (x.to(torch.int32).contiguous()
                           for x in (q_pos, k_pos, q_ctx))
    check_rows16("flash_attention", hd, k, v)
    check_rows16("flash_attention", hd, q, q)
    DA.check_head_dim("flash_attention", hd)
    L = build.lib()
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    n_split, split_len = split_plan(B, T, H, KV, S, DA.sm_count(q.device))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = L.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            q_ctx.data_ptr(), k_pos.data_ptr(), out.data_ptr(),
            B, T, S, H, KV, hd, int(block_rows(T, H, KV) == DA.WIDE_ROWS),
            n_split, split_len, int(causal), int(window),
            float(cap) if cap is not None else 0.0, 1.0 / math.sqrt(hd),
            int(q.dtype == torch.bfloat16), stream)
    build.check(rc, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    return out
