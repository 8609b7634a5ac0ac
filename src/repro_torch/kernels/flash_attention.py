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

``flash_attention_bwd`` launches the backward kernels
(``csrc/flash_attention_bwd.cu``: dq, and dk / dv summed over each kv
head's query heads, for the forward's whole contract; on the tensor
cores, bf16 as ``mma`` over bf16 tiles and f32 as 3xTF32 tiles, each f32
value split into two TF32 terms; ``bwd_plan`` gives their grids and
scratch), and
``FlashAttentionFn`` joins the two for autograd: its forward launches the
forward kernel unchanged and saves q, k, v, the output and the
positions; its backward launches the backward kernel.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as DA


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


# the backward kernels' tiles (csrc/flash_attention_bwd.cu): position
# summaries of SPAN rows or keys; at bf16 the dq kernel's 4-warp blocks of
# BWD_ROWS query rows over key tiles of 32 keys (16 above hd 128), the
# dk/dv kernel's blocks of BWD_KEYS keys over tiles of BWD_RTILE rows; at
# f32 one-warp blocks of BWD_F32_ROWS rows over key tiles of SPAN keys and
# of BWD_F32_KEYS keys over tiles of SPAN rows, two blocks a key block
# above hd 128 (each sums half of dk's and dv's columns); each block's
# walk split into chunks
# (``bwd_chunks``: about TARGET_BLOCKS blocks at bf16, at most MAX_CHUNKS;
# F32_TARGET at f32 (eight an SM: the f32 frames are small and
# latency-bound), down to single tiles, at most F32_MAX_CHUNKS)
SPAN, BWD_ROWS, BWD_KEYS, BWD_RTILE = 16, 64, 32, 32
TARGET_BLOCKS, MIN_CHUNK, MAX_CHUNKS = 800, 8, 8
BWD_F32_ROWS, BWD_F32_KEYS, F32_TARGET, F32_MIN_CHUNK = 16, 16, 1056, 1
F32_MAX_CHUNKS = 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bwd_chunks(n_tiles: int, n_units: int, target: int = TARGET_BLOCKS,
               min_chunk: int = MIN_CHUNK,
               max_chunks: int = MAX_CHUNKS) -> int:
    """Chunks each of ``n_units`` walks of ``n_tiles`` tiles is split into
    (the C entry's ``chunks_of``): as many as bring the grid to about
    ``target`` blocks, each at least ``min_chunk`` tiles, at most
    ``max_chunks``."""
    n = min(_cdiv(target, n_units), n_tiles // min_chunk)
    return max(1, min(max_chunks, n))


def bwd_plan(B: int, T: int, S: int, H: int, KV: int, width: int,
             dtype: torch.dtype) -> dict:
    """The backward's launches and scratch at the compiled ``width`` a
    head dim runs at (``decode_attention.head_dim_path``; the head dim
    itself on the aligned path): ``blocks`` of each kernel, ``chunks`` of
    the dq and dk/dv walks, and the f32 (``work``) and int32 (``ints``)
    scratch elements the C entry lays out (the chunks' sums have rows of
    ``width`` columns).  bf16 launches six kernels (the summaries, the row
    records, the dq chunks on ``mma`` blocks of four warps, their merge,
    the dk/dv chunks, their sum), f32 four (``prep``: the summaries and
    row records; the 3xTF32 dq and dk/dv chunks on one-warp blocks;
    ``final``: the dq merge and the dk/dv sum).  The C entry refuses
    scratch of any other size than its own layout's."""
    rows = T * (H // KV)
    n_spans = _cdiv(rows, SPAN) + _cdiv(S, SPAN)
    if dtype == torch.bfloat16:
        q_blk, k_blk, r_tile, splits = BWD_ROWS, BWD_KEYS, BWD_RTILE, 1
        key_tile = 16 if width > 128 else 32
        target, min_chunk, max_chunks = TARGET_BLOCKS, MIN_CHUNK, MAX_CHUNKS
    else:
        q_blk, k_blk = BWD_F32_ROWS, BWD_F32_KEYS
        key_tile = r_tile = SPAN
        splits = 2 if width > 128 else 1
        target, min_chunk = F32_TARGET, F32_MIN_CHUNK
        max_chunks = F32_MAX_CHUNKS
    n_rb, n_kb = _cdiv(rows, q_blk), _cdiv(S, k_blk)
    n_cq = bwd_chunks(_cdiv(S, key_tile), B * KV * n_rb, target, min_chunk,
                      max_chunks)
    n_ck = bwd_chunks(_cdiv(rows, r_tile), B * KV * n_kb * splits, target,
                      min_chunk, max_chunks)
    q_rows = n_cq * B * KV * n_rb * q_blk
    row_warps = _cdiv(B * KV * rows, 4)          # one row a warp
    blocks = {"spans": B * _cdiv(n_spans * SPAN, 128),
              "rows": row_warps,
              "dq": B * KV * n_rb * n_cq,
              "dq_merge": row_warps,
              "dkdv": B * KV * n_kb * splits * n_ck,
              "dkdv_reduce": _cdiv(B * S * KV * width // 4, 128)}
    if dtype != torch.bfloat16:
        blocks = {"prep": blocks["spans"] + blocks["rows"],
                  "dq": blocks["dq"], "dkdv": blocks["dkdv"],
                  "final": blocks["dq_merge"] + blocks["dkdv_reduce"]}
    return {"work": 4 * B * H * T + q_rows * (2 + width)
                    + n_ck * 2 * B * n_kb * k_blk * KV * width,
            "ints": 4 * B * n_spans + B * KV * n_kb * n_ck,
            "chunks": {"dq": n_cq, "dkdv": n_ck},
            "blocks": blocks}


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
    width, ragged = DA.head_dim_path("flash_attention", hd, q, k, v)
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
            B, T, S, H, KV, hd, width, int(ragged),
            int(block_rows(T, H, KV) == DA.WIDE_ROWS),
            n_split, split_len, int(causal), int(window),
            float(cap) if cap is not None else 0.0, 1.0 / math.sqrt(hd),
            int(q.dtype == torch.bfloat16), stream)
    build.check(rc, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, dout: torch.Tensor,
                        q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        cap: Optional[float] = None,
                        q_ctx: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """Launch the backward kernels (one call, on the current stream: the
    position summaries, the row records, the dq chunks and their merge,
    the dk/dv chunks and their sum) on CUDA tensors: o is the forward's
    output and dout its gradient, both (B, T, H, hd) in q's dtype.
    Returns (dq, dk, dv) in the dtypes of q, k, v.  Raises as
    ``flash_attention`` does."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if q_ctx is None:
        q_ctx = q_pos
    for name, x in (("q", q), ("k", k), ("v", v), ("o", o), ("dout", dout),
                    ("q_pos", q_pos), ("k_pos", k_pos), ("q_ctx", q_ctx)):
        if x.device.type != "cuda":
            raise ValueError(f"flash_attention_bwd: {name} is on {x.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention_bwd: dtype {q.dtype} unsupported")
    if any(x.dtype != q.dtype for x in (k, v, o, dout)):
        raise TypeError("flash_attention_bwd: q, k, v, o and dout differ "
                        "in dtype")
    if (tuple(k.shape) != (B, S, KV, hd) or v.shape != k.shape
            or o.shape != q.shape or dout.shape != q.shape or H % KV):
        raise ValueError("flash_attention_bwd: shape mismatch "
                         f"q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} o{tuple(o.shape)} "
                         f"dout{tuple(dout.shape)}")
    for name, x, shape in (("q_pos", q_pos, (B, T)), ("q_ctx", q_ctx, (B, T)),
                           ("k_pos", k_pos, (B, S))):
        if tuple(x.shape) != shape or x.dtype.is_floating_point:
            raise ValueError(f"flash_attention_bwd: {name} must be integer "
                             f"{shape}, got {x.dtype} {tuple(x.shape)}")
    q, k, v, o, dout = (x.contiguous() for x in (q, k, v, o, dout))
    width, ragged = DA.head_dim_path("flash_attention_bwd", hd, q, k, v, o,
                                     dout)
    q_pos, k_pos, q_ctx = (x.to(torch.int32).contiguous()
                           for x in (q_pos, k_pos, q_ctx))
    if B == 0 or T == 0 or S == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    L = build.lib()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    plan = bwd_plan(B, T, S, H, KV, width, q.dtype)
    work = torch.empty(plan["work"], dtype=torch.float32, device=q.device)
    ints = torch.empty(plan["ints"], dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        rc = L.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), q_pos.data_ptr(), q_ctx.data_ptr(),
            k_pos.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            work.data_ptr(), work.numel(), ints.data_ptr(), ints.numel(),
            B, T, S, H, KV, hd, width,
            int(ragged), int(causal), int(window),
            float(cap) if cap is not None else 0.0, 1.0 / math.sqrt(hd),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "flash_attention_bwd")
    build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with its backward kernel for autograd.
    ``apply(q, k, v, q_pos, k_pos, q_ctx, causal, window, cap)``; q_ctx
    may be None.  Gradients flow to q, k and v only."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, q_ctx, causal, window, cap):
        out = flash_attention(q, k, v, q_pos, k_pos, causal=causal,
                              window=window, cap=cap, q_ctx=q_ctx)
        ctx.save_for_backward(q, k, v, out, q_pos, k_pos, q_ctx)
        ctx.opts = (causal, window, cap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, q_pos, k_pos, q_ctx = ctx.saved_tensors
        causal, window, cap = ctx.opts
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, q_pos, k_pos,
                                         causal=causal, window=window,
                                         cap=cap, q_ctx=q_ctx)
        return dq, dk, dv, None, None, None, None, None, None
