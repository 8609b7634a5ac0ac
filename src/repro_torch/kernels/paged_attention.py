"""Wrapper of the CUDA paged decode-attention kernel
(``csrc/paged_attention.cu``), the port of the Pallas TPU kernel
``repro.kernels.paged_attention.paged_decode_attention``.

Layout as in the reference: q (B, T, H, hd); k/v pages (P, ps, KV, hd)
with the trash page last; table (B, n_max) int32; lens (B,) int32 valid
KV length per row including the T query tokens; q_start (B,) int32
absolute position of q[:, 0].  A block holds 16 query rows (G heads x
tokens, so T is tiled) of one kv head, and the key axis is split when
those blocks would leave SMs idle (``kernels.decode_attention``).

The kernel's tile loop (``csrc/decode_attention.cuh``) is shared with
the branch-decode and flash kernels, built for the head dims in
``decode_attention.HEAD_DIMS``; ``check_rows16`` serves all three
attention wrappers.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as DA


def check_rows16(name: str, hd: int, k: torch.Tensor,
                 v: torch.Tensor) -> None:
    """The kernels load K/V (and the decode kernels q) 16 bytes at a time:
    a row of hd values must span a multiple of 16 bytes and both tensors
    start 16-byte aligned."""
    if (hd * k.element_size()) % 16:
        raise ValueError(f"{name}: rows of hd={hd} {k.dtype} values are "
                         "not a multiple of 16 bytes")
    for x in (k, v):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: storage is not 16-byte aligned")


def split_plan(B: int, T: int, H: int, KV: int, n_max: int, ps: int,
               sm_count: int) -> Tuple[int, int]:
    """(n_split, split_len) of a call: B x row tiles x kv heads blocks,
    the key axis planned from ``n_max * ps``."""
    return DA.plan_splits(B * DA.row_tiles(T * (H // KV)) * KV, n_max * ps,
                          sm_count)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, table: torch.Tensor,
                    lens: torch.Tensor, q_start: torch.Tensor, *,
                    window: int = 0, cap: Optional[float] = None
                    ) -> torch.Tensor:
    """Launch the kernel (one launch, split-KV included) on CUDA tensors;
    returns (B, T, H, hd) in q's dtype.  Raises on a CPU tensor, a bad
    dtype/shape/head dim or a launch error."""
    B, T, H, hd = q.shape
    P, ps, KV, hd_k = k_pages.shape
    n_max = table.shape[1]
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("table", table), ("lens", lens), ("q_start", q_start)):
        if x.device.type != "cuda":
            raise ValueError(f"paged_attention: {name} is on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"paged_attention: {name} is not contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_attention: dtype {q.dtype} unsupported")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_attention: q and pages differ in dtype")
    if v_pages.shape != k_pages.shape or hd_k != hd or H % KV:
        raise ValueError("paged_attention: shape mismatch "
                         f"q{tuple(q.shape)} k{tuple(k_pages.shape)}")
    for name, x, shape in (("table", table, (B, n_max)), ("lens", lens, (B,)),
                           ("q_start", q_start, (B,))):
        if x.dtype != torch.int32 or tuple(x.shape) != shape:
            raise ValueError(f"paged_attention: {name} must be int32 "
                             f"{shape}, got {x.dtype} {tuple(x.shape)}")
    check_rows16("paged_attention", hd, k_pages, v_pages)
    check_rows16("paged_attention", hd, q, q)
    DA.check_head_dim("paged_attention", hd)
    L = build.lib()
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    n_split, split_len = split_plan(B, T, H, KV, n_max, ps,
                                    DA.sm_count(q.device))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = L.repro_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table.data_ptr(), lens.data_ptr(), q_start.data_ptr(),
            out.data_ptr(), B, T, H, KV, hd, ps, n_max, n_split, split_len,
            int(window),
            float(cap) if cap is not None else 0.0, 1.0 / math.sqrt(hd),
            int(q.dtype == torch.bfloat16), stream)
    build.check(rc, "paged_attention")
    build.LAUNCHES["paged_attention"] += 1
    return out
