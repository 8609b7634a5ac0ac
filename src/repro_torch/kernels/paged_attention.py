"""Wrapper of the CUDA paged decode-attention kernel
(``csrc/paged_attention.cu``), the port of the Pallas TPU kernel
``repro.kernels.paged_attention.paged_decode_attention``.

Layout as in the reference: q (B, T, H, hd); k/v pages (P, ps, KV, hd)
with the trash page last; table (B, n_max) int32; lens (B,) int32 valid
KV length per row including the T query tokens; q_start (B,) int32
absolute position of q[:, 0].  The kernel tiles T so that G * T_tile
query rows share each page tile read (``ROWS_MAX`` rows per block).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build

ROWS_MAX = 64                  # query rows (G * T_tile) per block
SMEM_LIMIT = 232_448           # bytes a block may use on sm_90


def t_tile(T: int, G: int) -> int:
    if G > ROWS_MAX:
        raise ValueError(f"{G} query heads per kv head exceed {ROWS_MAX}")
    return max(1, min(T, ROWS_MAX // G))


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, table: torch.Tensor,
                    lens: torch.Tensor, q_start: torch.Tensor, *,
                    window: int = 0, cap: Optional[float] = None
                    ) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns (B, T, H, hd) in q's
    dtype.  Raises on a CPU tensor, a bad dtype/shape or a launch error."""
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
    tt = t_tile(T, H // KV)
    L = build.lib()
    if L.repro_paged_attention_smem((H // KV) * tt, hd, ps) > SMEM_LIMIT:
        raise ValueError("paged_attention: tile exceeds shared memory "
                         f"(hd={hd}, ps={ps})")
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = L.repro_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table.data_ptr(), lens.data_ptr(), q_start.data_ptr(),
            out.data_ptr(), B, T, H, KV, hd, ps, n_max, tt, int(window),
            float(cap) if cap is not None else 0.0, 1.0 / math.sqrt(hd),
            int(q.dtype == torch.bfloat16), stream)
    build.check(rc, "paged_attention")
    build.LAUNCHES["paged_attention"] += 1
    return out
