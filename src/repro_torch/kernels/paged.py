"""Wrapper of the CUDA paged-gather kernel (``csrc/paged_gather.cu``),
the port of the Pallas TPU kernel ``repro.kernels.paged.paged_gather``.

pages (P, ps, dim) f32; table (n,) int32; rows at or past ``valid_len``
come back as zeros.  Returns (n * ps, dim).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def paged_gather(pages: torch.Tensor, table: torch.Tensor,
                 valid_len: int) -> torch.Tensor:
    P, ps, dim = pages.shape
    n = table.shape[0]
    for name, x in (("pages", pages), ("table", table)):
        if x.device.type != "cuda":
            raise ValueError(f"paged_gather: {name} is on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"paged_gather: {name} is not contiguous")
    if pages.dtype != torch.float32 or table.dtype != torch.int32 \
            or table.dim() != 1:
        raise ValueError("paged_gather: needs f32 pages and an int32 (n,) "
                         f"table, got {pages.dtype} {table.dtype} "
                         f"{tuple(table.shape)}")
    out = torch.empty((n * ps, dim), dtype=pages.dtype, device=pages.device)
    if n == 0:
        return out
    L = build.lib()
    with torch.cuda.device(pages.device):
        rc = L.repro_paged_gather(
            pages.data_ptr(), table.data_ptr(), out.data_ptr(), n, ps, dim,
            int(valid_len), torch.cuda.current_stream().cuda_stream)
    build.check(rc, "paged_gather")
    build.LAUNCHES["paged_gather"] += 1
    return out
