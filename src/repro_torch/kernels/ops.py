"""Routes for the port's kernels (port of ``repro.kernels.ops``).

A tensor on the CPU takes the kernel's plain PyTorch version
(``kernels.ref``); a CUDA tensor launches the hand-written CUDA kernel or
raises.  There is no override that sends CUDA tensors to the plain
version and no ``try`` that falls back to it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import paged as _paged
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import verify_accept as _va

LAUNCHES = build.LAUNCHES
reset_launches = build.reset_launches


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, table: torch.Tensor,
                    lens: torch.Tensor, q_start: torch.Tensor, *,
                    window: int = 0, cap: Optional[float] = None
                    ) -> torch.Tensor:
    """Decode attention straight over paged KV through a page table."""
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pages, v_pages, table, lens,
                                       q_start, window=window, cap=cap)
    return _pa.paged_attention(q, k_pages, v_pages, table, lens, q_start,
                               window=window, cap=cap)


def verify_accept_batched(p_logits: torch.Tensor, q_logits: torch.Tensor,
                          tokens: torch.Tensor, lens: torch.Tensor,
                          uniforms: torch.Tensor, res_uniforms: torch.Tensor
                          ) -> Tuple[torch.Tensor, ...]:
    """Batched ragged verification (see kernels.verify_accept)."""
    if p_logits.device.type == "cpu":
        return ref.verify_accept_batched_ref(p_logits, q_logits, tokens,
                                             lens, uniforms, res_uniforms)
    return _va.verify_accept_batched(p_logits, q_logits, tokens, lens,
                                     uniforms, res_uniforms)


def paged_gather(pages: torch.Tensor, table: torch.Tensor,
                 valid_len: int) -> torch.Tensor:
    """Gather logical pages through a page table (see kernels.paged)."""
    if pages.device.type == "cpu":
        return ref.paged_gather_ref(pages, table, valid_len)
    return _paged.paged_gather(pages, table, valid_len)
