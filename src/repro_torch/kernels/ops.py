"""Routes for the port's kernels (port of ``repro.kernels.ops``).

A tensor on the CPU takes the kernel's plain PyTorch version
(``kernels.ref``); a CUDA tensor launches the hand-written CUDA kernel or
raises.  There is no override that sends CUDA tensors to the plain
version and no ``try`` that falls back to it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import branch_attention as _ba
from repro_torch.kernels import build, ref
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged as _paged
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ssm_scan as _ssm
from repro_torch.kernels import verify_accept as _va

LAUNCHES = build.LAUNCHES
reset_launches = build.reset_launches


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    cap: Optional[float] = None, kv_chunk: int = 2048,
                    q_ctx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over position-masked dense KV (see
    kernels.flash_attention); ``kv_chunk`` sizes the plain version's
    chunks only."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, q_pos, k_pos, causal=causal,
                                       window=window, cap=cap,
                                       kv_chunk=kv_chunk, q_ctx=q_ctx)
    return _fa.flash_attention(q, k, v, q_pos, k_pos, causal=causal,
                               window=window, cap=cap, q_ctx=q_ctx)


def branch_decode_attention(q: torch.Tensor, prefix_k: torch.Tensor,
                            prefix_v: torch.Tensor, prefix_pos: torch.Tensor,
                            suffix_k: torch.Tensor, suffix_v: torch.Tensor,
                            suffix_pos: torch.Tensor, q_pos: torch.Tensor, *,
                            cap: Optional[float] = None) -> torch.Tensor:
    """Shared-prefix branch decode (Eq. 8): q (k, Tq, H, hd), one row per
    branch; prefix K/V (1, Sp, KV, hd) stored once; suffix K/V (k, Ss, KV,
    hd) per branch (see kernels.branch_attention)."""
    if q.device.type == "cpu":
        return ref.branch_decode_ref(q, prefix_k, prefix_v, prefix_pos,
                                     suffix_k, suffix_v, suffix_pos, q_pos,
                                     cap=cap)
    return _ba.branch_decode_attention(q, prefix_k, prefix_v, prefix_pos,
                                       suffix_k, suffix_v, suffix_pos, q_pos,
                                       cap=cap)


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


def verify_accept(p_logits: torch.Tensor, q_logits: torch.Tensor,
                  tokens: torch.Tensor, uniforms: torch.Tensor,
                  res_uniforms: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Single-request verification of (R, V) logits (see
    kernels.verify_accept)."""
    if p_logits.device.type == "cpu":
        return ref.verify_accept_ref(p_logits, q_logits, tokens, uniforms,
                                     res_uniforms)
    return _va.verify_accept(p_logits, q_logits, tokens, uniforms,
                             res_uniforms)


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


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
             h0: torch.Tensor, *, return_states: bool = False
             ) -> Tuple[torch.Tensor, ...]:
    """Mamba-1 selective scan (see kernels.ssm_scan); with
    ``return_states`` also the post-step carry at every position."""
    if x.device.type == "cpu":
        return ref.ssm_scan_ref(x, dt, Bm, Cm, A, D, h0,
                                return_states=return_states)
    return _ssm.ssm_scan(x, dt, Bm, Cm, A, D, h0,
                         return_states=return_states)


def ssm_scan_ring(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                  Cm: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                  h_ring: torch.Tensor, p0: torch.Tensor,
                  rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The scan over a Mamba checkpoint ring, read and written in place
    (see kernels.ssm_scan.ssm_scan_ring); returns y."""
    if x.device.type == "cpu":
        return ref.ssm_scan_ring_ref(x, dt, Bm, Cm, A, D, h_ring, p0, rows)
    return _ssm.ssm_scan_ring(x, dt, Bm, Cm, A, D, h_ring, p0, rows)
