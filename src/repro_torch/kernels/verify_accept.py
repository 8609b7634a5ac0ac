"""Wrappers of the CUDA fused verification kernels
(``csrc/verify_accept.cu``), the ports of the Pallas TPU kernels
``repro.kernels.verify_accept.verify_accept_batched`` and
``repro.kernels.verify_accept.verify_accept`` (one per-row body, two
entry points).

Batched: p_logits, q_logits (B, R, V) f32; tokens (B, R) int32; lens (B,)
int32; uniforms, res_uniforms (B, R) f32.  Returns (accept (B, R) i32,
residual token (B, R) i32, p_tok (B, R) f32, q_tok (B, R) f32); positions
r >= lens[b] are zeros.

Single request: p_logits, q_logits (R, V) f32 or bf16; tokens (R,) int32;
uniforms, res_uniforms (R,) f32.  Returns the same four outputs at (R,).

Each row is one thread-block cluster of ``split_plan(V, rows, SMs)``
blocks, each owning a slice of V in shared memory (see the source note).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as _da

MAX_SPLIT = 8         # a cluster's portable size
MAX_SPLIT_WIDE = 16   # non-portable: only where a slice must shrink to fit
MIN_SLICE = 1024      # a slice keeps >= 4 elements per thread of its block
TARGET_SLICE = 4096   # ... and is split until it holds at most this many
MAX_SLICE = 28672     # two f32 slices in a block's 227 KB of shared memory


def split_plan(V: int, rows: int, sms: int) -> int:
    """Blocks per row (the cluster size): enough that a slice holds at most
    TARGET_SLICE elements, or that rows x splits gives one block per SM
    when rows are few, but no slice below MIN_SLICE elements; at most 8,
    or 16 where a slice of V / 8 would not fit in shared memory.  Raises
    ``ValueError`` for a V above 16 x MAX_SLICE."""
    n = min(MAX_SPLIT, math.ceil(V / MIN_SLICE),
            max(math.ceil(V / TARGET_SLICE), math.ceil(sms / max(rows, 1))))
    n = max(n, 1)
    if math.ceil(V / n) > MAX_SLICE:
        n = MAX_SPLIT_WIDE
        if math.ceil(V / n) > MAX_SLICE:
            raise ValueError(f"verify: V={V} exceeds "
                             f"{MAX_SPLIT_WIDE * MAX_SLICE}")
    return n


def _check(fn: str, args) -> None:
    """Raise unless every (name, tensor, dtype, shape) is a contiguous
    CUDA tensor of that dtype and shape."""
    for name, x, dtype, shape in args:
        if x.device.type != "cuda":
            raise ValueError(f"{fn}: {name} is on {x.device}")
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{fn}: {name} must be {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")


def verify_accept_batched(p_logits: torch.Tensor, q_logits: torch.Tensor,
                          tokens: torch.Tensor, lens: torch.Tensor,
                          uniforms: torch.Tensor, res_uniforms: torch.Tensor
                          ) -> Tuple[torch.Tensor, ...]:
    """Launch the batched kernel."""
    B, R, V = p_logits.shape
    _check("verify_accept_batched",
           (("p_logits", p_logits, torch.float32, (B, R, V)),
            ("q_logits", q_logits, torch.float32, (B, R, V)),
            ("tokens", tokens, torch.int32, (B, R)),
            ("lens", lens, torch.int32, (B,)),
            ("uniforms", uniforms, torch.float32, (B, R)),
            ("res_uniforms", res_uniforms, torch.float32, (B, R))))
    dev = p_logits.device
    acc = torch.empty((B, R), dtype=torch.int32, device=dev)
    res = torch.empty((B, R), dtype=torch.int32, device=dev)
    ptok = torch.empty((B, R), dtype=torch.float32, device=dev)
    qtok = torch.empty((B, R), dtype=torch.float32, device=dev)
    if B * R == 0:
        return acc, res, ptok, qtok
    n = split_plan(V, B * R, _da.sm_count(dev))
    L = build.lib()
    with torch.cuda.device(dev):
        rc = L.repro_verify_accept_batched(
            p_logits.data_ptr(), q_logits.data_ptr(), tokens.data_ptr(),
            lens.data_ptr(), uniforms.data_ptr(), res_uniforms.data_ptr(),
            acc.data_ptr(), res.data_ptr(), ptok.data_ptr(), qtok.data_ptr(),
            B, R, V, n, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "verify_accept_batched")
    build.LAUNCHES["verify_accept_batched"] += 1
    return acc, res, ptok, qtok


def verify_accept(p_logits: torch.Tensor, q_logits: torch.Tensor,
                  tokens: torch.Tensor, uniforms: torch.Tensor,
                  res_uniforms: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Launch the single-request kernel."""
    R, V = p_logits.shape
    dt = p_logits.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"verify_accept: logits dtype {dt} unsupported")
    _check("verify_accept",
           (("p_logits", p_logits, dt, (R, V)),
            ("q_logits", q_logits, dt, (R, V)),
            ("tokens", tokens, torch.int32, (R,)),
            ("uniforms", uniforms, torch.float32, (R,)),
            ("res_uniforms", res_uniforms, torch.float32, (R,))))
    dev = p_logits.device
    acc = torch.empty((R,), dtype=torch.int32, device=dev)
    res = torch.empty((R,), dtype=torch.int32, device=dev)
    ptok = torch.empty((R,), dtype=torch.float32, device=dev)
    qtok = torch.empty((R,), dtype=torch.float32, device=dev)
    if R == 0:
        return acc, res, ptok, qtok
    n = split_plan(V, R, _da.sm_count(dev))
    L = build.lib()
    with torch.cuda.device(dev):
        rc = L.repro_verify_accept(
            p_logits.data_ptr(), q_logits.data_ptr(), tokens.data_ptr(),
            uniforms.data_ptr(), res_uniforms.data_ptr(), acc.data_ptr(),
            res.data_ptr(), ptok.data_ptr(), qtok.data_ptr(), R, V,
            int(dt == torch.bfloat16), n,
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "verify_accept")
    build.LAUNCHES["verify_accept"] += 1
    return acc, res, ptok, qtok
