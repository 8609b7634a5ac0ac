"""Wrapper of the CUDA fused batched verification kernel
(``csrc/verify_accept.cu``), the port of the Pallas TPU kernel
``repro.kernels.verify_accept.verify_accept_batched``.

p_logits, q_logits (B, R, V) f32; tokens (B, R) int32; lens (B,) int32;
uniforms, res_uniforms (B, R) f32.  Returns (accept (B, R) i32, residual
token (B, R) i32, p_tok (B, R) f32, q_tok (B, R) f32); positions
r >= lens[b] are zeros.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build


def verify_accept_batched(p_logits: torch.Tensor, q_logits: torch.Tensor,
                          tokens: torch.Tensor, lens: torch.Tensor,
                          uniforms: torch.Tensor, res_uniforms: torch.Tensor
                          ) -> Tuple[torch.Tensor, ...]:
    B, R, V = p_logits.shape
    args = (("p_logits", p_logits, torch.float32, (B, R, V)),
            ("q_logits", q_logits, torch.float32, (B, R, V)),
            ("tokens", tokens, torch.int32, (B, R)),
            ("lens", lens, torch.int32, (B,)),
            ("uniforms", uniforms, torch.float32, (B, R)),
            ("res_uniforms", res_uniforms, torch.float32, (B, R)))
    for name, x, dtype, shape in args:
        if x.device.type != "cuda":
            raise ValueError(f"verify_accept_batched: {name} is on "
                             f"{x.device}")
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"verify_accept_batched: {name} must be "
                             f"{dtype} {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"verify_accept_batched: {name} is not "
                             "contiguous")
    dev = p_logits.device
    acc = torch.empty((B, R), dtype=torch.int32, device=dev)
    res = torch.empty((B, R), dtype=torch.int32, device=dev)
    ptok = torch.empty((B, R), dtype=torch.float32, device=dev)
    qtok = torch.empty((B, R), dtype=torch.float32, device=dev)
    if B * R == 0:
        return acc, res, ptok, qtok
    L = build.lib()
    with torch.cuda.device(dev):
        rc = L.repro_verify_accept_batched(
            p_logits.data_ptr(), q_logits.data_ptr(), tokens.data_ptr(),
            lens.data_ptr(), uniforms.data_ptr(), res_uniforms.data_ptr(),
            acc.data_ptr(), res.data_ptr(), ptok.data_ptr(), qtok.data_ptr(),
            B, R, V, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "verify_accept_batched")
    build.LAUNCHES["verify_accept_batched"] += 1
    return acc, res, ptok, qtok
