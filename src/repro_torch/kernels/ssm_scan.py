"""Wrapper of the CUDA selective-scan kernel (``csrc/ssm_scan.cu``), the
port of the Pallas TPU kernel ``repro.kernels.ssm_scan.ssm_scan``: the
Mamba-1 recurrence h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t, y_t =
<h_t, C_t> + D x_t in float32, one thread per (row, channel).

x (B, T, E) float32 or bfloat16; dt (B, T, E), Bm and Cm (B, T, N), A
(E, N), D (E,) and h0 (B, E, N) float32.  Returns (y (B, T, E), hT (B,
E, N)) in float32 and, with ``return_states``, hs (B, T, E, N): the
post-step carry at every position (the checkpoint ring's writes).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

N_SUPPORTED = (4, 8, 16)


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
             h0: torch.Tensor, *, return_states: bool = False
             ) -> Tuple[torch.Tensor, ...]:
    """Launch the kernel on CUDA tensors.  Raises ``ValueError`` for a
    tensor off the card, a dtype or shape it does not take, a
    non-contiguous tensor or an N outside {4, 8, 16}; ``RuntimeError``
    on a launch error."""
    if x.dim() != 3:
        raise ValueError(f"ssm_scan: x must be (B, T, E), got "
                         f"{tuple(x.shape)}")
    B, T, E = x.shape
    N = A.shape[-1]
    if N not in N_SUPPORTED:
        raise ValueError(f"ssm_scan: state size N={N} not in {N_SUPPORTED}")
    want = {"dt": (dt, (B, T, E)), "Bm": (Bm, (B, T, N)),
            "Cm": (Cm, (B, T, N)), "A": (A, (E, N)), "D": (D, (E,)),
            "h0": (h0, (B, E, N))}
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ssm_scan: x dtype {x.dtype} unsupported")
    for name, t in [("x", x)] + [(k, v[0]) for k, v in want.items()]:
        if t.device.type != "cuda":
            raise ValueError(f"ssm_scan: {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan: {name} is not contiguous")
    for name, (t, shape) in want.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"ssm_scan: {name} must be float32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    dev = x.device
    y = torch.empty((B, T, E), dtype=torch.float32, device=dev)
    hT = torch.empty((B, E, N), dtype=torch.float32, device=dev)
    hs = (torch.empty((B, T, E, N), dtype=torch.float32, device=dev)
          if return_states else None)
    if B == 0 or E == 0:
        return (y, hT, hs) if return_states else (y, hT)
    L = build.lib()
    with torch.cuda.device(dev):
        rc = L.repro_ssm_scan(
            x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A.data_ptr(), D.data_ptr(), h0.data_ptr(), y.data_ptr(),
            hT.data_ptr(), hs.data_ptr() if hs is not None else None,
            B, T, E, N, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "ssm_scan")
    build.LAUNCHES["ssm_scan"] += 1
    return (y, hT, hs) if return_states else (y, hT)
