"""Wrappers of the CUDA selective-scan kernel (``csrc/ssm_scan.cu``), the
port of the Pallas TPU kernel ``repro.kernels.ssm_scan.ssm_scan``: the
Mamba-1 recurrence h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t, y_t =
<h_t, C_t> + D x_t in float32, each (row, channel) on N/4 lanes.

x (B, T, E) float32 or bfloat16; dt (B, T, E), Bm and Cm (B, T, N), A
(E, N) and D (E,) float32.  ``ssm_scan`` takes h0 (B, E, N) and returns
(y (B, T, E), hT (B, E, N)) in float32 and, with ``return_states``, hs
(B, T, E, N): the post-step carry at every position.  ``ssm_scan_ring``
reads its initial state from, and writes its checkpoints into, a
serving checkpoint ring h_ring (rows, Rg, E, N) in place, and returns y
only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

N_SUPPORTED = (4, 8, 16)


def _check_scan(fn: str, x, dt, Bm, Cm, A, D, extra) -> None:
    """Raise unless the scan's inputs (and ``extra``: name -> (tensor,
    shape), float32) are contiguous CUDA tensors of the scan's dtypes and
    shapes with N in {4, 8, 16}; x is (B, T, E)."""
    B, T, E = x.shape
    N = A.shape[-1]
    if N not in N_SUPPORTED:
        raise ValueError(f"{fn}: state size N={N} not in {N_SUPPORTED}")
    want = {"dt": (dt, (B, T, E)), "Bm": (Bm, (B, T, N)),
            "Cm": (Cm, (B, T, N)), "A": (A, (E, N)), "D": (D, (E,)),
            **extra}
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{fn}: x dtype {x.dtype} unsupported")
    for name, (t, shape) in want.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} must be float32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    tensors = [("x", x)] + [(k, v[0]) for k, v in want.items()]
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
    for name, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} is on {t.device}")


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
             h0: torch.Tensor, *, return_states: bool = False
             ) -> Tuple[torch.Tensor, ...]:
    """Launch the kernel on CUDA tensors.  Raises ``ValueError`` for an N
    outside {4, 8, 16}, a dtype or shape it does not take, a
    non-contiguous tensor or a tensor off the card (checked in that
    order); ``RuntimeError`` on a launch error."""
    if x.dim() != 3:
        raise ValueError(f"ssm_scan: x must be (B, T, E), got "
                         f"{tuple(x.shape)}")
    B, T, E = x.shape
    N = A.shape[-1]
    _check_scan("ssm_scan", x, dt, Bm, Cm, A, D, {"h0": (h0, (B, E, N))})
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


def ssm_scan_ring(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                  Cm: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                  h_ring: torch.Tensor, p0: torch.Tensor,
                  rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The scan over a checkpoint ring h_ring (n_rows, Rg, E, N) float32,
    updated in place: lane b starts from h_ring[rows[b], p0[b] % Rg]
    (zeros where p0[b] == 0 or rows[b] < 0) and writes the post-step
    state of its trailing min(T, Rg) steps to slot (p0[b] + t + 1) % Rg;
    a lane with rows[b] < 0 writes nothing.  p0 (B,) int32 start
    positions, any stride (a column of the positions tensor); rows (B,)
    int32 or None (lane b is row b); no two live lanes may share a row.
    Returns y (B, T, E) float32.  Raises as ``ssm_scan`` does (h_ring
    among the tensors checked), and for p0 or rows of another dtype,
    shape or device."""
    if x.dim() != 3 or h_ring.dim() != 4:
        raise ValueError(f"ssm_scan_ring: x must be (B, T, E) and h_ring "
                         f"(rows, Rg, E, N), got {tuple(x.shape)} and "
                         f"{tuple(h_ring.shape)}")
    B, T, E = x.shape
    N = A.shape[-1]
    n_rows, Rg = h_ring.shape[:2]
    for name, t in (("p0", p0), ("rows", rows)):
        if t is not None and (t.dtype != torch.int32
                              or tuple(t.shape) != (B,)):
            raise ValueError(f"ssm_scan_ring: {name} must be int32 ({B},), "
                             f"got {t.dtype} {tuple(t.shape)}")
    if rows is not None and not rows.is_contiguous():
        raise ValueError("ssm_scan_ring: rows is not contiguous")
    _check_scan("ssm_scan_ring", x, dt, Bm, Cm, A, D,
                {"h_ring": (h_ring, (n_rows, Rg, E, N))})
    for name, t in (("p0", p0), ("rows", rows)):
        if t is not None and t.device != x.device:
            raise ValueError(f"ssm_scan_ring: {name} is on {t.device}")
    if rows is None and n_rows < B:
        raise ValueError(f"ssm_scan_ring: {B} lanes but {n_rows} ring rows")
    y = torch.empty((B, T, E), dtype=torch.float32, device=x.device)
    if B == 0 or E == 0:
        return y
    L = build.lib()
    with torch.cuda.device(x.device):
        rc = L.repro_ssm_scan_ring(
            x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A.data_ptr(), D.data_ptr(), h_ring.data_ptr(), p0.data_ptr(),
            rows.data_ptr() if rows is not None else None, y.data_ptr(),
            p0.stride(0), Rg, B, T, E, N, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "ssm_scan_ring")
    build.LAUNCHES["ssm_scan_ring"] += 1
    return y
