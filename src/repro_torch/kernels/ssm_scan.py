"""Wrappers of the CUDA selective-scan kernel (``csrc/ssm_scan.cu``), the
port of the Pallas TPU kernel ``repro.kernels.ssm_scan.ssm_scan``: the
Mamba-1 recurrence h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t, y_t =
<h_t, C_t> + D x_t in float32, each (row, channel) on N/4 lanes.

x (B, T, E) float32 or bfloat16; dt (B, T, E), Bm and Cm (B, T, N), A
(E, N) and D (E,) float32.  ``ssm_scan`` takes h0 (B, E, N) and returns
(y (B, T, E), hT (B, E, N)) in float32 and, with ``return_states``, hs
(B, T, E, N): the post-step carry at every position; with ``chunks``
(the chunk mode) hc (B, ceil(T/K), E, N) instead: the state entering
each chunk of K = ``scan_chunk()`` steps (hc[:, 0] = h0), K fixed when
the kernels are built.  ``ssm_scan_ring`` reads its
initial state from, and writes its checkpoints into, a serving
checkpoint ring h_ring (rows, Rg, E, N) in place, and returns y only.

``ssm_scan_bwd`` launches the backward kernel (``csrc/ssm_scan_bwd.cu``:
each chunk's states recomputed from hc, the chunks walked backward in
parallel from carries joined across them) and ``SsmScanFn`` joins the
carry mode to it for autograd: its forward launches the chunk mode (one
launch) and saves hc,
never a (B, T, E, N) tensor, as the reference's training path saves
only its chunk boundaries.  The ring entry serves only and has no
backward.
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


def scan_chunk() -> int:
    """The chunk length K of the loaded library's chunk checkpoints (a
    compile-time constant of the forward and backward kernels): hc has
    ceil(T / K) chunks."""
    return build.lib().repro_ssm_scan_chunk()


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
             h0: torch.Tensor, *, return_states: bool = False,
             chunks: bool = False) -> Tuple[torch.Tensor, ...]:
    """Launch the kernel on CUDA tensors: (y, hT), plus hs with
    ``return_states`` or hc with ``chunks`` (not both).  Raises
    ``ValueError`` for an N outside {4, 8, 16}, a dtype or shape it does
    not take, a non-contiguous tensor or a tensor off the card (checked in
    that order); ``RuntimeError`` on a launch error."""
    if x.dim() != 3:
        raise ValueError(f"ssm_scan: x must be (B, T, E), got "
                         f"{tuple(x.shape)}")
    if return_states and chunks:
        raise ValueError("ssm_scan: return_states and chunks exclude each "
                         "other")
    B, T, E = x.shape
    N = A.shape[-1]
    _check_scan("ssm_scan", x, dt, Bm, Cm, A, D, {"h0": (h0, (B, E, N))})
    dev = x.device
    y = torch.empty((B, T, E), dtype=torch.float32, device=dev)
    hT = torch.empty((B, E, N), dtype=torch.float32, device=dev)
    states = None
    if return_states:
        states = torch.empty((B, T, E, N), dtype=torch.float32, device=dev)
    elif chunks:
        states = torch.empty((B, -(-T // scan_chunk()), E, N),
                             dtype=torch.float32, device=dev)
    out = (y, hT) if states is None else (y, hT, states)
    if B == 0 or E == 0:
        return out
    L = build.lib()
    args = (x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A.data_ptr(), D.data_ptr(), h0.data_ptr(), y.data_ptr(),
            hT.data_ptr(), states.data_ptr() if states is not None else None,
            B, T, E, N)
    bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = (L.repro_ssm_scan_chunks if chunks else L.repro_ssm_scan)(
            *args, bf16, stream)
    build.check(rc, "ssm_scan")
    build.LAUNCHES["ssm_scan"] += 1
    return out


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


def ssm_scan_bwd(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                 h0: torch.Tensor, hc: torch.Tensor, dy: torch.Tensor,
                 dhT: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """Launch the backward kernel (one call, up to four kernels in order:
    the chunks' local adjoints, their join into carries, the chunks'
    recompute and reverse walk, the fixed-order sum of their partials) on
    CUDA tensors: hc (B, ceil(T/K), E, N) the forward's chunk checkpoints
    at K = ``scan_chunk()``, dy (B, T, E) and dhT (B, E, N) or None,
    float32.  Returns (dx in x's dtype, ddt, dBm, dCm, dA, dD, dh0) in
    float32.  Raises as ``ssm_scan`` does."""
    if x.dim() != 3:
        raise ValueError(f"ssm_scan_bwd: x must be (B, T, E), got "
                         f"{tuple(x.shape)}")
    B, T, E = x.shape
    N = A.shape[-1]
    extra = {"h0": (h0, (B, E, N)), "dy": (dy, (B, T, E))}
    if dhT is not None:
        extra["dhT"] = (dhT, (B, E, N))
    _check_scan("ssm_scan_bwd", x, dt, Bm, Cm, A, D, extra)
    # hc's shape names the library's K: checked once the rest is on the card
    nC = -(-T // scan_chunk()) if T > 0 else 0
    _check_scan("ssm_scan_bwd", x, dt, Bm, Cm, A, D,
                {"hc": (hc, (B, nC, E, N))})
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    if B == 0 or E == 0 or T == 0:
        return (torch.zeros_like(x), torch.zeros_like(dt),
                torch.zeros_like(Bm), torch.zeros_like(Cm),
                torch.zeros_like(A), torch.zeros_like(D),
                torch.zeros_like(h0) if dhT is None else dhT.clone())
    L = build.lib()
    dx = torch.empty_like(x)
    ddt = torch.empty((B, T, E), **f32)
    dBm = torch.empty((B, T, N), **f32)
    dCm = torch.empty((B, T, N), **f32)
    dA = torch.empty((E, N), **f32)
    dD = torch.empty((E,), **f32)
    dh0 = torch.empty((B, E, N), **f32)
    scratch = torch.empty((L.repro_ssm_scan_bwd_scratch(B, T, E, N),), **f32)
    with torch.cuda.device(dev):
        rc = L.repro_ssm_scan_bwd(
            x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A.data_ptr(), D.data_ptr(), hc.data_ptr(), dy.data_ptr(),
            dhT.data_ptr() if dhT is not None else None,
            dx.data_ptr(), ddt.data_ptr(), dBm.data_ptr(), dCm.data_ptr(),
            dA.data_ptr(), dD.data_ptr(), dh0.data_ptr(), scratch.data_ptr(),
            B, T, E, N, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "ssm_scan_bwd")
    build.LAUNCHES["ssm_scan_bwd"] += 1
    return dx, ddt, dBm, dCm, dA, dD, dh0


class SsmScanFn(torch.autograd.Function):
    """``ssm_scan`` (carry mode) with its backward kernel for autograd.
    ``apply(x, dt, Bm, Cm, A, D, h0)`` returns (y, hT); gradients flow to
    all seven inputs.  The forward runs the kernel's chunk mode and saves
    the chunk checkpoints hc (B, ceil(T/K), E, N) float32 at K =
    ``scan_chunk()`` (1/K of the every-state hs), from which the backward
    recomputes each chunk's states."""

    @staticmethod
    def forward(ctx, x, dt, Bm, Cm, A, D, h0):
        y, hT, hc = ssm_scan(x, dt, Bm, Cm, A, D, h0, chunks=True)
        ctx.save_for_backward(x, dt, Bm, Cm, A, D, h0, hc)
        ctx.set_materialize_grads(False)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        x, dt, Bm, Cm, A, D, h0, hc = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        return ssm_scan_bwd(x, dt, Bm, Cm, A, D, h0, hc, dy.contiguous(),
                            None if dhT is None else dhT.contiguous())
