"""PyTorch + CUDA port of the SpecBranch serving system.

Mirrors the subpackages of the JAX package ``repro`` (the reference the
port is held against), so each module here names its counterpart:
``repro_torch.serving.batched_engine`` ports ``repro.serving.batched_engine``
and so on.  The port imports ``torch`` and never ``jax`` or ``repro``.

Entry points take ``device=`` and default to ``"cuda"``; without a GPU they
raise unless the caller asks for ``device="cpu"`` explicitly (the CPU path
runs every kernel's plain PyTorch version).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a visible
    card raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but no CUDA device is "
            "visible; pass device='cpu' to run the plain PyTorch path")
    return dev
