"""The disabled trace recorder of ``repro.obs.trace``.

Engines hold ``NULL_RECORDER``: every hook is an empty method and
``enabled`` is False, so instrumentation sites skip all recording work.
The recording ``TraceRecorder`` and its Perfetto export are a later slice
of the port (ROADMAP.md queue A).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs.registry import MetricsRegistry

__all__ = ["NullRecorder", "NULL_RECORDER"]


class NullRecorder:
    """Disabled recorder: the hooks the serving scheduler calls, empty."""

    enabled = False
    registry: Optional[MetricsRegistry] = None

    def request(self, kind: str, rid: int, **fields) -> None:
        pass

    def sample(self, name: str, value: float, **fields) -> None:
        pass


NULL_RECORDER = NullRecorder()
