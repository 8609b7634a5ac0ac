"""Collective census and collective bytes of the port's meshes (port of
``repro.sharding.hlo_analysis``: ``collective_counts`` and
``collective_bytes``).

The reference parses the compiled HLO of a program and counts the
collective ops GSPMD inserted.  The port has no HLO: its tensor-parallel
forward and the training step issue every collective themselves, through
the mesh axes of ``launch.mesh``, and each axis records what it issues
here, with its bytes.  So this module counts ISSUED collectives, not HLO
ops.  Keys take the reference's form, ``kind@n`` with ``n`` the group
size (``"all-reduce@2"``, ``"all-gather@2"``); a collective over a group
of one is never issued and never counted.  A census is read one program
at a time: ``reset`` before it, ``collective_counts`` /
``collective_bytes`` after it.

``collective_bytes`` applies the reference's ring factors (bytes each
participant moves) to the recorded bytes:

  all-gather        (n-1)/n * result bytes
  all-reduce        2 (n-1)/n * operand bytes   (RS + AG)
  reduce-scatter    (n-1)/n * operand bytes
  all-to-all        (n-1)/n * operand bytes
  broadcast, permute  operand bytes

The dry run cannot run the 256 ranks of a production mesh, so its
figures come from closed-form formulas of the same collectives
(``launch.steps.step_costs``, which also gives the step's dot FLOPs: the
reference's ``dot_flops`` parses them from the HLO), which the tests
hold equal to the census and to ``FlopCounterMode`` of executed steps.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute", "broadcast")


class Census:
    """Running count and bytes of issued collectives, by
    ``kind@group_size``.  The bytes are the operand's (all-reduce,
    reduce-scatter, broadcast) or the result's (all-gather), as the
    reference's HLO parser reads them."""

    def __init__(self):
        self._counts: Dict[str, int] = {}
        self._bytes: Dict[str, int] = {}

    def record(self, kind: str, n: int, nbytes: int = 0) -> None:
        key = f"{kind}@{n}"
        self._counts[key] = self._counts.get(key, 0) + 1
        self._bytes[key] = self._bytes.get(key, 0) + int(nbytes)

    def reset(self) -> None:
        self._counts.clear()
        self._bytes.clear()

    def counts(self) -> Dict[str, int]:
        return dict(self._counts)

    def raw_bytes(self) -> Dict[str, int]:
        """Recorded bytes by ``kind@n`` (no ring factor)."""
        return dict(self._bytes)


def collective_counts(census: Census) -> Dict[str, int]:
    """The census as the reference reports it: ``{"all-reduce@2": 5,
    ...}``."""
    return census.counts()


def ring_bytes(kind: str, n: int, nbytes: float) -> float:
    """Bytes each of ``n`` participants moves for one collective whose
    recorded bytes are ``nbytes`` (the reference's ring factors)."""
    ring = (n - 1) / max(n, 1)
    if kind == "all-reduce":
        return 2 * ring * nbytes
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return ring * nbytes
    return float(nbytes)                  # broadcast, collective-permute


def bytes_by_kind(events: Iterable[Tuple[str, int, float]]
                  ) -> Dict[str, float]:
    """Per-participant bytes by kind (plus ``"total"``) of ``(kind, n,
    recorded bytes, ...)`` events, as the reference's ``collective_bytes``
    reports an HLO module."""
    out: Dict[str, float] = {k: 0.0 for k in KINDS}
    for kind, n, nbytes, *_ in events:
        out[kind] += ring_bytes(kind, n, nbytes)
    out["total"] = sum(out[k] for k in KINDS)
    return out


def collective_bytes(census: Census) -> Dict[str, float]:
    """Per-participant bytes by kind, and ``"total"``, of the census."""
    events = []
    for key, b in census.raw_bytes().items():
        kind, _, n = key.rpartition("@")
        events.append((kind, int(n), b))
    return bytes_by_kind(events)
