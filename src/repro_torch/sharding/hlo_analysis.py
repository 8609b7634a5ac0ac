"""Collective census of the port's mesh serving (port of
``repro.sharding.hlo_analysis.collective_counts``).

The reference parses the compiled HLO of a forward and counts the
collective ops GSPMD inserted.  The port has no HLO: its tensor-parallel
forward issues every collective itself, through the mesh axes of
``launch.mesh``, and each axis records what it issues here.  So this
module counts ISSUED collectives, not HLO ops.  Keys take the
reference's form, ``kind@n`` with ``n`` the group size (``"all-reduce@2"``,
``"all-gather@2"``); a collective over a group of one is never issued and
never counted.  The census is read one forward at a time: ``reset``
before the forward, ``collective_counts`` after it.

The reference's ``collective_bytes`` and ``dot_flops`` (the HLO byte and
FLOP parsers of the training mesh's dry run) are not ported here.
"""
from __future__ import annotations

from typing import Dict


class Census:
    """Running count of issued collectives, by ``kind@group_size``."""

    def __init__(self):
        self._counts: Dict[str, int] = {}

    def record(self, kind: str, n: int) -> None:
        key = f"{kind}@{n}"
        self._counts[key] = self._counts.get(key, 0) + 1

    def reset(self) -> None:
        self._counts.clear()

    def counts(self) -> Dict[str, int]:
        return dict(self._counts)


def collective_counts(census: Census) -> Dict[str, int]:
    """The census as the reference reports it: ``{"all-reduce@2": 5,
    ...}``."""
    return census.counts()
