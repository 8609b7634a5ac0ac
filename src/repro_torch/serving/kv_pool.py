"""Paged KV-cache pool with copy-on-write sharing and rollback-aware
reclamation (port of ``repro.serving.kv_pool``, DESIGN.md §7.1).

The pool is pure host accounting and is the reference's code unchanged:
every token stream (a request's target stream, its draft stream, each
branch continuation) owns a page table; ``fork`` shares the parent's pages
(refcount++), ``extend`` copies a shared tail page before writing into it
(copy-on-write; ``cow_listeners`` mirror the copy in the physical page
buffers), and ``truncate`` returns pages of rejected tokens to the free
list tagged by reason (rollback / branch / prune / retire / preempt).  The
pool is the serving scheduler's admission and preemption authority
(``has_room`` / ``would_need``).

``PagedStore`` is the one part that differs: its buffer is a torch tensor
on the engine's device, written by ``put`` and read back by ``get``
through ``ops.paged_gather`` (the CUDA gather kernel on the card).  The
reference keeps the buffer in host memory and uploads it for every
gather; keeping it on the device makes swap-out and swap-in device-to-
device copies with no host round trip, at the price of device memory
sized to the swap store (``swap_pages * page_size * dim`` float32).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Hashable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops

SeqId = Hashable


class PoolExhausted(RuntimeError):
    """No free pages left for a required allocation."""


@dataclasses.dataclass
class PoolStats:
    allocated_pages: int = 0           # total pages ever handed out
    cow_copies: int = 0                # tail-page copies forced by sharing
    peak_pages_in_use: int = 0
    reclaimed_rollback_pages: int = 0  # rejected draft tokens (post-verify)
    reclaimed_branch_pages: int = 0    # losing branch continuations
    reclaimed_prune_pages: int = 0     # H-RAD pre-verify pruning
    reclaimed_retire_pages: int = 0    # request completed
    reclaimed_preempt_pages: int = 0   # evicted under pool pressure
    reclaimed_evict_pages: int = 0     # prefix-cache LRU eviction

    @property
    def reclaimed_speculative_pages(self) -> int:
        """Pages reclaimed because speculation was undone (the paper's
        rollback cost, Sec. 4.2) — excludes normal retirement."""
        return (self.reclaimed_rollback_pages + self.reclaimed_branch_pages
                + self.reclaimed_prune_pages)

    def as_dict(self) -> Dict[str, int]:
        d = dataclasses.asdict(self)
        d["reclaimed_speculative_pages"] = self.reclaimed_speculative_pages
        return d


_RECLAIM_FIELDS = {
    "rollback": "reclaimed_rollback_pages",
    "branch": "reclaimed_branch_pages",
    "prune": "reclaimed_prune_pages",
    "retire": "reclaimed_retire_pages",
    "preempt": "reclaimed_preempt_pages",
    "evict": "reclaimed_evict_pages",
}


class PagedKVPool:
    """Free-list page allocator with refcounted sharing.

    Invariants (``check()``):
      * ref[p] == number of appearances of p across all page tables;
      * the free list holds exactly the pages with ref == 0, once each;
      * len(table[s]) == pages_for(len[s]) for every open stream.
    """

    def __init__(self, num_pages: int, page_size: int):
        assert num_pages > 0 and page_size > 0
        self.num_pages = num_pages
        self.page_size = page_size
        # pop() from the end -> ascending page ids are handed out first
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._ref = np.zeros(num_pages, np.int32)
        self._tables: Dict[SeqId, List[int]] = {}
        self._lens: Dict[SeqId, int] = {}
        self.stats = PoolStats()
        # physically paged consumers (the paged-attention decoders) register
        # here: a COW is a *data* copy for them, not just accounting, and
        # the copy must land before the next forward reads the new page.
        self.cow_listeners: List[Callable[[int, int], None]] = []
        # observability taps: called as fn(reason, freed) whenever a release
        # physically frees pages, so the trace recorder can attribute
        # reclamation per cause without polling PoolStats.
        self.reclaim_listeners: List[Callable[[str, int], None]] = []

    # ------------------------------------------------------------- queries
    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.pages_in_use / self.num_pages

    @property
    def shared_pages(self) -> int:
        """Physical pages currently referenced by more than one table —
        the zero-copy win from branch forks and prefix-cache hits."""
        return int((self._ref > 1).sum())

    @property
    def logical_pages(self) -> int:
        """Table-entry count: what occupancy *would* be without sharing."""
        return sum(len(t) for t in self._tables.values())

    @property
    def cow_copies_total(self) -> int:
        return self.stats.cow_copies

    def refcount(self, page: int) -> int:
        """Tables currently referencing physical page ``page``."""
        return int(self._ref[page])

    def is_open(self, seq: SeqId) -> bool:
        return seq in self._tables

    def length(self, seq: SeqId) -> int:
        return self._lens[seq]

    def table(self, seq: SeqId) -> List[int]:
        return list(self._tables[seq])

    def would_need(self, updates: Sequence[Tuple[SeqId, int]]) -> int:
        """Worst-case new pages required to append ``add`` tokens to each
        stream (including copy-on-write of shared tail pages)."""
        need = 0
        for seq, add in updates:
            if add <= 0:
                continue
            cur_pages = len(self._tables[seq])
            new_pages = self.pages_for(self._lens[seq] + add)
            need += new_pages - cur_pages
            tail = self._tables[seq][-1] if cur_pages else None
            if (tail is not None and self._ref[tail] > 1
                    and self._lens[seq] % self.page_size != 0):
                need += 1      # tail page must be COW-copied before writing
        return need

    def has_room(self, updates: Sequence[Tuple[SeqId, int]],
                 slack_pages: int = 0) -> bool:
        return self.would_need(updates) + slack_pages <= len(self._free)

    # ----------------------------------------------------------- lifecycle
    def open(self, seq: SeqId) -> None:
        assert seq not in self._tables, f"stream {seq!r} already open"
        self._tables[seq] = []
        self._lens[seq] = 0

    def close(self, seq: SeqId, reason: str = "retire") -> None:
        self._release(self._tables.pop(seq), reason)
        del self._lens[seq]

    # ----------------------------------------------------------- alloc/free
    def _alloc(self) -> int:
        if not self._free:
            raise PoolExhausted(
                f"pool exhausted ({self.num_pages} pages of "
                f"{self.page_size} tokens)")
        p = self._free.pop()
        self._ref[p] = 1
        self.stats.allocated_pages += 1
        self.stats.peak_pages_in_use = max(self.stats.peak_pages_in_use,
                                           self.pages_in_use)
        return p

    def _release(self, pages: Sequence[int], reason: str) -> None:
        field = _RECLAIM_FIELDS[reason]
        freed = 0
        for p in pages:
            self._ref[p] -= 1
            assert self._ref[p] >= 0
            if self._ref[p] == 0:
                self._free.append(p)
                freed += 1
        setattr(self.stats, field, getattr(self.stats, field) + freed)
        if freed:
            for fn in self.reclaim_listeners:
                fn(reason, freed)

    def extend(self, seq: SeqId, n_tokens: int) -> None:
        """Append ``n_tokens`` KV slots to ``seq``.  Raises PoolExhausted
        *before* mutating anything if the pages are not available."""
        if n_tokens <= 0:
            return
        table = self._tables[seq]
        cur_len = self._lens[seq]
        need = self.pages_for(cur_len + n_tokens) - len(table)
        cow_tail = (bool(table) and self._ref[table[-1]] > 1
                    and cur_len % self.page_size != 0)
        if need + (1 if cow_tail else 0) > len(self._free):
            raise PoolExhausted(
                f"need {need + cow_tail} pages, {len(self._free)} free")
        if cow_tail:
            self._cow(seq, len(table) - 1)
        for _ in range(need):
            table.append(self._alloc())
        self._lens[seq] = cur_len + n_tokens

    def _cow(self, seq: SeqId, logical_page: int) -> None:
        """Give ``seq`` a private copy of one of its shared pages."""
        table = self._tables[seq]
        old = table[logical_page]
        assert self._ref[old] > 1
        new = self._alloc()
        self._ref[old] -= 1
        table[logical_page] = new
        self.stats.cow_copies += 1
        for fn in self.cow_listeners:
            fn(old, new)

    def truncate(self, seq: SeqId, new_len: int,
                 reason: str = "rollback") -> int:
        """Rollback-aware reclamation: drop pages holding only tokens beyond
        ``new_len``.  Returns the number of pages released from this table
        (physically freed only when unshared)."""
        assert new_len <= self._lens[seq], (seq, new_len, self._lens[seq])
        table = self._tables[seq]
        keep = self.pages_for(new_len)
        dropped = table[keep:]
        del table[keep:]
        self._release(dropped, reason)
        self._lens[seq] = new_len
        return len(dropped)

    # ---------------------------------------------------------------- fork
    def fork(self, parent: SeqId, child: SeqId) -> None:
        """Copy-on-write fork: the child shares every parent page."""
        assert child not in self._tables
        table = self._tables[parent]
        for p in table:
            self._ref[p] += 1
        self._tables[child] = list(table)
        self._lens[child] = self._lens[parent]

    def fork_prefix(self, parent: SeqId, child: SeqId,
                    n_tokens: int) -> None:
        """Copy-on-write fork of the parent's first ``n_tokens`` only.
        ``n_tokens`` must be page-aligned: the child never ends mid-page
        of a shared page, so a later ``extend`` appends fresh pages
        without ever COW-copying cached prefix data."""
        assert child not in self._tables
        assert n_tokens % self.page_size == 0, n_tokens
        assert n_tokens <= self._lens[parent], (n_tokens, self._lens[parent])
        run = self._tables[parent][:n_tokens // self.page_size]
        for p in run:
            self._ref[p] += 1
        self._tables[child] = list(run)
        self._lens[child] = n_tokens

    def adopt(self, parent: SeqId, child: SeqId) -> None:
        """Replace the parent's table with the (winning) child's and close
        the child, without double-counting the shared prefix."""
        old = self._tables[parent]
        self._tables[parent] = self._tables.pop(child)
        self._lens[parent] = self._lens.pop(child)
        self._release(old, "branch")

    # ---------------------------------------------------------- invariants
    def check(self) -> None:
        counts = np.zeros(self.num_pages, np.int64)
        for seq, table in self._tables.items():
            assert len(table) == self.pages_for(self._lens[seq]), seq
            for p in table:
                counts[p] += 1
        assert (counts == self._ref).all(), "refcount drift"
        free = sorted(self._free)
        assert len(set(free)) == len(free), "duplicate free pages"
        assert all(self._ref[p] == 0 for p in free), "free page with refs"
        assert len(free) + int((self._ref > 0).sum()) == self.num_pages


class PoolGroup:
    """Read-only aggregate over per-decoder pools (DESIGN.md §7.6).

    Target pages never appear in a draft table (and vice versa), so each
    physically paged decoder has its own pool and sizes its buffer to its
    own pages.  The split pools stay the allocation/accounting authority;
    this view only re-aggregates them for metrics, reports and invariant
    checks, so external consumers keep seeing one logical pool."""

    def __init__(self, pools: Dict[str, "PagedKVPool"]):
        assert pools
        sizes = {p.page_size for p in pools.values()}
        assert len(sizes) == 1, "split pools must share a page size"
        self.pools = dict(pools)

    @property
    def page_size(self) -> int:
        return next(iter(self.pools.values())).page_size

    @property
    def num_pages(self) -> int:
        return sum(p.num_pages for p in self.pools.values())

    @property
    def free_pages(self) -> int:
        return sum(p.free_pages for p in self.pools.values())

    @property
    def pages_in_use(self) -> int:
        return sum(p.pages_in_use for p in self.pools.values())

    @property
    def occupancy(self) -> float:
        return self.pages_in_use / self.num_pages

    @property
    def shared_pages(self) -> int:
        return sum(p.shared_pages for p in self.pools.values())

    @property
    def logical_pages(self) -> int:
        return sum(p.logical_pages for p in self.pools.values())

    @property
    def logical_occupancy(self) -> float:
        """Bound table entries over capacity — what occupancy would read
        if every shared page were physically replicated per table."""
        return self.logical_pages / self.num_pages

    @property
    def cow_copies_total(self) -> int:
        return sum(p.cow_copies_total for p in self.pools.values())

    @property
    def stats(self) -> PoolStats:
        merged = PoolStats()
        for pool in self.pools.values():
            for f in dataclasses.fields(PoolStats):
                # summing per-pool peaks upper-bounds the joint peak; every
                # other field is a plain counter
                setattr(merged, f.name, getattr(merged, f.name)
                        + getattr(pool.stats, f.name))
        return merged

    def check(self) -> None:
        for pool in self.pools.values():
            pool.check()


class PagedStore:
    """Physically paged token-row storage: a (num_pages, page_size, dim)
    float32 buffer on ``device`` addressed through PagedKVPool page tables.

    The serving engine uses one as preemption *swap space*: a preempted
    request's KV rows are scattered into pages here and gathered back — by
    the paged-gather kernel — on re-admission, instead of recomputing the
    prefix (DESIGN.md §7.3).
    """

    def __init__(self, num_pages: int, page_size: int, dim: int,
                 device="cuda"):
        self.pool = PagedKVPool(num_pages, page_size)
        self.buf = torch.zeros((num_pages, page_size, dim),
                               dtype=torch.float32,
                               device=resolve_device(device))
        self.dim = dim

    def put(self, seq: SeqId, rows: torch.Tensor) -> None:
        """Store ``rows`` (L, dim) as stream ``seq``.  Raises PoolExhausted
        (stream not created) when the store is full."""
        assert rows.dim() == 2 and rows.shape[1] == self.dim
        ps = self.pool.page_size
        self.pool.open(seq)
        try:
            self.pool.extend(seq, rows.shape[0])
        except PoolExhausted:
            self.pool.close(seq, "preempt")
            raise
        # only the L written rows: a partial last page keeps its stale
        # tail, which ``get`` zeroes through valid_len
        table = torch.tensor(self.pool.table(seq), dtype=torch.int64)
        flat = (table[:, None] * ps + torch.arange(ps)[None]).reshape(-1)
        self.buf.view(-1, self.dim)[flat[:rows.shape[0]].to(
            self.buf.device)] = rows.to(self.buf)

    def get(self, seq: SeqId) -> torch.Tensor:
        """Gather stream ``seq`` back into contiguous (L, dim) rows."""
        L = self.pool.length(seq)
        if L == 0:
            return torch.zeros((0, self.dim), dtype=self.buf.dtype,
                               device=self.buf.device)
        table = torch.tensor(self.pool.table(seq), dtype=torch.int32,
                             device=self.buf.device)
        return ops.paged_gather(self.buf, table, L)[:L]

    def drop(self, seq: SeqId, reason: str = "retire") -> None:
        self.pool.close(seq, reason)
