"""Per-row decode state of the paged backend (port of
``repro.serving.decode_state``: ``PagedAttnState`` and ``DecodeState``).

Attention KV lives scattered across a ``PagedKVPool``'s pages; rows exist
only as page-table views built per call from the pool.  Forks copy
nothing (the pool's COW fork shares pages and ``copy_page`` mirrors a COW
split physically), rollback is positional (the pool frees pages, the
write head moves), and swap packs a row straight through its table.  The
dense N-row backend and the SSM checkpoint rings are later slices.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.serving.kv_pool import PagedKVPool

__all__ = ["DecodeState", "PagedAttnState"]


class PagedAttnState:
    """Attention KV scattered across a ``PagedKVPool``'s pages.

    Leaves are ``(stack, num_pages + 1, page_size, KV, hd)`` — no batch
    axis; ``bind`` attaches a pool stream to a decoder row, and every
    forward reads the row's table and length live from the pool."""

    def __init__(self, pool: PagedKVPool, max_len: int):
        self.pool = pool
        self.n_table = pool.pages_for(max_len)
        self.trash = pool.num_pages
        self.row_key: Dict[int, Any] = {}

    def bind(self, row: int, key: Any) -> None:
        self.row_key[row] = key

    def unbind(self, row: int) -> None:
        self.row_key.pop(row, None)

    def table_view(self, rows: Optional[Sequence[int]], n_rows: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(table, lens) for a batched call: bound rows expose their pool
        stream's pages; unbound rows (and pad lanes, row < 0) are empty —
        lens 0, every write routed to the trash page, every read masked."""
        n = n_rows if rows is None else len(rows)
        tab = np.full((n, self.n_table), self.trash, np.int32)
        lens = np.zeros(n, np.int32)
        it = range(n_rows) if rows is None else rows
        for i, row in enumerate(it):
            key = self.row_key.get(row)
            if key is None or not self.pool.is_open(key):
                continue
            t = self.pool.table(key)
            tab[i, :len(t)] = t
            lens[i] = self.pool.length(key)
        return tab, lens


class DecodeState:
    """The paged cache pytree, per-row write heads and the free-row list.

    The engine-facing state operations — fork, bind, COW page copy, swap
    pack/unpack — live here, so the decoder above never touches the
    layout; rollback is the engine moving ``row_pos`` and truncating the
    pool stream."""

    def __init__(self, cfg: ModelConfig, *, n_rows: int, max_len: int,
                 paged: PagedKVPool, device):
        self.cfg, self.n_rows, self.max_len = cfg, n_rows, max_len
        self.paged = PagedAttnState(paged, max_len)
        self.cache = M.init_paged_cache(cfg, paged.num_pages,
                                        paged.page_size, device)
        self.free_rows = list(range(n_rows - 1, -1, -1))
        # per-row write head: idle rows of a batched call park here (their
        # writes at positions >= the pool length go to the trash page)
        self.row_pos = np.zeros(n_rows, np.int64)
        # swap layout: per token, every paged leaf contributes stack * KV
        # * hd float32 values, concatenated in (slot, leaf) order
        self.swap_dim = sum(a.shape[0] * int(np.prod(a.shape[3:]))
                            for c in M.iter_slots(self.cache)
                            for a in self._leaves(c))
        self.swappable = self.swap_dim > 0

    @staticmethod
    def _leaves(c):
        return [c[k] for k in sorted(c)]

    def fork(self, src: int, dst: int) -> None:
        """COW fork of one row: zero bytes move (the caller forks the pool
        stream and binds ``dst``)."""
        self.row_pos[dst] = self.row_pos[src]

    def bind(self, row: int, key: Any) -> None:
        self.paged.bind(row, key)

    def unbind(self, row: int) -> None:
        self.paged.unbind(row)

    @torch.no_grad()
    def copy_page(self, src: int, dst: int) -> None:
        """Physical COW mirror: duplicate one page in every paged leaf."""
        for c in M.iter_slots(self.cache):
            for a in self._leaves(c):
                a[:, dst] = a[:, src]

    def table_view(self, rows: Optional[Sequence[int]] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        return self.paged.table_view(rows, self.n_rows)

    @torch.no_grad()
    def pack_row(self, row: int, length: int) -> torch.Tensor:
        """The row's first ``length`` token slots as (L, swap_dim) float32
        rows on the cache's device, gathered page by page through the
        row's table (the partial tail page trimmed to ``length``)."""
        key = self.paged.row_key[row]
        parts = []
        for c in M.iter_slots(self.cache):
            for lf in self._leaves(c):
                table = torch.tensor(self.paged.pool.table(key),
                                     dtype=torch.int64, device=lf.device)
                pg = lf[:, table]                  # (stack, n, ps, KV, hd)
                tok = pg.reshape(pg.shape[0], -1, *pg.shape[3:]) \
                    .movedim(1, 0)                 # (n*ps, stack, KV, hd)
                parts.append(tok[:length].reshape(length, -1).float())
        return torch.cat(parts, dim=1)

    @torch.no_grad()
    def unpack_row(self, row: int, rows: torch.Tensor) -> None:
        """Scatter packed token rows (inverse of ``pack_row``) into the
        pages of the row's freshly re-extended table; the stale tail of a
        partial last page stays masked by the row's pool length."""
        key = self.paged.row_key[row]
        pool = self.paged.pool
        L = rows.shape[0]
        assert pool.length(key) == L, (pool.length(key), L)
        ps = pool.page_size
        off = 0
        for c in M.iter_slots(self.cache):
            for lf in self._leaves(c):
                table = torch.tensor(pool.table(key), dtype=torch.int64,
                                     device=lf.device)
                n = table.shape[0]
                stack, tail = lf.shape[0], tuple(lf.shape[3:])
                width = stack * int(np.prod(tail))
                seg = rows[:, off:off + width].reshape((L, stack) + tail)
                off += width
                pad = n * ps - L
                if pad:
                    seg = torch.cat([seg, seg.new_zeros((pad, stack) + tail)])
                pages = seg.reshape((n, ps, stack) + tail).movedim(2, 0)
                lf[:, table] = pages.to(lf.dtype)
        self.row_pos[row] = L
