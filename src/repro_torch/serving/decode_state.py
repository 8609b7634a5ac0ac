"""Per-row decode state of the paged backend (port of
``repro.serving.decode_state``: ``PagedAttnState``, ``SSMRingState`` and
``DecodeState``).

Attention KV lives scattered across a ``PagedKVPool``'s pages; rows exist
only as page-table views built per call from the pool.  Attention forks
copy nothing (the pool's COW fork shares pages and ``copy_page`` mirrors
a COW split physically), rollback is positional (the pool frees pages,
the write head moves), and swap packs a row straight through its table.
Mamba slots carry per-row position-indexed checkpoint rings, so their
rollback is positional too; a fork copies the source row's rings, and a
preempted row's rings survive as ONE snapshot at its packed length.  The
dense N-row backend is a later slice.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.serving.kv_pool import PagedKVPool

__all__ = ["DecodeState", "PagedAttnState", "SSMRingState"]


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


    @staticmethod
    def owns(slot_cache) -> bool:
        return "k_pages" in slot_cache


class SSMRingState:
    """Per-row position-indexed checkpoint rings of the mamba slots.

    Leaves are ``(stack, n_rows, ring, ...)``; slot ``k % ring`` holds
    the post-step carry after the row's k-th token, so rollback is the
    same positional reset as attention.  Rings are state, not token rows:
    they never pack, and a preempted row's rings survive as one explicit
    checkpoint (``snapshot_flat`` / ``restore`` at the packed length)."""

    name = "ssm-ring"

    def __init__(self, ring: int):
        assert ring > 0
        self.ring = ring

    @staticmethod
    def owns(slot_cache) -> bool:
        return "h_ring" in slot_cache

    def slots(self, cache) -> List[dict]:
        return [c for c in M.iter_slots(cache) if self.owns(c)]

    def snapshot_flat(self, cache, row: int, step: int) -> torch.Tensor:
        """One row's recurrent state at stream length ``step``, flattened
        and concatenated on the device so that it crosses to the host in
        ONE transfer."""
        s = step % self.ring
        return torch.cat([torch.cat([c["h_ring"][:, row, s].reshape(-1)
                                     .float(),
                                     c["conv_ring"][:, row, s].reshape(-1)
                                     .float()])
                          for c in self.slots(cache)])

    def snapshot_split(self, cache, buf: np.ndarray
                       ) -> List[Dict[str, torch.Tensor]]:
        """Split a fetched ``snapshot_flat`` buffer back into one {h,
        conv} dict of host tensors per recurrent slot (conv in the ring's
        dtype)."""
        out, off = [], 0
        flat = torch.from_numpy(np.ascontiguousarray(buf))
        for c in self.slots(cache):
            h_shape = (c["h_ring"].shape[0],) + tuple(c["h_ring"].shape[3:])
            c_shape = ((c["conv_ring"].shape[0],)
                       + tuple(c["conv_ring"].shape[3:]))
            hn, cn = int(np.prod(h_shape)), int(np.prod(c_shape))
            out.append({"h": flat[off:off + hn].reshape(h_shape).clone(),
                        "conv": flat[off + hn:off + hn + cn]
                        .reshape(c_shape).to(c["conv_ring"].dtype)})
            off += hn + cn
        return out

    @torch.no_grad()
    def restore(self, cache, row: int, step: int,
                snap: List[Dict[str, torch.Tensor]]) -> None:
        """Write a snapshot back into the rings at ``step`` (in place),
        after which a forward starting at position ``step`` resumes from
        it."""
        s = step % self.ring
        for c, sn in zip(self.slots(cache), snap):
            c["h_ring"][:, row, s] = sn["h"].to(c["h_ring"].device)
            c["conv_ring"][:, row, s] = sn["conv"].to(
                device=c["conv_ring"].device, dtype=c["conv_ring"].dtype)

    @torch.no_grad()
    def copy_row(self, cache, src: int, dst: int) -> None:
        """Row fork: the destination row's rings become the source's."""
        for c in self.slots(cache):
            for a in c.values():
                a[:, dst] = a[:, src]


class DecodeState:
    """The cache pytree (paged attention slots next to per-row mamba
    rings), per-row write heads and the free-row list.

    The engine-facing state operations — fork, bind, COW page copy, swap
    pack/unpack, ring snapshot/restore — live here, so the decoder above
    never touches the layout; rollback is the engine moving ``row_pos``
    and truncating the pool stream (rings resume from the checkpoint of
    the new length)."""

    def __init__(self, cfg: ModelConfig, *, n_rows: int, max_len: int,
                 paged: PagedKVPool, device, ssm_ring: int = 0):
        self.cfg, self.n_rows, self.max_len = cfg, n_rows, max_len
        self.ssm_ring = max(0, ssm_ring)
        has_ssm = any(m == "mamba" for m, _ in cfg.pattern)
        if has_ssm and self.ssm_ring <= 0:
            raise ValueError(
                "batched decoding of an SSM-bearing config needs a "
                "checkpoint ring (ssm_ring > 0) for per-row rollback")
        self.paged = PagedAttnState(paged, max_len)
        self.ssm: Optional[SSMRingState] = (SSMRingState(self.ssm_ring)
                                            if has_ssm else None)
        self.cache = M.init_paged_cache(
            cfg, paged.num_pages, paged.page_size, device,
            n_rows=n_rows if has_ssm else 0, ssm_ring=self.ssm_ring)
        self.free_rows = list(range(n_rows - 1, -1, -1))
        # per-row write head: idle rows of a batched call park here (their
        # attention writes at positions >= the pool length go to the trash
        # page; their ring writes land in future slots)
        self.row_pos = np.zeros(n_rows, np.int64)
        # swap layout: per token, every paged leaf contributes stack * KV
        # * hd float32 values, concatenated in (slot, leaf) order; rings
        # ride one snapshot.  An attention-free config (swap_dim 0) is not
        # swappable and recomputes its prefix on re-admission.
        self.swap_dim = sum(a.shape[0] * int(np.prod(a.shape[3:]))
                            for c in self._paged_slots()
                            for a in self._leaves(c))
        self.swappable = self.swap_dim > 0

    @staticmethod
    def _leaves(c):
        return [c[k] for k in sorted(c)]

    def _paged_slots(self) -> List[dict]:
        return [c for c in M.iter_slots(self.cache) if PagedAttnState.owns(c)]

    @property
    def has_ssm(self) -> bool:
        return self.ssm is not None

    def fork(self, src: int, dst: int) -> None:
        """COW fork of one row: the rings copy their row, paged attention
        moves zero bytes (the caller forks the pool stream and binds
        ``dst``)."""
        if self.ssm is not None:
            self.ssm.copy_row(self.cache, src, dst)
        self.row_pos[dst] = self.row_pos[src]

    def snapshot_flat(self, row: int, step: int) -> torch.Tensor:
        assert self.ssm is not None, "snapshot needs a checkpoint-ring cache"
        return self.ssm.snapshot_flat(self.cache, row, step)

    def snapshot_split(self, buf: np.ndarray
                       ) -> List[Dict[str, torch.Tensor]]:
        assert self.ssm is not None
        return self.ssm.snapshot_split(self.cache, buf)

    def restore(self, row: int, step: int,
                snap: List[Dict[str, torch.Tensor]]) -> None:
        assert self.ssm is not None, "restore needs a checkpoint-ring cache"
        self.ssm.restore(self.cache, row, step, snap)

    def bind(self, row: int, key: Any) -> None:
        self.paged.bind(row, key)

    def unbind(self, row: int) -> None:
        self.paged.unbind(row)

    @torch.no_grad()
    def copy_page(self, src: int, dst: int) -> None:
        """Physical COW mirror: duplicate one page in every paged leaf."""
        for c in self._paged_slots():
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
        for c in self._paged_slots():
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
        for c in self._paged_slots():
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
