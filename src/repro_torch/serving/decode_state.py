"""Per-row decode state of the batched decoders (port of
``repro.serving.decode_state``: ``DenseAttnState``, ``PagedAttnState``,
``SSMRingState`` and ``DecodeState``).

Two attention backends.  Dense: N-row ring caches ``(stack, n_rows, Sc,
...)`` as ``models.model.init_cache`` lays them out; rows fork by
copying, pack for swap by slicing, and a batched prefill runs on a fresh
``lanes``-row view that is then scattered into the admitted rows.  Paged:
attention KV scattered across a ``PagedKVPool``'s pages; rows exist only
as page-table views built per call from the pool, attention forks copy
nothing (the pool's COW fork shares pages and ``copy_page`` mirrors a COW
split physically), and swap packs a row straight through its table.
Rollback is positional on both (the write head moves; the pool frees
pages).  Mamba slots carry per-row position-indexed checkpoint rings on
either backend, so their rollback is positional too; a fork copies the
source row's rings.  A preempted paged hybrid row's rings survive as ONE
snapshot at its packed length; a dense hybrid row is not swappable and
recomputes its prefix at re-admission, as in the reference (the dense
backend is the oracle the paged swap is held against).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.serving.kv_pool import PagedKVPool

__all__ = ["DecodeState", "DenseAttnState", "PagedAttnState",
           "SSMRingState"]


def _leaves(c) -> List[torch.Tensor]:
    """A slot's leaves in the reference's (sorted-key) pytree order."""
    return [c[k] for k in sorted(c)]


def _fresh_like(a: torch.Tensor, lanes: int) -> torch.Tensor:
    """A fresh-row buffer with the row axis (axis 1) resized to
    ``lanes``: integer leaves filled with -1 (invalid position), floats
    with zero, the empty-row convention of ``init_cache``."""
    fill = -1 if not a.dtype.is_floating_point else 0
    return torch.full((a.shape[0], lanes) + tuple(a.shape[2:]), fill,
                      dtype=a.dtype, device=a.device)


class DenseAttnState:
    """N-row dense attention rows (global caches and sliding-window
    rings).

    Leaves are ``(stack, n_rows, Sc, ...)``; rows fork by copying, pack by
    slicing.  Token-packable only when every slot keeps the full sequence
    axis (``Sc == max_len``): a sliding-window ring folds positions, so a
    windowed row cannot be rebuilt from token rows."""

    def __init__(self, max_len: int):
        self.max_len = max_len

    @staticmethod
    def owns(slot_cache) -> bool:
        return "k" in slot_cache

    def token_packable(self, cache) -> bool:
        return all(a.shape[2] == self.max_len
                   for c in M.iter_slots(cache) if self.owns(c)
                   for a in c.values())

    def pack_parts(self, cache, row: int, length: int
                   ) -> List[torch.Tensor]:
        """One (L, width) float32 block per leaf (positions are exact in
        float32 below 2^24), in (slot, leaf) order."""
        return [lf[:, row, :length].movedim(1, 0).reshape(length, -1)
                .float()
                for c in M.iter_slots(cache) if self.owns(c)
                for lf in _leaves(c)]

    def unpack_slot(self, c, row: int, rows: torch.Tensor, off: int) -> int:
        """Rebuild one slot's row in place from packed token rows; slots
        beyond ``len(rows)`` reset to empty.  Returns the next offset."""
        L = rows.shape[0]
        for lf in _leaves(c):
            stack, tail = lf.shape[0], tuple(lf.shape[3:])
            width = stack * int(np.prod(tail))
            seg = rows[:, off:off + width].reshape((L, stack) + tail)
            off += width
            full = _fresh_like(lf[:, row:row + 1], 1)[:, 0]
            full[:, :L] = seg.movedim(0, 1).to(lf.dtype)
            lf[:, row] = full
        return off


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


class DecodeState:
    """The cache pytree (dense or paged attention slots next to per-row
    mamba rings), per-row write heads and the free-row list.

    The engine-facing state operations — fork, bind, COW page copy,
    prefill views, swap pack/unpack, ring snapshot/restore — live here,
    so the decoder above never touches the layout; rollback is the engine
    moving ``row_pos`` and truncating the pool stream (rings resume from
    the checkpoint of the new length, attention masks stale slots)."""

    def __init__(self, cfg: ModelConfig, *, n_rows: int, max_len: int,
                 paged: Optional[PagedKVPool], device, ssm_ring: int = 0):
        self.cfg, self.n_rows, self.max_len = cfg, n_rows, max_len
        self.ssm_ring = max(0, ssm_ring)
        has_ssm = any(m == "mamba" for m, _ in cfg.pattern)
        if has_ssm and self.ssm_ring <= 0:
            raise ValueError(
                "batched decoding of an SSM-bearing config needs a "
                "checkpoint ring (ssm_ring > 0) for per-row rollback")
        self.ssm: Optional[SSMRingState] = (SSMRingState(self.ssm_ring)
                                            if has_ssm else None)
        self.paged: Optional[PagedAttnState] = None
        if paged is not None:
            self.paged = PagedAttnState(paged, max_len)
            self.cache = M.init_paged_cache(
                cfg, paged.num_pages, paged.page_size, device,
                n_rows=n_rows if has_ssm else 0, ssm_ring=self.ssm_ring)
            self.attn: Any = self.paged
        else:
            # the ring depth doubles as sliding-window slack (init_cache)
            self.cache = M.init_cache(cfg, n_rows, max_len, device,
                                      ssm_ring=self.ssm_ring)
            self.attn = DenseAttnState(max_len)
        self.free_rows = list(range(n_rows - 1, -1, -1))
        # per-row write head: idle rows of a batched call park here, so
        # their pad writes land where the row's next real write lands
        # (causally masked until overwritten; on the paged backend a write
        # at a position >= the pool length goes to the trash page; ring
        # writes land in future slots).  Parking anywhere else would
        # clobber live slots (position 0 is the first prompt token).
        self.row_pos = np.zeros(n_rows, np.int64)
        # swap layout: per token, every attention leaf contributes stack
        # x its trailing dims as float32 values, concatenated in (slot,
        # leaf) order; paged rings ride one snapshot.  A config with no
        # attention (swap_dim 0), a dense hybrid and a dense windowed
        # config are not swappable and recompute their prefix on
        # re-admission, as in the reference.
        self.swap_dim = sum(a.shape[0] * int(np.prod(a.shape[3:]))
                            for c in self._attn_slots()
                            for a in _leaves(c))
        if self.paged is not None:
            self.swappable = self.swap_dim > 0
        else:
            self.swappable = (self.ssm is None and self.swap_dim > 0
                              and self.attn.token_packable(self.cache))
        # slots with a row axis (dense attention, rings): what a fork
        # copies; pure paged attention forks by page sharing alone
        self._row_slots = [c for c in M.iter_slots(self.cache)
                           if not PagedAttnState.owns(c)]

    def _attn_slots(self) -> List[dict]:
        return [c for c in M.iter_slots(self.cache) if self.attn.owns(c)]

    def _paged_slots(self) -> List[dict]:
        return [c for c in M.iter_slots(self.cache) if PagedAttnState.owns(c)]

    @property
    def has_ssm(self) -> bool:
        return self.ssm is not None

    @torch.no_grad()
    def fork(self, src: int, dst: int) -> None:
        """COW fork of one row: every row-axis leaf (dense K/V and
        positions, rings) copies its row; paged attention moves zero bytes
        (the caller forks the pool stream and binds ``dst``)."""
        for c in self._row_slots:
            for a in c.values():
                a[:, dst] = a[:, src]
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
        if self.paged is not None:
            self.paged.bind(row, key)

    def unbind(self, row: int) -> None:
        if self.paged is not None:
            self.paged.unbind(row)

    @torch.no_grad()
    def copy_page(self, src: int, dst: int) -> None:
        """Physical COW mirror: duplicate one page in every paged leaf."""
        for c in self._paged_slots():
            for a in _leaves(c):
                a[:, dst] = a[:, src]

    def table_view(self, rows: Optional[Sequence[int]] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        assert self.paged is not None
        return self.paged.table_view(rows, self.n_rows)

    # ------------------------------------------------- dense prefill views
    def prefill_view(self, lanes: int):
        """A ``lanes``-row cache for a bucketed prefill forward on the
        dense backend: every slot is a fresh buffer (a prefill targets
        fresh rows only, so nothing is gathered)."""
        assert self.paged is None
        return M.map_slot_caches(self.cache, lambda c: {
            k: _fresh_like(a, lanes) for k, a in c.items()})

    @torch.no_grad()
    def prefill_merge(self, sub, rows: Sequence[int]) -> None:
        """Scatter lane i of a prefill view into row ``rows[i]`` of the
        cache (in place); lanes past ``len(rows)`` are pad lanes and are
        dropped."""
        idx = torch.as_tensor(list(rows), dtype=torch.int64)
        n = len(idx)
        for c, s in zip(M.iter_slots(self.cache), M.iter_slots(sub)):
            for k, a in c.items():
                a[:, idx.to(a.device)] = s[k][:, :n].to(a.dtype)

    # --------------------------------------------------------------- swap
    @torch.no_grad()
    def pack_row(self, row: int, length: int) -> torch.Tensor:
        """The attention half of the row's first ``length`` token slots
        as (L, swap_dim) float32 rows on the cache's device: dense rows
        sliced, paged rows gathered page by page through the row's table
        (the partial tail page trimmed to ``length``)."""
        assert self.swappable
        if self.paged is None:
            return torch.cat(self.attn.pack_parts(self.cache, row, length),
                             dim=1)
        key = self.paged.row_key[row]
        parts = []
        for c in self._paged_slots():
            for lf in _leaves(c):
                table = torch.tensor(self.paged.pool.table(key),
                                     dtype=torch.int64, device=lf.device)
                pg = lf[:, table]                  # (stack, n, ps, KV, hd)
                tok = pg.reshape(pg.shape[0], -1, *pg.shape[3:]) \
                    .movedim(1, 0)                 # (n*ps, stack, KV, hd)
                parts.append(tok[:length].reshape(length, -1).float())
        return torch.cat(parts, dim=1)

    @torch.no_grad()
    def unpack_row(self, row: int, rows: torch.Tensor) -> None:
        """Restore a row from packed token rows (inverse of ``pack_row``):
        dense slots are rebuilt (positions beyond ``len(rows)`` reset to
        empty); paged rows scatter into the pages of the row's freshly
        re-extended table, where the stale tail of a partial last page
        stays masked by the row's pool length."""
        assert self.swappable
        if self.paged is None:
            off = 0
            for c in self._attn_slots():
                off = self.attn.unpack_slot(c, row, rows, off)
            self.row_pos[row] = rows.shape[0]
            return
        key = self.paged.row_key[row]
        pool = self.paged.pool
        L = rows.shape[0]
        assert pool.length(key) == L, (pool.length(key), L)
        ps = pool.page_size
        off = 0
        for c in self._paged_slots():
            for lf in _leaves(c):
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
